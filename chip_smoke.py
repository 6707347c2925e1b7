#!/usr/bin/env python3
"""On-card smoke run of audfprint_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases (any failure exits non-zero before the result line):
  1. environment: nvidia-smi name and power limit, torch and CUDA versions
  2. build the CUDA kernels from audfprint_torch/csrc (nvcc, sm_90a)
  3. K2 (hpf_scan) against its plain version at the main path's shape
     (256 rows x 1535 frames x 256 bins, one 30 s bucket), then K2_CASES
     with and without a carry (ragged and padded widths, T = 0, 1, 5 and
     8191, a query, 4 shifts, subnormal-heavy input, a chunk decaying
     through silence into the subnormal range) and chunks of 1001, 777
     and 2414 frames against one pass at F = 256 and 258, all bit for
     bit; K2 timed at the batch, a listen query and the streamed chunk
     with a carry at 1 and 4 shifts, beside its byte bound; the printed
     line adds a chain floor derived from an assumed FMA latency (T x 4
     cycles at the sampled SM clock), which is not a measurement
  4. K1 (prune_fwd_bwd) against its plain version on random spectrograms
     with ragged n_frames (including 0 and 1) and on np.round-quantised
     tie-heavy ones, and at 512 bins with 8 peaks per frame, bit for bit
     on the kept lists; a few rows against the numpy oracle's
     find_peaks_mask; then K1_CASES at the wrapper's level (dense frames
     with more than k candidates each, F = 200 and F = 258, B = 1, lists
     in global memory, F = 1024 with k = 16, F = 20, 6,000 frames of
     silence whose envelopes decay into the subnormal range)
  5. K1f (prune_fwd_carry) against its plain version at the streamed
     chunk shapes 1 x 8192 x 256 and 4 x 2048 x 256, random and
     tie-heavy, envelope in from the head and from a carry; K1f and K2
     over 3 carried chunks against one pass, bit for bit; then K1F_CASES
     (dense, F = 200, F = 258, a chunk ending inside a ring stage, one
     shorter than a stage, an empty one, F = 1024, 22,000 frames of
     silence) and chunks of 1001, 777 and 2414 frames against one pass at
     F = 256 and 258.  Then K3 (pair_scan) against its plain version, bit
     for bit on times, hashes and lvalid: PAIR_CASES (fanouts 0-6, 512
     bins with K = 8, T = 0, 1, mindt, targetdt and 2,100, no valid slot,
     slots dense within targetdf, partners at |df| = targetdf - 1 and
     targetdf, partners past the last frame, a listen query, mindt 0 and
     -2, slots 3 % valid, T one less than K3's tile, equal to it and one
     more, a tile whose halo runs past T, partners only at d = 62, mindt
     -2 past a tile and its halo, and d < -T at mindt -2 and -70), the
     config-2 batch shape 256 x 1535 x 5, and a 2 h file's
     1 x 310,078 x 5 int16 slots through streaming.pair_kept_slots; K3
     timed at the batch, a query and the streamed shape.  Then K4
     (seg_scan, phase_scan) against its plain version, bit for bit, on
     SCAN_CASES in each op (max, min, add) and direction (empty rows,
     one element, one tile less one, one tile and one tile more, odd
     widths, the mesh row 1 x 204,800, 64 x 51,200, the hist core's
     1,441 x 25,600, a chunk's 5,894,400 hashes 1-D; int64 extremes,
     negatives, runs across tiles, the vote's run starts; the one-query
     row 1 x 51,200, rows of 10,001 tiles), at the planned tile and at
     each tile forced; K4 inside a CUDA graph replayed 100 times over
     changing inputs, and on two streams at once; K4 timed at five main
     shapes (the one-query row added), each op and direction, beside
     torch's own call (cummax, cummin, cumsum), the plain version and
     its byte bound.  Each kernel's
     time (device time of back-to-back launches, cuda_ms) beside its bound
     (bytes over 3.35 TB/s, or float32 operations over 67 TFLOP/s or int32
     operations over 16.7 TOP/s, whichever is longer)
  6. the main path at BASELINE config 2 ("1k-track DB of 30s clips; clean
     exact-segment queries"): 1,000 synthetic music-like 30 s tracks from
     a fixed seed -> Analyzer(device="cuda") -> host HashTable (2^20 x 100)
     -> device table -> 64 clean 10 s hop-aligned queries through the fused
     Matcher path (its CUDA graph captured by a first call, then
     replayed); top-1 self >= 0.95, hash Jaccard > 0.9 against the
     oracle for 4 tracks, and K1, K2 and K3 launched on this path; K1
     timed on the candidate map of one (256 x 30 s) batch of the corpus,
     K3 held against its plain version and timed on its peak slots
  7. the fused device store (models/ingest.DeviceIngest) over the same
     1,000 tracks, each chunk after the first replaying the ingest key's
     CUDA graph: table, counts and hashesperid equal the host store's bit
     for bit, eager and replayed; K1, K2 and K3 once a chunk (counts) and
     once a replay (torch.profiler); the key's capture seconds and MiB;
     the ingest rate eager against replay in turns, beside fingerprint +
     host store; then `precompute -K`'s batched peaks (256 x 30 s),
     replayed equal to eager, and their rate both ways
  8. streaming: K1f timed on an 8,192-frame chunk of a seeded 7,200 s
     WAV, then the WAV through Analyzer's streamed route, whose passes
     replay CUDA graphs (K1f, K2 and K3 launched, time, device memory
     peak); its hashes equal eager and replayed in turns, the reversed
     file (same length) captures no key, one chunk's stats and peaks
     host dispatch eager against replay, K1f and K2 once a peaks replay
     (torch.profiler); four long WAVs hashed as one group (K1f launched
     once a chunk for all four) equal each hashed alone; equal at 8,192-
     and 2,048-frame chunks, Jaccard > 0.9 against the in-memory path; then
     `new` on it and two songs as a subprocess (the long file must stream)
     and 10 s excerpts from 0:30, 59:00 and 1:58:00 matched at rank 0 with
     the offset of their start modulo maxtime
  9. the CLI as subprocesses (python -m audfprint_torch new / match, with
     and without --device-store), which must print a rank-0 "Matched"
     line; `new --idbits 20` with and without --device-store (equal wide
     databases, rank-0 match), `match --windowed 4 --window-hop 2` on a
     recording of two songs, `warmup` then `match --speed-sweep 4` on a
     +4% query, and `match --profile DIR -I --sonify` (a trace naming
     prune_fwd_bwd, hpf_scan and pair_scan, and its count of kernel
     events; the sonify WAV); a one-shot `match` process, eager against
     graphs; `warmup -d db` then fresh `match --listen -d db` processes
     over a pipe (listen_processes): 16 requests of the warm buckets,
     each key's first request, p50 and max, the CLI as it is in turns
     with its graphs off and with each key captured on its first
     request; no capture after the first line (--json-metrics), lines
     equal batch mode; then the golden CLI
     session of tests/golden/cli_session.txt on the card, reporting
     differing lines
 10. BASELINE config 3 ("Noisy + resampled 5s queries with --shifts 4 /
     --density 40 against the 1k-track DB") as benchmarks/baseline_configs
     runs it: its own corpus of 1,000 x 30 s harmonic tracks
     (bench.synth_batch, seeds 0-999, made bit for bit by harmonic_track)
     in a default table, 32 queries of 3 s from tracks 0-31 under its 9
     degradations, fingerprinted by the `noisy-query` preset and matched
     plain, the 4 speed conditions again through
     Matcher.match_samples_sweep(..., 4.0); recall >= 0.95 on clean, SNR
     10, SNR 5 and lowpass 3 kHz, and the sweep recovering every speed
     condition; then the same queries plain and swept, eager against the
     two-stage path's replayed graphs in turns over 5 rounds, rows equal
 11. broadcast monitoring: a seeded 7,200 s WAV of 360 x 20 s segments,
     every third a frame-aligned excerpt of a distinct config-2 track, the
     rest fresh audio; `match --windowed 10 --window-hop 5` through
     cli.do_match on phase 6's table (the file streams: K1f and K2); every
     excerpt named at rank 0 by a window inside it, <= 5% of the windows
     inside filler reporting a track, and do_match's device peak above
     what was resident within the vote's budget (Matcher._budget_bytes);
     the windowed vote's key captured first (seconds, MiB held); then the
     vote alone and the whole do_match, eager against replay in turns
     over 5 rounds, rows and lines equal
 12. the `match --listen` loop (cli.do_listen over an os.pipe) on phase
     6's queries, after cli.do_warmup at --warm-durations 5,10 and
     --batchsize 16 on a matcher of its own (8 graphs captured: 2 buckets
     x sub-batch sizes 1 and 16 x float32 and int16; capture seconds, the
     cache's bytes and the reserved memory after warmup): 16 interactive
     requests (latency; their key among warmup's), then a backlog of 48
     with one missing path; lines equal batch do_match's, in order, the
     missing path reported, fewer do_match calls than backlog queries;
     then the 16 requests again, the eager function against the replays
     in turns over 5 rounds (p50 and max of each), and as .afpt files
     (the two-stage vote alone) likewise, lines equal
 13. a default-size wide table (2^20 x 100 int64, --idbits 20): phase 6's
     1,000 tracks stored on the card by DT.store_batch at sparse ids
     2^18 + 769 i equal the host HashTable bit for bit, and the 64
     queries match at rank 0 with their sparse ids through the fused path

 14. the vote's rows on the card against the numpy oracle
     (audfprint_torch/oracle/match.py), bit for bit: phase 6's 64 queries
     through Matcher in the default mode (two-stage and fused), with
     exact_count, with find_time_range, and with both plus sort_by_time,
     on the 2^20 x 100 table; in phase 11, a seeded sample of 96 of the
     windowed rows
 15. the sharded path on a mesh of 4 logical shards of the one card
     (parallel/): ShardedStore over the 1,000 tracks' hashes equals the
     host store; Matcher(ndev=4) rows equal Matcher(ndev=1) rows with the
     sorted and the hist core, the hpi plane on and off, in three modes;
     the single-device hist core equals the sorted core; the fused mesh
     path equals the two-stage one; DeviceIngest(ndev=4) equals the host
     store, again with a routing cap that forces the overflow replay;
     sharded_merge_fn equals HashTable.merge; dp_fingerprint_fn equals
     fingerprint_batch; the config-2 match batch timed with and without
     the plane.  Then the mesh's CUDA graphs (mesh_graphs), eager against
     replayed in turns: the two-stage mesh vote (RLE, plane off and on;
     hist), the fused mesh match, the routed ingest, its overflow replay
     and ShardedStore, each replay's rows or table equal to the eager
     run's and one device's (or the host store's); one fused-mesh and
     one routed-ingest replay run K1, K2 and K3 once per shard and K4
     its recorded count, the fused-mesh one no torch scan
     (torch.profiler and the counts); each kind's host dispatch of one
     call, the batch and ingest rates, each mesh key's capture seconds
     and MiB.  Then a process boundary: two processes of two shards each
     over gloo, both on the card, store 300 tracks' hashes and match 16
     queries; their table and rows equal the single-device ones.  Phase 9
     also runs new / add / match / merge with --ndev 4 against --ndev 1
     (`new` and `match` with --ndev 4 replaying graphs, --json-metrics),
     and a fresh `match --listen --ndev 4` process after `warmup --ndev
     4` that captures nothing after its first line

 16. the JAX package's behavioural contract (its test_compat_surface,
     test_edge_cases, test_fuzz_compat and test_accuracy), run right after
     phase 5: audfprint_torch.compat's Analyzer() and Matcher() with no
     device land on the card, glob2hashtable over four WAVs (oracle
     Jaccard > 0.9) and match_file at rank 0; K1, K1f, K2 and K3's
     wrappers at B = 0 and T = 0 (K3 also at fanout 0) return empty
     results without a launch; empty, short
     and silent audio give no hashes, an empty DB and empty queries no
     rows (Matcher and the fused path); 8/16/24/32-bit, stereo and
     truncated WAVs decode through the native batch loader to the host
     decode's arrays and hashes; time wrap at maxtime=512 matches at rank 0
     at the wrapped offset; the duplicate-heavy hashbits=8, depth=4,
     maxtimebits=8 table stored on the card equals the host store and both
     voting cores equal the oracle's rows in 8 modes for 3 seeds; the
     16 x 8 s accuracy fixture's clean, noisy, noise, out-of-DB, speed
     and sweep bars, its rows equal to the oracle's; then, outside the
     count, whitened_spectrogram on the card within the front end's
     tolerance of the CPU and fwd_prune_carry (K1f) bit for bit

 17. the fused path's CUDA graphs (utils/graphs.GraphCache), right after
     phase 14, on config 2's 64 queries: the eager _fused_match_graph
     raises no host sync under torch.cuda.set_sync_debug_mode("error");
     every key captured, then a counted run of replays alone at sub-batch
     sizes 1 and 16 with float32 and int16 input (K1, K2 and K3 counted
     exactly once a replay, K4 as often as each key recorded, no key
     captured again; one replay of each key under torch.profiler runs K4
     that often and torch's scan_innermost_dim never); each replayed output
     equal to the eager function's on the same input bit for bit, and the
     rows to the numpy oracle's; capture seconds per key; a 1 x 10 s
     int16 query's host dispatch and device events (torch.profiler) and
     the 64-query fused match rate, eager against replay in turns over 5
     rounds
 18. the two-stage path's CUDA graphs (the Analyzer's fingerprint, the
     Matcher's vote; phase_two_stage), right after phase 17, on config
     2's 64 queries: the eager functions raise no host sync (the vote
     sorted and hist, with and without the time range); every key
     captured, then a counted run of replays alone at sub-batch sizes 1
     and 16, float32 and int16 (K1, K2 and K3 once a fingerprint replay,
     in the counts and in the profiler's kernel events of one replay of
     each key); each replayed output equal to the eager function's bit
     for bit, the hashes to the main path's and the rows to the oracle's
     (sorted and hist); MiB held per key beside
     pipeline.fingerprint_bytes; a 1 x 10 s query's fingerprint and vote
     dispatch and device events and the 64-query two-stage rate, eager
     against replay in turns over 5 rounds

Each path of phases 6-8, 10-13 and 15-18 runs with the kernels' launch
counts set to 0 just before it and read just after; the kernel record
lists them by path.  Every one of these paths fingerprints, so each must
launch K3; each that votes or stores on the card must launch K4.
The last stdout line is {"ok": true, "device": {...}}; the line before it
is the per-kernel JSON record and the one before that the nvidia-smi line.
The script imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 11025
SEED = 20261016


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else "nvidia-smi: " + proc.stderr.strip()


def synth_audio(rng, dur_sec=5.0, sr=SR, n_tones=24, noise=0.01):
    """The test suite's music-like signal (tests/conftest.py synth_audio,
    reproduced here because conftest imports JAX): tone bursts + noise."""
    n = int(dur_sec * sr)
    t = np.arange(n) / sr
    x = noise * rng.standard_normal(n)
    for _ in range(n_tones):
        f = rng.uniform(80, 4000)
        start = rng.uniform(0, max(dur_sec - 0.3, 0.05))
        length = rng.uniform(0.1, 0.8)
        seg = (t >= start) & (t < start + length)
        env = np.hanning(int(seg.sum())) if seg.sum() > 1 else 1.0
        x[seg] += rng.uniform(0.1, 0.5) * env * np.sin(
            2 * np.pi * f * t[seg] + rng.uniform(0, 2 * np.pi))
    return (x / max(1e-9, np.max(np.abs(x))) * 0.7).astype(np.float32)


def synth_track(rng, dur_sec: float, tones_per_sec: float = 8.0,
                noise: float = 0.01) -> np.ndarray:
    """synth_audio's recipe at the same tone density, touching only each
    tone's own samples (fast enough for 1,000 x 30 s)."""
    n = int(dur_sec * SR)
    x = noise * rng.standard_normal(n)
    for _ in range(int(dur_sec * tones_per_sec)):
        f = rng.uniform(80, 4000)
        i0 = int(np.ceil(rng.uniform(0, dur_sec - 0.3) * SR))
        m = min(n, i0 + int(rng.uniform(0.1, 0.8) * SR)) - i0
        tt = np.arange(i0, i0 + m) / SR
        x[i0: i0 + m] += rng.uniform(0.1, 0.5) * np.hanning(m) * np.sin(
            2 * np.pi * f * tt + rng.uniform(0, 2 * np.pi))
    return (x / max(1e-9, np.max(np.abs(x))) * 0.7).astype(np.float32)


def config2_track(i: int) -> np.ndarray:
    """Track i of the config-2 corpus: synth_track at 30 s from its own
    seed, so the corpus can be made in several processes."""
    return synth_track(np.random.default_rng((SEED + 2, i)), 30.0)


def _in_processes(fn, *args) -> list:
    """list(map(fn, *args)) in spawned processes, one a core up to 8:
    numpy's sin holds the interpreter lock at these sizes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(fn, *args, chunksize=16))


def harmonic_track(seed: int, n: int) -> np.ndarray:
    """bench.synth_batch(1, n, seed=seed)[0] bit for bit (the corpus of
    benchmarks/baseline_configs.py: harmonic note events with decaying
    envelopes), touching only each note's own samples."""
    rng = np.random.default_rng(seed)
    x = 0.002 * rng.standard_normal(n)

    def first_at(v):                      # first i with i / SR >= v
        i = min(n, max(0, int(v * SR)))
        while i > 0 and (i - 1) / SR >= v:
            i -= 1
        while i < n and i / SR < v:
            i += 1
        return i

    for _ in range(max(8, int(n / SR * 10))):
        f0 = 55 * 2 ** rng.uniform(1, 6)
        s = rng.uniform(0, n / SR - 0.1)
        L = rng.uniform(0.08, 0.5)
        i0, i1 = first_at(s), first_at(s + L)
        m = i1 - i0
        if m < 8:
            continue
        env = np.exp(-3 * np.linspace(0, 1, m))
        tt = np.arange(i0, i1) / SR
        y = np.zeros(m)
        for k in range(1, 4):
            if f0 * k < SR / 2 - 500:
                y += (0.6 ** k) * np.sin(2 * np.pi * f0 * k * tt)
        x[i0:i1] += rng.uniform(0.2, 0.6) * env * y
    return (x / max(1e-9, np.abs(x).max()) * 0.7).astype(np.float32)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (after one warm-up).
    The calls queue behind a kernel that spins for about as long as the
    host takes to issue them, so a kernel shorter than its launch is timed
    back to back, not at the host's pace."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(0.05, 1.5 * host * reps + 1e-3) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_ms(fn) -> float:
    """Device milliseconds of one fn() call, for the plain versions: loops
    of small launches paced by the host, up to seconds a call, where
    cuda_ms's two untimed calls would triple the time spent."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores; and int32 operations/s,
# derived from the Hopper white paper's 64 INT32 lanes an SM, 132 SMs at
# the 1.98 GHz boost clock (the data sheet gives no int32 rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S
          ) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for a
    function that moves nbytes (each input read once, each output written
    once) and does nops operations at ops_per_s (float32 by default)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_bound(B: int, T: int, F: int, k: int, rounds: int) -> tuple:
    """K1's bound on these inputs: m0, n_frames, both envelopes and the
    template read, kept written; per frame and bin a compare, a max and a
    decay each way, and per argmax round or kept peak a product and a max
    over the F bins (`rounds` counts both passes' rounds in this run)."""
    nbytes = 4 * (B * T * F + B + 2 * B * F + 2 * F - 1 + B * T * k)
    return bound(nbytes, 5 * B * T * F + 2 * F * rounds)


def k1f_bound(B: int, T: int, F: int, k: int, rounds: int) -> tuple:
    """K1f's bound: m0, env_in and the template read, the (pos, val) lists
    and env_out written; 3 operations per frame and bin, 2 per round and
    bin."""
    nbytes = 4 * (B * T * F + 2 * B * F + 2 * F - 1 + 2 * B * T * k)
    return bound(nbytes, 3 * B * T * F + 2 * F * rounds)


def _silence(rng, b: int, t: int, F: int, scale: float = 1.0,
             head: int = 50) -> np.ndarray:
    """Whitened frames: a sounding head, then the constant that digital
    silence becomes after the log floor (the HPF decays through the
    subnormal range after ~4,400 frames, an envelope after ~18,000)."""
    x = (rng.standard_normal((b, t, F)) * 2.0 * scale).astype(np.float32)
    x[:, head:] = np.float32(-3.75 * scale)
    return x


def _seeded_prune_case(torch, rng, dev, b: int, t: int, F: int, kind: str):
    """Wrapper-level K1/K1f inputs from a seed: m0, an envelope and the
    2F - 1 template.  Random: a third of the bins hold N(1, 2) values, the
    rest _NEG, under a U(0, 3) envelope.  Dense: every bin is a candidate
    in every frame (frame t's values (t + 1) * 8 + {0..3} exceed every
    earlier envelope, a zero envelope at t = 0), with ties in each frame.
    Silence: the candidate map and head envelope of the HPF (plain) of
    _silence frames, the first row 1e-30 quiet so its envelopes reach the
    subnormal range early."""
    from audfprint_torch import params as P
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import peaks as PK
    from audfprint_torch.ops import spectro as SP

    if kind == "silence":
        cfg = PipelineConfig()
        w = np.concatenate([_silence(rng, 1, t, F, 1e-30),
                            _silence(rng, b - 1, t, F)]) if b > 1 \
            else _silence(rng, 1, t, F)
        y = SP.hpf_plain(torch.from_numpy(w).to(dev), cfg)[0]
        nf = torch.full((b,), t, dtype=torch.int32, device=dev)
        g = torch.as_tensor(P.gaussian_template(P.F_SD, F - 1)
                            .astype(np.float32), device=dev)
        return (CP.candidate_map(y, nf),
                PK.head_envelope(y, nf, CP._bump_table(g, F)), g)
    if kind == "dense":
        m0 = (np.arange(1, t + 1, dtype=np.float32)[None, :, None] * 8.0
              + rng.integers(0, 4, (b, t, F)).astype(np.float32))
        env = np.zeros((b, F), np.float32)
    else:
        m0 = np.where(rng.random((b, t, F)) < 0.3,
                      rng.standard_normal((b, t, F)) * 2.0 + 1.0, CP._NEG)
        env = rng.uniform(0.0, 3.0, (b, F))
    g = P.gaussian_template(P.F_SD, F - 1)
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                 for a in (m0, env, g))


# wrapper-level cases beyond the main path's shapes: (name, B, T, F, k,
# kind).  F = 200 is not a multiple of 32, F = 258 not one of 4 (the
# wrapper pads it); 3000 frames put K1's lists in global memory; F = 1024
# with k = 16 is the widest a lane holds (32 bins); T = 8191 ends inside a
# ring stage, T = 5 is less than one stage; the long silences decay both
# envelopes (K1) and the carried one (K1f) into the subnormal range,
# which the reference flushes
K1_CASES = [("dense", 8, 300, 256, 5, "dense"),
            ("F=200", 16, 400, 200, 5, "random"),
            ("F=258", 16, 400, 258, 5, "random"),
            ("B=1 listen", 1, 431, 256, 5, "random"),
            ("lists in global memory", 4, 3000, 256, 5, "random"),
            ("F=1024 k=16", 4, 200, 1024, 16, "random"),
            ("F=20 k=3", 3, 64, 20, 3, "random"),
            ("long silence", 2, 6000, 256, 5, "silence")]
K1F_CASES = [("dense", 2, 1000, 256, 5, "dense"),
             ("F=200", 2, 700, 200, 5, "random"),
             ("F=258", 2, 700, 258, 5, "random"),
             ("ragged ring", 1, 8191, 256, 5, "random"),
             ("T < one stage", 3, 5, 256, 5, "random"),
             ("empty chunk", 2, 0, 256, 5, "random"),
             ("F=1024 k=16", 2, 300, 1024, 16, "random"),
             ("long silence", 1, 22000, 256, 5, "silence")]

# K2 cases, each checked with and without a carry: (name, B, T, F, kind).
# Ragged strips (F = 200, 20), a padded width (258), the widest (1024),
# no frame, one frame, fewer than one box, a row ending inside a box, a
# query, the streamed shapes, the batch, inputs that are subnormal or sit
# either side of 2^-126, and a chunk decaying through a long constant
# stretch into the subnormal range (tests/test_torch_ftz.py checks the
# launch plan of every case on the CPU)
K2_CASES = [("F=200", 2, 700, 200, "random"), ("F=258", 2, 700, 258, "random"),
            ("F=20, B*F < 32", 1, 300, 20, "random"),
            ("F=1024", 2, 600, 1024, "random"), ("T=0", 2, 0, 256, "random"),
            ("T=1", 2, 1, 256, "random"), ("T < one box", 3, 5, 256, "random"),
            ("T=8191", 2, 8191, 256, "random"),
            ("listen query", 1, 431, 256, "random"),
            ("4 shifts", 4, 8192, 256, "random"),
            ("batch", 256, 1535, 256, "random"),
            ("subnormal-heavy", 2, 700, 256, "subnormal"),
            ("decay through silence", 1, 6000, 256, "silence")]


def _k2_input(rng, b: int, t: int, F: int, kind: str) -> np.ndarray:
    """K2 input frames from a seed: N(0, 3) values; subnormal-heavy ones
    (subnormals, +-2^-126 and its neighbours, signed zeros, tiny normals);
    or a sounding head then a constant (_silence)."""
    if kind == "silence":
        return _silence(rng, b, t, F)
    x = (rng.standard_normal((b, t, F)) * 3.0).astype(np.float32)
    if kind == "subnormal":
        tiny = np.float32(2.0 ** -126)
        edge = np.float32([tiny, -tiny, np.nextafter(tiny, np.float32(0)),
                           np.nextafter(tiny, np.float32(1)), 1e-39, -1e-39,
                           1e-45, 0.0, -0.0, 3e-38])
        x = np.where(rng.random(x.shape) < 0.7, rng.choice(edge, x.shape),
                     x * np.float32(1e-37)).astype(np.float32)
    return x


# K3 cases: (name, B, T, K, PipelineConfig fields, kind).  The fanouts of
# the presets and -F, the 512-bin configuration (K = 8, f1 > 255 masked),
# T = 0, 1, mindt, targetdt and longer than a 2047-frame bucket, inputs
# with no valid slot, slots dense within targetdf (the fanout fills at
# d = mindt), partners at |df| = targetdf - 1 and targetdf (strict), valid
# peaks only in the last frames (the walk meets t + d >= T), a listen
# query, mindt 0 and -2 (a negative dt reads where JAX's dynamic_slice
# lands, landmarks.slice_start).  Then the edges of K3's tile of K3_TILE
# frames: slots 3 % valid (the regime of real peak slots), T at the tile
# less one, equal and plus one (partners across the tile's edge), a tile
# whose halo of targetdt frames runs past T, partners only at d =
# targetdt - 1 (the halo's far end, from a tile's last frame too), mindt
# -2 past a tile and its halo (the d < 0 steps read frame t + targetdt,
# the halo's last), and d < -T (mindt -2 at T = 1, where every step reads
# the padding; mindt -70 at T = 10, where the steps read frames of the
# row).  tests/test_torch_pairing.py holds each against JAX on the CPU;
# the card holds K3 against its plain version on each.
K3_TILE = 128                      # csrc/pair.cu kTileFrames
PAIR_CASES = [("default", 2, 64, 5, {}, "random"),
              ("fanout 0", 2, 64, 5, {"maxpairsperpeak": 0}, "random"),
              ("fanout 1", 2, 64, 5, {"maxpairsperpeak": 1}, "random"),
              ("fanout 2", 2, 64, 5, {"maxpairsperpeak": 2}, "random"),
              ("fanout 6", 2, 64, 5, {"maxpairsperpeak": 6}, "random"),
              ("512 bins, K=8", 2, 80, 8,
               {"n_fft": 1024, "n_hop": 512, "maxpksperframe": 8}, "random"),
              ("T=0", 2, 0, 5, {}, "random"),
              ("T=1", 2, 1, 5, {}, "random"),
              ("T=mindt", 2, 2, 5, {}, "random"),
              ("T=targetdt", 2, 63, 5, {}, "random"),
              ("T=2100", 1, 2100, 5, {}, "random"),
              ("listen query", 1, 431, 5, {}, "random"),
              ("all invalid", 2, 64, 5, {}, "invalid"),
              ("dense within targetdf", 2, 64, 5, {}, "dense"),
              ("|df| = targetdf - 1 and targetdf", 2, 40, 5, {}, "edge_df"),
              ("partners in the last frames", 2, 40, 5, {}, "tail"),
              ("mindt=0", 2, 64, 5, {"mindt": 0}, "random"),
              ("mindt=-2", 2, 64, 5, {"mindt": -2}, "random"),
              ("sparse", 2, 600, 5, {}, "sparse"),
              ("T=tile-1", 1, K3_TILE - 1, 5, {}, "random"),
              ("T=tile", 2, K3_TILE, 5, {}, "random"),
              ("T=tile+1", 2, K3_TILE + 1, 5, {}, "random"),
              ("halo past T", 2, K3_TILE + 40, 5, {}, "random"),
              ("partners at d = targetdt - 1", 2, 400, 5, {}, "far"),
              ("mindt=-2, T=tile+80", 2, K3_TILE + 80, 5, {"mindt": -2},
               "random"),
              ("mindt=-2, T=1", 2, 1, 5, {"mindt": -2}, "random"),
              ("mindt=-70, T=10", 2, 10, 5, {"mindt": -70}, "random")]


def pair_input(rng, b: int, t: int, k: int, n_bins: int, kind: str,
               targetdf: int = 31):
    """K3 input slots from a seed: (bins (b, t, k) int32 ascending per
    frame, valid (b, t, k) bool).  Random: bins uniform over n_bins, 60 %
    valid.  Sparse: the same bins, 3 % valid.  Invalid: no valid slot.
    Dense: every slot valid, bins within 10 of 100.  Edge_df: every frame
    [f - targetdf, f - targetdf + 1, f, f + targetdf - 1, f + targetdf] at
    f = 100, 70 % valid.  Tail: valid (80 %) only in the last 12 frames.
    Far: bins within 10 of 100, valid only in frames 7 + 62 i, so every
    partner lies at d = 62, the default targetdt - 1, and anchors fall on
    the last frame of a tile of 8 frames (t = 7) and of 128 (t = 255)."""
    bins = np.sort(rng.integers(0, n_bins, (b, t, k)), axis=-1)
    valid = rng.random((b, t, k)) < 0.6
    if kind == "sparse":
        valid = rng.random((b, t, k)) < 0.03
    elif kind == "invalid":
        valid[:] = False
    elif kind == "dense":
        bins = 100 + np.sort(rng.integers(0, 10, (b, t, k)), axis=-1)
        valid[:] = True
    elif kind == "edge_df":
        bins = np.broadcast_to(100 + np.array(
            [-targetdf, 1 - targetdf, 0, targetdf - 1, targetdf]), (b, t, k))
        valid = rng.random((b, t, k)) < 0.7
    elif kind == "far":
        bins = 100 + np.sort(rng.integers(0, 10, (b, t, k)), axis=-1)
        valid = np.broadcast_to((np.arange(t) % 62 == 7)[None, :, None],
                                (b, t, k)).copy()
    elif kind == "tail":
        valid = (rng.random((b, t, k)) < 0.8) \
            & (np.arange(t) >= t - 12)[None, :, None]
    return bins.astype(np.int32), valid


def _same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def check_k2_cases(torch, dev, rng) -> None:
    """K2 against its plain version, bit for bit (y and the carry out), on
    K2_CASES with and without a carry, and chunks of 1001, 777 and 2414
    frames against one pass at F = 256 and 258."""
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_torch.ops import spectro as SP

    cfg = PipelineConfig()
    for name, b, t, F, kind in K2_CASES:
        x = torch.from_numpy(_k2_input(rng, b, t, F, kind)).to(dev)
        for carry in (None, tuple(torch.from_numpy(
                (rng.standard_normal((b, F)) * 3.0).astype(np.float32)).to(dev)
                for _ in range(2))):
            got = SP.hpf(x, cfg, carry)
            want = SP.hpf_plain(x, cfg, carry)
            torch.cuda.synchronize()
            require(_same_bits(torch, got[0], want[0])
                    and all(_same_bits(torch, u, v)
                            for u, v in zip(got[1], want[1])),
                    f"K2 differs from its plain version, case {name}, "
                    f"carry {carry is not None}")
        print(f"K2 hpf_scan case {name} ({b},{t},{F}): bit-exact vs plain "
              f"with and without a carry")
    for F in (256, 258):
        x = torch.from_numpy(_k2_input(rng, 2, 4192, F, "random")).to(dev)
        c0 = tuple(torch.rand((2, F), device=dev) for _ in range(2))
        whole, c_all = SP.hpf(x, cfg, c0)
        parts, carry = [], c0
        for a, e in ((0, 1001), (1001, 1778), (1778, 4192)):
            y, carry = SP.hpf(x[:, a:e].contiguous(), cfg, carry)
            parts.append(y)
        require(_same_bits(torch, torch.cat(parts, 1), whole)
                and all(_same_bits(torch, u, v) for u, v in zip(carry, c_all)),
                f"K2 over chunks of 1001, 777 and 2414 frames differs from "
                f"one pass at F = {F}")
        print(f"K2 (2,4192,{F}) in chunks of 1001, 777 and 2414 frames "
              "equals one pass bit for bit")


def check_k1_cases(torch, dev, rng, a_dec: float) -> None:
    """K1 against its plain version, bit for bit, on K1_CASES."""
    from audfprint_torch.ops import cuda_peaks as CP

    for name, b, t, F, k, kind in K1_CASES:
        m0, env, g = _seeded_prune_case(torch, rng, dev, b, t, F, kind)
        nf_np = rng.integers(0, t + 1, b).astype(np.int32)
        nf_np[:3] = [t, 0, 1][:b]
        if kind == "silence":
            nf_np[:] = t
        nf = torch.from_numpy(nf_np).to(dev)
        env_b = torch.from_numpy(
            rng.uniform(0.0, 3.0, (b, F)).astype(np.float32)).to(dev)
        if kind == "dense":
            env_b.zero_()
        elif kind == "silence":            # the tail frame's spread: zero
            env_b = env * 0.0
        kept = CP.prune_fwd_bwd(m0, nf, env, env_b, g, a_dec, k)
        plain = CP.prune_fwd_bwd_plain(m0, nf, env, env_b, g, a_dec, k)
        torch.cuda.synchronize()
        ndiff = int((kept != plain).sum().item())
        require(ndiff == 0, f"K1 differs from its plain version, case "
                            f"{name}: {ndiff} entries")
        print(f"K1 prune_fwd_bwd case {name} ({b},{t},{F}, k={k}): bit-exact "
              f"vs plain ({int((kept >= 0).sum())} kept)")


def check_k1f_cases(torch, dev, rng, a_dec: float) -> None:
    """K1f against its plain version, bit for bit, on K1F_CASES, and three
    carried chunks of uneven lengths against one pass at F = 256 and 258."""
    from audfprint_torch.ops import cuda_peaks as CP

    for name, b, t, F, k, kind in K1F_CASES:
        m0, env, g = _seeded_prune_case(torch, rng, dev, b, t, F, kind)
        got = CP.prune_fwd_carry(m0, env, g, a_dec, k)
        want = CP.prune_fwd_carry_plain(m0, env, g, a_dec, k)
        torch.cuda.synchronize()
        require(all(torch.equal(u, v) for u, v in zip(got, want)),
                f"K1f differs from its plain version, case {name}")
        print(f"K1f prune_fwd_carry case {name} ({b},{t},{F}, k={k}): "
              f"bit-exact vs plain ({int((got[0] >= 0).sum())} peaks)")
    for F in (256, 258):
        m0, env, g = _seeded_prune_case(torch, rng, dev, 2, 4192, F,
                                        "random")
        whole = CP.prune_fwd_carry(m0, env, g, a_dec, 5)
        lp, lv = [], []
        for c0, c1 in ((0, 1001), (1001, 1778), (1778, 4192)):
            p_, v_, env = CP.prune_fwd_carry(m0[:, c0:c1], env, g, a_dec, 5)
            lp.append(p_)
            lv.append(v_)
        require(torch.equal(torch.cat(lp, 1), whole[0])
                and torch.equal(torch.cat(lv, 1), whole[1])
                and torch.equal(env, whole[2]),
                f"K1f over chunks of 1001, 777 and 2414 frames differs from "
                f"one pass at F = {F}")
        print(f"K1f (2,4192,{F}) in chunks of 1001, 777 and 2414 frames "
              "equals one pass bit for bit")


def phase_kernels(torch, rec: dict) -> None:
    from audfprint_torch import params as P
    from audfprint_torch.oracle import analyze as oa
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import spectro as SP

    cfg = PipelineConfig()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    B, T, F = 256, 1535, cfg.n_bins

    # ---- K2 ----
    x = torch.from_numpy(
        rng.standard_normal((B, T, F)).astype(np.float32)).to(dev)
    y = SP.hpf(x, cfg)[0]
    yp = SP.hpf_plain(x, cfg)[0]
    torch.cuda.synchronize()
    err = (y - yp).abs().max().item()
    require(torch.equal(y, yp), f"K2 differs from its plain version ({err})")
    check_k2_cases(torch, dev, rng)
    rec["hpf_scan"] = dict(max_abs_err=err, library_ms=None,
                           **k2_timings(torch, dev, rng))

    # ---- K1 ----
    worst = 0
    k1_ms = k1_plain = None
    # the last case: 512 bins and 8 peaks per frame (n_fft 1024, -P 8)
    wide = PipelineConfig(n_fft=1024, n_hop=512, maxpksperframe=8)
    cases = [(256, 1535, False, cfg), (64, 400, True, cfg),
             (7, 97, True, cfg), (9, 80, True, wide)]
    for case, (b, t, quant, ccfg) in enumerate(cases):
        Fc = ccfg.n_bins
        w = rng.standard_normal((b, t, Fc)).astype(np.float32) * 2.0
        for r in range(b):                 # a few sustained tonal ridges
            for _ in range(6):
                f0 = rng.integers(5, Fc - 5)
                t0, t1 = sorted(rng.integers(0, t, 2).tolist())
                w[r, t0:t1 + 1, f0] += 3.0
        if quant:                          # plateaus, ties, repeats
            w = np.round(w).astype(np.float32)
        nf_np = rng.integers(0, t + 1, b).astype(np.int32)
        nf_np[:3] = [t, 0, 1]
        white = torch.from_numpy(w).to(dev)
        nf = torch.from_numpy(nf_np).to(dev)
        yy, m0, e0f, e0b, gvec = CP.prune_inputs(white, nf, ccfg)
        kept = CP.prune_fwd_bwd(m0, nf, e0f, e0b, gvec, ccfg.a_dec,
                                ccfg.maxpksperframe)
        plain = CP.prune_fwd_bwd_plain(m0, nf, e0f, e0b, gvec, ccfg.a_dec,
                                       ccfg.maxpksperframe)
        torch.cuda.synchronize()
        ndiff = int((kept != plain).sum().item())
        worst = max(worst, int((kept - plain).abs().max().item()))
        require(ndiff == 0, f"K1 differs from its plain version in case "
                            f"{case}: {ndiff} entries")
        # a few rows against the numpy oracle's own prune
        bins, valid = CP.find_peaks_slots_fused(white, nf, ccfg)
        bins, valid = bins.cpu().numpy(), valid.cpu().numpy()
        ynp = yy.cpu().numpy()
        params = P.AnalyzerParams(n_fft=ccfg.n_fft, n_hop=ccfg.n_hop,
                                  maxpksperframe=ccfg.maxpksperframe)
        for r in (0, 3, b - 1):
            n = int(nf_np[r])
            want = oa.find_peaks_mask(ynp[r, :n], params)
            got = np.zeros_like(want)
            tt, kk = np.nonzero(valid[r, :n])
            got[tt, bins[r, :n][tt, kk]] = True
            require(np.array_equal(got, want),
                    f"K1 path differs from the oracle, case {case} row {r}")
        print(f"K1 prune_fwd_bwd case {case} ({b},{t},{Fc}, "
              f"k={ccfg.maxpksperframe}, "
              f"{'tie-heavy' if quant else 'random'}): bit-exact vs plain "
              f"({int((kept >= 0).sum())} kept), oracle rows agree")
        if case == 0:
            k1_ms = cuda_ms(lambda: CP.prune_fwd_bwd(
                m0, nf, e0f, e0b, gvec, cfg.a_dec, cfg.maxpksperframe), 5)
            k1_plain = plain_ms(lambda: CP.prune_fwd_bwd_plain(
                m0, nf, e0f, e0b, gvec, cfg.a_dec, cfg.maxpksperframe))
            k1_stats = k1_rounds(torch, m0, e0f, gvec, kept, cfg)
            k1_b = k1_bound(b, t, Fc, ccfg.maxpksperframe, k1_stats[0])
            print(f"K1 prune_fwd_bwd (256,1535,256): kernel {k1_ms:.3f} ms, "
                  f"plain {k1_plain:.1f} ms, bound {k1_b[0]:.4f} ms "
                  f"({k1_b[1]}); {k1_stats[1]:.3f} argmax rounds and "
                  f"{k1_stats[2]:.2f} locmax bins per frame")
    check_k1_cases(torch, dev, rng, cfg.a_dec)
    rec["prune_fwd_bwd"] = dict(max_abs_err=float(worst), ms=k1_ms,
                                plain_ms=k1_plain, bound_ms=k1_b[0],
                                bound_by=k1_b[1], library_ms=None,
                                rounds_per_frame=k1_stats[1])


def k3_work(torch, bins, valid, cfg) -> tuple:
    """(partner slots examined, partners appended, list entries examined)
    on these inputs (mindt >= 0).  Slots examined: by PR 8's walk over
    every partner slot, per valid anchor the slots up to its fanout-th
    qualifying partner, or every slot of its frames t + d < T when it has
    fewer.  List entries examined: by K3's walk over the tile's list of
    valid peaks, the valid ones among those slots.  Counted with tensor
    code over chunks of frames."""
    B, T, K = bins.shape
    fan = cfg.maxpairsperpeak
    dev = bins.device
    d = torch.arange(cfg.mindt, cfg.targetdt, device=dev)
    nd = d.numel()
    bp = torch.cat([bins, bins.new_zeros((B, cfg.targetdt, K))], 1)
    vp = torch.cat([valid, valid.new_zeros((B, cfg.targetdt, K))], 1)
    examined = appended = entries = 0
    step = max(1, (1 << 26) // max(1, B * K * nd * K))
    for t0 in range(0, T, step):
        t = torch.arange(t0, min(T, t0 + step), device=dev)
        n = t.numel()
        fr = t[:, None] + d[None, :]                          # (n, nd)
        vpart = vp[:, fr].reshape(B, n, 1, nd * K)
        ok = (valid[:, t0:t0 + n, :, None] & vpart
              & ((bp[:, fr].reshape(B, n, 1, nd * K)
                  - bins[:, t0:t0 + n, :, None]).abs() < cfg.targetdf))
        c = ok.cumsum(-1, dtype=torch.int32)                  # (B, n, K, nd K)
        n_in = ((T - t - cfg.mindt).clamp(0, nd) * K)[None, :, None]
        seen = torch.where(c[..., -1] >= fan,
                           (c >= fan).to(torch.int32).argmax(-1) + 1, n_in)
        vc = vpart.expand_as(ok).cumsum(-1, dtype=torch.int32)
        listed = torch.where(seen > 0, vc.gather(
            -1, (seen - 1).clamp(min=0)[..., None])[..., 0], 0)
        v = valid[:, t0:t0 + n]
        examined += int(seen[v].sum().item())
        appended += int(c[..., -1].clamp(max=fan)[v].sum().item())
        entries += int(listed[v].sum().item())
    return examined, appended, entries


def k3_bound(torch, bins, valid, cfg) -> tuple:
    """K3's bound on these inputs: bins (int32) and valid read, hashes
    (int32) and lvalid written, each once; 4 int32 operations a partner
    slot examined (difference, absolute value, compare, valid) and 4 a
    partner appended (the pack).  Returns (bound_ms, bound_by, partner
    slots examined per valid anchor by PR 8's walk, list entries examined
    per valid anchor by K3's)."""
    n = bins.numel()
    fan = cfg.maxpairsperpeak
    examined, appended, entries = k3_work(torch, bins, valid, cfg)
    bms, bby = bound(4 * n + n + 4 * n * fan + n * fan,
                     4 * examined + 4 * appended, INT32_OPS_PER_S)
    anchors = max(1, int(valid.sum().item()))
    return bms, bby, examined / anchors, entries / anchors


@contextlib.contextmanager
def plain_pairing():
    """Within the block, landmarks.slots_to_hashes is its plain version:
    a caller such as streaming.pair_kept_slots pairs without K3."""
    from audfprint_torch.ops import landmarks as L

    k3 = L.slots_to_hashes
    L.slots_to_hashes = L.slots_to_hashes_plain
    try:
        yield
    finally:
        L.slots_to_hashes = k3


def _k3_equal(torch, bins, valid, cfg):
    """K3 and its plain version on the same slots: (equal in dtype and
    value on times, hashes and lvalid, max |hash difference|, K3's
    output)."""
    from audfprint_torch.ops import landmarks as L

    got = L.slots_to_hashes(bins, valid, cfg)
    want = L.slots_to_hashes_plain(bins, valid, cfg)
    torch.cuda.synchronize()
    same = all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))
    err = float((got[1] - want[1]).abs().max().item()) \
        if got[1].numel() else 0.0
    return same, err, got


def stream_slots(rng, t: int, k: int, n_bins: int = 256):
    """Streamed-route pairing inputs from a seed, as models/streaming.py
    builds them: slots (1, t, k) int16, kept peak bin + 1 in ascending
    order and 0 for an empty slot (0..k peaks a frame), and anchors (1, A)
    int64, the flat t * k + slot index of every kept peak."""
    n = rng.integers(0, k + 1, t)
    keys = (np.sort(rng.integers(0, n_bins - k + 1, (t, k)), axis=1)
            + np.arange(k))                          # ascending, distinct
    slots = np.where(np.arange(k) < n[:, None], keys + 1,
                     0).astype(np.int16)[None]
    anchors = np.flatnonzero(slots[0].reshape(-1) > 0)[None]
    return slots, anchors


def phase_pair(torch, rec: dict, dev) -> None:
    """K3 (pair_scan) against its plain version, bit for bit on times,
    hashes and lvalid: PAIR_CASES, the config-2 batch shape (256 x 1535
    x 5) with random sorted slots, and a streamed 2 h file's shape through
    streaming.pair_kept_slots; K3 timed at the batch, a listen query and
    the streamed shape beside its bound."""
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_torch.ops import landmarks as L
    from audfprint_torch.ops import streaming as ST

    rng = np.random.default_rng(SEED + 8)
    for name, b, t, k, fields, kind in PAIR_CASES:
        ccfg = PipelineConfig(**fields)
        bins, valid = (torch.from_numpy(a).to(dev) for a in pair_input(
            rng, b, t, k, ccfg.n_bins, kind, ccfg.targetdf))
        same, _err, got = _k3_equal(torch, bins, valid, ccfg)
        require(same, f"K3 differs from its plain version, case {name}")
        print(f"K3 pair_scan case {name} ({b},{t},{k}), fanout "
              f"{ccfg.maxpairsperpeak}: bit-exact vs plain "
              f"({int(got[2].sum())} landmarks)")

    cfg = PipelineConfig()
    slots, anchors = stream_slots(rng, 310078, cfg.maxpksperframe)
    s_dev, a_dev = (torch.from_numpy(a).to(dev) for a in (slots, anchors))
    got = ST.pair_kept_slots(s_dev, a_dev, cfg)
    with plain_pairing():
        want = ST.pair_kept_slots(s_dev, a_dev, cfg)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "pair_kept_slots through K3 differs "
                                    "from the plain pairing at 1 x 310078")
    print(f"K3 through pair_kept_slots (1,310078,5) int16 slots, "
          f"{anchors.shape[1]} anchors: equal to the plain pairing "
          f"({int((got >> 20).sum())} landmarks)")

    out, worst = {}, 0.0
    for key, b, t in (("", 256, 1535), ("listen_", 1, 431),
                      ("stream_", 1, 310078)):
        if key == "stream_":
            bins = torch.clamp(s_dev.to(torch.int32) - 1, min=0)
            valid = s_dev > 0
        else:
            bins, valid = (torch.from_numpy(a).to(dev) for a in pair_input(
                rng, b, t, cfg.maxpksperframe, cfg.n_bins, "random"))
            same, err, _got = _k3_equal(torch, bins, valid, cfg)
            worst = max(worst, err)
            require(same, f"K3 differs from its plain version at ({b},{t},5)")
        ms = cuda_ms(lambda: L.slots_to_hashes(bins, valid, cfg), 20)
        plain = plain_ms(lambda: L.slots_to_hashes_plain(bins, valid, cfg))
        bms, bby, per, listed = k3_bound(torch, bins, valid, cfg)
        out.update({f"{key}ms": ms, f"{key}plain_ms": plain,
                    f"{key}bound_ms": bms, f"{key}bound_by": bby,
                    f"{key}examined_per_anchor": per,
                    f"{key}entries_per_anchor": listed})
        print(f"K3 pair_scan ({b},{t},5): kernel {ms:.4f} ms, plain "
              f"{plain:.1f} ms, bound {bms:.5f} ms ({bby}); per valid "
              f"anchor {listed:.2f} list entries examined (PR 8's walk: "
              f"{per:.2f} partner slots)")
    rec["pair_scan"] = dict(max_abs_err=worst, library_ms=None, **out)


def pair_on_real(torch, rec: dict, audio: np.ndarray, lens: np.ndarray
                 ) -> None:
    """K3 against its plain version, bit for bit, and timed, on the peak
    slots of a (256 x 30 s) batch of phase 6's corpus."""
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import landmarks as L
    from audfprint_torch.ops import pipeline as pipe
    from audfprint_torch.ops import spectro as SP

    cfg = PipelineConfig()
    ln = torch.as_tensor(lens, device="cuda")
    nf = pipe.frame_count_device(ln, cfg)
    white = SP.whitened_logmag(torch.as_tensor(audio, device="cuda"), nf, cfg)
    bins, valid = CP.find_peaks_slots_fused(white, nf, cfg)
    same, err, got = _k3_equal(torch, bins, valid, cfg)
    require(same, "K3 differs from its plain version on config 2's peaks")
    ms = cuda_ms(lambda: L.slots_to_hashes(bins, valid, cfg), 20)
    bms, _bby, per, listed = k3_bound(torch, bins, valid, cfg)
    share = float(valid.float().mean().item())
    print(f"K3 pair_scan on config 2's peak slots {tuple(bins.shape)}: "
          f"bit-exact vs plain ({int(got[2].sum())} landmarks); kernel "
          f"{ms:.4f} ms, bound {bms:.5f} ms; {share:.3f} of the slots valid, "
          f"per valid anchor {listed:.2f} list entries examined (PR 8's "
          f"walk: {per:.2f} partner slots)")
    rec["pair_scan"].update(real_shape=list(bins.shape), real_ms=ms,
                            real_bound_ms=bms, real_valid_share=share,
                            real_examined_per_anchor=per,
                            real_entries_per_anchor=listed)
    rec["pair_scan"]["max_abs_err"] = max(rec["pair_scan"]["max_abs_err"],
                                          err)


# K4 (seg_scan) against its plain version: every case runs each op in
# each direction (SCAN_OPS), at the tile ops/scan.plan gives it and at
# each of K4's tiles forced (SCAN_TILES is csrc/scan.cu kTileSmall,
# kTileMedium, kTileLarge).  Shapes: empty either way, one element, a
# row one less than the small and the large tile, equal to it and one
# more, odd widths whose rows start
# at alternating 16-byte alignment, and the main paths' widths: a
# one-device query's vote row (1 x 512 x 100 hits), a 4-shard mesh
# query's exchanged row (4 x 512 x 100), 64 queries of 800 hashes at
# depth 100 (one device's fused batch at its sub-batch size), the hist
# core's (1,441, 25,600) rows, and a (256 x 1535 x 5 x 3)-slot chunk's
# hashes as the device store's 1-D run starts; then rows deep enough
# that a look-back crosses many windows: 300 rows of 4,097 (the plan's
# large tile, 2 tiles a row, odd width) and 1-D rows of 10,001 large
# tiles (40,001 small ones when forced).  Values: uniform over +-2^62
# (the add wraps), the int64 extremes, negatives, runs of one value, and
# the vote's run-start indices, with runs that cross tile borders.
# tests/test_torch_scan.py holds each (cut to CPU size) against JAX.
SCAN_TILES = (1024, 2048, 4096)
SCAN_TILE = SCAN_TILES[-1]
SCAN_OPS = [("max", False), ("max", True), ("min", False), ("min", True),
            ("add", False), ("add", True)]
SCAN_CASES = [("(0, 7)", (0, 7), "random"),
              ("(3, 0)", (3, 0), "random"),
              ("(1, 1)", (1, 1), "extremes"),
              ("(1, tile-1)", (1, SCAN_TILE - 1), "random"),
              ("(1, tile)", (1, SCAN_TILE), "extremes"),
              ("(1, tile+1)", (1, SCAN_TILE + 1), "negatives"),
              ("(5, 3 tiles+17) extremes", (5, 3 * SCAN_TILE + 17),
               "extremes"),
              ("(7, 2 tiles+5) runs", (7, 2 * SCAN_TILE + 5), "runs"),
              ("(3, 9 tiles+1) run starts", (3, 9 * SCAN_TILE + 1),
               "run starts"),
              ("(1, 204800) run starts", (1, 204800), "run starts"),
              ("(1, 204800) random", (1, 204800), "random"),
              ("(64, 51200) run starts", (64, 51200), "run starts"),
              ("(64, 51200) negatives", (64, 51200), "negatives"),
              ("(1441, 25600) runs", (1441, 25600), "runs"),
              ("1-D 5894400 run starts", (5894400,), "run starts"),
              ("1-D 5894400 extremes", (5894400,), "extremes"),
              ("(1, small-1)", (1, SCAN_TILES[0] - 1), "random"),
              ("(1, small)", (1, SCAN_TILES[0]), "extremes"),
              ("(1, small+1)", (1, SCAN_TILES[0] + 1), "negatives"),
              ("(1, 51200) run starts", (1, 51200), "run starts"),
              ("(300, tile+1) random", (300, SCAN_TILE + 1), "random"),
              ("1-D 10000 tiles+1 run starts", (10000 * SCAN_TILE + 1,),
               "run starts"),
              ("1-D 10000 tiles+1 random", (10000 * SCAN_TILE + 1,),
               "random")]


def scan_input(rng, shape: tuple, kind: str) -> np.ndarray:
    """A K4 input of `shape` (int64) from a seed.  Random: uniform over
    [-2^62, 2^62).  Extremes: INT64_MIN, INT64_MIN + 1, -1, 0, 1,
    INT64_MAX - 1 and INT64_MAX.  Negatives: uniform over [-10^6, 0).
    Runs: one value of +-2^40 a run, run lengths uniform over [1, 3
    tiles).  Run starts: the vote's where(first, iota, 0) on runs of
    lengths uniform over [1, 2 tiles)."""
    lim = np.iinfo(np.int64)
    if kind == "random":
        return rng.integers(-2**62, 2**62, shape, dtype=np.int64)
    if kind == "extremes":
        pool = np.array([lim.min, lim.min + 1, -1, 0, 1, lim.max - 1,
                         lim.max], np.int64)
        return pool[rng.integers(0, len(pool), shape)]
    if kind == "negatives":
        return rng.integers(-10**6, 0, shape, dtype=np.int64)
    H = shape[-1] if shape else 1
    rows = int(np.prod(shape[:-1], dtype=np.int64))
    longest = 3 * SCAN_TILE if kind == "runs" else 2 * SCAN_TILE
    starts = np.cumsum(rng.integers(1, longest,
                                    2 * (rows * H // longest) + 2))
    first = np.zeros(rows * H, bool)
    first[starts[starts < rows * H]] = True
    first = first.reshape(rows, H)
    first[:, 0] = True
    if kind == "runs":
        vals = rng.integers(-2**40, 2**40, rows * H, dtype=np.int64)
        ids = np.cumsum(first.reshape(-1)) - 1
        return vals[ids].reshape(shape)
    iota = np.broadcast_to(np.arange(H, dtype=np.int64), (rows, H))
    return np.where(first, iota, 0).reshape(shape)


def scan_bound(n: int) -> tuple:
    """K4's bound on n elements: x read once and y written once (int64),
    and one 64-bit op (two int32 operations) an element."""
    return bound(16 * n, 2 * n, INT32_OPS_PER_S)


def phase_scan(torch, rec: dict, dev) -> None:
    """K4 (seg_scan) against its plain version, bit for bit, on every
    SCAN_CASES case in each op and direction, at the planned tile and at
    each tile forced; inside a captured CUDA graph replayed 100 times
    (scan_graph_replays) and on two streams at once (scan_two_streams);
    then timed at the main paths' shapes, each op and direction, beside
    torch's own call for the same function (cummax, cummin with flips,
    cumsum), the plain version (forward max) and the byte bound."""
    from audfprint_torch.ops import scan as SC

    require(tuple(SC.TILES) == SCAN_TILES,
            f"ops/scan.TILES {SC.TILES} is not SCAN_TILES {SCAN_TILES}")
    rng = np.random.default_rng(SEED + 14)
    n, err = 0, 0.0
    for name, shape, kind in SCAN_CASES:
        x = torch.from_numpy(scan_input(rng, shape, kind)).to(dev)
        for op, rev in SCAN_OPS:
            want = SC.seg_scan_plain(x, op, rev)
            for tile in (None,) + SCAN_TILES:
                got = SC.seg_scan(x, op, rev, tile=tile)
                torch.cuda.synchronize()
                require(got.dtype == want.dtype and torch.equal(got, want),
                        f"K4 differs from its plain version: {name} {kind}, "
                        f"{op} {'reverse' if rev else 'forward'}, tile "
                        f"{tile or 'planned'}")
                if got.numel():
                    err = max(err, float((got - want).abs().max().item()))
                n += 1
        del x
    print(f"K4 seg_scan: bit-exact vs plain on {len(SCAN_CASES)} SCAN_CASES "
          f"x {len(SCAN_OPS)} ops and directions x the planned tile and "
          f"each of {SCAN_TILES} ({n} comparisons)")
    scan_graph_replays(torch, SC, rng, dev)
    scan_two_streams(torch, SC, rng, dev)

    def library(x, op, rev):
        """torch's one call for the function (flips outside the time
        would hide their cost, so a reverse scan flips inside)."""
        xs = x.flip(-1) if rev else x
        if op == "max":
            return torch.cummax(xs, dim=-1)
        if op == "min":
            return torch.cummin(xs, dim=-1)
        return torch.cumsum(xs, dim=-1)

    smi = nvidia_smi_line()
    out: dict = {"by_op_ms": {}}
    for key, shape in SCAN_TIMED:
        x = torch.from_numpy(scan_input(rng, shape, "run starts")).to(dev)
        H = shape[-1]
        tile = SC.plan(x.numel() // H, H)
        ms = cuda_ms(lambda: SC.seg_scan(x, "max"), 50)
        lib = cuda_ms(lambda: library(x, "max", False), 20)
        plain = plain_ms(lambda: SC.seg_scan_plain(x, "max"))
        bms, bby = scan_bound(x.numel())
        out.update({f"{key}ms": ms, f"{key}library_ms": lib,
                    f"{key}plain_ms": plain, f"{key}bound_ms": bms,
                    f"{key}bound_by": bby, f"{key}shape": list(shape),
                    f"{key}tile": tile})
        print(f"K4 seg_scan [{smi}] forward max {shape}, tile {tile}: kernel "
              f"{ms:.4f} ms, torch.cummax {lib:.4f} ms, plain {plain:.4f} ms,"
              f" bound {bms:.5f} ms ({bby})")
        by_op = {}
        for op, rev in SCAN_OPS:
            name = f"{op} {'reverse' if rev else 'forward'}"
            by_op[name] = [cuda_ms(lambda: SC.seg_scan(x, op, rev), 50),
                           cuda_ms(lambda: library(x, op, rev), 20)]
        out["by_op_ms"][str(tuple(shape))] = by_op
        print(f"K4 seg_scan [{smi}] {shape} by op, [kernel, torch] ms: "
              + json.dumps({k: [round(v, 4) for v in p]
                            for k, p in by_op.items()}))
        del x
    rec["seg_scan"] = dict(max_abs_err=err, **out)


# K4's timed shapes (key prefix in the kernels line, shape): the
# one-device query's vote row, the 4-shard mesh row (the unprefixed
# keys), 64 queries at their sub-batch size, the hist core's rows and a
# chunk's 1-D run starts
SCAN_TIMED = (("one_query_", (1, 51200)), ("", (1, 204800)),
              ("query_", (64, 51200)), ("hist_", (1441, 25600)),
              ("store_", (5894400,)))


def scan_graph_replays(torch, SC, rng, dev, replays: int = 100) -> None:
    """K4 captured in one torch.cuda.CUDAGraph at the main shapes (each at
    its planned tile, all of them rows of several tiles), replayed
    `replays` times with the inputs changed before each replay (three
    inputs in turn, uniform over +-2^62): every replay must equal the
    plain version bit for bit.  A replay that found the previous one's
    tile counter would scan nothing, and one that found its statuses
    would fold the previous input's prefixes, so this holds the memset
    node that zeroes them."""
    calls = (((1, 51200), "add", False), ((1, 204800), "max", True),
             ((64, 51200), "min", False), ((5894400,), "add", True))
    pools = [[torch.from_numpy(scan_input(rng, shape, "random")).to(dev)
              for _ in range(3)] for shape, _op, _rev in calls]
    wants = [[SC.seg_scan_plain(x, op, rev) for x in pool]
             for pool, (_s, op, rev) in zip(pools, calls)]
    xs = [pool[0].clone() for pool in pools]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x, (_s, op, rev) in zip(xs, calls):
            SC.seg_scan(x, op, rev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = [SC.seg_scan(x, op, rev) for x, (_s, op, rev) in zip(xs, calls)]
    for r in range(replays):
        for x, pool in zip(xs, pools):
            x.copy_(pool[r % 3])
        graph.replay()
        torch.cuda.synchronize()
        for i, (y, (shape, op, rev)) in enumerate(zip(ys, calls)):
            require(torch.equal(y, wants[i][r % 3]),
                    f"K4 replay {r} of a captured graph differs from its "
                    f"plain version: {shape} {op} "
                    f"{'reverse' if rev else 'forward'}")
    del graph
    print(f"K4 seg_scan: {replays} replays of a captured graph of "
          f"{len(calls)} calls ({', '.join(str(c[0]) for c in calls)}), "
          f"inputs changed before each: bit-exact vs plain")


def scan_two_streams(torch, SC, rng, dev, rounds: int = 8) -> None:
    """K4 on two streams at once over distinct inputs (two 1-D chunks at
    the large tile, the mesh row at the medium one and the one-query row
    at the small one, each op and direction in turn), so that the calls'
    blocks share the card and each spins on its own workspace; every
    result must equal the plain version bit for bit."""
    shapes = ((5894400,), (1, 204800), (5894400,), (1, 51200))
    xs = [torch.from_numpy(scan_input(rng, s, "random")).to(dev)
          for s in shapes]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for r in range(rounds):
        op, rev = SCAN_OPS[r % len(SCAN_OPS)]
        for i, x in enumerate(xs):
            with torch.cuda.stream(streams[i % 2]):
                got.append((i, op, rev, SC.seg_scan(x, op, rev)))
    torch.cuda.synchronize()
    for i, op, rev, y in got:
        require(torch.equal(y, SC.seg_scan_plain(xs[i], op, rev)),
                f"K4 on two streams differs from its plain version: "
                f"{shapes[i]} {op} {'reverse' if rev else 'forward'}")
    print(f"K4 seg_scan: {len(got)} calls on two streams at once over "
          f"{len(xs)} distinct inputs: bit-exact vs plain")


def sm_clock_mhz(torch) -> float:
    """The SM clock under load: nvidia-smi samples it while a spinning
    kernel keeps the card busy."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1.5 * 2e9))
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return float(proc.stdout.strip().splitlines()[0])


# K2's dependent step: one FMA a frame, assumed to take 4 cycles of latency
# on Hopper (an assumption, not measured here)
FMA_LATENCY_CYCLES = 4


def k2_timings(torch, dev, rng, reps: int = 50) -> dict:
    """K2 at the main path's shapes: the batch (config 2's 256 x 30 s), a
    listen query, and the streamed chunk with a carry at --shifts 1 and 4;
    beside each its byte bound (x read and y written once; the carry's
    four (B, F) planes).  The printed line adds a chain floor, T dependent
    FMAs at FMA_LATENCY_CYCLES each at the SM clock sampled under load:
    derived from an assumed latency, so it stays out of the record."""
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_torch.ops import spectro as SP

    cfg = PipelineConfig()
    mhz = sm_clock_mhz(torch)
    out = {"sm_clock_mhz": mhz}
    for key, b, t, carried in (("", 256, 1535, False),
                               ("listen_", 1, 431, False),
                               ("carry_", 1, 8192, True),
                               ("carry4_", 4, 8192, True)):
        F = cfg.n_bins
        x = torch.from_numpy(
            rng.standard_normal((b, t, F)).astype(np.float32)).to(dev)
        c = (tuple(torch.zeros((b, F), device=dev) for _ in range(2))
             if carried else None)
        ms = cuda_ms(lambda: SP.hpf(x, cfg, c), reps)
        plain = plain_ms(lambda: SP.hpf_plain(x, cfg, c))
        bms, bby = bound(4 * (2 * b * t * F + (4 * b * F if carried else 0)),
                         3 * b * t * F)
        floor = t * FMA_LATENCY_CYCLES / (mhz * 1e3)
        out.update({f"{key}ms": ms, f"{key}plain_ms": plain,
                    f"{key}bound_ms": bms, f"{key}bound_by": bby})
        print(f"K2 hpf_scan ({b},{t},{F}){' with a carry' if carried else ''}"
              f": kernel {ms:.4f} ms, plain {plain:.1f} ms, bound {bms:.5f} "
              f"ms ({bby}); derived chain floor {floor:.5f} ms ({t} FMAs x "
              f"{FMA_LATENCY_CYCLES} assumed cycles at {mhz:.0f} MHz)")
    return out


def k1_rounds(torch, m0, env0f, gvec, kept, cfg) -> tuple:
    """The data-dependent work of K1 on these inputs: (argmax rounds of
    the forward pass plus peaks kept by the backward pass, forward rounds
    per frame, locmax bins per frame).  The forward lists come from K1f,
    which runs the same forward loop."""
    from audfprint_torch.ops import cuda_peaks as CP

    lp = CP.prune_fwd_carry(m0, env0f, gvec, cfg.a_dec,
                            cfg.maxpksperframe)[0]
    fwd = int((lp >= 0).sum().item())
    frames = m0.shape[0] * m0.shape[1]
    return (fwd + int((kept >= 0).sum().item()), fwd / frames,
            float((m0 > -1e38).sum().item()) / frames)


def _ridged(rng, b: int, t: int, F: int, quant: bool) -> np.ndarray:
    """Random whitened-like frames with a few sustained tonal ridges;
    np.round-quantised (plateaus, ties, repeats) when quant."""
    w = rng.standard_normal((b, t, F)).astype(np.float32) * 2.0
    for r in range(b):
        for _ in range(6):
            f0 = rng.integers(5, F - 5)
            t0, t1 = sorted(rng.integers(0, t, 2).tolist())
            w[r, t0:t1 + 1, f0] += 3.0
    return np.round(w).astype(np.float32) if quant else w


def phase_stream_kernels(torch, rec: dict, dev, shapes=((1, 8192), (4, 2048)),
                         reps: int = 5) -> None:
    """K1f against its plain version and the carried chunks against one
    pass, for K1f and K2, at the streamed chunk shapes."""
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import peaks as PK
    from audfprint_torch.ops import spectro as SP

    cfg = PipelineConfig()
    F, k, a = cfg.n_bins, cfg.maxpksperframe, cfg.a_dec
    rng = np.random.default_rng(SEED + 5)
    gvec = torch.as_tensor(PK.gauss_vector(cfg), device=dev)
    gtab = CP._bump_table(gvec, F)

    def k1f_both(m0, env):
        got = CP.prune_fwd_carry(m0, env, gvec, a, k)
        want = CP.prune_fwd_carry_plain(m0, env, gvec, a, k)
        return got, want

    worst = 0.0
    for b, t in shapes:
        for quant in (False, True):
            white = torch.from_numpy(_ridged(rng, b, t, F, quant)).to(dev)
            y = SP.hpf(white, cfg)[0]
            nf = torch.full((b,), t, dtype=torch.int32, device=dev)
            nf[-1] = t - t // 3                  # a ragged last chunk
            m0 = CP.candidate_map(y, nf)
            for env in (PK.head_envelope(y, nf, gtab),
                        torch.rand((b, F), device=dev) * 4.0):
                got, want = k1f_both(m0, env)
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                err = (got[2] - want[2]).abs().max().item()
                worst = max(worst, err)
                require(same, f"K1f differs from its plain version at "
                              f"({b},{t},{F}) quant={quant}: env err {err}")
            print(f"K1f prune_fwd_carry ({b},{t},{F}, k={k}, "
                  f"{'tie-heavy' if quant else 'random'}): bit-exact vs "
                  f"plain, env in from the head and from the carry "
                  f"({int((got[0] >= 0).sum())} peaks)")

    # carried chunks against one pass (full chunks), K1f and K2
    b, t = shapes[0]
    white = torch.from_numpy(_ridged(rng, b, t, F, False)).to(dev)
    y1, c1 = SP.hpf(white, cfg)
    cuts = [0, t // 3, 2 * t // 3, t]
    parts, carry = [], (torch.rand((b, F), device=dev),
                        torch.rand((b, F), device=dev))
    y_all, c_all = SP.hpf(white, cfg, carry)
    for c0, c_1 in zip(cuts[:-1], cuts[1:]):
        yc, carry = SP.hpf(white[:, c0:c_1].contiguous(), cfg, carry)
        parts.append(yc)
    require(torch.equal(torch.cat(parts, dim=1), y_all)
            and all(torch.equal(u, v) for u, v in zip(carry, c_all)),
            "K2 over 3 carried chunks differs from one pass")
    nf = torch.full((b,), t, dtype=torch.int32, device=dev)
    m0 = CP.candidate_map(y1, nf)
    env0 = PK.head_envelope(y1, nf, gtab)
    whole = CP.prune_fwd_carry(m0, env0, gvec, a, k)
    env, lp, lv = env0, [], []
    for c0, c_1 in zip(cuts[:-1], cuts[1:]):
        p_, v_, env = CP.prune_fwd_carry(m0[:, c0:c_1].contiguous(), env,
                                         gvec, a, k)
        lp.append(p_)
        lv.append(v_)
    require(torch.equal(torch.cat(lp, 1), whole[0])
            and torch.equal(torch.cat(lv, 1), whole[1])
            and torch.equal(env, whole[2]),
            "K1f over 3 carried chunks differs from one pass")
    print(f"carries ({b},{t},{F}) in 3 chunks: K2 and K1f equal one pass "
          "bit for bit")

    check_k1f_cases(torch, dev, rng, a)

    # the chain's two costs: a frame with no candidate (m0 all _NEG) and
    # one with k argmax rounds (every bin a candidate)
    m_empty = torch.full_like(m0, CP._NEG)
    m_dense, env_d, _g = _seeded_prune_case(torch, rng, dev, b, t, F,
                                            "dense")
    empty_ms = cuda_ms(
        lambda: CP.prune_fwd_carry(m_empty, env0, gvec, a, k), reps)
    dense_ms = cuda_ms(
        lambda: CP.prune_fwd_carry(m_dense, env_d, gvec, a, k), reps)
    print(f"K1f ({b},{t},{F}) with no candidate: {empty_ms:.4f} ms "
          f"({empty_ms / t * 1e3:.4f} us a frame); with {k} rounds in every "
          f"frame: {dense_ms:.4f} ms ({(dense_ms - empty_ms) / (t * k) * 1e3:.4f}"
          f" us a round)")
    k1f_ms = cuda_ms(lambda: CP.prune_fwd_carry(m0, env0, gvec, a, k), reps)
    k1f_plain = plain_ms(
        lambda: CP.prune_fwd_carry_plain(m0, env0, gvec, a, k))
    fwd = int((whole[0] >= 0).sum().item())
    k1f_b = k1f_bound(b, t, F, k, fwd)
    print(f"K1f ({b},{t},{F}): kernel {k1f_ms:.3f} ms, plain "
          f"{k1f_plain:.1f} ms, bound {k1f_b[0]:.5f} ms ({k1f_b[1]}), "
          f"{fwd / (b * t):.3f} argmax rounds per frame")
    rec["prune_fwd_carry"] = dict(max_abs_err=worst, ms=k1f_ms,
                                  plain_ms=k1f_plain, bound_ms=k1f_b[0],
                                  bound_by=k1f_b[1], library_ms=None,
                                  rounds_per_frame=fwd / (b * t),
                                  empty_ms=empty_ms, dense_ms=dense_ms)


def prune_on_real(torch, rec: dict, audio: np.ndarray, lens: np.ndarray,
                  carry: bool) -> None:
    """K1 (carry=False) or K1f (carry=True) timed on the candidate map of
    real audio, with the data-dependent work it did: the (256, 30 s) batch
    of phase 6's corpus for K1, one 8192-frame chunk of phase 8's WAV for
    K1f."""
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import peaks as PK
    from audfprint_torch.ops import pipeline as pipe
    from audfprint_torch.ops import spectro as SP

    cfg = PipelineConfig()
    k, a = cfg.maxpksperframe, cfg.a_dec
    ln = torch.as_tensor(lens, device="cuda")
    nf = pipe.frame_count_device(ln, cfg)
    white = SP.whitened_logmag(torch.as_tensor(audio, device="cuda"), nf, cfg)
    y, m0, e0f, e0b, g = CP.prune_inputs(white, nf, cfg)
    B, T, F = m0.shape
    if carry:
        env = PK.head_envelope(y, nf, CP._bump_table(g, F))
        lp = CP.prune_fwd_carry(m0, env, g, a, k)[0]
        ms = cuda_ms(lambda: CP.prune_fwd_carry(m0, env, g, a, k), 5)
        rounds = int((lp >= 0).sum().item())
        per = rounds / (B * T)
        bms, bby = k1f_bound(B, T, F, k, rounds)
        name = "prune_fwd_carry"
    else:
        kept = CP.prune_fwd_bwd(m0, nf, e0f, e0b, g, a, k)
        ms = cuda_ms(lambda: CP.prune_fwd_bwd(m0, nf, e0f, e0b, g, a, k), 5)
        rounds, per, _lm = k1_rounds(torch, m0, e0f, g, kept, cfg)
        bms, bby = k1_bound(B, T, F, k, rounds)
        name = "prune_fwd_bwd"
    locmax = float((m0 > -1e38).sum().item()) / (B * T)
    print(f"{name} on real audio ({B},{T},{F}): kernel {ms:.4f} ms, bound "
          f"{bms:.5f} ms ({bby}); {per:.3f} argmax rounds and {locmax:.2f} "
          f"locmax bins per frame")
    rec[name].update(real_shape=[B, T, F], real_ms=ms, real_bound_ms=bms,
                     real_rounds_per_frame=per,
                     real_locmax_per_frame=locmax)


def stage_breakdown(torch, batch: np.ndarray, lens: np.ndarray) -> dict:
    """Device ms of each fingerprint stage for one (256, 30 s) batch."""
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import landmarks as L
    from audfprint_torch.ops import peaks as PK
    from audfprint_torch.ops import pipeline as pipe
    from audfprint_torch.ops import spectro as SP

    cfg = PipelineConfig()
    dev = torch.device("cuda")
    a = torch.as_tensor(batch, device=dev)
    ln = torch.as_tensor(lens, device=dev)
    nf = pipe.frame_count_device(ln, cfg)
    white = SP.whitened_logmag(a, nf, cfg)
    bins, valid = CP.find_peaks_slots_fused(white, nf, cfg)
    y = SP.hpf(white, cfg)[0]
    gtab = CP._bump_table(torch.as_tensor(PK.gauss_vector(cfg), device=dev),
                          y.shape[2])
    out = {
        "spectrogram": cuda_ms(lambda: SP.whitened_logmag(a, nf, cfg), 3),
        "hpf_K2": cuda_ms(lambda: SP.hpf(white, cfg), 3),
        "envelope_seeds": cuda_ms(lambda: (PK.head_envelope(y, nf, gtab),
                                           PK.tail_envelope(y, nf, gtab)), 3),
        "prune_prologue": cuda_ms(lambda: CP.prune_inputs(white, nf, cfg), 3),
        "prune_prologue+K1+slots": cuda_ms(
            lambda: CP.find_peaks_slots_fused(white, nf, cfg), 3),
        "slots_to_hashes": cuda_ms(
            lambda: L.slots_to_hashes(bins, valid, cfg), 3),
        "fingerprint_batch_compact": cuda_ms(
            lambda: pipe.fingerprint_batch_compact(a, ln, cfg), 3),
    }
    return out


def phase_main_path(torch, rec: dict) -> dict:
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.ops import pipeline as pipe
    from audfprint_torch.utils import graphs
    from audfprint_torch.oracle import analyze as oa
    from audfprint_torch.match.matcher import Matcher
    from audfprint_torch.models.analyzer import Analyzer

    n_tracks, dur, qdur, n_q = 1000, 30.0, 10.0, 64
    rng = np.random.default_rng(SEED + 2)
    t0 = time.time()
    tracks = _in_processes(config2_track, range(n_tracks))
    print(f"config 2: made {n_tracks} x {dur:g} s tracks in "
          f"{time.time() - t0:.1f} s (host numpy, not timed)")
    qsel = rng.choice(n_tracks, n_q, replace=False)
    starts = [256 * int(rng.integers(0, int((dur - qdur) * SR) // 256))
              for _ in qsel]
    queries = [tracks[i][s: s + int(qdur * SR)] for i, s in zip(qsel, starts)]

    an = Analyzer(device="cuda")
    matcher = Matcher(device="cuda")
    # warm-up outside the measured run: cuFFT plans, the kernel library,
    # the allocator, the ingest key's graph (captured into an empty pool,
    # so that the bytes it holds are its own); and the per-stage
    # breakdown of one full batch
    graphs.clear(torch.device("cuda"))
    an.samples_batch2hashes(tracks[:256])
    ((key, held),) = an._graphs.held_by_key().items()
    print(f"config 2 ingest key {_key_name(key)} [{nvidia_smi_line()}]: "
          f"captured in {an._graphs.capture_seconds()[key]:.3f} s, its "
          f"graph holds {held / 2**20:.1f} MiB "
          f"(pipeline.fingerprint_bytes estimates "
          f"{pipe.fingerprint_bytes(*key[0][0][0], an.config) / 2**20:.1f})")
    idxs, batch, lens = an.stage_groups(tracks[:256])[0]
    breakdown = stage_breakdown(torch, batch, lens)
    print("fingerprint stages, device ms per (256 x 30 s) batch: "
          + json.dumps({k: round(v, 3) for k, v in breakdown.items()}))
    prune_on_real(torch, rec, batch, lens, carry=False)
    pair_on_real(torch, rec, batch, lens)

    # ---- the main path, counted ----
    _counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    hashes = an.samples_batch2hashes(tracks)
    t_fp = time.time() - t0
    ht = HashTable()
    t0 = time.time()
    for i, h in enumerate(hashes):
        ht.store_vectorized(f"track{i}", h)
    t_store = time.time() - t0
    t0 = time.time()
    matcher._device_state(ht)
    torch.cuda.synchronize()
    t_up = time.time() - t0
    matcher.match_samples_fused(an, ht, queries)     # capture its graph
    torch.cuda.synchronize()
    t0 = time.time()
    res, nhash = matcher.match_samples_fused(an, ht, queries)
    t_match = time.time() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    in_use = torch.cuda.memory_allocated()

    t0 = time.time()
    groups = an.stage_groups(tracks)              # host staging alone
    t_stage = time.time() - t0
    t0 = time.time()
    for _i, batch, _l in groups:
        torch.as_tensor(batch, device="cuda")
    torch.cuda.synchronize()
    t_h2d = time.time() - t0
    del groups
    print(f"config 2 host side of the ingest: staging {t_stage:.3f} s, "
          f"host-to-device copies {t_h2d:.3f} s (outside the counted run)")

    n_hash = sum(len(h) for h in hashes)
    top1 = float(np.mean([len(r) > 0 and int(r[0][0]) == int(i)
                          for r, i in zip(res, qsel)]))
    jac = []
    for i in range(4):
        want = {tuple(r) for r in oa.samples_to_hashes(tracks[i]).tolist()}
        got = {tuple(r) for r in hashes[i].tolist()}
        jac.append(len(want & got) / max(1, len(want | got)))
    as_s = n_tracks * dur / t_fp
    print(f"config 2 ingest: {n_tracks} tracks, {n_hash} hashes "
          f"({n_hash / (n_tracks * dur):.2f}/s) in {t_fp:.3f} s = "
          f"{as_s:.1f} audio-s/s fingerprint; host store {t_store:.3f} s; "
          f"table upload {t_up:.3f} s")
    print(f"config 2 match: {n_q} x {qdur:g} s queries in {t_match:.3f} s = "
          f"{n_q / t_match:.2f} q/s (fused path, warm); top-1 self "
          f"{top1:.4f}; mean hashes/query {np.mean(nhash):.1f}")
    print(f"oracle Jaccard (4 tracks): {[round(j, 4) for j in jac]}")
    print(f"device memory: peak {peak / 2**20:.1f} MiB, in use "
          f"{in_use / 2**20:.1f} MiB; launches on the main path {launches}")
    require(top1 >= 0.95, f"top-1 self {top1} < 0.95")
    require(min(jac) > 0.9, f"oracle Jaccard {min(jac)} <= 0.9")
    require(launches["prune_fwd_bwd"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0 and launches["seg_scan"] > 0,
            f"a kernel was not launched on the main path: {launches}")
    rec["_paths"]["config2"] = launches
    ctx = dict(tracks=tracks, ht=ht, hashes=hashes, an=an, matcher=matcher,
               queries=queries, qsel=[int(i) for i in qsel])
    return ({"fingerprint_audio_s_per_s": as_s, "match_q_per_s":
             n_q / t_match, "top1_self": top1, "jaccard_min": min(jac),
             "peak_mib": peak / 2**20, "breakdown_ms": breakdown},
            ctx, t_fp + t_store)


# the modes the vote's rows are held in against the oracle: Matcher (and
# MatcherParams) keywords
VOTE_MODES = [
    ("default", {}),
    ("exact_count", {"exact_count": True, "max_returns": 4}),
    ("find_time_range", {"find_time_range": True}),
    ("exact_count + find_time_range + sort_by_time",
     {"exact_count": True, "find_time_range": True, "sort_by_time": True,
      "max_returns": 4}),
]


def _rows_differing(got: list, want: list) -> list:
    """Indices whose (k, 6) rows differ, in value or in number (the
    seventh column, the valid flag, is the number of rows)."""
    return [i for i, (g, w) in enumerate(zip(got, want))
            if g.shape != w.shape or not np.array_equal(g, w)]


def oracle_rows(ht, hash_lists: list, kw: dict) -> list:
    from audfprint_torch import params as P
    from audfprint_torch.oracle import match as om

    mp = P.MatcherParams(**kw)
    return [om.match_hashes(ht, h, mp) for h in hash_lists]


def phase_vote_rows(torch, ctx, dev) -> dict:
    """The card's vote rows against the numpy oracle's at config-2 scale,
    bit for bit, in VOTE_MODES; the default mode through the fused path
    too."""
    from audfprint_torch.match.matcher import Matcher

    ht, an, queries = ctx["ht"], ctx["an"], ctx["queries"]
    qh = an.samples_batch2hashes(queries)
    ctx["qhashes"] = qh
    n_rows = 0
    for name, kw in VOTE_MODES:
        m = Matcher(device=dev, verbose=0, **kw)
        got = m.match_hashes_batch(ht, qh)
        want = oracle_rows(ht, qh, kw)
        bad = _rows_differing(got, want)
        require(not bad, f"vote rows differ from the oracle in mode {name}: "
                         f"queries {bad[:8]}, e.g. card {got[bad[0]]} oracle "
                         f"{want[bad[0]]}" if bad else "")
        n = sum(len(w) for w in want)
        n_rows += n
        if not kw:
            ctx["oracle_rows"] = want
            fused, _nh = m.match_samples_fused(an, ht, queries)
            bad = _rows_differing(fused, want)
            require(not bad, f"fused-path rows differ from the oracle: "
                             f"queries {bad[:8]}")
            n_rows += n
        print(f"vote rows, mode {name}: {len(qh)} queries, {n} rows equal "
              f"the oracle's bit for bit"
              + ("" if kw else " (two-stage and fused)"))
        del m
    print(f"vote rows against the oracle: {n_rows} rows compared in "
          f"{len(VOTE_MODES)} modes, 0 differ")
    return {"vote_rows_compared": n_rows}


@contextlib.contextmanager
def eager_graphs():
    """Inside, every graph cache (the fused path's, the two-stage vote's
    and fingerprint's, the device store's, the streamed route's and
    `precompute -K`'s) runs its eager function, as on a CPU device: a
    measurement aid of this script; the port itself has no way to turn
    its graphs off."""
    from audfprint_torch.utils import graphs

    real = graphs.captures
    graphs.captures = lambda device: False
    try:
        yield
    finally:
        graphs.captures = real


def to_pcm(x: np.ndarray) -> np.ndarray:
    """float32 samples as 16-bit PCM, what a WAV at the analysis rate
    decodes to."""
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def _key_name(key) -> str:
    (audio, _lens), _none, _static = key
    return f"{audio[0][0]}x{audio[0][1]} {np.dtype(audio[1]).name}"


GRAPH_KERNELS = ("prune_fwd_bwd", "hpf_scan", "pair_scan", "seg_scan")
# the fingerprint's kernels, once a fingerprint replay; K4 runs once a
# scan site of the vote or the store, its recorded count a replay
FP_KERNELS = GRAPH_KERNELS[:3]
# torch's own scan kernel (cummax, cummin, cumsum along a row), which no
# sorted-core replay may run
TORCH_SCAN = "scan_innermost_dim"


def _device_events(torch, prof) -> list:
    """The device's kernels, copies and memsets of a profile: its CUDA
    events less the program's spans (utils/timing), each of which also
    shows on the device's timeline as a user annotation over the work it
    launched."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _cuda_events(torch, fn, kernels=GRAPH_KERNELS + (TORCH_SCAN,)
                 ) -> tuple:
    """(device events, device busy ms, {kernel: events whose name holds
    it} for `kernels`) of one fn() under torch.profiler, which lists a
    graph replay's kernels one by one.  A K4 wrapper call shows as one
    seg_scan event (its workspace reset is a memset, not a kernel).  fn
    starts 20 ms into the
    profile and the profile ends 20 ms after the device is idle: two
    profiles on the card that opened right before a short replay lacked
    its first kernels (a fingerprint replay with no event at all, a
    streamed peaks replay without K2), as if the profiler had placed
    them before its window.  A profile that holds no device event at all
    recorded nothing (every fn given here launches kernels): it is said
    so and taken again, up to three times, so fn must bear running more
    than once."""
    import torch.profiler as tp

    for attempt in range(3):
        with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                    tp.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        ev = _device_events(torch, prof)
        if ev:
            break
        print(f"torch.profiler recorded no device event (attempt "
              f"{attempt + 1} of 3)")
    by_name = {k: sum(k in e.name for e in ev) for k in kernels}
    return len(ev), sum(e.device_time for e in ev) / 1e3, by_name


def phase_graphs(torch, rec: dict, ctx, dev) -> dict:
    """The fused path's CUDA graphs over config 2's 64 queries: the eager
    function raises no host sync; every key captured first, then a counted
    run of replays alone at sub-batch sizes 1 and 16, float32 and int16
    input (K1, K2 and K3 counted once a replay); each replayed output
    equal to the eager function's bit for bit and the rows to the numpy
    oracle's; then a 1-row int16 query's device events and host dispatch,
    and the 64-query fused match rate, eager against replay in turns over
    5 rounds."""
    from audfprint_torch.match import matcher as M

    smi = nvidia_smi_line()
    ht, an, queries = ctx["ht"], ctx["an"], ctx["queries"]
    sigs = {"float32": queries, "int16": [to_pcm(q) for q in queries]}
    want = {"float32": ctx["oracle_rows"],
            "int16": oracle_rows(ht, an.samples_batch2hashes(sigs["int16"]),
                                 {})}
    m = M.Matcher(device=dev, verbose=0)
    (table, counts, hpi, tcfg, ncap, _mesh, plane) = m._device_state(ht)
    state = (table, counts, hpi, plane)
    mcfg = m._mcfg(M._QT_FLOOR, ncap)

    def static(batch):
        dur = batch.shape[1] / float(an.target_sr)
        return (an.config, tcfg, mcfg,
                M._next_pow2(int(dur * an.density * 1.5) + 64, 128))

    def eager(batch, lens):
        return M._fused_match_graph(torch.as_tensor(batch, device=dev),
                                    torch.as_tensor(lens, device=dev),
                                    *state, *static(batch))

    cases = [(kind, rows) for kind in sigs for rows in (1, 16)]
    # the eager function from device audio to the packed output: a host
    # sync raises here
    for kind, rows in cases:
        _i, batch, lens = an.stage_groups(sigs[kind][:rows])[0]
        xa = torch.as_tensor(batch, device=dev)
        xl = torch.as_tensor(lens, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            M._fused_match_graph(xa, xl, *state, *static(batch))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"graphs: the eager _fused_match_graph ran {len(cases)} cases "
          "under set_sync_debug_mode('error') without a host sync")

    for kind, rows in cases:                  # capture every key
        m.match_samples_fused(an, ht, sigs[kind][:rows])
    keys = m._graphs.keys()
    # ---- replays alone, counted ----
    _counts_zero()
    handles = []
    for kind, rows in cases:
        for i in range(0, len(queries), rows):
            chunk = sigs[kind][i: i + rows]
            handles.append((kind, chunk,
                            m.match_samples_fused_async(an, ht, chunk)))
    torch.cuda.synchronize()
    launches = _counts()
    n_rep = sum(len(h[1]) for _k, _c, h in handles)
    require(m._graphs.keys() == keys, "a replayed key was captured again")
    require(all(launches[k] == n_rep for k in FP_KERNELS),
            f"{n_rep} replays counted as {launches}")
    rec["_paths"]["graphs"] = launches
    # the counts above are what the captures recorded; hold them against
    # what the profiler sees one replay of each key launch: K1, K2 and K3
    # once, K4 as often as the key recorded, torch's scan never
    per_key = {}
    for kind, rows in cases:
        _j, batch, lens = an.stage_groups(sigs[kind][:rows])[0]

        def replay():
            return m._graphs((batch, lens), state, static(batch))

        before = _counts()
        replay()
        per_key[kind, rows] = _launch_delta(before)["seg_scan"]
        n_ev, _ms, seen = _cuda_events(torch, replay)
        require(all(seen[k] == 1 for k in FP_KERNELS)
                and seen["seg_scan"] == per_key[kind, rows] > 0
                and seen[TORCH_SCAN] == 0,
                f"one replay ({kind}, {rows} rows) ran the kernels {seen} "
                f"times of {n_ev} device events, not K1, K2 and K3 once "
                f"each, K4 its recorded {per_key[kind, rows]} and torch's "
                f"scan never")
    want_k4 = sum(len(h[1]) * per_key[kind, len(chunk)]
                  for kind, chunk, h in handles)
    require(launches["seg_scan"] == want_k4,
            f"{n_rep} replays counted K4 {launches['seg_scan']} times, their "
            f"keys recorded {want_k4}")
    print(f"graphs: one replay of each of the {len(cases)} keys ran "
          f"{', '.join(FP_KERNELS)} once each, seg_scan its recorded "
          f"{sorted(set(per_key.values()))} and {TORCH_SCAN} 0 times "
          "(torch.profiler kernel events)")
    got = {kind: [] for kind in sigs}
    n_out = 0
    for kind, chunk, h in handles:
        for (idxs, out), (_j, batch, lens) in zip(h[1],
                                                  an.stage_groups(chunk)):
            require(torch.equal(out, eager(batch, lens)),
                    f"replayed output differs from the eager function: "
                    f"{kind}, {len(chunk)} rows, queries {idxs}")
            n_out += 1
        got[kind] += m.match_fused_resolve(an, ht, h)[0]
    for kind in sigs:
        bad = _rows_differing(got[kind], want[kind] * 2)
        require(not bad, f"replayed rows differ from the oracle ({kind}): "
                         f"queries {bad[:8]}")
    # K1 sets its dynamic shared memory to each launch's size: a smaller
    # eager launch after the captures leaves a replay's result unchanged
    an.samples_batch2hashes([queries[0][: 2 * an.target_sr]])
    h = m.match_samples_fused_async(an, ht, queries[:16])
    _j, batch, lens = an.stage_groups(queries[:16])[0]
    require(torch.equal(h[1][0][1], eager(batch, lens)),
            "a replay after a smaller eager K1 launch differs")
    cap = {_key_name(k): round(v, 4)
           for k, v in m._graphs.capture_seconds().items()}
    print(f"graphs [{smi}]: {len(keys)} keys captured, seconds {cap}; "
          f"{n_rep} replays launched K1, K2 and K3 once each and K4 "
          f"{launches['seg_scan']} times ({launches}); "
          f"{n_out} replayed outputs equal the eager function's bit for "
          f"bit; {sum(len(w) for w in want.values()) * 2} rows equal the "
          f"oracle's at sub-batch sizes 1 and 16, float32 and int16; cache "
          f"holds {m._graphs.held_bytes / 2**20:.1f} MiB")

    # one 1-row int16 query, eager against replay, in turns
    _i, b1, l1 = an.stage_groups(sigs["int16"][:1])[0]

    def replay1():
        return m._graphs((b1, l1), state, static(b1))

    def eager1():
        return eager(b1, l1)

    med = _in_turns(torch, {"eager": eager1, "replay": replay1})
    ev = {name: _cuda_events(torch, fn)
          for name, fn in (("eager", eager1), ("replay", replay1))}
    top1 = _cuda_top(torch, replay1)
    print(f"graphs [{smi}]: a 1 x 10 s int16 query, host dispatch ms "
          f"(median of 50 calls in 5 rounds, eager / replay) "
          f"{med['eager']:.3f} / {med['replay']:.3f}; device events "
          f"{ev['eager'][0]} / {ev['replay'][0]}, device busy ms "
          f"{ev['eager'][1]:.3f} / {ev['replay'][1]:.3f} (with torch's "
          f"scans in place of K4: 2.213 replayed), kernels "
          f"{ev['eager'][2]} / {ev['replay'][2]} (torch.profiler); the "
          f"replay's kernels with the most device time (name, events, ms) "
          f"{top1}")

    # the 64-query fused match rate, eager against replay, in turns
    m.match_samples_fused(an, ht, queries)
    rate = {"eager": [], "replay": []}
    for _r in range(5):
        for name in ("eager", "replay"):
            with (eager_graphs() if name == "eager"
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m.match_samples_fused(an, ht, queries)
                rate[name].append(len(queries) / (time.perf_counter() - t0))
    print(f"graphs [{smi}]: fused match of 64 x 10 s queries, q/s by "
          f"round, eager {[round(x, 2) for x in rate['eager']]}, replay "
          f"{[round(x, 2) for x in rate['replay']]}")

    # a key's first call, what a one-shot `match` process pays: the eager
    # function against warm-up run + capture, each on a fresh
    # Matcher whose table is staged first, untimed; in turns, 5 rounds
    cold = {"eager": [], "capture": []}
    for _r in range(5):
        for name in ("eager", "capture"):
            mc = M.Matcher(device=dev, verbose=0)
            mc._device_state(ht)
            torch.cuda.synchronize()
            with (eager_graphs() if name == "eager"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                mc.match_samples_fused(an, ht, queries[:1])
                cold[name].append(1e3 * (time.perf_counter() - t0))
            del mc
    print(f"graphs [{smi}]: a new key's first call (1 x 10 s float32, "
          f"fresh Matcher), ms by round, eager "
          f"{[round(x, 2) for x in cold['eager']]}, capture "
          f"{[round(x, 2) for x in cold['capture']]}")
    return {"graph_keys": len(keys), "graph_capture_s": cap,
            "graph_replays_counted": n_rep,
            "graph_held_mib": m._graphs.held_bytes / 2**20,
            "query_dispatch_ms": med,
            "query_device_events": {k: v[0] for k, v in ev.items()},
            "query_device_busy_ms": {k: v[1] for k, v in ev.items()},
            "query_top_kernels": top1,
            "fused_match_q_per_s": rate, "first_call_ms": cold}


def padded_queries(hash_lists: list, Q: int) -> tuple:
    """(t, hash, valid) (B, Q) host columns of query hash lists, as
    Matcher._match_padded pads them."""
    B = len(hash_lists)
    tt, hh = np.zeros((B, Q), np.int32), np.zeros((B, Q), np.int32)
    vv = np.zeros((B, Q), bool)
    for b, h in enumerate(hash_lists):
        tt[b, : len(h)], hh[b, : len(h)] = h[:, 0], h[:, 1]
        vv[b, : len(h)] = True
    return tt, hh, vv


def _in_turns(torch, fns: dict, rounds: int = 5, calls: int = 10) -> dict:
    """Host ms of each fn() (after a sync, without one after it), the fns
    in turns, `calls` calls a round over `rounds` rounds: {name: median}."""
    ms = {name: [] for name in fns}
    for _r in range(rounds):
        for name, fn in fns.items():
            for _c in range(calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                ms[name].append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return {k: float(np.median(v)) for k, v in ms.items()}


def phase_two_stage(torch, rec: dict, ctx, dev) -> dict:
    """The two-stage path's CUDA graphs over config 2's 64 queries: the
    Analyzer's fingerprint (fingerprint_batch_compact_k) and the Matcher's
    vote (match_batch_packed, sorted and hist core).  The eager functions
    raise no host sync; every key captured, then a counted run of replays
    alone at sub-batch sizes 1 and 16, float32 and int16 (K1, K2 and K3
    once a fingerprint replay, in the counts and in the profiler's kernel
    events of one replay of each key); each replayed output equal to the
    eager function's bit for bit, the hashes to the main path's and the
    rows to the numpy oracle's; MiB each key holds; a 1 x 10 s query's
    host dispatch and device events and the 64-query two-stage rate,
    eager against replay in turns over 5 rounds."""
    from audfprint_torch.match import matcher as M
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.ops import pipeline as pipe
    from audfprint_torch.utils import graphs

    smi = nvidia_smi_line()
    ht, queries, want = ctx["ht"], ctx["queries"], ctx["oracle_rows"]
    sigs = {"float32": queries, "int16": [to_pcm(q) for q in queries]}
    an = Analyzer(device=dev)
    cfg = an.config
    mats = {"sorted": M.Matcher(device=dev, verbose=0),
            "hist": M.Matcher(device=dev, verbose=0)}
    mats["hist"].force_core = "hist"

    def fp_static(batch):
        return (cfg, an._hash_cap_estimate(batch.shape[1] / an.target_sr))

    def fp_eager(batch, lens):
        return pipe.fingerprint_batch_compact_k(
            torch.as_tensor(batch, device=dev),
            torch.as_tensor(lens, device=dev), *fp_static(batch))

    def vote_args(core, hash_lists):
        m = mats[core]
        table, counts, hpi, tcfg, ncap, _mesh, plane = m._device_state(ht)
        Q = M._next_pow2(max([1] + [len(h) for h in hash_lists]), 128)
        maxt = max([1] + [int(h[:, 0].max()) + 1 for h in hash_lists
                          if len(h)])
        mcfg = m._mcfg(M._next_pow2(maxt, M._QT_FLOOR), ncap)
        return (padded_queries(hash_lists, Q),
                (table, counts, hpi, plane if core == "sorted" else None),
                (tcfg, mcfg, core))

    def vote_eager(inputs, state, static):
        return M._two_stage_vote(
            *(torch.as_tensor(a, device=dev) for a in inputs), *state,
            *static)

    # the eager functions from device inputs: a host sync raises here
    qh = ctx["qhashes"]
    for kind, rows in [(k, r) for k in sigs for r in (1, 16)]:
        _i, batch, lens = an.stage_groups(sigs[kind][:rows])[0]
        xa = torch.as_tensor(batch, device=dev)
        xl = torch.as_tensor(lens, device=dev)
        checks = [lambda: pipe.fingerprint_batch_compact_k(
            xa, xl, *fp_static(batch))]
        for core in mats:
            inputs, state, static = vote_args(core, qh[:rows])
            dv = [torch.as_tensor(a, device=dev) for a in inputs]
            checks.append(lambda dv=dv, state=state, static=static:
                          M._two_stage_vote(*dv, *state, *static))
            checks.append(lambda dv=dv, state=state, static=static:
                          M._two_stage_vote(*dv, *state, static[0],
                                            static[1]._replace(
                                                find_time_range=True),
                                            static[2]))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for fn in checks:
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("two-stage graphs: the eager fingerprint_batch_compact_k and "
          "_two_stage_vote (sorted and hist core, with and without the "
          "time range) ran without a host sync under "
          "set_sync_debug_mode('error')")

    def run():
        """Every fingerprint key's groups, queued; every vote key's
        sub-batches.  Returns (fingerprint handles, vote outputs)."""
        fps = []
        for kind in sigs:
            for rows in (1, 16):
                for i in range(0, len(queries), rows):
                    chunk = sigs[kind][i: i + rows]
                    fps.append((kind, chunk, an.fingerprint_async(chunk)))
        votes = []
        for core in mats:
            for rows in (1, 16):
                for i in range(0, len(qh), rows):
                    args = vote_args(core, qh[i: i + rows])
                    votes.append((core, args, mats[core]._votes(*args)))
        return fps, votes

    t0 = time.time()
    run()                                       # capture every key
    torch.cuda.synchronize()
    t_cap = time.time() - t0
    keys = {"fingerprint": an._graphs.keys(),
            **{core: m._votes.keys() for core, m in mats.items()}}
    # ---- replays alone, counted ----
    caps = graphs.counts["captures"]
    _counts_zero()
    fps, votes = run()
    torch.cuda.synchronize()
    launches = _counts()
    n_fp = sum(len(h[1]) for _k, _c, h in fps)
    require(graphs.counts["captures"] == caps,
            "a replayed two-stage key was captured again")
    require(all(launches[k] == n_fp for k in FP_KERNELS)
            and launches["seg_scan"] > 0,
            f"{n_fp} fingerprint replays counted as {launches} (the votes' "
            f"replays launch K4)")
    rec["_paths"]["two_stage_graphs"] = launches
    for kind, rows in [(k, r) for k in sigs for r in (1, 16)]:
        _j, batch, lens = an.stage_groups(sigs[kind][:rows])[0]
        n_ev, _ms, seen = _cuda_events(
            torch, lambda: an._graphs((batch, lens), (), fp_static(batch)))
        require(all(seen[k] == 1 for k in FP_KERNELS)
                and seen["seg_scan"] == 0,
                f"one fingerprint replay ({kind}, {rows} rows) of {n_ev} "
                f"device events ran the "
                f"kernels {seen} times, not once each")
    n_out = 0
    hashes = {}
    for kind, chunk, h in fps:
        for (idxs, out), (_j, batch, lens) in zip(h[1],
                                                  an.stage_groups(chunk)):
            ref = fp_eager(batch, lens)
            require(all(torch.equal(a, b) for a, b in zip(out, ref)),
                    f"replayed fingerprint differs from the eager "
                    f"function: {kind}, {len(chunk)} rows, rows {idxs}")
            n_out += 1
        hashes.setdefault((kind, len(chunk)), []).extend(
            an.fingerprint_resolve(h))
    for (kind, _rows), hl in hashes.items():
        if kind == "float32":
            bad = [i for i, (a, b) in enumerate(zip(hl, qh))
                   if not np.array_equal(a, b)]
            require(not bad, f"replayed fingerprints differ from the main "
                             f"path's hashes: queries {bad[:8]}")
    for core, args, out in votes:
        require(torch.equal(out, vote_eager(*args)),
                f"replayed vote differs from the eager function ({core}, "
                f"{args[0][0].shape[0]} rows)")
        n_out += 1
    n_rows = 0
    for core, m in mats.items():
        for rows in (1, 16):
            got = []
            for i in range(0, len(qh), rows):
                got += m.match_hashes_batch(ht, qh[i: i + rows])
            bad = _rows_differing(got, want)
            require(not bad, f"two-stage replayed rows differ from the "
                             f"oracle ({core}, sub-batch {rows}): queries "
                             f"{bad[:8]}")
            n_rows += sum(len(w) for w in want)
    held = {"fingerprint " + _key_name(k): round(b / 2**20, 1)
            for k, b in an._graphs.held_by_key().items()}
    for core, m in mats.items():
        held.update({f"vote {core} {k[0][0][0][0]}x{k[0][0][0][1]}":
                     round(b / 2**20, 1)
                     for k, b in m._votes.held_by_key().items()})
    est = {_key_name(k): round(pipe.fingerprint_bytes(
        k[0][0][0][0], k[0][0][0][1], cfg) / 2**20, 1)
        for k in an._graphs.keys()}
    print(f"two-stage graphs [{smi}]: {sum(len(v) for v in keys.values())} "
          f"keys captured in {t_cap:.2f} s (fingerprint "
          f"{len(keys['fingerprint'])}, vote sorted {len(keys['sorted'])}, "
          f"hist {len(keys['hist'])}); {n_fp} fingerprint replays launched "
          f"K1, K2 and K3 once each ({launches}); {n_out} replayed outputs "
          f"equal the eager functions' bit for bit; {n_rows} rows equal the "
          f"oracle's (sorted and hist, sub-batch sizes 1 and 16); MiB held "
          f"by key {held}; fingerprint_bytes estimates MiB {est}")

    # one 1 x 10 s int16 query: host dispatch and device events
    _i, b1, l1 = an.stage_groups(sigs["int16"][:1])[0]
    v1 = vote_args("sorted", qh[:1])
    fns = {"fingerprint eager": lambda: fp_eager(b1, l1),
           "fingerprint replay": lambda: an._graphs((b1, l1), (),
                                                   fp_static(b1)),
           "vote eager": lambda: vote_eager(*v1),
           "vote replay": lambda: mats["sorted"]._votes(*v1)}
    disp = _in_turns(torch, fns)
    ev = {name: _cuda_events(torch, fn) for name, fn in fns.items()}
    print(f"two-stage graphs [{smi}]: a 1 x 10 s int16 query, host dispatch "
          f"ms (median of 50 calls in 5 rounds) "
          f"{ {k: round(v, 3) for k, v in disp.items()} }; device events "
          f"{ {k: v[0] for k, v in ev.items()} }, device busy ms "
          f"{ {k: round(v[1], 3) for k, v in ev.items()} }")

    # the 64-query two-stage match (fingerprint, resolve, vote), eager
    # against replay in turns, its keys captured first
    m = mats["sorted"]
    m.match_hashes_batch(ht, an.samples_batch2hashes(sigs["int16"]))
    rate = {"eager": [], "replay": []}
    for _r in range(5):
        for name in rate:
            with (eager_graphs() if name == "eager"
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = m.match_hashes_batch(ht, an.samples_batch2hashes(
                    sigs["int16"]))
                rate[name].append(len(queries) / (time.perf_counter() - t0))
            require(len(got) == len(queries), "two-stage rate: rows lost")
    print(f"two-stage graphs [{smi}]: 64 x 10 s int16 queries through "
          f"samples_batch2hashes + match_hashes_batch, q/s by round, eager "
          f"{[round(x, 2) for x in rate['eager']]}, replay "
          f"{[round(x, 2) for x in rate['replay']]}")
    return {"two_stage_keys": {k: len(v) for k, v in keys.items()},
            "two_stage_capture_s": t_cap, "two_stage_fp_replays": n_fp,
            "two_stage_held_mib": held, "two_stage_dispatch_ms": disp,
            "two_stage_device_events": {k: v[0] for k, v in ev.items()},
            "two_stage_q_per_s": rate}


def _timed(torch, dev, fn, warm: bool = True):
    """(result, wall seconds, device peak MiB above resident) of fn(), after
    one warm-up call."""
    if warm:
        fn()
    base = _reset_peak(torch, dev)
    t0 = time.time()
    out = fn()
    _sync(torch, dev)
    return out, time.time() - t0, _peak_mib(torch, dev, base)


def _tables_equal(a, b) -> bool:
    return (np.array_equal(a.table, b.table)
            and np.array_equal(a.counts, b.counts)
            and np.array_equal(a.hashesperid, b.hashesperid)
            and a.names == b.names)


def phase_sharded(torch, rec, ctx, dev, ndev: int = 4, chunk: int = 256,
                  replay_cap: int = 1024) -> dict:
    """The sharded path on `ndev` logical shards of the one card, each
    result held against its single-device counterpart; records each path's
    wall time and device peak."""
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match.matcher import Matcher
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.models.ingest import DeviceIngest
    from audfprint_torch.ops import pipeline as pipe
    from audfprint_torch.parallel import sharded

    ht, an, tracks = ctx["ht"], ctx["an"], ctx["tracks"]
    hashes, queries, qh = ctx["hashes"], ctx["queries"], ctx["qhashes"]
    names = [f"track{i}" for i in range(len(tracks))]
    card = nvidia_smi_line()
    out: dict = {}

    def record(key, wall, peak, note=""):
        out[key + "_s"] = wall
        out[key + "_peak_mib"] = peak
        print(f"sharded path [{card}] {key}: {wall:.3f} s wall, device peak "
              f"{peak:.1f} MiB above resident{note}")

    mesh = sharded.make_mesh(ndev, [dev])
    require(mesh.size == ndev and all(d.type == torch.device(dev).type
                                      for d in mesh.devices),
            f"the mesh is not {ndev} shards of {dev}: {mesh}")
    _counts_zero()

    # ---- the replicated store
    def store_all():
        h = HashTable()
        st = sharded.ShardedStore(h, mesh)
        for i in range(0, len(hashes), chunk):
            st.store_chunk(list(zip(names[i: i + chunk],
                                    hashes[i: i + chunk])))
        st.finalize()
        return h

    got, wall, peak = _timed(torch, dev, store_all, warm=False)
    require(_tables_equal(got, ht), "ShardedStore's table differs from the "
                                    "host store's")
    record("sharded_store", wall, peak,
           f"; {len(hashes)} tracks' hashes, equal to the host store")
    del got

    # ---- Matcher(ndev) against Matcher(1): cores, plane, modes
    grid_s: dict = {}
    for name, kw in VOTE_MODES[:3]:
        ref_m = Matcher(device=dev, ndev=1, verbose=0, **kw)
        ref, wall1, peak1 = _timed(torch, dev,
                                   lambda: ref_m.match_hashes_batch(ht, qh))
        grid_s[f"{name} | 1 shard, sorted"] = (wall1, peak1)
        m1h = Matcher(device=dev, ndev=1, verbose=0, **kw)
        m1h.force_core = "hist"
        rows, wall, peak = _timed(torch, dev,
                                  lambda: m1h.match_hashes_batch(ht, qh))
        bad = _rows_differing(rows, ref)
        require(not bad, f"the single-device hist core differs from the "
                         f"sorted core in mode {name}: queries {bad[:8]}")
        grid_s[f"{name} | 1 shard, hist"] = (wall, peak)
        del ref_m, m1h
        for core in ("sorted", "hist"):
            for plane in (False, True):
                m = Matcher(device=dev, ndev=ndev, verbose=0, **kw)
                m.force_core = "hist" if core == "hist" else None
                m.use_hpi_plane = plane
                rows, wall, peak = _timed(
                    torch, dev, lambda: m.match_hashes_batch(ht, qh))
                state = m._device_state(ht)
                require(state[5] is not None and state[5].size == ndev
                        and (state[6] is not None) == plane,
                        f"Matcher(ndev={ndev}) did not build its mesh or "
                        f"plane (plane {plane})")
                bad = _rows_differing(rows, ref)
                require(not bad, f"Matcher(ndev={ndev}) rows differ from "
                                 f"ndev=1: mode {name}, core {core}, plane "
                                 f"{plane}, queries {bad[:8]}")
                grid_s[f"{name} | {ndev} shards, {core}, plane "
                       f"{'on' if plane else 'off'}"] = (wall, peak)
                del m
    for key, (wall, peak) in grid_s.items():
        print(f"sharded path [{card}] match of {len(qh)} queries, {key}: "
              f"{wall * 1e3:.1f} ms wall, device peak {peak:.1f} MiB above "
              f"resident; rows equal the single-device sorted core's")
    out["match_grid_ms"] = {k: v[0] * 1e3 for k, v in grid_s.items()}
    out["match_grid_peak_mib"] = {k: v[1] for k, v in grid_s.items()}

    # ---- the config-2 match batch with and without the plane, in turns
    pm = {False: Matcher(device=dev, verbose=0),
          True: Matcher(device=dev, verbose=0)}
    pm[True].use_hpi_plane = True
    walls = {False: [], True: []}
    for m in pm.values():
        m.match_hashes_batch(ht, qh)
    for turn in (False, True, True, False, False, True, True, False):
        _sync(torch, dev)
        t0 = time.time()
        r = pm[turn].match_hashes_batch(ht, qh)
        _sync(torch, dev)
        walls[turn].append(time.time() - t0)
    require(pm[True]._device_state(ht)[6] is not None
            and pm[False]._device_state(ht)[6] is None,
            "use_hpi_plane did not decide the plane")
    off_ms, on_ms = (1e3 * float(np.median(walls[k])) for k in (False, True))
    print(f"hpi plane [{card}] config-2 match batch of {len(qh)} queries "
          f"(two-stage, sorted core, one device), median of 4 in turns: "
          f"plane off {off_ms:.2f} ms, plane on {on_ms:.2f} ms (runs off "
          f"{[round(1e3 * w, 2) for w in walls[False]]}, on "
          f"{[round(1e3 * w, 2) for w in walls[True]]})")
    out.update(plane_off_ms=off_ms, plane_on_ms=on_ms)
    del pm, r

    # ---- the fused mesh path against the two-stage one
    m = Matcher(device=dev, ndev=ndev, verbose=0)
    two = m.match_hashes_batch(ht, qh)
    fused, wall, peak = _timed(
        torch, dev, lambda: m.match_samples_fused(an, ht, queries))
    require(fused is not None, "the fused mesh path was not eligible")
    bad = _rows_differing(fused[0], two)
    require(not bad and fused[1] == [len(h) for h in qh],
            f"the fused mesh path differs from the two-stage one: {bad[:8]}")
    record("fused_mesh_match", wall, peak,
           f"; {len(queries)} queries, rows equal the two-stage mesh path's")
    del m

    # ---- the routed ingest, and once more through the overflow replay
    def ingest_all(cap=None):
        h = HashTable()
        ing = DeviceIngest(h, Analyzer(device=dev), ndev, cap_override=cap)
        for i in range(0, len(tracks), chunk):
            ing.consume_chunk(ing.dispatch_chunk(
                [(n, "wav", x) for n, x in zip(names[i: i + chunk],
                                               tracks[i: i + chunk])], print))
        ing.finalize()
        return h, ing.replays

    (got, replays), wall, peak = _timed(torch, dev, ingest_all, warm=False)
    require(_tables_equal(got, ht) and replays == 0,
            f"DeviceIngest(ndev={ndev}) differs from the host store "
            f"(replays {replays})")
    audio = sum(len(x) for x in tracks) / SR
    record("routed_ingest", wall, peak,
           f"; {audio / wall:.1f} audio-s/s, equal to the host store, no "
           f"replay")
    (got, replays), wall, peak = _timed(
        torch, dev, lambda: ingest_all(replay_cap), warm=False)
    require(replays > 0,
            f"a routing cap of {replay_cap} did not force the replay")
    require(_tables_equal(got, ht), "the overflow replay's table differs "
                                    "from the host store's")
    record("routed_ingest_replayed", wall, peak,
           f"; routing cap {replay_cap}: {replays} chunks replayed through "
           f"the replicated store, equal to the host store")
    del got

    # ---- merge as resharding
    half = len(hashes) // 2
    parts = []
    for lo, hi in ((0, half), (half, len(hashes))):
        h = HashTable()
        for i in range(lo, hi):
            h.store_vectorized(names[i], hashes[i])
        parts.append(h)
    ht_a, ht_b = parts
    table, counts, tcfg = sharded.upload_sharded(ht_a, mesh)
    merge_fn = sharded.sharded_merge_fn(mesh, tcfg)
    hs, es, vs = sharded.entry_streams(ht_b, id_offset=len(ht_a.names))
    _r, wall, peak = _timed(torch, dev,
                            lambda: merge_fn(table, counts, hs, es, vs),
                            warm=False)
    ht_a.merge(ht_b)
    keep = ht_b.counts <= ht_b.depth
    require(np.array_equal(sharded.gather_sharded(mesh, table)
                           .view(np.uint32), ht_a.table)
            and np.array_equal(sharded.gather_sharded(mesh, counts)[keep],
                               ht_a.counts[keep]),
            "sharded_merge_fn differs from HashTable.merge")
    record("sharded_merge", wall, peak,
           f"; {len(hs)} entries of {len(hashes) - half} tracks, equal to "
           f"HashTable.merge")
    del table, counts, parts, ht_a, ht_b

    # ---- data-parallel fingerprint
    _idxs, batch, lens = an.stage_groups(tracks[:chunk])[0]
    whole = pipe.fingerprint_batch(torch.as_tensor(batch, device=dev),
                                   torch.as_tensor(lens, device=dev),
                                   an.config)
    dp = sharded.dp_fingerprint_fn(mesh, an.config)
    parts, wall, peak = _timed(torch, dev, lambda: dp(batch, lens))
    require(all(torch.equal(a, b) for a, b in zip(parts, whole)),
            "dp_fingerprint_fn differs from fingerprint_batch")
    record("dp_fingerprint", wall, peak,
           f"; {chunk} x 30 s tracks in {ndev} blocks, equal to one "
           f"fingerprint_batch bit for bit")

    out.update(mesh_graphs(torch, ctx, dev, ndev, chunk, replay_cap))

    launches = _counts()
    print(f"sharded path: launches {launches}")
    require(launches["prune_fwd_bwd"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0 and launches["seg_scan"] > 0,
            f"a kernel was not launched on the sharded path: {launches}")
    rec["_paths"]["sharded"] = launches
    return {"sharded": out}


def _key_mib(cache) -> dict:
    """{key: [capture s, MiB held]} of a graph cache, keyed by its inputs'
    shapes."""
    cap = cache.capture_seconds()
    return {" ".join("x".join(map(str, sh)) for sh, _dt in k[0]):
            [round(cap[k], 4), round(b / 2**20, 1)]
            for k, b in cache.held_by_key().items()}


def _cuda_top(torch, fn, n: int = 6) -> list:
    """The n kernel names with the most device time in one fn() under
    torch.profiler: [(name, events, device ms)]."""
    import torch.profiler as tp

    with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                tp.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by: dict = {}
    for e in _device_events(torch, prof):
        c, t = by.get(e.name, (0, 0.0))
        by[e.name] = (c + 1, t + e.device_time / 1e3)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:n]
    return [(name[:48], c, round(t, 3)) for name, (c, t) in top]


def _launch_delta(before: dict) -> dict:
    now = _counts()
    return {k: now[k] - before.get(k, 0) for k in GRAPH_KERNELS}


def mesh_graphs(torch, ctx, dev, ndev: int, chunk: int,
                replay_cap: int) -> dict:
    """The sharded paths as CUDA graphs on `ndev` logical shards of the
    card, eager against replayed in turns: the two-stage mesh vote (RLE
    exchange, plane off and on; hist core), the fused mesh match, the
    routed ingest, its overflow replay and ShardedStore.  Gates: every
    replay's rows or table bit-equal to the eager run's and to one
    device's (or the host store's); one fused-mesh replay and one
    routed-ingest replay run K1, K2 and K3 once per shard and K4 its
    recorded count, the fused-mesh one no torch scan (torch.profiler
    kernel events, and the launch counts a replay adds).  Reports each
    kind's host dispatch of one call (median of 30), the batch and ingest
    rates, and each mesh key's capture seconds and MiB."""
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match import matcher as M
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.models.ingest import DeviceIngest
    from audfprint_torch.parallel import sharded

    smi = nvidia_smi_line()
    ht, an, tracks = ctx["ht"], ctx["an"], ctx["tracks"]
    hashes, queries, qh = ctx["hashes"], ctx["queries"], ctx["qhashes"]
    names = [f"track{i}" for i in range(len(tracks))]
    out: dict = {"mesh_dispatch_ms": {}, "mesh_keys": {}}
    mode_ctx = {"eager": eager_graphs, "replay": contextlib.nullcontext}

    def turns(fn, rounds):
        """fn(mode) for eager and replay in turns -> {mode: [s, ...]},
        {mode: last result}."""
        walls = {m: [] for m in mode_ctx}
        last = {}
        for _r in range(rounds):
            for mode, cm in mode_ctx.items():
                with cm():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    last[mode] = fn(mode)
                    torch.cuda.synchronize()
                    walls[mode].append(time.perf_counter() - t0)
        return walls, last

    one = M.Matcher(device=dev, ndev=1, verbose=0)
    ref = one.match_hashes_batch(ht, qh)
    ref_fused = one.match_samples_fused(an, ht, queries)
    require(ref_fused is not None, "the one-device fused path was not "
                                   "eligible")
    del one

    # ---- the two-stage mesh vote: RLE exchange (plane off, on), hist
    for name, core, plane in (("rle", "sorted", False),
                              ("rle, plane", "sorted", True),
                              ("hist", "hist", False)):
        m = M.Matcher(device=dev, ndev=ndev, verbose=0)
        m.force_core = "hist" if core == "hist" else None
        m.use_hpi_plane = plane or None
        m.match_hashes_batch(ht, qh)                       # capture
        require(m._mesh_votes.replays and m._mesh_votes.keys(),
                f"the {name} mesh vote captured no graph")

        def batch(mode, m=m, name=name):
            rows = m.match_hashes_batch(ht, qh)
            bad = _rows_differing(rows, ref)
            require(not bad, f"the {name} mesh vote ({mode}) differs from "
                             f"one device: queries {bad[:8]}")
            return rows

        walls, _last = turns(batch, 3)
        (table, counts, hpi, tcfg, ncap, mesh, pl) = m._device_state(ht)
        Q = M._next_pow2(len(qh[0]), 128)
        qt_cap = M._next_pow2(int(qh[0][:, 0].max()) + 1, M._QT_FLOOR)
        inputs = padded_queries(qh[:1], Q)
        if core == "sorted":
            inputs = M._pad_rows(inputs, ndev)
        state = (table, counts, hpi, pl if core == "sorted" else None)
        static = (mesh, tcfg, m._mcfg(qt_cap, ncap), core)
        m._mesh_votes(inputs, state, static)                # capture
        require(torch.equal(m._mesh_votes(inputs, state, static),
                            M._mesh_vote(*inputs, *state, *static)),
                f"the {name} mesh vote's replay differs from its eager "
                "function")
        med = _in_turns(torch, {
            "eager": lambda: M._mesh_vote(*inputs, *state, *static),
            "replay": lambda: m._mesh_votes(inputs, state, static)},
            rounds=3)
        out["mesh_dispatch_ms"][f"vote {name}"] = med
        out["mesh_keys"][f"vote {name}"] = _key_mib(m._mesh_votes)
        out[f"mesh_vote_{name}_ms"] = {k: [round(1e3 * w, 3) for w in v]
                                       for k, v in walls.items()}
        print(f"mesh graphs [{smi}] two-stage vote, {name}, {ndev} "
              f"shards: 64-query batch ms by round, eager "
              f"{out[f'mesh_vote_{name}_ms']['eager']}, replay "
              f"{out[f'mesh_vote_{name}_ms']['replay']}; rows equal one "
              f"device's both ways; one 1-query vote's host dispatch ms "
              f"(median of 30, eager / replay) {med['eager']:.3f} / "
              f"{med['replay']:.3f}; keys [capture s, MiB] "
              f"{out['mesh_keys'][f'vote {name}']}")
        del m

    # ---- the fused mesh match
    m = M.Matcher(device=dev, ndev=ndev, verbose=0)
    m.match_samples_fused(an, ht, queries)                 # capture

    def fused(mode):
        got = m.match_samples_fused(an, ht, queries)
        bad = _rows_differing(got[0], ref_fused[0])
        require(not bad and got[1] == ref_fused[1],
                f"the fused mesh match ({mode}) differs from one device: "
                f"queries {bad[:8]}")
        return got

    walls, _last = turns(fused, 3)
    (table, counts, hpi, tcfg, ncap, mesh, pl) = m._device_state(ht)
    state = (table, counts, hpi, pl)
    _i, b1, l1 = an.stage_groups([to_pcm(queries[0])])[0]
    b1, l1 = M._pad_rows((b1, l1), ndev)
    qcap = M._next_pow2(int(b1.shape[1] / an.target_sr * an.density * 1.5)
                        + 64, 128)
    static = (mesh, an.config, tcfg, m._mcfg(M._QT_FLOOR, ncap), qcap)
    m._mesh_graphs((b1, l1), state, static)                # capture

    def replay1():
        return m._mesh_graphs((b1, l1), state, static)

    def eager1():
        return M._mesh_fused_match(b1, l1, *state, *static)

    require(torch.equal(replay1(), eager1()),
            "the fused mesh match's replay differs from its eager function")
    before = _counts()
    replay1()
    torch.cuda.synchronize()
    counted = _launch_delta(before)
    _n, _ms, seen = _cuda_events(torch, replay1)
    require(all(seen[k] == ndev and counted[k] == ndev
                for k in FP_KERNELS)
            and seen["seg_scan"] == counted["seg_scan"] > 0
            and seen[TORCH_SCAN] == 0,
            f"one fused-mesh replay ran the kernels {seen} times (counted "
            f"{counted}), not K1, K2 and K3 {ndev} each, K4 its recorded "
            f"count and torch's scan never")
    med = _in_turns(torch, {"eager": eager1, "replay": replay1}, rounds=3)
    ev = {name: _cuda_events(torch, fn)[:2]
          for name, fn in (("eager", eager1), ("replay", replay1))}
    out["mesh_fused_top_kernels"] = _cuda_top(torch, replay1)
    out["mesh_dispatch_ms"]["fused"] = med
    out["mesh_fused_device_ms"] = {k: v[1] for k, v in ev.items()}
    out["mesh_keys"]["fused"] = _key_mib(m._mesh_graphs)
    out["mesh_fused_ms"] = {k: [round(1e3 * w, 3) for w in v]
                            for k, v in walls.items()}
    print(f"mesh graphs [{smi}] fused match, {ndev} shards: 64 x 10 s "
          f"queries, ms by round, eager {out['mesh_fused_ms']['eager']}, "
          f"replay {out['mesh_fused_ms']['replay']}; rows equal one "
          f"device's both ways; one replay of a 1 x 10 s int16 query ran "
          f"{seen} (profiler; counted {counted}); its host dispatch ms "
          f"(median of 30, eager / replay) {med['eager']:.3f} / "
          f"{med['replay']:.3f}, device events {ev['eager'][0]} / "
          f"{ev['replay'][0]}, device busy ms {ev['eager'][1]:.3f} / "
          f"{ev['replay'][1]:.3f} (with torch's scans in place of K4: "
          f"18.591 replayed); "
          f"keys [capture s, MiB] "
          f"{out['mesh_keys']['fused']}; the replay's kernels with the most "
          f"device time (name, events, ms) {out['mesh_fused_top_kernels']}")
    del m

    # ---- the routed ingest, and its overflow replay
    audio = sum(len(x) for x in tracks) / SR

    def ingest(mode, cap=None):
        h = HashTable()
        ing = DeviceIngest(h, Analyzer(device=dev), ndev, cap_override=cap)
        for i in range(0, len(tracks), chunk):
            ing.consume_chunk(ing.dispatch_chunk(
                [(n, "wav", x) for n, x in zip(names[i: i + chunk],
                                               tracks[i: i + chunk])],
                print))
        ing.finalize()
        require(_tables_equal(h, ht) and (ing.replays > 0) == (cap is not
                                                               None),
                f"the routed ingest ({mode}, cap {cap}) differs from the "
                f"host store (overflow replays {ing.replays})")
        return ing

    walls, last = turns(ingest, 2)
    ing = last["replay"]
    out["mesh_ingest_audio_s_per_s"] = {
        k: [round(audio / w, 1) for w in v] for k, v in walls.items()}
    out["mesh_keys"]["routed ingest"] = _key_mib(ing._ingest)
    ing_t = DeviceIngest(HashTable(), Analyzer(device=dev), ndev)
    slot = ing_t._stage_chunk(tracks[:chunk])
    batch, lens = slot.batch, slot.lens
    ids = np.arange(len(lens), dtype=np.int32)
    st_i = (ing_t.table, ing_t.counts)
    static = (ing_t.mesh, an.config, ing_t.cfg, None)
    ing_t._ingest((batch, lens, ids), st_i, static)        # capture

    def ing_replay():
        return ing_t._ingest((batch, lens, ids), st_i, static)

    def ing_eager():
        return ing_t._ingest.fn(batch, lens, ids, *st_i, *static)

    before = _counts()
    ing_replay()
    torch.cuda.synchronize()
    counted = _launch_delta(before)
    _n, _ms, seen = _cuda_events(torch, ing_replay)
    require(all(seen[k] == ndev and counted[k] == ndev
                for k in FP_KERNELS)
            and seen["seg_scan"] == counted["seg_scan"] > 0,
            f"one routed-ingest replay ran the kernels {seen} times "
            f"(counted {counted}), not K1, K2 and K3 {ndev} each and K4 "
            f"its recorded count")
    med = _in_turns(torch, {"eager": ing_eager, "replay": ing_replay},
                    rounds=3, calls=3)
    out["mesh_dispatch_ms"]["routed ingest"] = med
    del ing_t
    print(f"mesh graphs [{smi}] routed ingest, {ndev} shards, "
          f"{len(tracks)} x 30 s in chunks of {chunk}: audio-s/s by round "
          f"{out['mesh_ingest_audio_s_per_s']}; tables equal the host "
          f"store's both ways; one replay ran {seen} (profiler; counted "
          f"{counted}); one chunk's host dispatch ms (median of 9, eager / "
          f"replay) {med['eager']:.3f} / {med['replay']:.3f}; keys "
          f"[capture s, MiB] {out['mesh_keys']['routed ingest']}")

    walls, last = turns(lambda mode: ingest(mode, replay_cap), 1)
    ing = last["replay"]
    out["mesh_keys"]["overflow replay"] = _key_mib(ing._replay)
    out["mesh_overflow_s"] = {k: [round(w, 3) for w in v]
                              for k, v in walls.items()}
    print(f"mesh graphs [{smi}] routed ingest at routing cap {replay_cap}, "
          f"every chunk replayed through the dp fingerprint and the "
          f"replicated store: s eager / replay "
          f"{out['mesh_overflow_s']['eager']} / "
          f"{out['mesh_overflow_s']['replay']}; tables equal the host "
          f"store's; overflow key [capture s, MiB] "
          f"{out['mesh_keys']['overflow replay']}")
    del ing, last

    # ---- ShardedStore
    def store(mode):
        h = HashTable()
        st = sharded.ShardedStore(h, sharded.make_mesh(ndev, [dev]))
        for i in range(0, len(hashes), chunk):
            st.store_chunk(list(zip(names[i: i + chunk],
                                    hashes[i: i + chunk])))
        st.finalize()
        require(_tables_equal(h, ht), f"ShardedStore ({mode}) differs from "
                                      f"the host store")
        return st

    walls, last = turns(store, 1)
    out["mesh_keys"]["store"] = _key_mib(last["replay"]._graphs)
    out["mesh_store_s"] = {k: [round(w, 3) for w in v]
                           for k, v in walls.items()}
    print(f"mesh graphs [{smi}] ShardedStore, {len(hashes)} tracks' "
          f"hashes: s eager / replay {out['mesh_store_s']['eager']} / "
          f"{out['mesh_store_s']['replay']}; tables equal the host store's; "
          f"keys [capture s, MiB] {out['mesh_keys']['store']}")
    print(f"mesh graphs [{smi}]: host dispatch ms of one call, eager / "
          f"replay: " + "; ".join(
              f"{k} {v['eager']:.3f} / {v['replay']:.3f}"
              for k, v in out["mesh_dispatch_ms"].items()))
    return out


def _gloo_rank(argv: list) -> int:
    """One process of phase_process_boundary (python3 chip_smoke.py
    --gloo-rank RANK NPROC PORT DIR DEVICE): joins the gloo group, holds
    two logical shards on DEVICE, stores the tracks' hashes through
    ShardedStore and matches the queries through Matcher over the global
    mesh; writes its table and rows to DIR."""
    rank, nproc, port = (int(a) for a in argv[:3])
    d, device = argv[3], argv[4]
    import torch

    sys.path.insert(0, ROOT)
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match.matcher import Matcher
    from audfprint_torch.parallel import multihost, sharded

    data = np.load(os.path.join(d, "gloo_data.npz"))
    cuts = data["cuts"]
    rows = [data["rows"][a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    n_tracks = int(data["n_tracks"])
    hashes, qh = rows[:n_tracks], rows[n_tracks:]
    multihost.initialize(f"localhost:{port}", nproc, rank, backend="gloo",
                         timeout_s=240)
    mesh = multihost.global_table_mesh([device] * 2)
    t0 = time.time()
    ht = HashTable()
    st = sharded.ShardedStore(ht, mesh)
    st.store_chunk([(f"track{i}", h) for i, h in enumerate(hashes)])
    st.finalize()
    t_store = time.time() - t0
    m = Matcher(device=device, ndev=mesh.size, verbose=0,
                exact_count=True, find_time_range=True, max_returns=4)
    m.match_hashes_batch(ht, qh)                     # upload, warm
    _sync(torch, device)
    t0 = time.time()
    got = m.match_hashes_batch(ht, qh)
    _sync(torch, device)
    t_match = time.time() - t0
    require(m._device_state(ht)[5].size == 2 * nproc, "no global mesh")
    np.savez(os.path.join(d, f"gloo_rank{rank}.npz"),
             table=ht.table, counts=ht.counts, n=[len(r) for r in got],
             rows=np.concatenate(got) if got else np.zeros((0, 6)))
    multihost.shutdown()
    print(f"GLOO_RANK_OK rank={rank} shards={mesh.size} store "
          f"{t_store:.3f} s match {t_match:.3f} s", flush=True)
    return 0


def phase_process_boundary(torch, ctx, dev, d, nproc: int = 2,
                           n_tracks: int = 300, n_q: int = 16) -> dict:
    """Two processes of two shards each over gloo, both on the card: they
    store n_tracks tracks' hashes and match n_q queries across the process
    boundary; every rank's table equals the host store's and its rows the
    single-device rows.  The kernels are built by now, and the ranks
    fingerprint nothing."""
    import socket

    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match.matcher import Matcher

    hashes = ctx["hashes"][:n_tracks]
    sel = [i for i, t in enumerate(ctx["qsel"]) if t < n_tracks]
    qh = [ctx["qhashes"][i] for i in sel][:n_q]
    qh += ctx["qhashes"][: n_q - len(qh)]        # the rest match nothing
    rows = list(hashes) + qh
    np.savez(os.path.join(d, "gloo_data.npz"),
             rows=np.concatenate(rows),
             cuts=np.cumsum([0] + [len(r) for r in rows]), n_tracks=n_tracks)
    ht = HashTable()
    for i, h in enumerate(hashes):
        ht.store_vectorized(f"track{i}", h)
    want = Matcher(device=dev, ndev=1, verbose=0, exact_count=True,
                   find_time_range=True, max_returns=4).match_hashes_batch(
        ht, qh)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--gloo-rank",
         str(r), str(nproc), str(port), d, str(torch.device(dev))], cwd=ROOT,
        env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=360)[0])
            except subprocess.TimeoutExpired:
                outs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        require(p.returncode == 0 and f"GLOO_RANK_OK rank={r}" in o,
                f"gloo rank {r} failed (rc {p.returncode}): {o[-2000:]}")
        print(o.strip().splitlines()[-1])
    n_rows = 0
    for r in range(nproc):
        got = np.load(os.path.join(d, f"gloo_rank{r}.npz"))
        require(np.array_equal(got["table"], ht.table)
                and np.array_equal(got["counts"], ht.counts),
                f"gloo rank {r}: the sharded store differs from the host "
                f"store")
        cuts = np.cumsum([0] + list(got["n"]))
        rr = [got["rows"][a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        bad = _rows_differing(rr, want)
        require(not bad, f"gloo rank {r}: rows differ from the single-device "
                         f"rows, queries {bad[:8]}")
        n_rows = sum(len(w) for w in want)
    top = sum(len(w) > 0 for w in want)
    print(f"process boundary [{nvidia_smi_line()}]: {nproc} processes x 2 "
          f"shards over gloo on one card, {n_tracks} tracks stored and "
          f"{len(qh)} queries matched ({top} with a match, {n_rows} rows) in "
          f"{wall:.1f} s wall, process start included; every rank's table "
          f"equals the host store and its rows the single-device rows")
    return {"gloo_ranks_wall_s": wall}


def _jaccard(a: np.ndarray, b: np.ndarray):
    sa = {tuple(r) for r in a.tolist()}
    sb = {tuple(r) for r in b.tolist()}
    return len(sa & sb) / max(1, len(sa | sb)), len(sa ^ sb)


def _launch_counters() -> tuple:
    """The kernels' launch counts: K2 (spectro), K1 and K1f (cuda_peaks),
    K3 (landmarks); a graph replay adds the launches it recorded."""
    from audfprint_torch.ops.pipeline import launch_counters

    return launch_counters()


def _counts_zero() -> None:
    for d in _launch_counters():
        for key in d:
            d[key] = 0


def _counts() -> dict:
    return {k: v for d in _launch_counters() for k, v in d.items()}


# `python -m audfprint_torch` inside eager_graphs(), so that a process's
# eager cost can be timed beside its graphs' (oneshot_match)
_EAGER_MAIN = ("import runpy; from audfprint_torch.utils import graphs; "
               "graphs.captures = lambda device: False; "
               "runpy.run_module('audfprint_torch', run_name='__main__', "
               "alter_sys=True)")


def _cli(argv: list, timeout: int = 900, eager: bool = False) -> str:
    """python -m audfprint_torch <argv> as a subprocess (with the fused
    path's graphs off when `eager`); returns stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = ["-c", _EAGER_MAIN] if eager else ["-m", "audfprint_torch"]
    proc = subprocess.run([sys.executable, *cmd, *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    require(proc.returncode == 0,
            f"CLI {argv[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def phase_streaming(torch, rec: dict, paths: dict, dev, long_sec=7200.0,
                    excerpt_sec=(30.0, 3540.0, 7080.0)) -> dict:
    """A seeded long WAV through the streamed route: in-process (counted,
    timed, device memory), at two chunk sizes, against the in-memory path,
    then through the CLI as subprocesses with rank-0 matches of excerpts."""
    from audfprint_torch.utils.audio import audio_write_wav
    from audfprint_torch.models.analyzer import Analyzer

    d = paths["dir"]
    rng = np.random.default_rng(SEED + 4)
    t0 = time.time()
    x = synth_track(rng, long_sec)
    long_wav = os.path.join(d, "long.wav")
    audio_write_wav(long_wav, x, SR)
    songs = []
    for i in range(2):
        songs.append(os.path.join(d, f"song{i}.wav"))
        audio_write_wav(songs[-1], synth_track(rng, 20.0), SR)
    queries, starts = [], []
    for j, sec in enumerate(excerpt_sec):
        s0 = 256 * int(round(sec * SR / 256))
        queries.append(os.path.join(d, f"excerpt{j}.wav"))
        audio_write_wav(queries[-1], x[s0: s0 + 10 * SR], SR)
        starts.append(s0 // 256)
    n = 8191 * 256 + 512                         # one 8192-frame chunk
    prune_on_real(torch, rec, x[None, len(x) // 2: len(x) // 2 + n],
                  np.array([n]), carry=True)
    # a second long file of the same length, for the keys it should reuse
    long2 = os.path.join(d, "long_reversed.wav")
    audio_write_wav(long2, x[::-1].copy(), SR)
    # and two shorter ones, for a group of four
    group = [long_wav, long2]
    for name, part in (("long_head", x[: len(x) * 3 // 4]),
                       ("long_tail", x[len(x) // 3:])):
        group.append(os.path.join(d, f"{name}.wav"))
        audio_write_wav(group[-1], part, SR)
    del x
    print(f"streaming: wrote a {long_sec:g} s WAV "
          f"({os.path.getsize(long_wav) / 1e6:.1f} MB) in "
          f"{time.time() - t0:.1f} s (host numpy, not timed)")

    an = Analyzer(device=dev)
    an.stream_chunk_frames = 8192
    # ---- the streamed path, counted ----
    _counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    h8192 = an.wavfile2hashes_streaming(long_wav)
    torch.cuda.synchronize()
    t_stream = time.time() - t0
    launches = _counts()
    peak_stream = torch.cuda.max_memory_allocated()
    require(launches["prune_fwd_carry"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0,
            f"the streamed route did not launch K1f, K2 and K3: {launches}")
    dur = an.soundfiledur
    print(f"streamed {dur:.1f} s: {len(h8192)} hashes in {t_stream:.3f} s = "
          f"{dur / t_stream:.1f} audio-s/s; device memory peak "
          f"{peak_stream / 2**20:.1f} MiB; launches {launches}")

    streaming_graphs(torch, an, long_wav, long2, h8192, dev)
    streaming_group(torch, an, group, h8192, dev)

    t0 = time.time()
    h2048 = an.wavfile2hashes_streaming(long_wav, chunk_frames=2048)
    t_2048 = time.time() - t0
    same = np.array_equal(h8192, h2048)
    jac_c, ndiff_c = _jaccard(h8192, h2048)
    print(f"chunk-size invariance, 8192 vs 2048 frames: identical {same}, "
          f"{ndiff_c} hashes differ, Jaccard {jac_c:.6f} "
          f"(2048-frame run {t_2048:.3f} s)")
    require(same, f"chunk sizes 8192 and 2048 give different hashes "
                  f"({ndiff_c} differ)")

    samples = an.read_audio(long_wav)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    h_mem = an.samples_batch2hashes([samples])[0]
    torch.cuda.synchronize()
    t_mem = time.time() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    del samples
    jac, ndiff = _jaccard(h8192, h_mem)
    print(f"in-memory path on the same file: {len(h_mem)} hashes in "
          f"{t_mem:.3f} s, device memory peak {peak_mem / 2**20:.1f} MiB; "
          f"streamed vs in-memory Jaccard {jac:.6f}, {ndiff} hashes differ")
    require(jac > 0.9, f"streamed vs in-memory Jaccard {jac} <= 0.9")

    # ---- the CLI, as a user runs it ----
    db = os.path.join(d, "long.pklz")
    metrics = os.path.join(d, "long_metrics.json")
    t0 = time.time()
    out = _cli(["new", "-d", db, long_wav, *songs, "--json-metrics", metrics])
    t_cli = time.time() - t0
    with open(metrics) as f:
        cli_launches = json.load(f)["kernel_launches"]
    print("CLI new (subprocess, " + f"{t_cli:.1f} s):\n" + out.rstrip())
    require(cli_launches.get("prune_fwd_carry", 0) > 0
            and cli_launches.get("hpf_scan", 0) > 0
            and cli_launches.get("pair_scan", 0) > 0,
            f"CLI new did not stream the long WAV: launches {cli_launches}")
    out = _cli(["match", "-d", db, *queries])
    print("CLI match (subprocess):\n" + out.rstrip())
    hop = 256 / SR
    for q, f0 in zip(queries, starts):
        m = re.search(re.escape(q) + r" .*? as \S+long\.wav at (-?[\d.]+) s "
                      r".* at rank 0", out)
        require(m is not None, f"{os.path.basename(q)}: no rank-0 match of "
                               "long.wav")
        want = (f0 % 16384) * hop
        require(abs(float(m.group(1)) - want) <= 0.1,
                f"{os.path.basename(q)}: offset {m.group(1)} s, expected "
                f"{want:.2f} s (start modulo maxtime)")
    rec["_paths"]["streaming"] = launches
    return {"stream_audio_s_per_s": dur / t_stream, "stream_wall_s": t_stream,
            "stream_peak_mib": peak_stream / 2**20,
            "inmemory_peak_mib": peak_mem / 2**20,
            "inmemory_wall_s": t_mem, "stream_vs_inmemory_jaccard": jac,
            "stream_vs_inmemory_differing": ndiff,
            "cli_new_long_wall_s": t_cli}


def streaming_graphs(torch, an, long_wav: str, long2: str, h8192, dev,
                     rounds: int = 2) -> None:
    """The streamed route's graphs on the 7,200 s file: its hashes equal
    eager and replayed, a second file of its length captures no key, the
    stats and peaks passes' host dispatch of one chunk eager against
    replay, and one peaks replay's kernels under torch.profiler."""
    from audfprint_torch.models import streaming as STM
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.utils import graphs

    smi = nvidia_smi_line()
    sg = STM.stream_graphs(an.device)
    keys = sg.keys()
    walls = {"eager": [], "replay": []}
    for _r in range(rounds):
        for mode in ("eager", "replay"):
            with (eager_graphs() if mode == "eager"
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                h = an.wavfile2hashes_streaming(long_wav)
                walls[mode].append(time.perf_counter() - t0)
            require(np.array_equal(h, h8192),
                    f"streamed hashes ({mode}) differ from the first run's")
    require(sg.keys() == keys, "a streamed file of the same shape was "
                               "captured again")
    caps = graphs.counts["captures"]
    h2 = an.wavfile2hashes_streaming(long2)
    require(graphs.counts["captures"] == caps,
            f"a second streamed file captured "
            f"{graphs.counts['captures'] - caps} keys: {sg.keys()[len(keys):]}")
    require(len(h2) > len(h8192) // 2, "the reversed file gave few hashes")

    # one chunk's passes, host dispatch eager against replay
    cfg = an.config
    src = STM.open_stream_source(long_wav, an.target_sr)
    rd = STM._ChunkReader([src], cfg, an.stream_chunk_frames, dev)
    audio, nf, _nf = rd.chunk_dev(1)
    src.close()
    S = len(rd.offs)
    z = torch.zeros((S, cfg.n_bins), dtype=torch.float32, device=dev)
    zs, ones = (torch.full((S,), v, dtype=torch.float32, device=dev)
                for v in (0.0, 1.0))
    gvec = CP.gauss_vector_on(cfg, dev)
    nbytes = STM._chunk_bytes(1, rd.Nc, cfg)

    def peaks():
        return sg.peaks((audio, nf, ones, zs, z, z, z), (gvec,),
                        (cfg, False), nbytes)

    def stats():
        return sg.stats((audio, nf), (), (cfg,), nbytes)

    def eager(fn):
        def run():
            with eager_graphs():
                return fn()
        return run

    peaks(), stats()
    med = _in_turns(torch, {"stats eager": eager(stats), "stats replay": stats,
                            "peaks eager": eager(peaks),
                            "peaks replay": peaks})
    _n, _ms, seen = _cuda_events(torch, peaks, ("prune_fwd_carry",
                                                "hpf_scan"))
    require(all(v == 1 for v in seen.values()),
            f"one peaks replay ran the kernels {seen} times, not once each")
    dur = an.soundfiledur
    print(f"streaming graphs [{smi}]: {len(keys)} keys "
          f"{[_key_shapes(k) for k in keys]}; the {dur:.0f} s file's "
          f"hashes equal eager and replayed; wall s by round, eager "
          f"{[round(x, 3) for x in walls['eager']]}, replay "
          f"{[round(x, 3) for x in walls['replay']]}; a second file of its "
          f"length captured 0 keys; one {rd.Tc}-frame chunk's host "
          f"dispatch ms (median of 50 calls in 5 rounds) "
          f"{ {k: round(v, 3) for k, v in med.items()} }; one peaks replay "
          f"ran {seen} (torch.profiler)")


def streaming_group(torch, an, wavs: list, h_first, dev) -> None:
    """Four long WAVs hashed as one group (Analyzer.wavfiles2hashes_streaming:
    their rows in one stats pass and one peaks pass) equal each hashed
    alone, with one group of 4 files counted and K1f launched once a chunk
    for all four."""
    from audfprint_torch.utils import timing

    alone, walls = [h_first], []
    for w in wavs[1:]:
        t0 = time.perf_counter()
        alone.append(an.wavfile2hashes_streaming(w))
        walls.append(time.perf_counter() - t0)
    an.wavfiles2hashes_streaming(wavs)              # the group's keys, warm
    _counts_zero()
    timing.TRACER.reset()
    timing.TRACER.on = True
    try:
        _sync(torch, dev)
        t0 = time.perf_counter()
        got = an.wavfiles2hashes_streaming(wavs)
        _sync(torch, dev)
        t_group = time.perf_counter() - t0
    finally:
        timing.TRACER.on = False
    c = dict(timing.TRACER.counters)
    timing.TRACER.reset()
    launches = _counts()
    for w, g, h in zip(wavs, got, alone):
        require(not isinstance(g, Exception), f"{w}: {g}")
        require(np.array_equal(g[0], h),
                f"{os.path.basename(w)}: its hashes in a group of "
                f"{len(wavs)} differ from its hashes alone")
    require((c.get("stream.groups"), c.get("stream.group_files"))
            == (1, len(wavs)), f"not one group of {len(wavs)} files: {c}")
    nchunks = c["stream.chunks"] // 2
    require(launches.get("prune_fwd_carry") == nchunks,
            f"K1f launched {launches.get('prune_fwd_carry')} times for "
            f"{nchunks} chunks of the group")
    print(f"streaming group [{nvidia_smi_line()}]: {len(wavs)} WAVs "
          f"({[len(h) for h in alone]} hashes) equal alone and in one "
          f"group; {nchunks} chunks a pass, K1f {launches['prune_fwd_carry']}"
          f" launches; group {t_group:.3f} s against "
          f"{sum(walls):.3f} s for the last {len(walls)} alone")


def _key_shapes(key) -> list:
    return [shape for shape, _dt in key[0]]


def _numpy_staged_store(an, chunks: list):
    """The device store with each chunk staged as it was before the
    pinned slots: a fresh zeroed NumPy batch, handed to the graph cache
    as host arrays (pinned there by a second copy), the counts fetched
    with a blocking copy; chunk by chunk -> (host table, each chunk's
    counts)."""
    from audfprint_torch import params as P
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.models import ingest as ING
    from audfprint_torch.models.analyzer import _bucket_len

    ht = HashTable()
    ing = ING.DeviceIngest(ht, an)
    pcfg, got = an.config, []
    for c in chunks:
        sigs = [x for _n, _k, x in c]
        batch = np.zeros((P.next_pow2(len(sigs), 8),
                          _bucket_len(max(map(len, sigs)))), np.int16)
        lens = np.zeros(len(batch), np.int32)
        ids = np.zeros(len(batch), np.int32)
        for row, (name, _k, x) in enumerate(c):
            batch[row, : len(x)] = x
            lens[row] = len(x)
            ids[row] = ing._assign_id(name, None)
        cnt = ing._ingest((batch, lens, ids), (ing.table, ing.counts),
                          (pcfg, ing.cfg),
                          ING._ingest_bytes(*batch.shape, pcfg))
        cnt = cnt.cpu().numpy()[: len(sigs)]
        for row in range(len(sigs)):
            ht.hashesperid[ids[row]] += int(cnt[row])
        got.append(cnt)
    ing.finalize()
    return ht, got


def device_store_slots(torch, an, tracks: list, dev) -> dict:
    """The device store through its reused pinned slots (DeviceIngest one
    chunk ahead, as `new --device-store`) over four int16 chunks of one
    key, the third shorter and with fewer rows than the second (its slot's
    stale tails and spare rows zeroed): the table, counts and each chunk's
    counts equal the same chunks staged through NumPy
    (_numpy_staged_store); 2 slots made and 2 reused; every replay's
    graph.pin span under 0.5 ms (no second copy of the batch); and, in a
    profiled pass, every chunk's counts copy starting before the next
    chunk's first device operation (tools/ingest_trace.fetch_order)."""
    import importlib.util

    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.models.ingest import DeviceIngest
    from audfprint_torch.utils import timing

    pcm = [to_pcm(x) for x in tracks[:968]]
    cut = int(25.0 * SR)                 # the same bucket as 30 s
    rows = ([(f"a{i}", x) for i, x in enumerate(pcm[:256])]
            + [(f"b{i}", x) for i, x in enumerate(pcm[256:512])]
            + [(f"c{i}", x[:cut]) for i, x in enumerate(pcm[512:712])]
            + [(f"d{i}", x) for i, x in enumerate(pcm[712:968])])
    bounds = (0, 256, 512, 712, 968)
    chunks = [[(n, "wav", x) for n, x in rows[a:b]]
              for a, b in zip(bounds, bounds[1:])]
    want, want_cnt = _numpy_staged_store(an, chunks)

    def one_ahead(ing):
        out, handle = [], None
        for c in chunks:
            h = ing.dispatch_chunk(c, print)
            if handle is not None:
                out.append([n for _name, n, _d in ing.consume_chunk(handle)])
            handle = h
        out.append([n for _name, n, _d in ing.consume_chunk(handle)])
        return out

    saved = timing.TRACER
    timing.TRACER = tr = timing.Tracer()
    tr.on = True
    try:
        ht = HashTable()
        ing = DeviceIngest(ht, an)
        got_cnt = one_ahead(ing)
        ing.finalize()
    finally:
        tr.on = False
        timing.TRACER = saved
    require(_tables_equal(ht, want),
            "the device store through pinned slots differs from the same "
            "chunks staged through NumPy")
    require(all(np.array_equal(g, w) for g, w in zip(got_cnt, want_cnt)),
            "a chunk's counts through pinned slots differ from the NumPy "
            "path's")
    made = tr.counters.get("ingest.slot_made", 0)
    reused = tr.counters.get("ingest.slot_reused", 0)
    require(made == 2 and reused == 2,
            f"one ahead over 4 chunks of one key made {made} slots and "
            f"reused {reused}, not 2 and 2")
    pins = [(b - a) / 1e6 for name, _i, _p, a, b in tr.records
            if name == "graph.pin"]
    require(len(pins) == 3 and max(pins) < 0.5,
            f"graph.pin of the 3 replays took {pins} ms, not all under 0.5")

    spec = importlib.util.spec_from_file_location(
        "ingest_trace", os.path.join(ROOT, "tools", "ingest_trace.py"))
    it = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(it)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_ahead(ing)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            order = it.fetch_order(json.load(f).get("traceEvents", []))
    require(len(order) == len(chunks) - 1
            and all(o["before_next_work"] for o in order),
            f"a chunk's counts copy did not start before the next chunk's "
            f"device work: {order}")
    del ing
    print(f"device store through pinned slots [{nvidia_smi_line()}]: "
          f"{len(chunks)} int16 chunks (256, 256, 200 x 25 s, 256) equal "
          f"the NumPy staging's table and counts; slots made {made}, reused "
          f"{reused}; graph.pin of the replays "
          f"{[round(p, 4) for p in pins]} ms; counts copy ahead of the "
          f"next chunk's work by own gap "
          f"{[round(o['own_gap_ms'], 4) for o in order]} ms")
    return {"slot_graph_pin_ms_max": max(pins),
            "slot_counts_own_gap_ms_max": max(o["own_gap_ms"]
                                              for o in order)}


def phase_device_store(torch, rec: dict, tracks: list, ht_host,
                       t_two_stage: float, dev, chunk: int = 256,
                       rounds: int = 3) -> dict:
    """The fused device store over config 2's tracks, each chunk after
    the first replaying the ingest key's captured graph: bit-identical to
    the host store both ways, the key's capture seconds and MiB, one
    replay's kernels under torch.profiler, and the rate eager against
    replay in turns; then `precompute -K`'s batched peaks (256 x 30 s),
    replayed against eager."""
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.models.ingest import DeviceIngest

    smi = nvidia_smi_line()
    an = Analyzer(device=dev)
    names = [f"track{i}" for i in range(len(tracks))]
    chunks = [[(n, "wav", x) for n, x in zip(names[i: i + chunk],
                                             tracks[i: i + chunk])]
              for i in range(0, len(tracks), chunk)]
    audio = sum(len(x) for x in tracks) / SR
    later = sum(len(x) for c in chunks[1:] for _n, _k, x in c) / SR

    def ingest(mode):
        """A fresh DeviceIngest over every chunk, then finalize -> (host
        table, ingest, whole wall s, wall s of the chunks after the
        first, which replay)."""
        ht = HashTable()
        with (eager_graphs() if mode == "eager"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ing = DeviceIngest(ht, an)
            for i, c in enumerate(chunks):
                ing.consume_chunk(ing.dispatch_chunk(c, print))
                if i == 0:
                    t1 = time.perf_counter()
            t2 = time.perf_counter()
            ing.finalize()
            t3 = time.perf_counter()
        return ht, ing, t3 - t0, t2 - t1

    warm, _ing, _w, _l = ingest("eager")       # allocator, cuFFT plans
    require(_tables_equal(warm, ht_host),
            "the eager device store's table differs from the host store's")
    del warm, _ing
    # ---- the device-store path, counted (the key's first call warms and
    # captures, the other chunks replay) ----
    _counts_zero()
    ht, ing, t_dev, _l = ingest("replay")
    launches = _counts()
    require(_tables_equal(ht, ht_host),
            "the replayed device store's table differs from the host store's")
    require(all(launches[k] == len(chunks) for k in FP_KERNELS)
            and launches["seg_scan"] >= len(chunks),
            f"the device-store path did not launch K1, K2 and K3 once a "
            f"chunk and K4 at least once a chunk: {launches}")
    rec["_paths"]["device_store"] = launches
    # the key of the full chunks (a short last chunk may have its own)
    cap_s = list(ing._ingest.capture_seconds().values())[0]
    held = list(ing._ingest.held_by_key().values())[0] / 2**20
    def chunk1():
        ing.consume_chunk(ing.dispatch_chunk(chunks[1], print))

    before = _counts()
    chunk1()
    torch.cuda.synchronize()
    counted = _launch_delta(before)
    n_ev, _ms, seen = _cuda_events(torch, chunk1)
    require(all(seen[k] == 1 for k in FP_KERNELS)
            and seen["seg_scan"] == counted["seg_scan"] > 0,
            f"one ingest replay ran the kernels {seen} times of {n_ev} "
            f"device events, not K1, K2 and K3 once each and K4 its "
            f"recorded {counted['seg_scan']}")
    del ing
    print(f"device store [{smi}], config 2: {len(tracks)} tracks in "
          f"{t_dev:.3f} s = {audio / t_dev:.1f} audio-s/s, its ingest key "
          f"({len(chunks[0])} x 30 s) captured in {cap_s:.3f} s, holding "
          f"{held:.1f} MiB (fingerprint + host store: "
          f"{audio / t_two_stage:.1f} audio-s/s); table, counts and "
          f"hashesperid equal the host store's; launches {launches}; one "
          f"replay ran {seen} (torch.profiler)")
    slots = device_store_slots(torch, an, tracks, dev)

    rate = {"eager": [], "replay": []}
    steady = {"eager": [], "replay": []}
    for _r in range(rounds):
        for mode in ("eager", "replay"):
            got, _ing, wall, wall_later = ingest(mode)
            require(_tables_equal(got, ht_host),
                    f"the device store ({mode}) differs from the host store")
            rate[mode].append(audio / wall)
            steady[mode].append(later / wall_later)
            del got, _ing
    print(f"device store [{smi}]: audio-s/s by round, whole run (DeviceIngest,"
          f" {len(chunks)} chunks, finalize; the replayed run captures its "
          f"key on its first chunk) eager {[round(x, 1) for x in rate['eager']]}"
          f", replay {[round(x, 1) for x in rate['replay']]}; chunks 2-"
          f"{len(chunks)} eager {[round(x, 1) for x in steady['eager']]}, "
          f"replay {[round(x, 1) for x in steady['replay']]}")

    # where a chunk's wall goes: the host's padded batch in its pinned
    # slot, the graph cache's staging of it (none: the slot is pinned),
    # the dispatch (both included) and the wait for the counts
    from audfprint_torch.utils import graphs
    sigs1 = [x for _n, _k, x in chunks[1]]
    parts = {}
    for mode in ("eager", "replay"):
        with (eager_graphs() if mode == "eager"
              else contextlib.nullcontext()):
            ing = DeviceIngest(HashTable(), an)
            ing.consume_chunk(ing.dispatch_chunk(chunks[1], print))
            ms = []
            for _r in range(3):
                t0 = time.perf_counter()
                slot = ing._stage_chunk(sigs1)
                t1 = time.perf_counter()
                graphs._staged(slot.batch, dev)
                ing._release(slot)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                handle = ing.dispatch_chunk(chunks[1], print)
                t3 = time.perf_counter()
                ing.consume_chunk(handle)
                t4 = time.perf_counter()
                ms.append([1e3 * (t1 - t0), 1e3 * (t2 - t1), 1e3 * (t3 - t2),
                           1e3 * (t4 - t3)])
            parts[mode] = [round(float(v), 1) for v in np.median(ms, axis=0)]
            del ing, slot
    print(f"device store [{smi}]: one {len(sigs1)} x 30 s chunk, host ms "
          f"(median of 3): pad the batch in its pinned slot, hand it to "
          f"the graph cache, "
          f"dispatch_chunk (both included), consume_chunk's wait: eager "
          f"{parts['eager']}, replay {parts['replay']}")

    # ---- precompute -K: the batched peaks, eager against replay ----
    sigs = tracks[:chunk]
    with eager_graphs():
        want = an.samples_batch2peaks(sigs)
    t0 = time.perf_counter()
    first = an.samples_batch2peaks(sigs)       # warms and captures
    t_first = time.perf_counter() - t0
    require(first == want, "precompute -K: the first call's peaks differ "
                           "from the eager call's")
    pk_rate = {"eager": [], "replay": []}
    for _r in range(rounds):
        for mode in ("eager", "replay"):
            with (eager_graphs() if mode == "eager"
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = an.samples_batch2peaks(sigs)
                pk_rate[mode].append(
                    len(sigs) * 30.0 / (time.perf_counter() - t0))
            require(got == want, f"precompute -K ({mode}): the peaks differ "
                                 "from the eager call's")
    # one replay, counted: K1 and K2, no pairing
    _counts_zero()
    require(an.samples_batch2peaks(sigs) == want,
            "precompute -K: the counted replay's peaks differ")
    pk_launches = _counts()
    require(pk_launches["prune_fwd_bwd"] == pk_launches["hpf_scan"] == 1,
            f"precompute -K's replay launched {pk_launches}")
    rec["_paths"]["precompute_k"] = pk_launches
    print(f"precompute -K [{smi}]: {len(sigs)} x 30 s, replayed peaks equal "
          f"the eager call's ({sum(map(len, want))} peaks); first call "
          f"(warm-up + capture) {t_first:.3f} s; audio-s/s by round, eager "
          f"{[round(x, 1) for x in pk_rate['eager']]}, replay "
          f"{[round(x, 1) for x in pk_rate['replay']]}; key holds "
          f"{an._peaks.held_bytes / 2**20:.1f} MiB; one replay launched "
          f"{pk_launches}")
    an._peaks.clear()
    return {"device_store_audio_s_per_s": audio / t_dev,
            "two_stage_audio_s_per_s": audio / t_two_stage,
            "device_store_rate": rate, "device_store_steady_rate": steady,
            "ingest_key_capture_s": cap_s, "ingest_key_mib": held,
            "device_store_chunk_ms": parts,
            "precompute_k_rate": pk_rate, "precompute_k_first_s": t_first,
            **slots}


def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(torch, dev) -> int:
    """Reset the peak statistic; returns the bytes allocated now."""
    if torch.device(dev).type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_mib(torch, dev, base: int = 0) -> float:
    """Peak device memory since _reset_peak, above `base` bytes."""
    if torch.device(dev).type != "cuda":
        return 0.0
    return (torch.cuda.max_memory_allocated() - base) / 2**20


# benchmarks/baseline_configs.py's config 3 (that module imports JAX):
# condition name -> _degrade kwargs, 3 s queries
CONFIG3_CONDITIONS = [
    ("clean", {}),
    ("snr10", {"snr_db": 10}),
    ("snr5", {"snr_db": 5}),
    ("snr0", {"snr_db": 0}),
    ("lowpass3k", {"lowpass_hz": 3000}),
    ("speed+2%", {"speed": 1.02}),
    ("speed-3%", {"speed": 0.97}),
    ("speed+4%", {"speed": 1.04}),
    ("snr5_lp3k_speed+2%", {"snr_db": 5, "lowpass_hz": 3000,
                            "speed": 1.02}),
]


def _degrade(clip, rng, snr_db=None, speed=None, lowpass_hz=None):
    """benchmarks/baseline_configs._degrade: speed change (time-scale and
    pitch), a 6th-order lowpass, additive noise at an SNR."""
    from scipy.signal import butter, resample_poly, sosfilt
    x = clip.astype(np.float64)
    if speed and speed != 1.0:
        up, dn = max(1, round(1000 / speed)), 1000
        x = resample_poly(x, up, dn)
    if lowpass_hz:
        sos = butter(6, lowpass_hz / (SR / 2), output="sos")
        x = sosfilt(sos, x)
    if snr_db is not None:
        sig_pow = float(np.mean(x ** 2))
        noise_pow = sig_pow / (10 ** (snr_db / 10))
        x = x + np.sqrt(noise_pow) * rng.standard_normal(len(x))
    return x.astype(np.float32)


def _pr(results, truths):
    """benchmarks/baseline_configs._pr: rank-0 precision and recall."""
    tp = sum(1 for r, t in zip(results, truths) if len(r) and r[0][0] == t)
    fp = sum(1 for r, t in zip(results, truths) if len(r) and r[0][0] != t)
    fn = sum(1 for r in results if not len(r))
    return tp / max(1, tp + fp), tp / max(1, tp + fp + fn)


def phase_config3(torch, rec, dev, n_tracks=1000, dur=30.0, nq=32,
                  qdur=3.0, chunk=8) -> dict:
    """BASELINE config 3 as benchmarks/baseline_configs.config3 runs it:
    its own corpus (bench.synth_batch tracks, seeds 0..n-1) in a default
    table, 3 s queries degraded 9 ways and fingerprinted by the
    noisy-query analyzer, matched plain, and the speed conditions again
    through the +/-4% sweep in chunks of 8 queries."""
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match.matcher import Matcher, sweep_factors
    from audfprint_torch.models import presets
    from audfprint_torch.models.analyzer import Analyzer

    t0 = time.time()
    tracks = _in_processes(harmonic_track, range(n_tracks),
                           [int(dur * SR)] * n_tracks)
    t_make = time.time() - t0
    t0 = time.time()
    hashes = Analyzer(device=dev).samples_batch2hashes(tracks)
    ht = HashTable()
    for i, h in enumerate(hashes):
        ht.store_vectorized(f"t{i}", h)
    print(f"config 3: made {n_tracks} x {dur:g} s harmonic tracks in "
          f"{t_make:.1f} s (host numpy, not timed); table of "
          f"{sum(len(h) for h in hashes)} hashes built in "
          f"{time.time() - t0:.2f} s")
    del hashes
    matcher = Matcher(device=dev)
    an4 = presets.make_analyzer("noisy-query", device=dev)
    rng = np.random.default_rng(2)
    starts = [int(rng.integers(0, int((dur - qdur - 1) * SR)))
              for _ in range(nq)]
    clean = [tracks[i][starts[i]: starts[i] + int(qdur * SR)].copy()
             for i in range(nq)]
    del tracks
    # warm-up outside the counted run: the 3 s bucket and the variants'
    warm = an4.samples_batch2hashes(clean[:chunk])
    matcher.match_samples_sweep(an4, ht, clean[:chunk], 4.0,
                                base_hashes=warm)
    _sync(torch, dev)
    # ---- config 3 with the sweep, counted ----
    _counts_zero()
    curve, conds = {}, {}
    for name, kw in CONFIG3_CONDITIONS:
        queries = [_degrade(c, rng, **kw) for c in clean]
        conds[name] = queries
        truths = list(range(nq))
        t0 = time.time()
        qh = an4.samples_batch2hashes(queries)
        t_fp = time.time() - t0
        t0 = time.time()
        results = matcher.match_hashes_batch(ht, qh)
        t_m = time.time() - t0
        prec, recall = _pr(results, truths)
        row = {"precision": prec, "recall": recall,
               "q_per_s": nq / (t_fp + t_m)}
        msg = (f"config 3 {name:>20}: P {prec:.3f} R {recall:.3f}, "
               f"{nq / (t_fp + t_m):.1f} q/s (fingerprint {t_fp:.3f} s + "
               f"match {t_m:.3f} s)")
        if "speed" in name:
            t0 = time.time()
            best = []
            for c in range(0, nq, chunk):
                best.extend(matcher.match_samples_sweep(
                    an4, ht, queries[c: c + chunk], 4.0,
                    base_hashes=qh[c: c + chunk]))
            t_s = time.time() - t0
            sp, sr_ = _pr([rr for rr, _f, _n in best], truths)
            wins = {}
            for _rr, f, _n in best:
                key = f"{round((f - 1) * 100):+d}%"
                wins[key] = wins.get(key, 0) + 1
            row.update(sweep_precision=sp, sweep_recall=sr_,
                       sweep_q_per_s=nq / (t_fp + t_s),
                       sweep_winners=wins)
            msg += (f"; swept: P {sp:.3f} R {sr_:.3f}, "
                    f"{nq / (t_fp + t_s):.1f} q/s (sweep {t_s:.3f} s), "
                    f"winning corrections {wins}")
        curve[name] = row
        print(msg)
    launches = _counts()
    print(f"config 3: {1 + len(sweep_factors(4.0))} variants per swept "
          f"query; launches {launches}")
    for name in ("clean", "snr10", "snr5", "lowpass3k"):
        require(curve[name]["recall"] >= 0.95,
                f"config 3 {name}: recall {curve[name]['recall']} < 0.95")
    for name, row in curve.items():
        if "speed" in name:
            require(row["sweep_recall"] >= row["recall"],
                    f"config 3 {name}: the sweep lowered recall {row}")
    for name in ("speed-3%", "speed+4%"):
        require(curve[name]["sweep_recall"] > curve[name]["recall"],
                f"config 3 {name}: the sweep did not recover it "
                f"{curve[name]}")
    require(launches["prune_fwd_bwd"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0 and launches["seg_scan"] > 0,
            f"a kernel was not launched on the config 3 path: {launches}")
    rec["_paths"]["config3_sweep"] = launches

    # the same queries, eager against the replayed graphs in turns: plain
    # (every condition) and swept (the speed conditions); rows equal
    def plain():
        return [matcher.match_hashes_batch(ht, an4.samples_batch2hashes(q))
                for q in conds.values()]

    def swept():
        out = []
        for name, q in conds.items():
            if "speed" in name:
                for c in range(0, nq, chunk):
                    out.append(matcher.match_samples_sweep(
                        an4, ht, q[c: c + chunk], 4.0))
        return out

    ab = {(path, mode): [] for path in ("plain", "swept")
          for mode in ("eager", "replay")}
    n_q = {"plain": nq * len(conds),
           "swept": nq * sum("speed" in n for n in conds)}
    first: dict = {}
    for _r in range(5):
        for path, fn in (("plain", plain), ("swept", swept)):
            for mode in ("eager", "replay"):
                with (eager_graphs() if mode == "eager"
                      else contextlib.nullcontext()):
                    t0 = time.time()
                    out = fn()
                    ab[path, mode].append(n_q[path] / (time.time() - t0))
                flat = [np.asarray(r[0] if isinstance(r, tuple) else r)
                        for batch in out for r in batch]
                ref = first.setdefault(path, flat)
                require(len(flat) == len(ref) and not _rows_differing(
                    flat, ref), f"config 3 {path}: {mode} rows differ")
    print(f"config 3 [{nvidia_smi_line()}]: eager against replayed graphs "
          f"in turns, q/s by round (fingerprint included): "
          + "; ".join(f"{p} {m} {[round(x, 1) for x in v]}"
                      for (p, m), v in ab.items())
          + "; rows equal in every round")
    return {"config3_curve": curve,
            "config3_q_per_s": {f"{p} {m}": v for (p, m), v in ab.items()}}


def phase_broadcast(torch, rec, ctx, dev, d, n_seg=360, seg_sec=20.0,
                    win=10.0, hop=5.0, extra=()) -> dict:
    """Broadcast monitoring over a long log through cli.do_match with
    --windowed: every third segment is an excerpt of a DB track placed on
    the log's frame grid, the rest is audio not in the DB.  `extra` adds
    `match` flags (a lower --stream-above streams a shorter log)."""
    from audfprint_torch import params as P
    from audfprint_torch.utils.audio import audio_write_wav
    from audfprint_torch.utils.timing import Stages
    from audfprint_torch import cli
    from audfprint_torch.match.matcher import slice_hash_windows
    from audfprint_torch.utils import graphs

    tracks, ht, matcher = ctx["tracks"], ctx["ht"], ctx["matcher"]
    rng = np.random.default_rng(SEED + 6)
    seg_n = int(seg_sec * SR)
    tlen = len(tracks[0])
    src = rng.permutation(len(tracks))[: (n_seg + 2) // 3]
    x = np.empty(n_seg * seg_n, np.float32)
    excerpts = {}                          # segment -> track id
    t0 = time.time()
    for k in range(n_seg):
        o = k * seg_n
        if k % 3 == 0:
            j = int(src[k // 3])
            # source start = log offset modulo the hop: the excerpt's
            # frames coincide with the track's own frames
            phase = o % 256
            s0 = 256 * int(rng.integers(0, (tlen - seg_n - phase) // 256 + 1)) \
                + phase
            x[o: o + seg_n] = tracks[j][s0: s0 + seg_n]
            excerpts[k] = j
        else:
            x[o: o + seg_n] = synth_track(rng, seg_sec)
    wav = os.path.join(d, "broadcast.wav")
    audio_write_wav(wav, x, SR)
    del x
    print(f"broadcast: wrote a {n_seg * seg_sec:g} s log ({len(excerpts)} "
          f"excerpts) in {time.time() - t0:.1f} s (host numpy, not timed)")

    args = cli.make_parser().parse_intermixed_args(
        ["match", "--windowed", f"{win:g}", "--window-hop", f"{hop:g}",
         *extra, wav])
    an = cli.setup_analyzer(args, dev)
    require(an._should_stream(wav), "the broadcast log does not stream")
    base = _reset_peak(torch, dev)
    t0 = time.time()
    h = an.wavfile2hashes_streaming(wav)
    _sync(torch, dev)
    t_stream = time.time() - t0
    peak_stream = _peak_mib(torch, dev, base)
    dur = an.soundfiledur
    wins = slice_hash_windows(h, dur, win, SR / 256.0, hop)
    # the windowed vote's key captured outside the counted run, into an
    # empty pool: its capture seconds and the bytes its graph holds
    wh = [w[1] for w in wins]
    graphs.clear(torch.device(dev))
    t0 = time.time()
    matcher.match_hashes_batch(ht, wh)
    _sync(torch, dev)
    t_cap = time.time() - t0
    vkey = [k for k in matcher._votes.keys()
            if k[0][0][0][1] == P.next_pow2(max(len(x) for x in wh), 128)]
    held = {f"{k[0][0][0][0]}x{k[0][0][0][1]}": round(b / 2**20, 1)
            for k, b in matcher._votes.held_by_key().items() if k in vkey}
    print(f"broadcast [{nvidia_smi_line()}]: the windowed vote's first call "
          f"(warm-up run and capture of its key) {t_cap:.3f} s; "
          f"captured into an empty pool, its graph holds MiB {held}; budget "
          f"clears so far {graphs.counts['budget_clears']}")
    lines: list = []
    # ---- the windowed CLI path, counted ----
    _counts_zero()
    base = _reset_peak(torch, dev)
    t0 = time.time()
    n_files, _tot = cli.do_match(ht, an, matcher, [wav], args, lines.append,
                                 Stages())
    _sync(torch, dev)
    wall = time.time() - t0
    peak_all = _peak_mib(torch, dev, base)
    launches = _counts()

    # the vote's memory envelope: the sub-batch the matcher picks for
    # these windows, and the whole do_match's peak against its budget
    budget = matcher._budget_bytes()
    q_rows = P.next_pow2(max([1] + [len(w[1]) for w in wins]), 128)
    bsub = matcher.sub_batch(len(wins), matcher._device_state(ht)[3], q_rows)

    named = {}                             # window label -> rank-0 track
    for ln in lines:
        m = re.search(r" t=(\d+\.\d)s ", ln)
        if m is None:
            continue
        hit = re.search(r" as track(\d+) at .* rank 0$", ln)
        named[m.group(1)] = int(hit.group(1)) if hit else None
    found, fp, filler = set(), 0, 0
    for t0w, _sel, _wd in wins:
        k = int(t0w // seg_sec)
        if t0w + win > (k + 1) * seg_sec + 1e-9:
            continue                       # spans a segment boundary
        got = named.get(f"{t0w:.1f}")
        if k in excerpts:
            if got == excerpts[k]:
                found.add(k)
        else:
            filler += 1
            fp += got is not None
    fp_share = fp / max(1, filler)
    print(f"broadcast: {len(wins)} windows of {win:g} s (hop {hop:g} s) over "
          f"{dur:.1f} s in {wall:.3f} s = {len(wins) / wall:.1f} windows/s "
          f"(do_match: streamed fingerprint + one batched vote); "
          f"{len(found)} of {len(excerpts)} excerpts named at rank 0 by a "
          f"window inside them; {fp} of {filler} filler windows report a "
          f"track ({fp_share:.4f}); streamed route alone {t_stream:.3f} s, "
          f"device memory peak {peak_stream:.1f} MiB (whole do_match, vote "
          f"included, {peak_all:.1f} MiB; both above the {base / 2**20:.1f} "
          f"MiB already resident); launches {launches}")
    print(f"broadcast vote envelope: {len(wins)} windows of Q = {q_rows} "
          f"hashes in sub-batches of {bsub}; do_match peak above resident "
          f"{peak_all:.1f} MiB against the {budget / 2**20:.1f} MiB budget "
          f"(_budget_bytes), {len(wins) / wall:.1f} windows/s")
    require(n_files == 1 and len(named) == len(wins),
            f"broadcast: {len(named)} window results for {len(wins)} windows")
    require(len(found) == len(excerpts),
            f"broadcast: excerpts not found {sorted(set(excerpts) - found)}")
    require(fp_share <= 0.05, f"broadcast: {fp} of {filler} filler windows "
                              "report a DB track")
    require(torch.device(dev).type != "cuda" or peak_all * 2**20 <= budget,
            f"broadcast: do_match peaked {peak_all:.1f} MiB above resident, "
            f"past the vote's {budget / 2**20:.1f} MiB budget")
    require(launches["prune_fwd_carry"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0 and launches["seg_scan"] > 0,
            f"the broadcast log did not stream through K1f, K2 and K3, or "
            f"its vote through K4: {launches}")
    # a seeded sample of the windowed rows against the oracle, bit for bit
    pick = np.random.default_rng(SEED + 7).choice(
        len(wins), min(96, len(wins)), replace=False)
    sample = [wins[i][1] for i in sorted(pick)]
    got_rows = matcher.match_hashes_batch(ht, sample)
    want_rows = oracle_rows(ht, sample, {})
    bad = _rows_differing(got_rows, want_rows)
    print(f"broadcast: {len(sample)} sampled windows' rows against the "
          f"oracle: {len(sample) - len(bad)} equal bit for bit "
          f"({sum(len(w) > 0 for w in want_rows)} of them report a track)")
    require(not bad, f"windowed rows differ from the oracle: sample {bad[:8]}")
    rec["_paths"]["broadcast_windowed"] = launches

    # the windowed vote alone, and the whole do_match, eager against the
    # replayed graphs in turns over 5 rounds; rows and lines equal
    ref = matcher.match_hashes_batch(ht, wh)
    vote_s = {"eager": [], "replay": []}
    wps = {"eager": [], "replay": []}
    for _r in range(5):
        for mode in vote_s:
            with (eager_graphs() if mode == "eager"
                  else contextlib.nullcontext()):
                t0 = time.time()
                got = matcher.match_hashes_batch(ht, wh)
                vote_s[mode].append(time.time() - t0)
                require(not _rows_differing(got, ref),
                        f"broadcast: the {mode} windowed vote's rows differ")
                again: list = []
                t0 = time.time()
                cli.do_match(ht, an, matcher, [wav], args, again.append,
                             Stages())
                _sync(torch, dev)
                wps[mode].append(len(wins) / (time.time() - t0))
                require(again == lines, f"broadcast: {mode} do_match lines "
                                        "differ from the counted run's")
    print(f"broadcast [{nvidia_smi_line()}]: eager against replayed graphs "
          f"in turns: the {len(wins)}-window vote s by round, eager "
          f"{[round(x, 4) for x in vote_s['eager']]}, replay "
          f"{[round(x, 4) for x in vote_s['replay']]}; do_match windows/s, "
          f"eager {[round(x, 1) for x in wps['eager']]}, replay "
          f"{[round(x, 1) for x in wps['replay']]}")
    return {"broadcast_windows": len(wins), "broadcast_wall_s": wall,
            "broadcast_rows_vs_oracle": len(sample),
            "broadcast_windows_per_s": len(wins) / wall,
            "broadcast_found": len(found), "broadcast_filler_fp": fp_share,
            "broadcast_stream_peak_mib": peak_stream,
            "broadcast_do_match_peak_mib": peak_all,
            "broadcast_vote_sub_batch": bsub,
            "broadcast_vote_budget_mib": budget / 2**20,
            "broadcast_vote_held_mib": held,
            "broadcast_vote_s": vote_s, "broadcast_ab_windows_per_s": wps}


def phase_listen(torch, rec, ctx, dev, d, n_inter=16, n_backlog=48) -> dict:
    """cli.do_listen fed through an os.pipe: interactive requests one at a
    time (latency), then a backlog with a missing path (throughput,
    batching); lines equal batch do_match's over the same list."""
    from audfprint_torch.utils.audio import audio_write_wav
    from audfprint_torch.utils.timing import Stages
    from audfprint_torch import cli

    from audfprint_torch.match.matcher import Matcher

    ht = ctx["ht"]
    # a matcher of its own, so that what warmup captures is counted alone
    matcher = Matcher(device=dev)
    paths = []
    for i, q in enumerate(ctx["queries"][: n_inter + n_backlog]):
        paths.append(os.path.join(d, f"listen{i:02d}.wav"))
        audio_write_wav(paths[-1], q, SR)
    inter, backlog = paths[:n_inter], paths[n_inter:]
    missing = os.path.join(d, "missing.wav")
    backlog = backlog[: len(backlog) // 2] + [missing] \
        + backlog[len(backlog) // 2:]
    args = cli.make_parser().parse_intermixed_args(["match", "--listen"])
    an = cli.setup_analyzer(args, dev)
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    t0 = time.time()
    n_warm = cli.do_warmup(ht, an, matcher, args, print)
    _sync(torch, dev)
    t_warm = time.time() - t0
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    warm_keys = matcher._graphs.keys()
    cap = {_key_name(k): round(v, 4)
           for k, v in matcher._graphs.capture_seconds().items()}
    print(f"listen [{nvidia_smi_line()}]: warmup (--warm-durations "
          f"{args.warm_durations}, --batchsize {args.batchsize}) ran "
          f"{n_warm} paths in {t_warm:.2f} s and captured {len(warm_keys)} "
          f"graphs, seconds {cap}; the graph cache holds "
          f"{matcher._graphs.held_bytes / 2**20:.1f} MiB; reserved "
          f"{reserved / 2**20:.1f} MiB after warmup, "
          f"{(reserved - reserved0) / 2**20:.1f} MiB more than before it "
          f"(table upload included)")
    require(len(warm_keys) == 8, f"warmup captured {len(warm_keys)} graphs, "
                                 "not 2 buckets x 2 sizes x 2 dtypes")

    # ---- the listen loop, counted ----
    _counts_zero()
    sess = _listen_session(cli, ht, an, matcher, args, inter, backlog)
    _sync(torch, dev)
    launches = _counts()
    one = [k for k in warm_keys if k[0][0] == ((1, 131072), "<i2")]
    require(len(one) == 1, f"warmup did not capture the interactive "
                           f"requests' key: {warm_keys}")
    require(matcher._graphs.keys()[: len(warm_keys)] == warm_keys,
            "the listen loop captured a warm key again")
    served = sess["lines"]
    batch: list = []
    an.fail_on_error = False
    cli.do_match(ht, an, matcher, inter + backlog, args, batch.append,
                 Stages())
    an.fail_on_error = True

    def results(ls):
        return [ln for ln in ls if ln.startswith(("Matched", "NOMATCH"))]

    backlog_calls = sess["backlog_calls"]
    n_ok = len(backlog) - 1
    bq_s = n_ok / (sess["t_end"] - sess["t_backlog"])
    lat_ms = sorted(sess["lat_ms"])
    p50 = lat_ms[len(lat_ms) // 2]
    errs = [ln for ln in served if ln.startswith("Error reading")]
    print(f"listen: {n_inter} interactive requests, latency p50 "
          f"{p50:.2f} ms, max {lat_ms[-1]:.2f} ms (write path -> result "
          f"line; decode + fused fingerprint and match + one sync each); "
          f"backlog of {len(backlog)} paths ({n_ok} queries + 1 missing) "
          f"served in {len(backlog_calls)} do_match calls {backlog_calls}, "
          f"{bq_s:.1f} q/s; {sess['n_served']} served in all; launches "
          f"{launches}")
    require(results(served) == results(batch)
            and len(results(served)) == len(paths),
            "listen results differ from batch do_match over the same list")
    for ln, p in zip(results(served), paths[:n_inter] + [
            b for b in backlog if b != missing]):
        require(f"Matched {p} " in ln or f"NOMATCH {p} " in ln,
                f"listen line out of order: {ln!r} for {p}")
    require(len(errs) == 1 and missing in errs[0],
            f"the missing path was not reported once: {errs}")
    require(len(backlog_calls) < n_ok,
            f"the backlog took {len(backlog_calls)} do_match calls")
    require(launches["prune_fwd_bwd"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0 and launches["seg_scan"] > 0,
            f"a kernel was not launched on the listen path: {launches}")
    rec["_paths"]["listen"] = launches

    # interactive latency, the eager function against the replays, in
    # turns over 5 rounds of the 16 requests
    rounds = {"eager": [], "replay": []}
    for _r in range(5):
        for name in ("eager", "replay"):
            with (eager_graphs() if name == "eager"
                  else contextlib.nullcontext()):
                ms = sorted(_listen_session(cli, ht, an, matcher, args,
                                            inter)["lat_ms"])
            rounds[name].append((ms[len(ms) // 2], ms[-1]))
    print(f"listen [{nvidia_smi_line()}]: p50 / max ms by round, eager "
          f"{[(round(a, 2), round(b, 2)) for a, b in rounds['eager']]}, "
          f"replay {[(round(a, 2), round(b, 2)) for a, b in rounds['replay']]}")

    # precomputed .afpt requests (the two-stage vote alone), eager against
    # the replayed graphs in turns over 5 rounds after an untimed replayed
    # session captures their keys; lines equal in every session
    from audfprint_torch.utils import formats

    afpt = []
    for p, h in zip(inter, ctx["qhashes"]):
        afpt.append(p[:-4] + ".afpt")
        formats.hashes_save(afpt[-1], h)
    ref = _listen_session(cli, ht, an, matcher, args, afpt)["lines"]
    afpt_rounds = {"eager": [], "replay": []}
    for _r in range(5):
        for name in afpt_rounds:
            with (eager_graphs() if name == "eager"
                  else contextlib.nullcontext()):
                sess = _listen_session(cli, ht, an, matcher, args, afpt)
            require(sess["lines"] == ref,
                    f"listen .afpt lines differ ({name})")
            ms = sorted(sess["lat_ms"])
            afpt_rounds[name].append((ms[len(ms) // 2], ms[-1]))
    print(f"listen [{nvidia_smi_line()}]: {len(afpt)} .afpt requests, p50 / "
          f"max ms by round, eager "
          f"{[(round(a, 2), round(b, 2)) for a, b in afpt_rounds['eager']]}, "
          f"replay "
          f"{[(round(a, 2), round(b, 2)) for a, b in afpt_rounds['replay']]}"
          f"; lines equal in every round")

    streamed_beside_capture(ht, dev, d, inter[:2], ctx["tracks"][5],
                            "track5")
    return {"listen_p50_ms": p50, "listen_max_ms": lat_ms[-1],
            "listen_afpt_rounds_p50_max_ms": afpt_rounds,
            "listen_rounds_p50_max_ms": rounds,
            "listen_backlog_q_per_s": bq_s,
            "listen_backlog_calls": len(backlog_calls)}


def streamed_beside_capture(ht, dev, d, queries, track, name) -> None:
    """`match --stream-above 20 --batchsize 1` of [query, 30 s track,
    query] (the queries' WAVs share one key) on a fresh Matcher: chunk 0's
    fused call captures while the decode thread reads chunk 1, whose
    streamed route then runs on the device from the dispatching thread.
    The lines equal the eager function's, one key is captured, and the
    streamed file matches `name` at rank 0."""
    from audfprint_torch import cli
    from audfprint_torch.match.matcher import Matcher
    from audfprint_torch.utils.audio import audio_write_wav
    from audfprint_torch.utils.timing import Stages

    long_wav = os.path.join(d, "streamed_beside_capture.wav")
    audio_write_wav(long_wav, track, SR)
    mixed = [queries[0], long_wav, queries[1]]
    args = cli.make_parser().parse_intermixed_args(
        ["match", "--stream-above", "20", "--batchsize", "1"])
    an = cli.setup_analyzer(args, dev)
    lines, n_keys = {}, None
    for mode in ("graphs", "eager"):
        m = Matcher(device=dev)
        lines[mode] = []
        with (eager_graphs() if mode == "eager"
              else contextlib.nullcontext()):
            cli.do_match(ht, an, m, mixed, args, lines[mode].append,
                         Stages())
        if mode == "graphs":
            n_keys = len(m._graphs.keys())
        del m
    got = [ln for ln in lines["graphs"] if ln.startswith("Matched")]
    print(f"listen: match --stream-above 20 --batchsize 1 of [query, "
          f"{len(track) / SR:g} s streamed, query] on a fresh Matcher: "
          f"{n_keys} graph captured; lines equal the eager function's: "
          f"{lines['graphs'] == lines['eager']}")
    require(lines["graphs"] == lines["eager"] and len(got) == 3,
            f"a streamed file beside a capture: {lines}")
    require(n_keys == 1, f"{n_keys} keys captured for two queries of one "
                         "shape")
    require(got[1].startswith(f"Matched {long_wav} ")
            and f" {name} " in got[1] and "rank 0" in got[1],
            f"the streamed file's line: {got[1]!r}")


def _listen_session(cli, ht, an, matcher, args, inter,
                    backlog=()) -> dict:
    """cli.do_listen over an os.pipe: each path of `inter` written after
    the previous one's result line, the first once the loop reads its
    stream (after its warm-up), then `backlog` written at once.
    Returns lat_ms (write -> result line, per interactive path), lines
    (everything reported), backlog_calls (paths per do_match call after
    the interactive ones), t_backlog and t_end (perf_counter when the
    backlog was written and when the loop ended) and n_served."""
    import threading

    from audfprint_torch.utils.timing import Stages

    cond = threading.Condition()
    got: list = []                       # (perf_counter, line)

    def report(msg):
        with cond:
            got.append((time.perf_counter(), msg))
            cond.notify_all()

    def n_results():
        return sum(ln.startswith(("Matched", "NOMATCH")) for _, ln in got)

    rfd, wfd = os.pipe()
    reader, writer = os.fdopen(rfd, "r"), os.fdopen(wfd, "w")
    reading = threading.Event()

    class Stream:
        """The read end, which says when the loop starts reading it."""

        def __iter__(self):
            reading.set()
            return iter(reader)

    calls: list = []
    real = cli.do_match

    def counting(*a, **kw):
        calls.append(len(a[3]))
        return real(*a, **kw)

    lat: list = []
    mark: dict = {}
    errors: list = []

    def feeder():
        try:
            if not reading.wait(120):
                raise RuntimeError("the loop never read its stream")
            for p in inter:
                with cond:
                    n0 = n_results()
                t = time.perf_counter()
                writer.write(p + "\n")
                writer.flush()
                with cond:
                    if not cond.wait_for(lambda: n_results() > n0, 120):
                        raise RuntimeError(f"no answer for {p}")
                    lat.append(1e3 * (got[-1][0] - t))
            mark["calls"] = len(calls)
            mark["t"] = time.perf_counter()
            writer.write("".join(p + "\n" for p in backlog))
            writer.flush()
        except Exception as e:             # reported by the gate below
            errors.append(repr(e))
        finally:
            writer.close()

    cli.do_match = counting
    try:
        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        n_served, _dur = cli.do_listen(ht, an, matcher, args, report,
                                       Stages(), None, stream=Stream())
        t_end = time.perf_counter()
        th.join(timeout=60)
    finally:
        cli.do_match = real
        reader.close()
    require(not errors and not th.is_alive() and len(lat) == len(inter),
            f"listen feeder: {errors}")
    return {"lat_ms": lat, "lines": [ln for _, ln in got],
            "backlog_calls": calls[mark["calls"]:], "t_backlog": mark["t"],
            "t_end": t_end, "n_served": n_served}


def phase_wide(torch, rec, ctx, dev, hashbits=None) -> dict:
    """A default-size wide table: phase 6's tracks stored on the device at
    sparse ids past the packed 2^18 cap, against the host store, then the
    queries through the fused path on it."""
    from audfprint_torch import params as P
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.index import device_table as DT
    from audfprint_torch.match.matcher import Matcher

    hashes, queries, qsel = ctx["hashes"], ctx["queries"], ctx["qsel"]
    ids = [(1 << 18) + 769 * i for i in range(len(hashes))]
    ht = HashTable(idbits=20, **({} if hashbits is None
                                 else {"hashbits": hashbits}))
    require(ht.wide and ids[-1] < 1 << 20, "the wide table is not wide")
    ht.names = [None] * (ids[-1] + 1)
    ht.hashesperid = np.zeros(len(ht.names), np.int64)
    for i, tid in enumerate(ids):
        ht.names[tid] = f"track{i}"
    ht._invalidate_index()
    t0 = time.time()
    for i, h in enumerate(hashes):
        ht.store_vectorized(f"track{i}", h)
    t_host = time.time() - t0

    cfg = DT.config_for(ht)
    base = _reset_peak(torch, dev)
    t0 = time.time()
    table, counts = DT.empty_table(cfg, dev)
    for c in range(0, len(hashes), 256):
        rows = hashes[c: c + 256]
        L = P.next_pow2(max(len(h) for h in rows), 256)
        tt = np.zeros((len(rows), L), np.int32)
        hh = np.zeros((len(rows), L), np.int32)
        vv = np.zeros((len(rows), L), bool)
        for b, h in enumerate(rows):
            tt[b, : len(h)], hh[b, : len(h)], vv[b, : len(h)] = \
                h[:, 0], h[:, 1], True
        DT.store_batch(table, counts,
                       *[torch.as_tensor(a, device=dev) for a in (
                           tt, hh, vv, np.asarray(ids[c: c + 256], np.int32))],
                       cfg)
    _sync(torch, dev)
    t_store = time.time() - t0
    peak = _peak_mib(torch, dev, base)
    tab_mib = table.numel() * table.element_size() / 2**20
    same = (np.array_equal(table.cpu().numpy().view(np.uint64), ht.table)
            and np.array_equal(counts.cpu().numpy(), ht.counts))
    del table, counts
    print(f"wide table {cfg.n_buckets} x {cfg.depth} int64 ({tab_mib:.1f} "
          f"MiB): {len(hashes)} tracks at ids {ids[0]}..{ids[-1]} stored on "
          f"the device in {t_store:.3f} s (device memory peak {peak:.1f} "
          f"MiB above what was resident; host store {t_host:.3f} s); equal "
          f"to the host table bit "
          f"for bit: {same}")
    require(same, "the device wide table differs from the host store's")

    an = ctx["an"]
    m = Matcher(device=dev)
    m.match_samples_fused(an, ht, queries)     # upload + capture its graph
    _sync(torch, dev)
    # ---- the fused path on the wide table, counted ----
    _counts_zero()
    t0 = time.time()
    res, _nh = m.match_samples_fused(an, ht, queries)
    _sync(torch, dev)
    t_match = time.time() - t0
    launches = _counts()
    ok = [len(r) > 0 and int(r[0][0]) == ids[i] for r, i in zip(res, qsel)]
    print(f"wide table match: {sum(ok)} of {len(ok)} queries at rank 0 with "
          f"their sparse ids, {len(queries) / t_match:.2f} q/s (fused, "
          f"warm); launches {launches}")
    require(all(ok), "a query missed its sparse id on the wide table")
    require(launches["prune_fwd_bwd"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0 and launches["seg_scan"] > 0,
            f"a kernel was not launched on the wide path: {launches}")
    rec["_paths"]["wide"] = launches
    return {"wide_table_mib": tab_mib, "wide_store_s": t_store,
            "wide_store_peak_mib": peak, "wide_match_q_per_s":
            len(queries) / t_match}


def golden_session(tmpdir: str, main) -> str:
    """tests/test_golden_cli.py's session through the port's CLI."""
    from audfprint_torch.utils.audio import audio_write_wav

    common = ["-h", "16", "-b", "20", "-t", "4096"]
    rng = np.random.default_rng(424242)
    tracks = []
    for i in range(3):
        x = synth_audio(rng, dur_sec=6.0, n_tones=50)
        audio_write_wav(os.path.join(tmpdir, f"track{i}.wav"), x, SR)
        tracks.append(x)
    q = tracks[2][256 * 43: 256 * 43 + 3 * SR].copy()
    audio_write_wav(os.path.join(tmpdir, "query.wav"), q, SR)
    db = os.path.join(tmpdir, "db.pklz")
    wavs = [os.path.join(tmpdir, f"track{i}.wav") for i in range(3)]
    query = os.path.join(tmpdir, "query.wav")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["new", "-d", db, *common, *wavs])
        main(["match", "-d", db, *common, query])
        main(["match", "-d", db, *common, "-R", "-X", query])
        main(["list", "-d", db, *common])
        main(["remove", "-d", db, *common, wavs[2]])
        main(["match", "-d", db, *common, query])
        pre = os.path.join(tmpdir, "pre")
        main(["precompute", "-p", pre, *common, wavs[0], wavs[1]])
        main(["precompute", "-K", "-p", pre, *common, wavs[2]])
        afpt = [os.path.join(pre, tmpdir.lstrip(os.sep), f"track{i}.afpt")
                for i in range(2)]
        afpk2 = os.path.join(pre, tmpdir.lstrip(os.sep), "track2.afpk")
        db2 = os.path.join(tmpdir, "db2.pklz")
        main(["new", "-d", db2, *common, *afpt])
        main(["add", "-d", db2, *common, afpk2])
        op = os.path.join(tmpdir, "match.out")
        main(["match", "-d", db2, *common, "-o", op, query])
        print("--- opfile ---")
        with open(op) as f:
            sys.stdout.write(f.read())
        dbs = os.path.join(tmpdir, "dbshard.pklz")
        db4 = os.path.join(tmpdir, "db4.pklz")
        main(["new", "-d", dbs, *common, wavs[2]])
        main(["new", "-d", db4, *common, wavs[0]])
        main(["merge", "-d", db4, *common, dbs])
        main(["match", "-d", db4, *common, query])
        db5 = os.path.join(tmpdir, "db5.pklz")
        main(["newmerge", "-d", db5, *common, db4, db2])
        main(["list", "-d", db5, *common])
        db6 = os.path.join(tmpdir, "db6.pklz")
        main(["new", "-d", db6, *common, "-i", "2", wavs[2]])
        main(["match", "-d", db6, *common, "-i", "2", query])
    text = buf.getvalue()
    text = text.replace(tmpdir + os.sep, "<DIR>/").replace(tmpdir, "<DIR>")
    return re.sub(r"in \d+\.\d s sec = \d+\.\d+ x RT",
                  "in <T> s sec = <R> x RT", text)


def phase_cli() -> dict:
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.utils.audio import audio_write_wav
    from audfprint_torch.cli import main

    rng = np.random.default_rng(SEED + 3)
    with tempfile.TemporaryDirectory() as d:
        wavs, songs = [], []
        for i in range(3):
            x = synth_track(rng, 20.0)
            songs.append(x)
            wavs.append(os.path.join(d, f"song{i}.wav"))
            audio_write_wav(wavs[-1], x, SR)
            if i == 1:
                q = x[256 * 200: 256 * 200 + 8 * SR]
        query = os.path.join(d, "query.wav")
        audio_write_wav(query, q, SR)
        db = os.path.join(d, "db.pklz")
        dbdev = os.path.join(d, "dbdev.pklz")
        rank0 = (r"Matched \S+query\.wav .* as \S+song1\.wav at "
                 r".* at rank 0")
        out = _cli(["new", "-d", db, *wavs]) + _cli(["match", "-d", db, query])
        print("CLI subprocess output:\n" + out.rstrip())
        require(re.search(rank0, out) is not None,
                "the CLI printed no rank-0 Matched line for the query")
        out = (_cli(["new", "-d", dbdev, "--device-store", *wavs])
               + _cli(["match", "-d", dbdev, query]))
        print("CLI --device-store subprocess output:\n" + out.rstrip())
        require(re.search(rank0, out) is not None,
                "no rank-0 Matched line against the --device-store database")
        a, b = HashTable(db), HashTable(dbdev)
        same_db = (np.array_equal(a.table, b.table)
                   and np.array_equal(a.counts, b.counts)
                   and np.array_equal(a.hashesperid, b.hashesperid))
        print(f"CLI new --device-store database equals new's: {same_db}")
        # the --ndev chains beside the serving modes: each subprocess
        # spends most of its time starting up
        with ThreadPoolExecutor(max_workers=1) as ex:
            ndev = ex.submit(phase_cli_ndev, d, wavs, query, rank0)
            serving = phase_cli_serving(d, db, wavs, songs, query, q, rank0)
            serving.update(ndev.result())
        serving.update(oneshot_match(d, db, query, rank0))
        serving.update(listen_processes(d, db, songs))
    with tempfile.TemporaryDirectory() as d:
        got = golden_session(d, lambda argv: main(argv, device="cuda"))
    with open(os.path.join(ROOT, "tests", "golden", "cli_session.txt")) as f:
        want = f.read()
    g, w = got.splitlines(), want.splitlines()
    diff = [(i, a, b) for i, (a, b) in enumerate(zip(w, g)) if a != b]
    ndiff = len(diff) + abs(len(g) - len(w))
    print(f"golden CLI session on the card: {ndiff} of {len(w)} lines "
          "differ from tests/golden/cli_session.txt")
    for i, a, b in diff[:10]:
        print(f"  line {i + 1}: golden {a!r}\n           card   {b!r}")
    return {"golden_lines_differing": ndiff, "cli_device_store_same_db":
            same_db, **serving}


# `python -m audfprint_torch` with the listen loop's warm-up left out: a
# listen process that captures each key on its first request, as before
# match --listen warmed itself (listen_processes' "first-capture" mode)
_NOWARM_MAIN = ("import runpy; from audfprint_torch import cli; "
                "cli.warm_serving = lambda *a, **k: 0; "
                "runpy.run_module('audfprint_torch', run_name='__main__', "
                "alter_sys=True)")


def _listen_process(db, reqs, missing, mj, mode, timeout=300,
                    extra=()) -> dict:
    """One `match --listen -d db --json-metrics mj` process over a pipe.
    The missing path goes first: its error line says the loop has read
    its first line (the warm-up is behind it) without any device work.
    Then each request is written after the previous one's result line.
    mode: "graphs" (the CLI as it is), "eager" (graphs off, _EAGER_MAIN)
    or "first-capture" (_NOWARM_MAIN).  Returns lat_ms per request, the
    result lines, the process's wall to its first line and its
    --json-metrics."""
    import queue
    import threading

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    main = {"graphs": ["-m", "audfprint_torch"],
            "eager": ["-c", _EAGER_MAIN],
            "first-capture": ["-c", _NOWARM_MAIN]}[mode]
    t_start = time.perf_counter()
    err = open(mj + ".stderr", "w+")
    proc = subprocess.Popen(
        [sys.executable, *main, "match", "-d", db, "--listen",
         "--json-metrics", mj, *extra], cwd=ROOT, env=env,
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=err, text=True, bufsize=1)

    def errors() -> str:
        err.seek(0)
        return err.read()[-2000:]
    out: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            out.put((time.perf_counter(), line.rstrip("\n")))
        out.put((time.perf_counter(), None))

    threading.Thread(target=pump, daemon=True).start()

    def answer(prefixes):
        while True:
            t, line = out.get(timeout=timeout)
            require(line is not None,
                    f"listen process ({mode}) ended: {errors()}")
            if line.startswith(prefixes):
                return t, line

    lat, lines = [], []
    try:
        proc.stdin.write(missing + "\n")
        proc.stdin.flush()
        t_ready, _ = answer(("Error reading",))
        for p in reqs:
            t0 = time.perf_counter()
            proc.stdin.write(p + "\n")
            proc.stdin.flush()
            t1, line = answer(("Matched", "NOMATCH"))
            lat.append(1e3 * (t1 - t0))
            lines.append(line)
        proc.stdin.close()
        require(proc.wait(timeout=timeout) == 0,
                f"listen process ({mode}) exited {proc.returncode}: "
                f"{errors()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    with open(mj) as f:
        metrics = json.load(f)
    return {"lat_ms": lat, "lines": lines, "ready_s": t_ready - t_start,
            "metrics": metrics}


def listen_processes(d, db, songs, rounds: int = 5) -> dict:
    """`warmup -d db`, then fresh `match --listen -d db` processes over a
    pipe, as a user runs them: 16 requests, 5 s and 10 s excerpts of the
    songs in turn (the warm buckets, int16 PCM, one row each).  Gates:
    each listen process captured nothing after it read its first line
    (its --json-metrics listen_graph_captures), and its result lines equal
    batch do_match's over the same paths.  Times each key's first request
    and the p50 and max of the 16, the CLI as it is ("graphs") in turns
    with each key captured on its first request ("first-capture") over
    `rounds` rounds, and with the graphs off ("eager") in the first; then
    one round on 4 logical shards (`warmup --ndev 4`, a fresh `match
    --listen --ndev 4`) under the same gates."""
    from audfprint_torch import cli
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.utils.audio import audio_write_wav
    from audfprint_torch.utils.timing import Stages

    smi = nvidia_smi_line()
    reqs = []
    for i in range(16):
        n = int((5.0 if i % 2 == 0 else 10.0) * SR)
        o = 256 * (23 * i % 40)
        reqs.append(os.path.join(d, f"listen_proc{i:02d}.wav"))
        audio_write_wav(reqs[-1], songs[i % 3][o: o + n], SR)
    missing = os.path.join(d, "listen_proc_missing.wav")
    t0 = time.time()
    out = _cli(["warmup", "-d", db])
    t_warm = time.time() - t0
    require("warmed 10 s bucket" in out, f"warmup: {out}")
    args = cli.make_parser().parse_intermixed_args(["match", "-d", db])
    batch: list = []
    cli.do_match(HashTable(db), cli.setup_analyzer(args, "cuda"),
                 cli.setup_matcher(args, "cuda"), reqs, args, batch.append,
                 Stages())
    batch = [ln for ln in batch if ln.startswith(("Matched", "NOMATCH"))]
    res = {mode: [] for mode in ("graphs", "first-capture", "eager")}
    for r in range(rounds):
        for mode in list(res)[: 3 if r == 0 else 2]:
            mj = os.path.join(d, f"listen_proc_{mode}{r}.json")
            sess = _listen_process(db, reqs, missing, mj, mode)
            caps = sess["metrics"].get("listen_graph_captures")
            require(sess["lines"] == batch,
                    f"listen process ({mode}): lines differ from batch "
                    f"mode: {sess['lines'][:2]} / {batch[:2]}")
            if mode == "graphs":
                require(caps["serving"] == 0 and caps["warm"] > 0,
                        f"the listen process captured after its first "
                        f"line: {caps}")
            lat = sess["lat_ms"]
            res[mode].append({
                "first_5s_ms": round(lat[0], 3),
                "first_10s_ms": round(lat[1], 3),
                "p50_ms": round(float(np.median(lat)), 3),
                "max_ms": round(max(lat), 3),
                "ready_s": round(sess["ready_s"], 3),
                "warm_s": round(sess["metrics"]["stage_seconds"].get(
                    "warm", 0.0), 3),
                "captures": caps})
    # one round on 4 logical shards: `warmup --ndev 4`, then a fresh
    # `match --listen --ndev 4` process, whose mesh keys are warm before
    # its first line
    nd = ["--ndev", "4"]
    out = _cli(["warmup", "-d", db, *nd])
    require("warmed 10 s bucket" in out, f"warmup --ndev 4: {out}")
    mj = os.path.join(d, "listen_proc_ndev4.json")
    sess = _listen_process(db, reqs, missing, mj, "graphs", extra=nd)
    caps = sess["metrics"].get("listen_graph_captures")
    require(sess["lines"] == batch,
            f"listen process (--ndev 4): lines differ from batch mode: "
            f"{sess['lines'][:2]} / {batch[:2]}")
    require(caps["serving"] == 0 and caps["warm"] > 0,
            f"the --ndev 4 listen process captured after its first line: "
            f"{caps}")
    lat = sess["lat_ms"]
    res["graphs, --ndev 4"] = [{
        "first_5s_ms": round(lat[0], 3), "first_10s_ms": round(lat[1], 3),
        "p50_ms": round(float(np.median(lat)), 3),
        "max_ms": round(max(lat), 3), "ready_s": round(sess["ready_s"], 3),
        "warm_s": round(sess["metrics"]["stage_seconds"].get("warm", 0.0),
                        3),
        "captures": caps, "graphs": sess["metrics"].get("graphs")}]
    print(f"listen processes [{smi}]: `warmup -d db` ({t_warm:.1f} s of "
          f"wall), then fresh `match --listen -d db` processes, 16 requests "
          f"(5 s / 10 s in turn), lines equal batch mode; by round:")
    for mode, rows in res.items():
        print(f"  {mode}: " + "; ".join(
            f"first 5 s {x['first_5s_ms']} ms, first 10 s "
            f"{x['first_10s_ms']} ms, p50 {x['p50_ms']}, max {x['max_ms']}, "
            f"ready after {x['ready_s']} s (warm-up {x['warm_s']} s), "
            f"captures {x['captures']}" for x in rows))
    return {"listen_processes": res, "listen_processes_warmup_s": t_warm}


def oneshot_match(d, db, query, rank0, rounds: int = 2) -> dict:
    """A one-shot `match -d db query` process, what a user who matches
    one file pays: its one key's first call warms and captures a graph
    and returns the warm-up run's output, where the eager function ran
    once before the graphs.  The
    two in turns over `rounds`: process wall, the CLI's elapsed seconds
    and its dispatch stage (--json-metrics)."""
    smi = nvidia_smi_line()
    got = {"eager": [], "graphs": []}
    for r in range(rounds):
        for mode in got:
            mj = os.path.join(d, f"oneshot_{mode}{r}.json")
            t0 = time.time()
            out = _cli(["match", "-d", db, "--json-metrics", mj, query],
                       eager=mode == "eager")
            wall = time.time() - t0
            require(re.search(rank0, out) is not None,
                    f"one-shot match ({mode}): no rank-0 line")
            with open(mj) as f:
                m = json.load(f)
            got[mode].append((round(wall, 3), m["elapsed_s"],
                              round(m["stage_seconds"]["dispatch"], 4)))
    print(f"one-shot CLI match of an 8 s query [{smi}]: (process wall s, "
          f"elapsed s, dispatch s) by round, eager {got['eager']}, graphs "
          f"{got['graphs']}")
    return {"oneshot_match_s": got}


def phase_cli_ndev(d, wavs, query, rank0, ndev: int = 4) -> dict:
    """new, add, match and merge with --ndev 4 (four logical shards of the
    card) as subprocesses: their lines and saved databases equal the
    --ndev 1 ones, `new --ndev 4` launches the kernels, and `new` (a WAV a
    chunk) and `match` (the query twice, a query a batch) with --ndev 4
    replay their mesh keys' graphs (--json-metrics)."""
    from audfprint_torch.index.hash_table import HashTable

    def lines(text, n):
        return [ln.replace(f"_n{n}.", "_n.") for ln in text.splitlines()
                if not ln.startswith("Processed ")]

    outs, launches, graph_counts = {}, {}, {}

    def run_ndev(n):
        nd = ["--ndev", str(n)]
        db, dbb = (os.path.join(d, f"{k}_n{n}.pklz") for k in ("nd", "ndb"))
        metrics = os.path.join(d, f"nd_metrics{n}.json")
        mmatch = os.path.join(d, f"nd_match_metrics{n}.json")
        o = _cli(["new", "-d", db, *nd, "--batchsize", "1", "--json-metrics",
                  metrics, *wavs[:2]])
        with open(metrics) as f:
            m = json.load(f)
        launches[n] = m["kernel_launches"]
        o += _cli(["add", "-d", db, *nd, wavs[2]])
        o += _cli(["new", "-d", dbb, *nd, wavs[1], wavs[0]])
        o += _cli(["merge", "-d", db, *nd, dbb])
        o += _cli(["match", "-d", db, *nd, "-R", "-X", "-x", "3", query])
        o += _cli(["match", "-d", db, *nd, "--batchsize", "1",
                   "--json-metrics", mmatch, query, query])
        with open(mmatch) as f:
            graph_counts[n] = {"new": m["graphs"],
                               "match": json.load(f)["graphs"]}
        outs[n] = lines(o, n)

    # the two runs side by side: each subprocess spends most of its
    # time starting up
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=2) as ex:
        for fut in [ex.submit(run_ndev, n) for n in (1, ndev)]:
            fut.result()
    wall = time.time() - t0
    print(f"CLI new / add / merge / match --ndev {ndev}:\n"
          + "\n".join(outs[ndev]))
    require(outs[1] == outs[ndev],
            f"--ndev {ndev} lines differ from --ndev 1: "
            f"{[(a, b) for a, b in zip(outs[1], outs[ndev]) if a != b][:4]}")
    require(any(re.search(rank0, ln) for ln in outs[ndev]),
            f"no rank-0 Matched line under --ndev {ndev}")
    for k in ("nd", "ndb"):
        a, b = (HashTable(os.path.join(d, f"{k}_n{n}.pklz"))
                for n in (1, ndev))
        require(np.array_equal(a.table, b.table)
                and np.array_equal(a.counts, b.counts)
                and np.array_equal(a.hashesperid, b.hashesperid)
                and a.names == b.names,
                f"the --ndev {ndev} database {k} differs from --ndev 1's")
    require(launches[ndev].get("prune_fwd_bwd", 0) > 0
            and launches[ndev].get("hpf_scan", 0) > 0
            and launches[ndev].get("pair_scan", 0) > 0,
            f"new --ndev {ndev} did not launch the kernels: {launches}")
    require(all(c["captures"] > 0 and c["replays"] > 0
                for c in graph_counts[ndev].values()),
            f"new / match --ndev {ndev} replayed no graph: "
            f"{graph_counts[ndev]}")
    print(f"CLI --ndev {ndev}: lines and both saved databases equal --ndev "
          f"1's; new --ndev {ndev} launches {launches[ndev]} (--ndev 1: "
          f"{launches[1]}); graphs (--json-metrics) --ndev {ndev} "
          f"{graph_counts[ndev]}, --ndev 1 {graph_counts[1]}; 12 "
          f"subprocesses in {wall:.1f} s")
    return {"cli_ndev_same": True, "cli_ndev_launches": launches[ndev],
            "cli_ndev_graphs": graph_counts[ndev]}


def phase_cli_serving(d, db, wavs, songs, query, q, rank0) -> dict:
    """Phase 9's serving modes and wide tables, as subprocesses on the
    3-song database."""
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.utils.audio import _resample, audio_write_wav

    # wide tables, host store and device store
    dbw, dbwd = os.path.join(d, "wide.pklz"), os.path.join(d, "wided.pklz")
    _cli(["new", "-d", dbw, "--idbits", "20", *wavs])
    _cli(["new", "-d", dbwd, "--idbits", "20", "--device-store", *wavs])
    a, b = HashTable(dbw), HashTable(dbwd)
    same_wide = (a.wide and a.table.dtype == np.uint64
                 and np.array_equal(a.table, b.table)
                 and np.array_equal(a.counts, b.counts)
                 and np.array_equal(a.hashesperid, b.hashesperid))
    out = _cli(["match", "-d", dbw, query])
    print(f"CLI new --idbits 20 (wide) with and without --device-store: "
          f"equal {same_wide}; match:\n" + out.rstrip())
    require(same_wide, "the two wide databases differ")
    require(re.search(rank0, out) is not None, "no rank-0 match on the wide "
                                               "database")

    # broadcast monitoring: song0 then song2 in one recording, the second
    # on the recording's frame grid
    o = 8 * SR
    s0 = 256 * 20 + o % 256
    rec = os.path.join(d, "two_songs.wav")
    audio_write_wav(rec, np.concatenate([songs[0][:o],
                                         songs[2][s0: s0 + o]]), SR)
    out = _cli(["match", "-d", db, "--windowed", "4", "--window-hop", "2",
                rec])
    print("CLI match --windowed 4 --window-hop 2:\n" + out.rstrip())
    hits = [(float(m.group(1)), m.group(2)) for m in re.finditer(
        r" t=(\d+\.\d)s .* as \S+(song\d)\.wav at .* rank 0", out)]
    require(any(t <= 4.0 and s == "song0" for t, s in hits)
            and any(t >= 8.0 and s == "song2" for t, s in hits),
            f"--windowed did not find both songs in their windows: {hits}")

    # warmup, then a serving process with --speed-sweep on a +4% query
    sped = os.path.join(d, "sped.wav")
    audio_write_wav(sped, _resample(q, 104, 100), SR)
    t0 = time.time()
    out = _cli(["warmup", "-d", db, "--warm-durations", "5,10",
                "--batchsize", "16"])
    t_warm = time.time() - t0
    print(f"CLI warmup ({t_warm:.1f} s wall):\n" + out.rstrip())
    require("warmed 5 s bucket (batch sizes [1, 16])" in out,
            "warmup did not report the 5 s bucket")
    t0 = time.time()
    out = _cli(["match", "-d", db, "--speed-sweep", "4", sped, query])
    t_after = time.time() - t0
    print(f"CLI match --speed-sweep 4 after warmup ({t_after:.1f} s "
          "wall):\n" + out.rstrip())
    require(re.search(r"Matched \S+sped\.wav .* as \S+song1\.wav .* rank 0 "
                      r"\(speed \+4%\)", out) is not None,
            "the +4% query's rank-0 line carries no (speed +4%)")
    require(re.search(rank0, out) is not None,
            "the plain query lost its rank-0 match under --speed-sweep")

    # --profile with the diagnostics
    prof = os.path.join(d, "prof")
    diag = os.path.join(d, "diag.wav")
    audio_write_wav(diag, q, SR)
    out = _cli(["match", "-d", db, "--profile", prof, "-I", "--sonify",
                diag])
    print("CLI match --profile -I --sonify:\n" + out.rstrip())
    traces = [f for f in os.listdir(prof) if f.endswith(".trace.json")]
    require(len(traces) == 1, f"--profile wrote {os.listdir(prof)}")
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f).get("traceEvents", [])
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    kern = {k: sum(k in n for n in names)
            for k in ("prune_fwd_bwd", "hpf_scan", "pair_scan")}
    print(f"--profile trace: {len(events)} events, {len(names)} kernel "
          f"events; by name {kern}")
    require(min(kern.values()) > 0,
            f"the profile trace does not name the kernels: {kern}; kernel "
            f"names seen: {sorted(set(names))[:12]}")
    require(os.path.getsize(diag + ".sonify.wav") > 44,
            "--sonify wrote no WAV")
    require("illustrate_match: matplotlib not available; skipping" in out
            or "illustrate_match: wrote" in out, "-I printed nothing")
    return {"cli_wide_same_db": same_wide, "cli_warmup_wall_s": t_warm,
            "cli_match_after_warmup_wall_s": t_after,
            "profile_kernel_events": kern,
            "profile_kernel_events_total": len(names)}


# ---- the JAX package's behavioural contract on the card -------------------

def _write_wav(path: str, x, sampwidth: int, nch: int = 1) -> None:
    """A PCM WAV of `sampwidth` bytes and `nch` identical channels
    (tests/test_edge_cases.py's writer, which imports JAX)."""
    import wave

    x = np.asarray(x)
    if nch > 1:
        x = np.repeat(x[:, None], nch, axis=1).reshape(-1)
    if sampwidth == 1:
        raw = (np.clip(x, -1, 1) * 127 + 128).astype(np.uint8).tobytes()
    elif sampwidth == 2:
        raw = (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    elif sampwidth == 3:
        v = (np.clip(x, -1, 1) * (2**23 - 1)).astype(np.int32)
        b = np.zeros((len(v), 3), np.uint8)
        b[:, 0], b[:, 1], b[:, 2] = v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF
        raw = b.tobytes()
    else:
        raw = (np.clip(x, -1, 1) * (2**31 - 1)).astype("<i4").tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(sampwidth)
        w.setframerate(SR)
        w.writeframes(raw)


def _contract_compat(torch, dev, d) -> dict:
    """audfprint_torch.compat with no device: Analyzer() lands on `dev`,
    glob2hashtable over four WAVs equals the Analyzer's own call, the
    hashes hold Jaccard > 0.9 against the numpy oracle, and
    Matcher().match_file names each excerpt's track at rank 0."""
    from audfprint_torch.compat import audfprint_analyze as ca
    from audfprint_torch.compat import audfprint_match as cm
    from audfprint_torch.oracle import analyze as oa
    from audfprint_torch.utils.audio import audio_write_wav

    rng = np.random.default_rng(SEED + 70)
    songs = [synth_audio(rng, dur_sec=10.0, n_tones=80) for _ in range(4)]
    for i, x in enumerate(songs):
        audio_write_wav(os.path.join(d, f"compat{i}.wav"), x, SR)
    an = ca.Analyzer()
    require(an.device.type == torch.device(dev).type,
            f"compat Analyzer() landed on {an.device}, not {dev}")
    pattern = os.path.join(d, "compat*.wav")
    ht = ca.glob2hashtable(pattern)
    again = an.glob2hashtable(pattern)
    require(_tables_equal(ht, again),
            "compat glob2hashtable differs from Analyzer().glob2hashtable")
    jac = [_jaccard(oa.samples_to_hashes(x), h)[0]
           for x, h in zip(songs, an.samples_batch2hashes(songs))]
    m = cm.Matcher()
    require(m.device.type == torch.device(dev).type,
            f"compat Matcher() landed on {m.device}, not {dev}")
    ranks = []
    for i, x in enumerate(songs):
        q = os.path.join(d, f"compat_q{i}.wav")
        audio_write_wav(q, x[3 * SR: 7 * SR], SR)
        rows, _dur, _nh = m.match_file(an, ht, q)
        ranks.append(len(rows) > 0 and ht.names[int(rows[0][0])]
                     == os.path.join(d, f"compat{i}.wav"))
    print(f"contract compat: Analyzer() on {an.device}, glob2hashtable "
          f"{len(ht.names)} files, {ht.totalhashes()} hashes; oracle "
          f"Jaccard {[round(j, 4) for j in jac]}; match_file rank 0 "
          f"{sum(ranks)} of {len(ranks)}")
    require(min(jac) > 0.9, f"compat hashes: oracle Jaccard {min(jac)}")
    require(all(ranks), f"compat match_file missed rank 0: {ranks}")
    return {"contract_compat_jaccard_min": min(jac)}


def _contract_zero_size(torch, dev) -> None:
    """The kernels' wrappers at B = 0 and T = 0 (and K3 at fanout 0, K4
    at H = 0) return empty results without a launch (their guards, not a
    caught error)."""
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import landmarks as L
    from audfprint_torch.ops import peaks as PK
    from audfprint_torch.ops import scan as SC
    from audfprint_torch.ops import spectro as SP
    from audfprint_torch.ops.config import PipelineConfig

    cfg = PipelineConfig()
    F, k = cfg.n_bins, cfg.maxpksperframe
    gvec = torch.as_tensor(PK.gauss_vector(cfg), device=dev)
    before = _counts()
    for B, T, fan in ((0, 40, 3), (2, 0, 3), (0, 0, 3), (2, 40, 0)):
        slots = torch.ones((B, T, k), dtype=torch.int32, device=dev)
        pcfg = cfg._replace(maxpairsperpeak=fan)
        out = L.slots_to_hashes(slots, slots.bool(), pcfg)
        require(all(a.shape == (B, T, k, fan) for a in out),
                f"slots_to_hashes at B={B}, T={T}, fanout {fan}: "
                f"{[tuple(a.shape) for a in out]}")
    for B, T in ((0, 40), (2, 0), (0, 0)):
        x = torch.zeros((B, T, F), device=dev)
        nf = torch.full((B,), T, dtype=torch.int32, device=dev)
        y, (xc, yc) = SP.hpf(x, cfg)
        require(y.shape == (B, T, F) and xc.shape == (B, F),
                f"hpf at B={B}, T={T}: {tuple(y.shape)}")
        bins, valid = CP.find_peaks_slots_fused(x, nf, cfg)
        require(bins.shape == (B, T, k) and not bool(valid.any()),
                f"find_peaks_slots_fused at B={B}, T={T}")
        kept = CP.prune_fwd_bwd(x, nf, torch.zeros((B, F), device=dev),
                                torch.zeros((B, F), device=dev), gvec,
                                cfg.a_dec, k)
        require(kept.shape == (B, T, k), f"prune_fwd_bwd at B={B}, T={T}")
        if B == 0:
            lpos, _v, env = CP.prune_fwd_carry(
                x, torch.zeros((B, F), device=dev), gvec, cfg.a_dec, k)
            require(lpos.shape == (B, T, k) and env.shape == (B, F),
                    f"prune_fwd_carry at B={B}, T={T}")
    for shape in ((0, 9), (4, 0), (0,)):
        x = torch.zeros(shape, dtype=torch.int64, device=dev)
        for op, rev in SCAN_OPS:
            require(SC.seg_scan(x, op, rev).shape == shape,
                    f"seg_scan at {shape}, {op}")
    _sync(torch, dev)
    after = _counts()
    require(after == before, f"a zero-size call launched a kernel: {before} "
                             f"-> {after}")


def _contract_edges(torch, dev, d) -> dict:
    """Empty, short and silent audio give no hashes; an empty DB and an
    empty query give no rows through Matcher and the fused path; WAVs of
    8/16/24/32 bits, stereo and truncated decode through the batched
    native loader to the host decode's arrays and hashes; a 20 s track
    stored at maxtime=512 matches at rank 0 at the wrapped offset."""
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match.matcher import Matcher
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.utils import audio as audio_io

    an = Analyzer(device=dev)
    rng = np.random.default_rng(SEED + 71)
    song = synth_audio(rng, dur_sec=4.0)
    zeros = [np.zeros(n, np.float32) for n in (0, 100, SR)]
    silent = os.path.join(d, "silent.wav")
    audio_io.audio_write_wav(silent, zeros[2], SR)
    got = an.samples_batch2hashes(zeros + [song])
    require([len(h) for h in got[:3]] == [0, 0, 0] and len(got[3]) > 10,
            f"empty/short/silent audio: {[len(h) for h in got]} hashes")
    require(all(len(an.samples2hashes(z)) == 0 for z in zeros)
            and len(an.wavfile2hashes(silent)) == 0,
            "empty, short or silent audio gave hashes")

    q = an.samples2hashes(song)
    empty_q = np.zeros((0, 2), np.int32)
    n_rows = []
    for geom in ({"hashbits": 12, "depth": 4, "maxtime": 1024}, {}):
        ht = HashTable(**geom)
        m = Matcher(device=dev, verbose=0)
        n_rows.append(len(m.match_hashes(ht, q)))
        fused = m.match_samples_fused(an, ht, [song, zeros[2]])
        n_rows += [len(r) for r in fused[0]]
        ht.store_vectorized("song", q)
        m.invalidate()
        n_rows.append(len(m.match_hashes(ht, empty_q)))
        both = m.match_hashes_batch(ht, [empty_q, q, empty_q])
        fused = m.match_samples_fused(an, ht, [zeros[0], song, zeros[2]])
        require([len(r) for r in both] == [0, 1, 0]
                and [len(r) for r in fused[0]] == [0, 1, 0],
                f"empty queries beside a real one: {both} / {fused[0]}")
    require(n_rows == [0] * len(n_rows),
            f"an empty DB or an empty query gave rows: {n_rows}")

    paths, variants = [], [(1, 1), (2, 1), (2, 2), (3, 1), (4, 1)]
    x = synth_audio(rng, dur_sec=3.0, n_tones=30)
    for w, nch in variants:
        paths.append(os.path.join(d, f"v{w}_{nch}.wav"))
        _write_wav(paths[-1], x, w, nch)
    with open(paths[1], "rb") as f:
        raw = f.read()
    paths.append(os.path.join(d, "trunc.wav"))
    with open(paths[-1], "wb") as f:
        f.write(raw[:-1])
    nat = audio_io.read_wav_batch(paths, sr=SR)
    require(nat is not None, "the native WAV loader did not build")
    native_ok = 0
    for p, y in zip(paths, nat):
        host, _sr = audio_io.audio_read(p, sr=SR)
        if y is not None:
            native_ok += 1
            require(np.array_equal(y, host), f"{os.path.basename(p)}: the "
                    "native decode differs from the host decode")
        hy = an.samples2hashes(host if y is None else y)
        require(np.array_equal(hy, an.wavfile2hashes(p)) and len(hy) > 10,
                f"{os.path.basename(p)}: hashes differ from the host "
                "decode's")
    trunc, _sr = audio_io.audio_read(paths[-1], sr=SR)
    require(len(trunc) == 3 * SR - 1,
            f"the truncated WAV decoded to {len(trunc)} samples")

    maxtime = 512
    long = synth_audio(np.random.default_rng(SEED + 72), dur_sec=20.0,
                       n_tones=140)
    h = an.samples2hashes(long)
    ht = HashTable(hashbits=16, depth=30, maxtime=maxtime)
    ht.store_vectorized("wrap", h)
    clip = long[256 * 600: 256 * 600 + 4 * SR]
    rows = Matcher(device=dev, verbose=0).match_hashes(
        ht, an.samples2hashes(clip))
    fused = Matcher(device=dev, verbose=0).match_samples_fused(an, ht, [clip])
    require(int(h[:, 0].max()) > maxtime, "the track does not wrap")
    require(len(rows) == 1 and int(rows[0][0]) == 0
            and abs(int(rows[0][2]) - 600 % maxtime) <= 2,
            f"time wrap: rows {rows}")
    require(np.array_equal(fused[0][0], rows), "time wrap: the fused path's "
                                               "rows differ")
    print(f"contract edges: 0/100/{SR} zero samples and a silent WAV give "
          f"0 hashes; empty DB and empty queries 0 rows (Matcher, fused); "
          f"{len(paths)} WAV variants decoded ({native_ok} by the native "
          f"loader) to the host decode's hashes; time wrap at maxtime="
          f"{maxtime}: rank 0 at offset {int(rows[0][2])} (expected "
          f"{600 % maxtime})")
    return {"contract_native_decoded": native_ok}


def _contract_duplicates(torch, dev, seeds=(11, 12, 13)) -> int:
    """tests/test_fuzz_compat.py's duplicate-heavy store and match on the
    card: a hashbits=8, depth=4, maxtimebits=8 table whose buckets all
    overflow; DT.store_batch equals the numpy HashTable, and both voting
    cores equal oracle.match.match_hashes in every combination of exact x
    time range x sort by time, bit for bit."""
    from audfprint_torch import params as P
    from audfprint_torch.index import device_table as DT
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match import voting
    from audfprint_torch.oracle import match as om

    n_rows = 0
    for seed in seeds:
        rng = np.random.default_rng(seed)
        tcfg = DT.TableConfig(hashbits=8, depth=4, maxtimebits=8)
        ht = HashTable(hashbits=8, depth=4, maxtime=256)
        streams = [np.stack([rng.integers(0, 64, 300),
                             rng.integers(0, 16, 300)], axis=1).astype(
            np.int32) for _ in range(4)]
        for i, pairs in enumerate(streams):
            ht.store(f"t{i}", pairs)
        table, counts = DT.empty_table(tcfg, dev)
        DT.store_batch(
            table, counts,
            torch.as_tensor(np.stack([s[:, 0] for s in streams]), device=dev),
            torch.as_tensor(np.stack([s[:, 1] for s in streams]), device=dev),
            torch.ones((4, 300), dtype=torch.bool, device=dev),
            torch.arange(4, dtype=torch.int32, device=dev), tcfg)
        require(np.array_equal(table.cpu().numpy().view(np.uint32), ht.table)
                and np.array_equal(counts.cpu().numpy(), ht.counts),
                f"seed {seed}: the device store differs from the host's")
        q = np.unique(np.stack([rng.integers(0, 32, 60),
                                rng.integers(0, 16, 60)], axis=1).astype(
            np.int32), axis=0)
        qt, qh, qv = (np.zeros((1, 64), np.int32), np.zeros((1, 64), np.int32),
                      np.zeros((1, 64), bool))
        qt[0, :len(q)], qh[0, :len(q)], qv[0, :len(q)] = q[:, 0], q[:, 1], True
        hpi = np.zeros(16, np.int32)
        hpi[:4] = ht.hashesperid
        args = [torch.as_tensor(a, device=dev) for a in (hpi, qt, qh, qv)]
        for exact in (False, True):
            for tr in (False, True):
                for sbt in (False, True):
                    mp = P.MatcherParams(search_depth=8, max_returns=4,
                                         threshcount=1, exact_count=exact,
                                         find_time_range=tr, sort_by_time=sbt)
                    want = om.match_hashes(ht, q, mp)
                    mcfg = voting.MatchConfig.from_params(mp, qt_cap=64,
                                                          n_ids_cap=16)
                    out = voting.match_batch(table, counts, *args, tcfg, mcfg)
                    n = int(out["n_results"][0])
                    got = {"sorted": np.stack(
                        [out[c][0].cpu().numpy() for c in (
                            "ids", "filtcount", "mode_dt", "rawcount",
                            "min_t", "max_t")], axis=1)[:n]}
                    packed = voting.match_batch_packed(
                        table, counts, *args, tcfg, mcfg, core="hist").cpu()
                    got["hist"] = packed[0, : int(packed[0, :, 6].sum()),
                                         :6].numpy()
                    for core, g in got.items():
                        require(np.array_equal(g, want),
                                f"seed {seed} core {core} exact={exact} "
                                f"time range={tr} sort by time={sbt}: card "
                                f"{g.tolist()} oracle {want.tolist()}")
                    n_rows += 2 * len(want)
    print(f"contract duplicate-heavy: {len(seeds)} seeds, the device store "
          f"equal to the host's, {n_rows} rows of 2 cores x 8 modes equal "
          f"the oracle's bit for bit")
    return n_rows


def _contract_accuracy(torch, dev) -> dict:
    """tests/test_accuracy.py's 16 x 8 s fixture and query sets on the
    card: clean >= 0.95, noisy >= 0.8, no rows on noise or out-of-DB
    music, the rows equal to the numpy oracle's on the card's hashes; the
    +/-4% sweep recovers the sped queries (>= 0.9, >= plain + 0.3)."""
    from scipy.signal import resample_poly

    from audfprint_torch import params as P
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match.matcher import Matcher
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.oracle import match as om

    dur, n_tracks = 8.0, 16
    rng = np.random.default_rng(2026)
    tracks = [synth_audio(rng, dur_sec=dur, n_tones=60)
              for _ in range(n_tracks)]
    an = Analyzer(device=dev)
    ht = HashTable(hashbits=18, depth=50, maxtime=8192)
    for i, h in enumerate(an.samples_batch2hashes(tracks)):
        ht.store_vectorized(f"track{i}", h)

    def segment(x):
        start = rng.integers(0, int((dur - 4) * SR))
        return x[start: start + 4 * SR].copy()

    def sped(c):
        return resample_poly(c.astype(np.float64), 962, 1000).astype(
            np.float32)

    # the file's draws from its module generator, in the order of its tests
    sets = {"clean": [segment(x) for x in tracks], "noisy": []}
    for x in tracks:
        c = segment(x)
        sets["noisy"].append(c + 0.05 * rng.standard_normal(len(c)).astype(
            np.float32))
    sets["noise"] = [(0.1 * rng.standard_normal(4 * SR)).astype(np.float32)
                     for _ in range(8)]
    clean0 = [segment(x) for x in tracks]
    for snr_db in (30, 20, 10, 5, 0):
        for c in clean0:
            rng.standard_normal(len(c))
    speed_clean = [segment(x) for x in tracks]
    sets["speed"] = [sped(c) for c in speed_clean]
    sweep = [sped(segment(x)) for x in tracks]
    sets["oodb"] = [synth_audio(np.random.default_rng(777000 + i),
                                dur_sec=4.0, n_tones=60) for i in range(8)]

    m = Matcher(device=dev, verbose=0)
    truths = list(range(n_tracks))
    top1, n_rows = {}, 0
    for name, queries in sets.items():
        qh = an.samples_batch2hashes(queries)
        rows = m.match_hashes_batch(ht, qh)
        want = [om.match_hashes(ht, h, P.MatcherParams()) for h in qh]
        bad = _rows_differing(rows, want)
        require(not bad, f"accuracy set {name}: rows differ from the "
                         f"oracle's for queries {bad[:8]}")
        n_rows += sum(len(w) for w in want)
        top1[name] = (sum(1 for r in rows if len(r)) / len(rows)
                      if name in ("noise", "oodb") else
                      sum(1 for r, t in zip(rows, truths)
                          if len(r) and r[0][0] == t) / n_tracks)
    best = m.match_samples_sweep(an, ht, sweep, 4.0)
    plain = m.match_hashes_batch(ht, an.samples_batch2hashes(sweep))
    r_plain = sum(1 for r, t in zip(plain, truths)
                  if len(r) and r[0][0] == t) / n_tracks
    r_sweep = sum(1 for (r, _f, _nh), t in zip(best, truths)
                  if len(r) and int(r[0][0]) == t) / n_tracks
    print(f"contract accuracy (16 x 8 s): top-1 clean {top1['clean']}, "
          f"noisy {top1['noisy']}, sped {top1['speed']}; rows reported on "
          f"noise {top1['noise']}, out-of-DB {top1['oodb']}; sweep "
          f"{r_sweep} against plain {r_plain}; {n_rows} rows equal the "
          f"oracle's")
    require(top1["clean"] >= 0.95, f"clean top-1 {top1['clean']}")
    require(top1["noisy"] >= 0.8, f"noisy top-1 {top1['noisy']}")
    require(top1["noise"] == 0 and top1["oodb"] == 0,
            f"false positives: noise {top1['noise']}, oodb {top1['oodb']}")
    require(top1["speed"] <= top1["clean"] - 0.3,
            f"a 3.8% speed change did not degrade: {top1['speed']}")
    require(r_sweep >= 0.9 and r_sweep >= r_plain + 0.3,
            f"sweep {r_sweep} against plain {r_plain}")
    return {"contract_top1_clean": top1["clean"],
            "contract_top1_noisy": top1["noisy"],
            "contract_sweep_top1": r_sweep}


def _contract_new_functions(torch, dev) -> None:
    """The entry points ported last, on the card against the CPU:
    whitened_spectrogram (K2) within the front end's tolerance, and
    fwd_prune_carry (K1f) bit for bit on the same spectrogram, from the
    head and from a carried envelope."""
    from audfprint_torch.ops import peaks as PK
    from audfprint_torch.ops import pipeline as PL
    from audfprint_torch.ops import spectro as SP
    from audfprint_torch.ops.config import PipelineConfig

    cfg = PipelineConfig()
    rng = np.random.default_rng(SEED + 73)
    x = np.stack([synth_audio(rng, dur_sec=6.0, n_tones=50)
                  for _ in range(2)])
    nf = np.array([PL.n_frames_padded_static(x.shape[1], cfg), 100],
                  np.int32)
    got = SP.whitened_spectrogram(torch.as_tensor(x, device=dev),
                                  torch.as_tensor(nf, device=dev), cfg)
    want = SP.whitened_spectrogram(torch.as_tensor(x), torch.as_tensor(nf),
                                   cfg)
    err = max(float((got[b, :n].cpu() - want[b, :n]).abs().max())
              for b, n in enumerate(nf))
    require(all(torch.allclose(got[b, :n].cpu(), want[b, :n], atol=5e-3,
                               rtol=1e-3) for b, n in enumerate(nf)),
            f"whitened_spectrogram on the card: max |diff| {err}")
    sg = np.round(rng.standard_normal((2, 400, cfg.n_bins)) * 2).astype(
        np.float32) / 2
    nfp = np.array([400, 257], np.int32)
    env = np.abs(rng.standard_normal((2, cfg.n_bins))).astype(np.float32)
    for use_env in (False, True):
        mk, ek = PK.fwd_prune_carry(
            *[torch.as_tensor(a, device=dev) for a in (sg, nfp, env)], cfg,
            use_env)
        mp, ep = PK.fwd_prune_carry(
            *[torch.as_tensor(a) for a in (sg, nfp, env)], cfg, use_env)
        require(torch.equal(mk.cpu(), mp) and _same_bits(torch, ek.cpu(), ep),
                f"fwd_prune_carry (K1f) differs from its plain version, "
                f"envelope in: {use_env}")
    print(f"contract new entry points: whitened_spectrogram on the card "
          f"max |diff| {err:.3g} against the CPU; fwd_prune_carry (K1f) bit "
          f"for bit, from the head and from a carry")


def phase_contract(torch, rec: dict, dev, d) -> dict:
    """The JAX package's behavioural contract (its tests/test_edge_cases,
    test_fuzz_compat, test_accuracy and test_compat_surface) on the card:
    the compat surface with no device, the kernels' zero-size guards, the
    edge inputs, the duplicate-heavy tiny geometry against the oracle and
    the accuracy fixture.  The kernels' launches are counted over these
    (the zero-size calls launch nothing); the comparisons of the entry
    points ported last with the CPU come after the count."""

    t0 = time.time()
    _counts_zero()
    out = _contract_compat(torch, dev, d)
    _contract_zero_size(torch, dev)
    out.update(_contract_edges(torch, dev, d))
    out["contract_rows_duplicate_heavy"] = _contract_duplicates(torch, dev)
    out.update(_contract_accuracy(torch, dev))
    _sync(torch, dev)
    launches = _counts()
    out["contract_s"] = time.time() - t0
    print(f"contract phase: {out['contract_s']:.2f} s; launches {launches}")
    require(launches["prune_fwd_bwd"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0 and launches["seg_scan"] > 0,
            f"a kernel was not launched on the contract path: {launches}")
    rec["_paths"]["contract"] = launches
    _contract_new_functions(torch, dev)      # comparisons: not counted
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--gloo-rank":
        return _gloo_rank(sys.argv[2:])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from audfprint_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of an audfprint checkout ({e})",
              file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rec: dict = {"_paths": {}}
    summary: dict = {"card": smi}
    try:
        t0 = time.time()
        so = _build.build()
        summary["build_s"] = time.time() - t0
        print(f"build: {summary['build_s']:.2f} s -> "
              f"{os.path.relpath(so, ROOT)}")
        with open(so[:-3] + ".log") as f:
            for line in f:
                if "Used" in line:
                    print("  ptxas:" + line.split("info    :")[-1].rstrip())
        walls: dict = {}
        summary["phase_wall_s"] = walls

        def timed(name, fn, *args):
            t = time.time()
            out = fn(*args)
            walls[name] = round(time.time() - t, 1)
            return out

        timed("kernels", phase_kernels, torch, rec)
        timed("stream_kernels", phase_stream_kernels, torch, rec, dev)
        timed("pair_kernel", phase_pair, torch, rec, dev)
        timed("scan_kernel", phase_scan, torch, rec, dev)
        with tempfile.TemporaryDirectory() as d:
            summary.update(timed("contract", phase_contract, torch, rec, dev,
                                 d))
        main_summary, ctx, t_two_stage = timed("main_path", phase_main_path,
                                               torch, rec)
        summary.update(main_summary)
        summary.update(timed("vote_rows", phase_vote_rows, torch, ctx, dev))
        summary.update(timed("graphs", phase_graphs, torch, rec, ctx, dev))
        summary.update(timed("two_stage", phase_two_stage, torch, rec, ctx,
                             dev))
        summary.update(timed("device_store", phase_device_store, torch, rec,
                             ctx["tracks"], ctx["ht"], t_two_stage, dev))
        summary.update(timed("sharded", phase_sharded, torch, rec, ctx, dev))
        with tempfile.TemporaryDirectory() as d:
            summary.update(timed("process_boundary", phase_process_boundary,
                                 torch, ctx, dev, d))
        summary.update(timed("config3", phase_config3, torch, rec, dev))
        with tempfile.TemporaryDirectory() as d:
            summary.update(timed("broadcast", phase_broadcast, torch, rec,
                                 ctx, dev, d))
            summary.update(timed("listen", phase_listen, torch, rec, ctx, dev,
                                 d))
        summary.update(timed("wide", phase_wide, torch, rec, ctx, dev))
        del ctx
        with tempfile.TemporaryDirectory() as d:
            summary.update(timed("streaming", phase_streaming, torch, rec,
                                 {"dir": d}, dev))
        summary.update(timed("cli", phase_cli))
        print("phase walls, s: " + json.dumps(walls))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print("summary: " + json.dumps(summary, default=float))
    paths = rec.pop("_paths")
    kernels = []
    for name, source, replaces in (
            ("prune_fwd_bwd", "audfprint_torch/csrc/prune.cu",
             "audfprint_tpu/ops/pallas_peaks.py:316"),
            ("prune_fwd_carry", "audfprint_torch/csrc/prune.cu",
             "audfprint_tpu/ops/peaks.py:111"),
            ("hpf_scan", "audfprint_torch/csrc/hpf.cu",
             "audfprint_tpu/ops/spectro.py:77"),
            ("pair_scan", "audfprint_torch/csrc/pair.cu",
             "audfprint_tpu/ops/landmarks.py:77"),
            ("seg_scan", "audfprint_torch/csrc/scan.cu",
             "audfprint_tpu/match/voting.py:546")):
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=sum(by_path.values()),
                            launches_by_path=by_path, **rec[name]))
    print(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
