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
     timed at the batch, a query and the streamed shape.  Each kernel's
     time (device time of back-to-back launches, cuda_ms) beside its bound
     (bytes over 3.35 TB/s, or float32 operations over 67 TFLOP/s or int32
     operations over 16.7 TOP/s, whichever is longer)
  6. the main path at BASELINE config 2 ("1k-track DB of 30s clips; clean
     exact-segment queries"): 1,000 synthetic music-like 30 s tracks from
     a fixed seed -> Analyzer(device="cuda") -> host HashTable (2^20 x 100)
     -> device table -> 64 clean 10 s hop-aligned queries through the fused
     Matcher path; top-1 self >= 0.95, hash Jaccard > 0.9 against the
     oracle for 4 tracks, and K1, K2 and K3 launched on this path; K1
     timed on the candidate map of one (256 x 30 s) batch of the corpus,
     K3 held against its plain version and timed on its peak slots
  7. the fused device store (models/ingest.DeviceIngest) over the same
     1,000 tracks: table, counts and hashesperid equal the host store's
     bit for bit; ingest rate against fingerprint + host store
  8. streaming: K1f timed on an 8,192-frame chunk of a seeded 7,200 s
     WAV, then the WAV through Analyzer's streamed route (K1f, K2 and K3
     launched, time, device memory peak), equal at 8,192- and 2,048-frame
     chunks, Jaccard > 0.9 against the in-memory path; then
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
     events; the sonify WAV); then the golden CLI
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
     condition
 11. broadcast monitoring: a seeded 7,200 s WAV of 360 x 20 s segments,
     every third a frame-aligned excerpt of a distinct config-2 track, the
     rest fresh audio; `match --windowed 10 --window-hop 5` through
     cli.do_match on phase 6's table (the file streams: K1f and K2); every
     excerpt named at rank 0 by a window inside it, <= 5% of the windows
     inside filler reporting a track, and do_match's device peak above
     what was resident within the vote's budget (Matcher._budget_bytes)
 12. the `match --listen` loop (cli.do_listen over an os.pipe) on phase
     6's queries: 16 interactive requests (latency), then a backlog of 48
     with one missing path; lines equal batch do_match's, in order, the
     missing path reported, fewer do_match calls than backlog queries
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
     the plane.  Then a process boundary: two processes of two shards each
     over gloo, both on the card, store 300 tracks' hashes and match 16
     queries; their table and rows equal the single-device ones.  Phase 9
     also runs new / add / match / merge with --ndev 4 against --ndev 1

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

Each path of phases 6-8, 10-13, 15 and 16 runs with the kernels' launch
counts set to 0 just before it and read just after; the kernel record
lists them by path.  Every one of these paths fingerprints, so each must
launch K3.
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
            k1_plain = cuda_ms(lambda: CP.prune_fwd_bwd_plain(
                m0, nf, e0f, e0b, gvec, cfg.a_dec, cfg.maxpksperframe), 1)
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
        plain = cuda_ms(lambda: L.slots_to_hashes_plain(bins, valid, cfg), 1)
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
        plain = cuda_ms(lambda: SP.hpf_plain(x, cfg, c), 1)
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
    k1f_plain = cuda_ms(
        lambda: CP.prune_fwd_carry_plain(m0, env0, gvec, a, k), 1)
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
    # the allocator; and the per-stage breakdown of one full batch
    an.samples_batch2hashes(tracks[:256])
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
    matcher.match_samples_fused(an, ht, queries[:8])       # warm shapes
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
            and launches["pair_scan"] > 0,
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
    from audfprint_torch.models.ingest import (DeviceIngest,
                                               sharded_fused_ingest_fn)
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
        ing = DeviceIngest(h, Analyzer(device=dev), ndev)
        if cap is not None:
            ing._fn = sharded_fused_ingest_fn(ing.mesh, ing.analyzer.config,
                                              ing.cfg, cap_override=cap)
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

    launches = _counts()
    print(f"sharded path: launches {launches}")
    require(launches["prune_fwd_bwd"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0,
            f"a kernel was not launched on the sharded path: {launches}")
    rec["_paths"]["sharded"] = launches
    return {"sharded": out}


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
    K3 (landmarks)."""
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import landmarks as L
    from audfprint_torch.ops import spectro as SP

    return SP.launches, CP.launches, L.launches


def _counts_zero() -> None:
    for d in _launch_counters():
        for key in d:
            d[key] = 0


def _counts() -> dict:
    return {k: v for d in _launch_counters() for k, v in d.items()}


def _cli(argv: list, timeout: int = 900) -> str:
    """python -m audfprint_torch <argv> as a subprocess; returns stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "audfprint_torch", *argv],
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


def phase_device_store(torch, rec: dict, tracks: list, ht_host,
                       t_two_stage: float, dev, chunk: int = 256) -> dict:
    """The fused device store over config 2's tracks: bit-identical to the
    host store, and its ingest rate against fingerprint + host store."""
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.models.ingest import DeviceIngest

    an = Analyzer(device=dev)
    names = [f"track{i}" for i in range(len(tracks))]
    warm = DeviceIngest(HashTable(), an)       # allocator, cuFFT plans
    warm.consume_chunk(warm.dispatch_chunk(
        [(n, "wav", x) for n, x in zip(names[:chunk], tracks[:chunk])],
        print))
    del warm
    ht = HashTable()
    # ---- the device-store path, counted ----
    _counts_zero()
    torch.cuda.synchronize()
    t0 = time.time()
    ing = DeviceIngest(ht, an)
    for i in range(0, len(tracks), chunk):
        ing.consume_chunk(ing.dispatch_chunk(
            [(n, "wav", x) for n, x in zip(names[i: i + chunk],
                                           tracks[i: i + chunk])], print))
    ing.finalize()
    t_dev = time.time() - t0
    launches = _counts()
    same = (np.array_equal(ht.table, ht_host.table)
            and np.array_equal(ht.counts, ht_host.counts)
            and np.array_equal(ht.hashesperid, ht_host.hashesperid)
            and ht.names == ht_host.names)
    audio = sum(len(x) for x in tracks) / SR
    print(f"device store, config 2: {len(tracks)} tracks in {t_dev:.3f} s = "
          f"{audio / t_dev:.1f} audio-s/s fused (fingerprint + host store: "
          f"{audio / t_two_stage:.1f} audio-s/s); table, counts and "
          f"hashesperid equal the host store's: {same}; launches {launches}")
    require(same, "the device store's table differs from the host store's")
    require(launches["prune_fwd_bwd"] > 0 and launches["hpf_scan"] > 0
            and launches["pair_scan"] > 0,
            f"a kernel was not launched on the device-store path: {launches}")
    rec["_paths"]["device_store"] = launches
    return {"device_store_audio_s_per_s": audio / t_dev,
            "two_stage_audio_s_per_s": audio / t_two_stage}


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
    curve = {}
    for name, kw in CONFIG3_CONDITIONS:
        queries = [_degrade(c, rng, **kw) for c in clean]
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
            and launches["pair_scan"] > 0,
            f"a kernel was not launched on the config 3 path: {launches}")
    rec["_paths"]["config3_sweep"] = launches
    return {"config3_curve": curve}


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
            and launches["pair_scan"] > 0,
            f"the broadcast log did not stream through K1f, K2 and K3: "
            f"{launches}")
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
    return {"broadcast_windows": len(wins), "broadcast_wall_s": wall,
            "broadcast_rows_vs_oracle": len(sample),
            "broadcast_windows_per_s": len(wins) / wall,
            "broadcast_found": len(found), "broadcast_filler_fp": fp_share,
            "broadcast_stream_peak_mib": peak_stream,
            "broadcast_do_match_peak_mib": peak_all,
            "broadcast_vote_sub_batch": bsub,
            "broadcast_vote_budget_mib": budget / 2**20}


def phase_listen(torch, rec, ctx, dev, d, n_inter=16, n_backlog=48) -> dict:
    """cli.do_listen fed through an os.pipe: interactive requests one at a
    time (latency), then a backlog with a missing path (throughput,
    batching); lines equal batch do_match's over the same list."""
    import threading

    from audfprint_torch.utils.audio import audio_write_wav
    from audfprint_torch.utils.timing import Stages
    from audfprint_torch import cli

    ht, matcher = ctx["ht"], ctx["matcher"]
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
    t0 = time.time()
    n_warm = cli.do_warmup(ht, an, matcher, args, print)
    _sync(torch, dev)
    print(f"listen: warmup ran {n_warm} paths in {time.time() - t0:.2f} s")

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
            for p in inter:
                with cond:
                    n0 = n_results()
                t = time.perf_counter()
                writer.write(p + "\n")
                writer.flush()
                with cond:
                    if not cond.wait_for(lambda: n_results() > n0, 120):
                        raise RuntimeError(f"no answer for {p}")
                    lat.append(got[-1][0] - t)
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
        # ---- the listen loop, counted ----
        _counts_zero()
        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        n_served, _dur = cli.do_listen(ht, an, matcher, args, report,
                                       Stages(), None, stream=reader)
        _sync(torch, dev)
        t_end = time.perf_counter()
        th.join(timeout=60)
    finally:
        cli.do_match = real
        reader.close()
    launches = _counts()
    require(not errors and not th.is_alive(), f"listen feeder: {errors}")
    served = [ln for _, ln in got]
    batch: list = []
    an.fail_on_error = False
    cli.do_match(ht, an, matcher, inter + backlog, args, batch.append,
                 Stages())
    an.fail_on_error = True

    def results(ls):
        return [ln for ln in ls if ln.startswith(("Matched", "NOMATCH"))]

    backlog_calls = calls[mark["calls"]:]
    n_ok = len(backlog) - 1
    bq_s = n_ok / (t_end - mark["t"])
    lat_ms = sorted(1e3 * t for t in lat)
    p50 = lat_ms[len(lat_ms) // 2]
    errs = [ln for ln in served if ln.startswith("Error reading")]
    print(f"listen: {n_inter} interactive requests, latency p50 "
          f"{p50:.2f} ms, max {lat_ms[-1]:.2f} ms (write path -> result "
          f"line; decode + fused fingerprint and match + one sync each); "
          f"backlog of {len(backlog)} paths ({n_ok} queries + 1 missing) "
          f"served in {len(backlog_calls)} do_match calls {backlog_calls}, "
          f"{bq_s:.1f} q/s; {n_served} served in all; launches {launches}")
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
            and launches["pair_scan"] > 0,
            f"a kernel was not launched on the listen path: {launches}")
    rec["_paths"]["listen"] = launches
    return {"listen_p50_ms": p50, "listen_max_ms": lat_ms[-1],
            "listen_backlog_q_per_s": bq_s,
            "listen_backlog_calls": len(backlog_calls)}


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
    m.match_samples_fused(an, ht, queries[:8])     # upload + warm shapes
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
            and launches["pair_scan"] > 0,
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


def phase_cli_ndev(d, wavs, query, rank0, ndev: int = 4) -> dict:
    """new, add, match and merge with --ndev 4 (four logical shards of the
    card) as subprocesses: their lines and saved databases equal the
    --ndev 1 ones, and `new --ndev 4` launches the kernels."""
    from audfprint_torch.index.hash_table import HashTable

    def lines(text, n):
        return [ln.replace(f"_n{n}.", "_n.") for ln in text.splitlines()
                if not ln.startswith("Processed ")]

    outs, launches = {}, {}

    def run_ndev(n):
        nd = ["--ndev", str(n)]
        db, dbb = (os.path.join(d, f"{k}_n{n}.pklz") for k in ("nd", "ndb"))
        metrics = os.path.join(d, f"nd_metrics{n}.json")
        o = _cli(["new", "-d", db, *nd, "--json-metrics", metrics, *wavs[:2]])
        with open(metrics) as f:
            launches[n] = json.load(f)["kernel_launches"]
        o += _cli(["add", "-d", db, *nd, wavs[2]])
        o += _cli(["new", "-d", dbb, *nd, wavs[1], wavs[0]])
        o += _cli(["merge", "-d", db, *nd, dbb])
        o += _cli(["match", "-d", db, *nd, "-R", "-X", "-x", "3", query])
        o += _cli(["match", "-d", db, *nd, query])
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
    print(f"CLI --ndev {ndev}: lines and both saved databases equal --ndev "
          f"1's; new --ndev {ndev} launches {launches[ndev]} (--ndev 1: "
          f"{launches[1]}); 12 subprocesses in {wall:.1f} s")
    return {"cli_ndev_same": True, "cli_ndev_launches": launches[ndev]}


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
    """The kernels' wrappers at B = 0 and T = 0 (and K3 at fanout 0)
    return empty results without a launch (their guards, not a caught
    error)."""
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import landmarks as L
    from audfprint_torch.ops import peaks as PK
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
            and launches["pair_scan"] > 0,
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
        with tempfile.TemporaryDirectory() as d:
            summary.update(timed("contract", phase_contract, torch, rec, dev,
                                 d))
        main_summary, ctx, t_two_stage = timed("main_path", phase_main_path,
                                               torch, rec)
        summary.update(main_summary)
        summary.update(timed("vote_rows", phase_vote_rows, torch, ctx, dev))
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
             "audfprint_tpu/ops/landmarks.py:77")):
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
