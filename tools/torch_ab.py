#!/usr/bin/env python3
"""Host-sensitive timings of audfprint_torch checkouts, side by side on one
GPU, so that two trees are compared within one session of one card.

    python3 tools/torch_ab.py OLD NEW NEW OLD [--out DIR]

Each argument is the root of a checkout (a `git archive` of a commit will
do), measured in that order, each in a fresh process that imports that
root's audfprint_torch.  The inputs are made once, from chip_smoke's seeds
and recipes (chip_smoke.synth_track): the 7,200 s WAV of its streaming
phase and one 256 x 30 s batch of config 2's tracks.  For each root:

  * host_probe_s: wall seconds of a fixed host-only numpy job (a 300 s
    synth_track), a reading of how fast the host runs in this process;
  * stream_s: wall seconds of three runs of the streamed route
    (Analyzer.wavfile2hashes_streaming, 8,192-frame chunks; the first one
    cold) and the audio-s/s of the best;
  * stream_host_s: cumulative host seconds of the streamed route's stages
    under cProfile (one more run, slowed by the profiler);
  * stream_device_ms: the device's busy time in one more run under
    torch.profiler (the summed spans of its kernels and copies), beside
    that run's wall;
  * stages_ms: device ms per stage of the batch (chip_smoke.stage_breakdown:
    CUDA events, calls queued behind a spinning kernel);
  * query_device_events: kernels and copies on the device, in
    torch.profiler, while the Analyzer fingerprints one 8 s query (the
    first 8 s of the batch's first track), warm.

Prints one `torch_ab: {json}` line per root and writes the cProfile
listings to DIR when --out is given.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the streamed route's stages whose cumulative host time is reported
_STAGES = ("open_stream_source", "_stats_pass", "_peaks_pass",
           "chunk_fwd_peaks", "drain", "bwd_prune_sparse", "_pair_on_device",
           "unique")


def _inputs(work: str) -> tuple:
    """chip_smoke's 7,200 s WAV (phase 8's seed) and a 256 x 30 s batch of
    config 2's tracks (phase 6's seed), written under `work`."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from audfprint_torch.utils.audio import audio_write_wav

    wav = os.path.join(work, "long.wav")
    audio_write_wav(wav, cs.synth_track(np.random.default_rng(cs.SEED + 4),
                                        7200.0), cs.SR)
    rng = np.random.default_rng(cs.SEED + 2)
    batch = np.stack([cs.synth_track(rng, 30.0) for _ in range(256)]
                     ).astype(np.float32)
    npz = os.path.join(work, "batch.npy")
    np.save(npz, batch)
    return wav, npz


def _child(root: str, wav: str, npy: str, out: str | None) -> dict:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import audfprint_torch
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(audfprint_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise SystemExit(f"imported {pkg}, not the package of {root}")
    res = {"root": root}
    t0 = time.perf_counter()
    cs.synth_track(np.random.default_rng(0), 300.0)
    res["host_probe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.build()
    res["build_s"] = time.perf_counter() - t0

    dev = torch.device("cuda")
    an = Analyzer(device=dev)
    an.stream_chunk_frames = 8192

    def stream():
        torch.cuda.synchronize()
        t = time.perf_counter()
        h = an.wavfile2hashes_streaming(wav)
        torch.cuda.synchronize()
        return time.perf_counter() - t, h

    walls, hashes = [], None
    for _ in range(3):
        w, h = stream()
        walls.append(w)
        hashes = h if hashes is None else hashes
        if not np.array_equal(h, hashes):
            raise SystemExit("the streamed route gave different hashes")
    res["stream_s"] = walls
    res["stream_audio_s_per_s"] = an.soundfiledur / min(walls)
    res["stream_hashes"] = int(len(hashes))

    prof = cProfile.Profile()
    prof.enable()
    w, _h = stream()
    prof.disable()
    res["stream_cprofile_wall_s"] = w
    st = pstats.Stats(prof)
    cum: dict = {}
    for (_f, _l, name), (_cc, _nc, _tt, ct, _callers) in st.stats.items():
        if name in _STAGES:
            cum[name] = cum.get(name, 0.0) + ct
    res["stream_host_s"] = cum
    if out:
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(40)
        tag = os.path.basename(os.path.abspath(root).rstrip(os.sep))
        with open(os.path.join(out, f"stream_cprofile_{tag}.txt"), "w") as f:
            f.write(buf.getvalue())

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        w, _h = stream()
    # the program's spans also show on the device's timeline as user
    # annotations over the work they launched: not device work
    def device(e):
        return (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    spans = [e for e in p.events() if device(e)]
    res["stream_device_events"] = len(spans)
    res["stream_device_ms"] = sum(e.time_range.elapsed_us()
                                  for e in spans) / 1e3
    res["stream_profiled_wall_s"] = w

    batch = np.load(npy)
    lens = np.full(batch.shape[0], batch.shape[1], np.int32)
    res["stages_ms"] = cs.stage_breakdown(torch, batch, lens)

    query = [batch[0, : 8 * cs.SR]]
    an.samples_batch2hashes(query)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        an.samples_batch2hashes(query)
        torch.cuda.synchronize()
    res["query_device_events"] = sum(device(e) for e in p.events())
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="checkout roots, in run order")
    ap.add_argument("--out", help="directory for the cProfile listings")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--wav", help=argparse.SUPPRESS)
    ap.add_argument("--npy", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("torch_ab: " + json.dumps(
            _child(args.child, args.wav, args.npy, args.out), default=float),
            flush=True)
        return 0
    if not args.roots:
        ap.error("give at least one checkout root")
    import torch
    if not torch.cuda.is_available():
        print("torch_ab: needs a CUDA device", file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        wav, npy = _inputs(work)
        print(f"inputs made in {time.perf_counter() - t0:.1f} s", flush=True)
        for root in args.roots:
            cmd = [sys.executable, os.path.abspath(__file__), "--child", root,
                   "--wav", wav, "--npy", npy]
            if args.out:
                cmd += ["--out", args.out]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("torch_ab: ")]
            if proc.returncode or not lines:
                print(f"{root}: exit {proc.returncode}\n{proc.stdout[-3000:]}"
                      f"\n{proc.stderr[-3000:]}", file=sys.stderr)
                return 1
            print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
