#!/usr/bin/env python3
"""Where kernel K3 (audfprint_torch/csrc/pair.cu) spends its time, on one GPU.

    python3 tools/k3_phases.py [--out chiprun_out/k3_phases.json]

Builds csrc/pair.cu four times with nvcc, each time with one more of its
phases cut out of the source text (the anchors' walk; then the compaction
of the valid peaks; then the load of the frames), so that the last build
only zeroes the output tiles and stores them.  Times each build by direct
calls at the main path's shapes (chip_smoke.cuda_ms: device time of
back-to-back launches): a 256 x 1535 x 5 batch of random slots (60 %
valid), config 2's real peak slots (one 256 x 30 s batch of its corpus),
a 1 x 431 x 5 listen query and a streamed 2 h file's 1 x 310,078 x 5
slots.  The whole build must equal the plain version bit for bit; the cut
ones compute less and are only timed.  A phase's cost is the difference
between two neighbouring builds.  Beside them, torch's zero_ of the two
outputs, a store of the same bytes.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each build cuts the previous one's phases and one more
CUTS = (
    ("full", ()),
    ("no walk", (("for (int a = tid; a < start[nt]; a += kThreads) {",
                  "for (int a = tid; a < 0; a += kThreads) {"),)),
    ("no compaction", (("for (int f0 = 0; f0 < nf; f0 += kThreads) {",
                        "for (int f0 = 0; f0 < 0; f0 += kThreads) {"),)),
    ("no load", (("  copy_tile(s_bins, g_bins, nf * K);\n"
                  "  copy_tile(s_valid, g_valid, nf * K);\n", ""),)),
)


def build(out_dir: str) -> dict:
    """The cut builds, compiled in parallel: {name: loaded library}."""
    from audfprint_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "pair.cu")) as f:
        src = f.read()
    procs = {}
    for i, (name, reps) in enumerate(CUTS):
        for old, new in reps:
            if old not in src:
                raise RuntimeError(f"k3_phases: csrc/pair.cu has no {old!r}")
            src = src.replace(old, new)
        cu = os.path.join(out_dir, f"pair_{i}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = cu[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _out, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"k3_phases: nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(so)
        lib.pair_scan.argtypes = _build._SIGNATURES["pair_scan"]
        lib.pair_scan.restype = ctypes.c_int
        libs[name] = lib
    return libs


def inputs(torch, cs, cfg) -> dict:
    """{shape name: (bins int32, valid bool)} on the card, from
    chip_smoke's seeds and recipes."""
    import numpy as np
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.ops import cuda_peaks as CP
    from audfprint_torch.ops import pipeline as pipe
    from audfprint_torch.ops import spectro as SP

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED + 8)
    shapes = {}
    for name, b, t in (("random 256 x 1535", 256, 1535),
                       ("query 1 x 431", 1, 431)):
        shapes[name] = tuple(torch.from_numpy(a).to(dev) for a in
                             cs.pair_input(rng, b, t, cfg.maxpksperframe,
                                           cfg.n_bins, "random"))
    slots, _anchors = cs.stream_slots(rng, 310078, cfg.maxpksperframe)
    s = torch.from_numpy(slots).to(dev)
    shapes["stream 1 x 310078"] = (
        torch.clamp(s.to(torch.int32) - 1, min=0), s > 0)
    tracks = cs._in_processes(cs.config2_track, range(256))
    _idx, batch, lens = Analyzer(device="cuda").stage_groups(tracks)[0]
    nf = pipe.frame_count_device(torch.as_tensor(lens, device=dev), cfg)
    white = SP.whitened_logmag(torch.as_tensor(batch, device=dev), nf, cfg)
    bins, valid = CP.find_peaks_slots_fused(white, nf, cfg)
    shapes["config-2 peaks 256 x 1535"] = (bins.to(torch.int32).contiguous(),
                                           valid.contiguous())
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "k3_phases.json"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("k3_phases: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from audfprint_torch.ops import landmarks as L
    from audfprint_torch.ops.config import PipelineConfig

    print(cs.nvidia_smi_line(), flush=True)
    cfg = PipelineConfig()
    libs = build(os.path.join(REPO, "build", "k3_phases"))
    res = {"card": cs.nvidia_smi_line(), "ms": {}}
    for shape, (bins, valid) in inputs(torch, cs, cfg).items():
        B, T, K = bins.shape
        fan = cfg.maxpairsperpeak
        want = L.slots_to_hashes_plain(bins, valid, cfg)
        h = torch.empty((B, T, K, fan), dtype=torch.int32, device="cuda")
        v = torch.empty((B, T, K, fan), dtype=torch.bool, device="cuda")
        row = {}
        for name, lib in libs.items():
            def call(lib=lib):
                return lib.pair_scan(
                    bins.data_ptr(), valid.data_ptr(), h.data_ptr(),
                    v.data_ptr(), B, T, K, fan, cfg.mindt, cfg.targetdt,
                    cfg.targetdf, torch.cuda.current_stream().cuda_stream)

            if call():
                raise RuntimeError(f"k3_phases: {name} failed to launch")
            torch.cuda.synchronize()
            if name == "full" and not (torch.equal(h, want[1])
                                       and torch.equal(v, want[2])):
                raise RuntimeError(f"k3_phases: K3 differs on {shape}")
            row[name] = cs.cuda_ms(call, 50)
        row["torch zero_ of both outputs"] = cs.cuda_ms(
            lambda: (h.zero_(), v.zero_()), 50)
        res["ms"][shape] = row
        print(f"{shape}: " + ", ".join(f"{k} {ms:.4f} ms"
                                       for k, ms in row.items()), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
