#!/usr/bin/env python3
"""Kernel K4 (seg_scan) of audfprint_torch checkouts side by side on one
GPU, so that two trees are compared in one run on one card.

    python3 tools/k4_ab.py OLD NEW NEW OLD [--out FILE]

Each argument is the root of a checkout (a `git archive` of a commit will
do), measured in that order, each in a fresh process that imports that
root's audfprint_torch and so builds that root's csrc/scan.cu.  The
inputs are made in each process from one seed by this checkout's
chip_smoke.scan_input (the vote's run starts), at this checkout's
chip_smoke.SCAN_TIMED shapes; at each shape every op and direction of
chip_smoke.SCAN_OPS is checked bit for bit against the plain version
(ops/scan.seg_scan_plain) and then timed with chip_smoke.cuda_ms (50
launches queued behind a spinning kernel) beside torch's own call
(cummax, cummin, cumsum; a reverse scan flips inside the time).  Where
the tree's ops/scan.py offers several tiles (TILES), the forward max is
also timed at each tile forced, beside the one ops/scan.plan takes.
Then the floor: a one-tile row of the tree's smallest tile, and a row
one element longer (two tiles: the tree's second launch or workspace
memset, and the carry between tiles).

Prints one `k4_ab: {json}` line per root ({"root", "device", "ms":
{shape: {op: [kernel, torch]}}, "floor_ms"}) and, with --out, writes the
lines to FILE.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(root: str) -> dict:
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import numpy as np
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import audfprint_torch
    from audfprint_torch.ops import scan as SC

    here = os.path.dirname(os.path.abspath(audfprint_torch.__file__))
    if os.path.dirname(here) != os.path.abspath(root):
        raise RuntimeError(f"imported {here}, not {root}'s audfprint_torch")
    dev = torch.device("cuda")

    def library(x, op, rev):
        xs = x.flip(-1) if rev else x
        if op == "max":
            return torch.cummax(xs, dim=-1)
        if op == "min":
            return torch.cummin(xs, dim=-1)
        return torch.cumsum(xs, dim=-1)

    rng = np.random.default_rng(cs.SEED + 15)
    out = {}
    for _key, shape in cs.SCAN_TIMED:
        x = torch.from_numpy(cs.scan_input(rng, shape, "run starts")).to(dev)
        by_op = {}
        for op, rev in cs.SCAN_OPS:
            if not torch.equal(SC.seg_scan(x, op, rev),
                               SC.seg_scan_plain(x, op, rev)):
                raise RuntimeError(f"K4 differs from its plain version at "
                                   f"{shape}, {op} reverse={rev}")
            by_op[f"{op} {'reverse' if rev else 'forward'}"] = [
                cs.cuda_ms(lambda: SC.seg_scan(x, op, rev), 50),
                cs.cuda_ms(lambda: library(x, op, rev), 20)]
        out[str(shape)] = by_op
        # a tree whose K4 offers several tiles: forward max at each
        for tile in getattr(SC, "TILES", ()):
            by_op[f"max forward, tile {tile}"] = [cs.cuda_ms(
                lambda: SC.seg_scan(x, "max", tile=tile), 50), None]
    # the floor: a row of the smallest tile (no look-back, no workspace)
    # and a row one longer (two tiles: the workspace memset and the
    # look-back)
    small = getattr(SC, "TILES", (getattr(SC, "TILE", 4096),))[0]
    floor = {}
    for n in (small, small + 1):
        x = torch.from_numpy(cs.scan_input(rng, (1, n), "random")).to(dev)
        floor[f"(1, {n})"] = cs.cuda_ms(lambda: SC.seg_scan(x, "max"), 100)
    return {"root": root, "device": cs.nvidia_smi_line(), "ms": out,
            "floor_ms": floor}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("k4_ab: " + json.dumps(_child(args.roots[0])))
        return 0
    lines = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("k4_ab: ")][-1]
        print(line, flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
