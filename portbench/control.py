"""The control of the comparison: the plain reference computed in
bfloat16 (the nearest precision below the float32 the configuration
states) put in the program's place, judged as a run's outputs are.

  python3 -m portbench.control --workload W --seeds 11,12,13

prints one JSON line of readings a seed.  Each kind's `control`
(portbench/kinds/<kind>.py) gives the reference's outputs on the same
inputs as a run, without a window.  The control has to come out as not
correct (portbench/tests/test_pb_control.py holds that at a small size;
PERF.md gives its readings on the card at the cell's own size).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import torch

from portbench import drive, run
from portbench.spans import Spans

LOW = torch.bfloat16


def readings(files: dict, seed: int, device) -> dict:
    cell = drive.Cell(files["cfg"], files["mix"], seed, 0.0, False, device,
                      tempfile.gettempdir(), Spans())
    traffic = run.kind(files["mix"]["kind"])
    out, inp = traffic.control(cell, LOW)
    return traffic.judge(out, inp, device)


def main(argv: list) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    files = run.cell_files(run.manifest(), a.workload)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    limits = files["limits"]
    for s in a.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(files, int(s), dev)
        fails = sorted(k for k, v in r.items()
                       if limits.get(k) is None or v > limits[k])
        print(json.dumps({"workload": a.workload, "seed": int(s),
                          "readings": r, "fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
