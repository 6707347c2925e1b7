"""The control of the comparison: the plain reference computed in
bfloat16 (the nearest precision below the float32 the configuration
states) put in the program's place, judged as a run's outputs are.

  python3 -m portbench.control --workload W --seeds 11,12,13

prints one JSON line of readings a seed.  The control answers each pool
query once and stores the whole collection: the same prompts as a run,
without a window.  It has to come out as not correct (portbench/tests/
test_pb_control.py holds that at a small size; PERF.md gives its readings on
the card at the cell's own size).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from portbench import drive, judge, run
from portbench.spans import Spans

LOW = torch.bfloat16


def control_outputs(cell: drive.Cell) -> tuple[dict, dict]:
    """(outputs, inputs) of the bfloat16 reference on a cell's inputs."""
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    kind = mix["kind"]
    n = int(mix["tracks"]) if kind == "ingest" else int(
        cfg["corpus"]["tracks"])
    tracks = drive.make_tracks(cell, n)
    keys, tb = judge.reference_tables(tracks, n, cfg, dev, LOW)
    inputs = {"cfg": cfg, "tracks": tracks}
    if kind == "ingest":
        stored = np.array([[i, len(k)] for i, k in enumerate(keys)],
                          np.int64)
        return {"table": tb, "n_table": n, "stored": stored}, inputs
    pool = int(mix["batch"]) * int(mix["pool_batches"])
    clips = drive.queries(cell, tracks, pool)
    rows, nq = judge.reference_rows(tb, clips, cfg, dev, LOW)
    inputs["clips"] = clips
    answers = np.concatenate([np.arange(pool)[:, None], rows, nq[:, None]],
                             axis=1)
    return {"table": tb, "answers": answers}, inputs


def readings(files: dict, seed: int, device) -> dict:
    cell = drive.Cell(files["cfg"], files["mix"], seed, 0.0, False, device,
                      tempfile.gettempdir(), Spans())
    out, inp = control_outputs(cell)
    return judge.JUDGES[files["mix"]["kind"]](out, inp, device)


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
