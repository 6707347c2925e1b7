"""One run of one cell: python -m portbench --workload W --seed N
--seconds S --trace 0|1, from the root of a checkout.

The run loads the program (the first run in a checkout builds its CUDA
kernels and host library into build/audfprint_torch/), makes its inputs
from the seed, builds the cell's table through the program, warms what
the window runs, measures for S seconds, frees the program's state, runs
the comparison with the plain reference, and prints one JSON line last.
Everything a cell needs is found by name from BENCHMARK.json: the
configuration in portbench/configs/<config>.json, the traffic in
portbench/mixes/<traffic>.json, whose "kind" names the module of its
driver and comparison in portbench/kinds/<kind>.py (drive.py says what it
holds), the limits of the comparison in portbench/limits/<workload>.json
and a reader for each metric in portbench/metrics/<metric>.py, or
<base>.py for a metric <base>.<suffix>.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_files(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix, limits and metric entries;
    its mix's kind is loaded here, so an unknown one stops the run before
    any set-up."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"one of {sorted(cells)}")
    files = files_of(bench, cells[workload])
    kind(files["mix"]["kind"])
    return files


def files_of(bench: dict, w: dict) -> dict:
    """The files of a cell entry {name, config, traffic, chips}."""
    workload = w["name"]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])]
    return {"cell": w,
            "cfg": load_json(os.path.join(HERE, "configs",
                                          w["config"] + ".json")),
            "mix": load_json(os.path.join(HERE, "mixes",
                                          w["traffic"] + ".json")),
            "limits": load_json(os.path.join(HERE, "limits",
                                             workload + ".json")),
            "end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    """The `read(rec)` of metrics/<name>.py, or of metrics/<base>.py."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            return _module(path, "portbench_metric_"
                           + stem.replace(".", "_")).read
    raise FileNotFoundError(f"no reader for metric {name}")


def kind(name: str):
    """The module kinds/<name>.py of a kind of traffic: its `drive(cell)`,
    `judge(outputs, inputs, device)` and `control(cell, dtype)`."""
    folder = os.path.join(HERE, "kinds")
    known = sorted(f[:-3] for f in os.listdir(folder) if f.endswith(".py"))
    if name not in known:
        raise SystemExit(f"unknown traffic kind {name!r}; one of {known}")
    return _module(os.path.join(folder, name + ".py"),
                   "portbench_kind_" + name)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse(argv: list) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def check_chip(chips: int) -> str | None:
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device (torch.cuda.is_available() is false)"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} devices, "
                f"{torch.cuda.device_count()} present")
    return None


def run_cell(files: dict, seed: int, seconds: float, traced: bool,
             device, tmp: str, started: float) -> dict:
    """Drive the cell, judge it and read its metrics -> the result line
    (without its process checks)."""
    import torch
    from portbench import drive
    from portbench.spans import Spans

    cfg, mix = files["cfg"], files["mix"]
    traffic = kind(mix["kind"])
    spans = Spans()
    cell = drive.Cell(cfg, mix, seed, seconds, traced, device, tmp, spans)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rec = traffic.drive(cell)
    rec["setup_s"] = cell.t_open - started
    rec["spans"] = spans
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    outputs, inputs = rec["outputs"](), rec["inputs"]
    rec["release"]()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = traffic.judge(outputs, inputs, device)
    log(f"reference and comparison: {time.perf_counter() - t0:.3f} s")
    limits = files["limits"]
    checks = {k: {"value": readings[k], "limit": limits.get(k)}
              for k in sorted(readings)}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values()) and rec["failed"] == 0
    entries = files["per_layer"] if traced else files["end_to_end"]
    metrics = {}
    for m in entries:
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics, "device": dev}
    if traced and "trace" in rec:
        tr = rec["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv: list) -> int:
    from portbench import procs
    age = procs.process_age_s()
    started = time.time() - (age if age is not None else 0.0)
    args = parse(argv)
    files = cell_files(manifest(), args.workload)
    # kernel and JIT caches at fixed paths inside the checkout
    os.environ.setdefault("CUDA_CACHE_PATH",
                          os.path.join(ROOT, "build", "portbench", "nv"))
    why = check_chip(int(files["cell"]["chips"]))
    if why:
        log(f"portbench: {why}; no result")
        return 2
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        line = run_cell(files, args.seed, args.seconds, bool(args.trace),
                        "cuda", tmp, started)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = procs.forbidden_modules()
    if bad:
        log(f"portbench: the run loaded {bad}; no result")
        return 3
    log(f"card: {procs.nvidia_smi()}")
    strays = procs.children()
    if strays:
        log("portbench: processes left running: "
            + "; ".join(procs.describe(p) for p in strays))
        procs.reap(strays)
        line["correct"] = False
        line["failed"] += len(strays)
    for k, c in line["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 1 if strays else 0
