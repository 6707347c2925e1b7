#!/usr/bin/env python3
"""Where a chunk of the benchmark's ingest cell spends its host time, and
whether a chunk's counts fetch waits for the next chunk's device work.

    python3 tools/ingest_trace.py [--seed N] [--out DIR]

Builds the inputs of portbench's `c2-1k.ingest` cell from the seed, at the
cell's own sizes (2,048 x 30 s int16 tracks in chunks of 256, through the
program's DeviceIngest on the GPU one chunk ahead, each pass into the
zeroed table), warms the key, then:

  * span_ns: the cost of one span of utils/timing on this host, off, on,
    and on under a recording torch.profiler (ns a span, 200,000 spans,
    20,000 under the profiler), beside the bare loop around them;
  * rounds: three passes over the collection in turns with the tracer off
    and on (no profiler): each pass's host ms a chunk in dispatch_chunk and
    consume_chunk on the host clock around the calls, so the on/off
    difference is the tracer's cost;
  * split: one traced pass of the cell's traced chunks (its mix's
    `traced_chunks`, 8) under torch.profiler (CPU and CUDA activity) with the tracer's spans as its
    ranges: per chunk the ms of ingest.dispatch and its children
    (ingest.stage, ingest.ids, graph.pin, graph.launch) and their self
    time, of ingest.consume and ingest.counts_fetch, and the device's busy
    ms in the span;
  * fetch_order: for each consume of chunk i-1 made after chunk i's
    dispatch, from the trace's timestamps (one clock for host ranges and
    device events): when the device-to-host copy of its counts started,
    against the start and end of chunk i's device work (the device
    events that begin after chunk i's graph.launch range opened).

Prints one `ingest_trace: {json}` line and writes the Chrome trace to DIR
when --out is given.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from audfprint_torch.models.ingest import DeviceIngest  # noqa: E402
from audfprint_torch.utils import timing  # noqa: E402
from portbench import drive, run  # noqa: E402
from portbench.spans import Spans  # noqa: E402
from portbench.trace import DEVICE_CATS, _union_s  # noqa: E402

ROUNDS = 3


def span_ns(n: int = 200_000) -> dict:
    """ns a span (with its exit) off, on, and on under a profiler (n / 10
    spans there, each an event the profiler keeps), beside the bare loop
    ("loop") that each of them includes."""
    from torch.profiler import ProfilerActivity, profile

    def loop(n, bare=False):
        t0 = time.perf_counter_ns()
        if bare:
            for i in range(n):
                pass
        else:
            for i in range(n):
                with timing.span("ingest.dispatch", id=i):
                    pass
        return (time.perf_counter_ns() - t0) / n

    saved = timing.TRACER
    timing.TRACER = timing.Tracer()
    try:
        out = {"loop": loop(n, bare=True), "off": loop(n)}
        timing.TRACER.on = True
        out["on"] = loop(n)
        timing.TRACER.on = False
        timing.TRACER.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            out["profiled"] = loop(n // 10)
    finally:
        timing.TRACER = saved
    return out


def per_chunk(tracer, names) -> dict:
    """The mean ms a chunk of each span name, and the parents' self ms."""
    n = max(1, tracer.calls.get("ingest.dispatch", 0))
    out = {k: tracer.total_ns.get(k, 0) / n / 1e6 for k in names}
    for k in ("ingest.dispatch", "ingest.consume"):
        out[k + ".self"] = tracer.self_ns.get(k, 0) / n / 1e6
    return out


def fetch_order(events: list) -> list:
    """For each counts fetch of chunk i-1 that follows chunk i's
    graph.launch: its device-to-host copy's start against chunk i's
    device work, all in ms from chunk i's graph.launch opening."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e.get("name", "?"), e.get("cat"))
                 for e in events if e.get("ph") == "X" and "dur" in e
                 and e.get("cat") in DEVICE_CATS)
    host = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            host.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    launches = sorted(host.get("graph.launch", []))
    fetches = sorted(host.get("ingest.counts_fetch", []))
    out = []
    for i, (la, lb) in enumerate(launches):
        nxt = launches[i + 1][0] if i + 1 < len(launches) else float("inf")
        # the fetch made after this launch and before the next one
        fs = [f for f in fetches if la < f[0] < nxt]
        if not fs:
            continue
        fa, fb = fs[0]
        d2h = [d for d in dev if d[3] == "gpu_memcpy" and "DtoH" in d[2]
               and fa <= d[0] <= fb]
        work = [d for d in dev if la <= d[0] < nxt and d not in d2h
                and not (d[3] == "gpu_memcpy" and "DtoH" in d[2])]
        if not d2h or not work:
            continue
        c0 = d2h[0][0]
        before = [d for d in work if d[1] <= c0]
        out.append({
            "chunk": i, "fetch_of": i - 1,
            "launch_close_ms": (lb - la) / 1e3,
            "fetch_open_ms": (fa - la) / 1e3,
            "fetch_close_ms": (fb - la) / 1e3,
            "d2h_start_ms": (c0 - la) / 1e3,
            "chunk_work_first_ms": (work[0][0] - la) / 1e3,
            "chunk_work_last_end_ms": (max(d[1] for d in work) - la) / 1e3,
            "work_events": len(work),
            "work_events_before_d2h": len(before),
            "d2h_after_all_chunk_work": len(before) == len(work)})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/ingest_trace.py")
    p.add_argument("--seed", type=int, default=7100000001)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    files = run.cell_files(run.manifest(), "c2-1k.ingest")
    cfg, mix = files["cfg"], files["mix"]
    res = {"device": torch.cuda.get_device_name(0), "seed": a.seed,
           "span_ns": span_ns()}
    tmp = tempfile.mkdtemp(prefix="ingest_trace-")
    cell = drive.Cell(cfg, mix, a.seed, 0.0, True, "cuda", tmp, None)
    tracks = drive.make_tracks(cell, int(mix["tracks"]))
    an = drive.analyzer(cfg["db_analyzer"], "cuda")
    di = DeviceIngest(drive.empty_table(cfg), an, ndev=1)
    chunks = drive.chunked([(f"track{i}", x) for i, x in enumerate(tracks)],
                           int(mix["chunk"]))

    def reset():
        di.table.zero_()
        di.counts.zero_()

    sync = torch.cuda.synchronize
    drive.ingest_chunks(di, chunks, reset=reset)           # the key, warm
    sync()
    rounds = {"off": [], "on": []}
    for r in range(ROUNDS):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            timing.TRACER.reset()
            timing.TRACER.on = mode == "on"
            spans = Spans()
            drive.ingest_chunks(di, chunks, spans=spans, reset=reset)
            sync()
            timing.TRACER.on = False
            rounds[mode].append({
                "dispatch_ms": spans.mean_ms("ingest_dispatch"),
                "consume_ms": spans.mean_ms("ingest_consume_wait"),
                "traced_dispatch_ms": timing.TRACER.mean_ms(
                    "ingest.dispatch")})
    res["rounds"] = rounds
    res["rounds_median_dispatch_ms"] = {
        m: statistics.median(x["dispatch_ms"] for x in v)
        for m, v in rounds.items() if v}

    from torch.profiler import ProfilerActivity, profile
    timing.TRACER.reset()
    nc = int(mix["traced_chunks"])
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        drive.ingest_chunks(di, chunks[:nc], reset=reset)
        sync()
        window = time.perf_counter() - w0
    tr = timing.TRACER
    names = ("ingest.dispatch", "ingest.stage", "ingest.ids", "graph.pin",
             "graph.launch", "ingest.consume", "ingest.counts_fetch")
    res["split_ms_a_chunk"] = per_chunk(tr, names)
    res["split_window_ms_a_chunk"] = 1e3 * window / nc
    d = res["split_ms_a_chunk"]
    for k in ("ingest.dispatch", "ingest.consume"):
        tot = d[k]
        res[f"{k}.children_cover"] = (tot - d[k + ".self"]) / tot if tot \
            else None
    res["counters"] = dict(tr.counters)
    path = os.path.join(a.out or tmp, "ingest_trace.json")
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    busy = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATS]
    res["device_busy_ms_a_chunk"] = 1e3 * _union_s(busy) / nc
    res["fetch_order"] = fetch_order(events)
    if not a.out:
        os.remove(path)
    os.rmdir(tmp)
    print("ingest_trace: " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
