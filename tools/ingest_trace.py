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
    (ingest.slot_wait, ingest.stage, ingest.ids, graph.pin,
    graph.launch) and their self time, of ingest.consume and
    ingest.counts_fetch, and the device's busy ms in the span;
  * fetch_order: for each chunk i-1 consumed after chunk i's dispatch,
    from the trace's device events: when the device-to-host copy of its
    counts started, against the end of its own chunk's device work and
    the start and end of chunk i's (fetch_order below);
  * slot_counters: the staging slots DeviceIngest made and reused in
    the traced pass.

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
    """Each chunk's counts copy against the device work of its own chunk
    and of the next, from the trace's device events.  A chunk's work runs
    from its first host-to-device copy (its inputs) to the next chunk's;
    the k-th device-to-host copy is chunk k's counts (one a chunk, in
    consume order).  For each chunk i-1 whose copy and whose successor
    i are in the trace, in ms:

      own_gap_ms       the copy's start less the end of its own chunk's
                       last device operation before it (a copy queued
                       right after its chunk's graph: ~0);
      next_gap_ms      its start less the end of chunk i's last device
                       operation (a copy queued behind chunk i's graph:
                       ~0, positive);
      before_next_work whether it starts before chunk i's first device
                       operation;
      after_next_work  whether it starts after all of chunk i's."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e.get("name", "?"), e.get("cat"))
                 for e in events if e.get("ph") == "X" and "dur" in e
                 and e.get("cat") in DEVICE_CATS)

    def copy(d, way):
        return d[3] == "gpu_memcpy" and way in d[2]

    starts, prev_h2d = [], False
    for i, d in enumerate(dev):
        h2d = copy(d, "HtoD")
        if h2d and not prev_h2d:
            starts.append(i)
        prev_h2d = h2d
    bounds = starts + [len(dev)]
    work = [[d for d in dev[a:b] if not copy(d, "DtoH")]
            for a, b in zip(bounds, bounds[1:])]
    d2h = [d for d in dev if copy(d, "DtoH")]
    out = []
    for i in range(1, min(len(work), len(d2h) + 1)):
        c0 = d2h[i - 1][0]
        own = [d[1] for d in work[i - 1] if d[1] <= c0]
        nxt = work[i]
        if not own or not nxt:
            continue
        out.append({
            "chunk": i, "fetch_of": i - 1,
            "own_gap_ms": (c0 - max(own)) / 1e3,
            "next_gap_ms": (c0 - max(d[1] for d in nxt)) / 1e3,
            "before_next_work": c0 < nxt[0][0],
            "after_next_work": c0 >= max(d[1] for d in nxt),
            "next_work_events": len(nxt)})
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
    names = ("ingest.dispatch", "ingest.slot_wait", "ingest.stage",
             "ingest.ids", "graph.pin", "graph.launch", "ingest.consume",
             "ingest.counts_fetch")
    res["split_ms_a_chunk"] = per_chunk(tr, names)
    res["split_window_ms_a_chunk"] = 1e3 * window / nc
    d = res["split_ms_a_chunk"]
    for k in ("ingest.dispatch", "ingest.consume"):
        tot = d[k]
        res[f"{k}.children_cover"] = (tot - d[k + ".self"]) / tot if tot \
            else None
    res["counters"] = dict(tr.counters)
    res["slot_counters"] = {k: v for k, v in tr.counters.items()
                            if k.startswith("ingest.slot_")}
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
