"""Device time from a `torch.profiler` trace of a span of the workload.

The trace is exported as Chrome JSON into the run's temporary directory
and read back: device events are kernels, copies and memsets; the busy
time is the union of their intervals; an idle gap is named by the
innermost host range (a benchmark span or a PyTorch op) that covers its
middle.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_s(iv: list) -> float:
    busy, end = 0.0, -1.0
    for a, b in sorted(iv):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / 1e6


def _gaps(iv: list, t0: float, t1: float) -> list:
    out, end = [], t0
    for a, b in sorted(iv):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if t1 > end:
        out.append((end, t1))
    return out


def _host_at(hosts: list, starts: list, t: float, look: int = 400) -> str:
    """Innermost host range covering t, among the `look` ranges that start
    last before it (hosts sorted by start)."""
    best, width = "host (untraced)", float("inf")
    i = bisect.bisect_right(starts, t)
    for a, b, name in hosts[max(0, i - look): i]:
        if b >= t and b - a < width:
            best, width = name, b - a
    return best


def profile(fn, spans, tmpdir: str) -> dict:
    """Run fn() under the profiler; returns the trace's summary."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    spans.annotate = True
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - w0
    spans.annotate = False
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    dev, hosts, per_op = [], [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, b))
            per_op[e.get("name", "?")] += (b - a) / 1e6
        elif e.get("cat") in ("user_annotation", "cpu_op"):
            hosts.append((a, b, e.get("name", "?")))
    hosts.sort()
    starts = [h[0] for h in hosts]
    gaps = defaultdict(float)
    if dev:
        t0 = min(a for a, _ in dev)
        for a, b in _gaps(dev, t0, max(b for _, b in dev)):
            gaps[_host_at(hosts, starts, (a + b) / 2)] += (b - a) / 1e6
    top = sorted(per_op.items(), key=lambda kv: -kv[1])
    return {"busy_s": _union_s(dev), "window_s": window,
            "kernel_s": dict(per_op), "n_device_events": len(dev),
            "device_ops": [[k, v] for k, v in top[:10]],
            "idle_gaps": [[k, v] for k, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
