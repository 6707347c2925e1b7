"""The port's one tracer: per-stage totals, program spans and counters.

The reference has only the end-of-run "= R x RT" line; this adds, without
changing the stdout contract:

  Stages     the CLI's coarse stages (decode / analyze / store / match /
             save ...), timed always; `-v 2` reports them and
             `--json-metrics` writes them as stage_seconds / stage_calls.
             While spans record, a stage is also the span `stage.<name>`
             (a parent, a raw record and a profiler range) whose time
             goes to the stage's total alone, not to the tracer's.
  span       `span(name, id=None)`, a context manager at a boundary of
             the program (models/ingest.py, utils/graphs.py).  Off by
             default: a span is then one shared no-op that reads no clock
             and allocates nothing.  On (`TRACER.on`, which the CLI's
             `--json-metrics` sets for its run) or while a torch.profiler
             session records, a span records its perf_counter_ns start
             and end, its parent (the innermost open span on its thread)
             and an id (its parent's when not given: the spans of one
             ingest chunk share the chunk's sequence number), and adds to
             per-name totals, calls and self time (its time less what its
             children cover).  Under a profiler it is also a
             record_function range, so the Chrome trace holds it on the
             profiler's clock beside the device's kernels and copies.
             With CUDA activity a range that launches device work also
             shows on the device's timeline as a `gpu_user_annotation`
             event (`is_user_annotation`): a reader of device time leaves
             it out, as torch's own tables do.
  count      `count(name, n)` adds to a counter while spans record.
  event      `event(name, seconds)`: a one-time event (a graph key's
             warm-up and capture, timed by its caller), added to a
             process-wide total always.

The tracer is process-wide (`TRACER`); its raw records are kept up to
RECORDS_CAP and written out by `--json-metrics` at the end of the run.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

from torch.autograd import profiler as _profiler

RECORDS_CAP = 1 << 16


class _Off:
    """The span handed out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "tally", "parent", "t0", "t1", "child_ns",
                 "rf")

    def __init__(self, name: str, id, tally: bool = True):
        # tally: add to the tracer's per-name totals (a stage's time goes
        # to its Stages instead)
        self.name, self.id, self.tally = name, id, tally

    def __enter__(self):
        stack = TRACER._stack()
        self.parent = stack[-1] if stack else None
        if self.id is None and self.parent is not None:
            self.id = self.parent.id
        stack.append(self)
        self.child_ns = 0
        # the clock is read outside the profiler's range, so that the
        # span's time holds the range (and what opening it cost)
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = self.t1 = time.perf_counter_ns()
        TRACER._stack().pop()
        dur = t1 - self.t0
        if self.parent is not None:
            self.parent.child_ns += dur
        TRACER._close(self, t1, dur)
        return False


class Tracer:
    """Per-name span totals (ns), calls and self time, counters, raw
    records and one-time events.  `on` turns spans and counters on; a
    recording profiler does too, for as long as it records."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self.events: dict[str, list] = {}
        self.reset()

    def reset(self) -> None:
        """Forget spans, counters and records (not the one-time events,
        which are the process's)."""
        with self._lock:
            self.total_ns: dict[str, int] = defaultdict(int)
            self.self_ns: dict[str, int] = defaultdict(int)
            self.calls: dict[str, int] = defaultdict(int)
            self.counters: dict[str, int] = defaultdict(int)
            self.records: list = []
            self.dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, sp: _Span, t1: int, dur: int) -> None:
        with self._lock:
            if sp.tally:
                self.total_ns[sp.name] += dur
                self.self_ns[sp.name] += dur - sp.child_ns
                self.calls[sp.name] += 1
            if len(self.records) < RECORDS_CAP:
                self.records.append(
                    (sp.name, sp.id,
                     sp.parent.name if sp.parent is not None else None,
                     sp.t0, t1))
            else:
                self.dropped += 1

    def mean_ms(self, name: str) -> float | None:
        """Milliseconds a call of span `name`, None when it never ran."""
        n = self.calls.get(name, 0)
        return self.total_ns[name] / n / 1e6 if n else None

    def event_s(self, name: str) -> float | None:
        """Seconds of the one-time event `name` in the process, None
        when it never happened."""
        e = self.events.get(name)
        return e[0] if e else None

    def summary(self) -> dict:
        """What --json-metrics writes: each span's total and self seconds
        and calls, the counters, the one-time events and the raw records
        (start seconds on perf_counter's clock)."""
        with self._lock:
            return {
                "spans": {k: {"total_s": self.total_ns[k] / 1e9,
                              "self_s": self.self_ns[k] / 1e9,
                              "calls": n} for k, n in self.calls.items()},
                "counters": dict(self.counters),
                "events": {k: {"total_s": s, "calls": n}
                           for k, (s, n) in self.events.items()},
                "span_records": [
                    {"name": nm, "id": i, "parent": p, "start_s": a / 1e9,
                     "dur_s": (b - a) / 1e9}
                    for nm, i, p, a, b in self.records],
                "span_records_dropped": self.dropped}


TRACER = Tracer()


def _recording() -> bool:
    return TRACER.on or _profiler._is_profiler_enabled


def span(name: str, id=None):
    """A span named `name` (see the module docstring); `id` defaults to
    the enclosing span's."""
    if not _recording():
        return _OFF
    return _Span(name, id)


def count(name: str, n: int) -> None:
    """Add n to counter `name` while spans record."""
    if _recording():
        with TRACER._lock:
            TRACER.counters[name] += n


def event(name: str, seconds: float) -> None:
    """Add a one-time event of `seconds` to the process-wide total."""
    with TRACER._lock:
        e = TRACER.events.setdefault(name, [0.0, 0])
        e[0] += seconds
        e[1] += 1


class Stages:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.meta: dict[str, float] = {}

    @contextmanager
    def time(self, name: str):
        """Time stage `name`; while spans record, on the span's clock."""
        sp = _Span("stage." + name, None, tally=False) if _recording() \
            else None
        t0 = time.perf_counter_ns()
        try:
            with _OFF if sp is None else sp:
                yield
        finally:
            ns = time.perf_counter_ns() - t0 if sp is None \
                else sp.t1 - sp.t0
            self.totals[name] += ns / 1e9
            self.counts[name] += 1

    def add_meta(self, **kv) -> None:
        self.meta.update(kv)

    def summary(self) -> dict:
        return {
            "stage_seconds": {k: round(v, 4) for k, v in self.totals.items()},
            "stage_calls": dict(self.counts),
            **self.meta,
        }

    def report(self, report_fn) -> None:
        for name in sorted(self.totals):
            report_fn(f"  stage {name}: {self.totals[name]:.2f} s "
                      f"({self.counts[name]} calls)")

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1, sort_keys=True)
            f.write("\n")
