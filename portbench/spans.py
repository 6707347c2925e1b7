"""Host spans around the benchmark's calls into the program's layers.

A span adds its seconds and a count to a named total.  While a profile is
recorded the same span is also a `record_function` range, so that the
trace can say what the host was doing while the device idled.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Spans:
    def __init__(self):
        self.total: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)
        self.on = True          # off outside the measured window
        self.annotate = False   # inside a recorded profile

    @contextmanager
    def __call__(self, name: str):
        if self.annotate:
            import torch
            with torch.profiler.record_function(name):
                yield
            return
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def mean_ms(self, name: str) -> float | None:
        n = self.count.get(name, 0)
        return 1e3 * self.total[name] / n if n else None
