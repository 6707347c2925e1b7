"""Per-stage timing + structured metrics (SURVEY §5 tracing row).

The reference has only the end-of-run "= R x RT" line; this adds named
stage accumulators (decode / analyze / store / match / save) and an optional
JSON metrics dump, without changing the stdout contract.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager


class Stages:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.meta: dict[str, float] = {}

    @contextmanager
    def time(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
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
