"""The readers of the program's tracer (audfprint_torch/utils/timing.py):
each gives its number from a tracer that holds its span or event, and
None from an empty one, as a run of a program without them gives."""

import pytest

from audfprint_torch.utils import timing
from portbench.run import reader

SPANS = {"ingest_stage_ms.ingest": "ingest.stage",
         "graph_pin_ms.ingest": "graph.pin",
         "graph_launch_ms.ingest": "graph.launch",
         "ingest_counts_fetch_ms.ingest": "ingest.counts_fetch"}


def _filled() -> timing.Tracer:
    tr = timing.Tracer()
    tr.total_ns.update({name: 6_000_000 for name in SPANS.values()})
    tr.calls.update({name: 3 for name in SPANS.values()})
    tr.events["graph.capture"] = [0.75, 2]
    return tr


@pytest.mark.parametrize("metric", [*SPANS, "graph_capture_s.ingest"])
def test_reader(metric, monkeypatch):
    """A span's reader is its mean ms a call (6 ms over 3 calls: 2.0);
    the capture's is the event's seconds over the process."""
    monkeypatch.setattr(timing, "TRACER", _filled())
    assert reader(metric)({}) == (0.75 if metric.startswith("graph_capture")
                                  else 2.0)
    monkeypatch.setattr(timing, "TRACER", timing.Tracer())
    assert reader(metric)({}) is None
    monkeypatch.delattr(timing, "TRACER")
    assert reader(metric)({}) is None
