"""Seconds of every graph key's warm-up run and capture in the process
(the one-time event 'graph.capture' of audfprint_torch.utils.timing, which
records always): part of set-up.  None where the program has no such
tracer or captured nothing."""

from audfprint_torch.utils import timing


def read(rec):
    tracer = getattr(timing, "TRACER", None)
    return None if tracer is None else tracer.event_s("graph.capture")
