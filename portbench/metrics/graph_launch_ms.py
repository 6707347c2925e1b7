"""Host milliseconds a call of the program's span 'graph.launch' (the graph
cache's input copies queued, its replay and the output clones), from the
process-wide tracer of audfprint_torch.utils.timing, which records while
the traced span's profiler runs: its total over its calls, one call a
chunk in the ingest cell.  None where the program has no such tracer or
the span never ran."""

from audfprint_torch.utils import timing


def read(rec):
    tracer = getattr(timing, "TRACER", None)
    return None if tracer is None else tracer.mean_ms("graph.launch")
