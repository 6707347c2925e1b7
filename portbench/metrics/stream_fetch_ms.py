"""Host milliseconds a call of the program's span 'stream.fetch'
(models/streaming.py: the wait in _Fetch.get for a chunk's results, or the
pairing's, copied back into pinned host memory), from the process-wide
tracer of audfprint_torch.utils.timing, which records while the traced
span's profiler runs.  None where the program has no such tracer or the span
never ran."""

from audfprint_torch.utils import timing


def read(rec):
    tracer = getattr(timing, "TRACER", None)
    return None if tracer is None else tracer.mean_ms("stream.fetch")
