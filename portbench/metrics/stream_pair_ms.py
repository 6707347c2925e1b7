"""Host milliseconds a call of the program's span 'stream.pair'
(models/streaming.py: _pair_on_device, the pairing of a file's kept peaks on
the card with its host slot staging and its fetch), from the process-wide
tracer of audfprint_torch.utils.timing, which records while the traced
span's profiler runs.  None where the program has no such tracer or the span
never ran."""

from audfprint_torch.utils import timing


def read(rec):
    tracer = getattr(timing, "TRACER", None)
    return None if tracer is None else tracer.mean_ms("stream.pair")
