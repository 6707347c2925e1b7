"""Host milliseconds a call of the program's span 'stream.bwd_prune'
(models/streaming.py: one bwd_prune_sparse call, the host's backward prune
over a file's sparse forward peaks, one a file and active shift), from the
process-wide tracer of audfprint_torch.utils.timing, which records while the
traced span's profiler runs.  None where the program has no such tracer or
the span never ran."""

from audfprint_torch.utils import timing


def read(rec):
    tracer = getattr(timing, "TRACER", None)
    return None if tracer is None else tracer.mean_ms("stream.bwd_prune")
