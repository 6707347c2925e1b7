"""Host milliseconds a call of the program's span 'stream.read'
(models/streaming.py: a chunk's ranged read, staging and upload in
_ChunkReader.chunk_dev, when the device cache does not serve it), from the
process-wide tracer of audfprint_torch.utils.timing, which records while the
traced span's profiler runs.  None where the program has no such tracer or
the span never ran."""

from audfprint_torch.utils import timing


def read(rec):
    tracer = getattr(timing, "TRACER", None)
    return None if tracer is None else tracer.mean_ms("stream.read")
