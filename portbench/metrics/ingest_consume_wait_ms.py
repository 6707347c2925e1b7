"""Host milliseconds per call of the benchmark's span 'ingest_consume_wait' over the
window: its total over its count."""


def read(rec):
    return rec["spans"].mean_ms("ingest_consume_wait")
