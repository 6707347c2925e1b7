"""Host milliseconds per call of the benchmark's span 'match_dispatch' over the
window: its total over its count."""


def read(rec):
    return rec["spans"].mean_ms("match_dispatch")
