"""Audio-seconds fingerprinted and stored (their counts fetched) in the
window over the window's seconds."""


def read(rec):
    return rec["audio_s"] / rec["window_s"] if "audio_s" in rec else None
