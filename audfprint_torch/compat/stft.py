"""Reference stft.py surface: the NumPy oracle STFT."""

from audfprint_torch.oracle.stft import frame, stft  # noqa: F401
