"""Reference audio_read.py surface."""

from audfprint_torch.utils.audio import (  # noqa: F401
    CommunicationError,
    DecodeError,
    NotInstalledError,
    audio_read,
    buf_to_float,
)
