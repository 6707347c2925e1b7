"""Minimal librosa-compatible STFT (oracle spec of the reference's stft.py).

Reference behavior (SURVEY §2.3.2, stft.py:~1-70): strided framing with NO
centering padding (first frame starts at sample 0), window multiply,
np.fft.rfft, librosa orientation (freq, time).
"""

from __future__ import annotations

import numpy as np


def frame(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Slice a 1-D signal into overlapping frames, shape (n_frames, frame_length).

    No padding: n_frames = 1 + (len(x) - frame_length) // hop_length.
    """
    n = len(x)
    if n < frame_length:
        return np.zeros((0, frame_length), dtype=x.dtype)
    n_frames = 1 + (n - frame_length) // hop_length
    idx = (
        np.arange(frame_length)[None, :]
        + hop_length * np.arange(n_frames)[:, None]
    )
    return x[idx]


def stft(
    x: np.ndarray,
    n_fft: int = 512,
    hop_length: int | None = None,
    window: np.ndarray | None = None,
) -> np.ndarray:
    """Short-time Fourier transform; returns complex (1 + n_fft/2, n_frames).

    Matches the reference stft.py contract: frames start at sample 0, no
    centering, `window * frame` then rfft, transposed to librosa (F, T).
    """
    if hop_length is None:
        hop_length = n_fft // 2
    if window is None:
        window = np.hanning(n_fft)
    frames = frame(np.asarray(x), n_fft, hop_length)
    spec = np.fft.rfft(window[None, :] * frames, axis=-1)
    return spec.T
