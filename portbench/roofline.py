"""Peaks of the card and the least work of the port's kernels.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W): 3.35 TB/s of HBM3.  K1, the peak prune (audfprint_torch/csrc/
prune.cu), reads each valid frame of each row's 256-bin spectrogram once,
each row's two envelopes and its frame count, the 511-value Gaussian
template, and writes up to `k` kept peak slots a frame: the bytes of
the repository's smoke run's `k1_bound`, counted over valid frames only, so
that padding the program adds is not counted as work.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def k1_bytes(frames_per_row: list, n_bins: int = 256, k: int = 5) -> float:
    rows = len(frames_per_row)
    frames = float(sum(frames_per_row))
    return 4.0 * (frames * n_bins + rows + 2 * rows * n_bins
                  + 2 * n_bins - 1 + frames * k)


def share_pct(nbytes: float, seconds: float) -> float | None:
    """The bytes' least time at the HBM peak over the measured time, %."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
