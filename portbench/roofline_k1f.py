"""The least work of K1f, the streamed route's forward prune with its
envelope carry (audfprint_torch/csrc/prune.cu, prune_fwd_carry), one launch
a chunk of the peaks pass with one row a shift.  A launch reads each valid
frame of each row's 256-bin whitened spectrogram once, each row's envelope
and the 511-value Gaussian template, and writes each row's envelope and up
to `k` (position, value) pairs a frame: the bytes of the repository's smoke
run's `k1f_bound`, 4 (B T F + 2 B F + 2 F - 1 + 2 B T k), counted over valid
frames only.  The peak they are set against is roofline.py's."""

from __future__ import annotations


def k1f_bytes(frames_per_row: list, n_bins: int = 256, k: int = 5) -> float:
    """One launch's least bytes; frames_per_row holds each row's valid
    frames."""
    rows = len(frames_per_row)
    frames = float(sum(frames_per_row))
    return 4.0 * (frames * n_bins + 2 * rows * n_bins + 2 * n_bins - 1
                  + 2 * frames * k)


def file_bytes(n_samples: int, pcfg, chunk_frames: int) -> float:
    """K1f's least bytes over the peaks pass of one file of n_samples at
    the analysis rate, cut into chunks as the route cuts it."""
    S = max(1, pcfg.shifts)
    frames = []
    for s in range(S):
        n = n_samples - s * pcfg.n_hop // S
        frames.append(1 + (n - pcfg.n_fft) // pcfg.n_hop
                      if n >= pcfg.n_fft else 0)
    chunks = -(-max(frames) // chunk_frames)
    return sum(k1f_bytes([min(max(t - c * chunk_frames, 0), chunk_frames)
                          for t in frames], pcfg.n_bins, pcfg.maxpksperframe)
               for c in range(chunks))
