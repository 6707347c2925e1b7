"""Precompute file formats: .afpt (hashes) and .afpk (peaks).

Reference: audfprint_analyze.py hashes_save/load, peaks_save/load
(SURVEY §2.3.3 "Precompute I/O" + Appendix B): raw little-endian uint32
(value, value) pairs, no header — np.fromfile(...).reshape(-1, 2).
"""

from __future__ import annotations

import numpy as np

from audfprint_torch import params as P

PRECOMPEXT = P.PRECOMPEXT      # ".afpt"
PRECOMPPKEXT = P.PRECOMPPKEXT  # ".afpk"


def hashes_save(filename: str, hashes: np.ndarray) -> None:
    """(N, 2) int rows (t, hash) -> raw LE uint32 pairs."""
    arr = np.ascontiguousarray(np.asarray(hashes, dtype=np.int64))
    arr.astype("<u4").tofile(filename)


def hashes_load(filename: str) -> np.ndarray:
    data = np.fromfile(filename, dtype="<u4")
    if data.size % 2:
        raise ValueError(f"{filename}: odd number of uint32 words")
    return data.reshape(-1, 2).astype(np.int32)


def peaks_save(filename: str, peaks) -> None:
    """Iterable of (t, bin) -> raw LE uint32 pairs."""
    arr = np.asarray(list(peaks) if not isinstance(peaks, np.ndarray) else peaks,
                     dtype=np.int64).reshape(-1, 2)
    arr.astype("<u4").tofile(filename)


def peaks_load(filename: str) -> list:
    data = np.fromfile(filename, dtype="<u4")
    if data.size % 2:
        raise ValueError(f"{filename}: odd number of uint32 words")
    return [(int(t), int(f)) for t, f in data.reshape(-1, 2)]
