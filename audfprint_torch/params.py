"""Shared parameter dataclasses and constants of audfprint_torch (the
port's own copy of audfprint_tpu/params.py; both packages must agree on
every value here).

Behavioral spec source: SURVEY.md (reconstructed from dpwe/audfprint).
Reference citations below use the survey's convention (`file.py:~N` =
approximate upstream line).

Every constant here is part of the compat contract:
  - analysis constants: audfprint_analyze.py:~30-80 (SURVEY Appendix C)
  - hash bit layout:    audfprint_analyze.py:~100 (landmarks2hashes)
  - table geometry:     hash_table.py:~60 (HashTable defaults)
  - matcher defaults:   audfprint_match.py:~60-110
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# ---------------------------------------------------------------------------
# Analysis constants (audfprint_analyze.py, SURVEY §2.3.3 + Appendix C)
# ---------------------------------------------------------------------------

TARGET_SR = 11025          # analysis sample rate (Hz)
N_FFT = 512                # FFT size
N_HOP = 256                # hop size (23.2 ms, 43.07 frames/s)
OVERSAMP = 1               # oversampling of masking envelope decay
HPF_POLE = 0.98            # onset high-pass pole (applied in find_peaks)

DENSITY = 20.0             # target hashes/sec
MAX_PKS_PER_FRAME = 5      # peaks accepted per STFT frame
MAX_PAIRS_PER_PEAK = 3     # fanout: landmark pairs per anchor peak
F_SD = 30.0                # masking gaussian SD (freq bins)
SHIFTS = 1                 # sub-hop re-analyses

TARGET_DF = 31             # pairing: |f2 - f1| < TARGET_DF (strict)
MIN_DT = 2                 # pairing: t2 - t1 >= MIN_DT
TARGET_DT = 63             # pairing: t2 - t1 < TARGET_DT

# 20-bit hash layout (audfprint_analyze.py:~100, SURVEY Appendix C) [H]
F1_BITS = 8
DF_BITS = 6
DT_BITS = 6
HASH_BITS = F1_BITS + DF_BITS + DT_BITS    # = 20
F1_SHIFT = DF_BITS + DT_BITS               # = 12
DF_SHIFT = DT_BITS                         # = 6
F1_MASK = (1 << F1_BITS) - 1               # 0xFF
DF_MASK = (1 << DF_BITS) - 1               # 0x3F
DT_MASK = (1 << DT_BITS) - 1               # 0x3F

# Number of usable freq bins: rfft gives 1 + n_fft/2 = 257 rows; find_peaks
# drops the nyquist row so that f1 fits in F1_BITS (audfprint_analyze.py:
# "[:-1,] discards top bin"), leaving 256.
N_BINS = N_FFT // 2  # 256

# ---------------------------------------------------------------------------
# Hash table constants (hash_table.py:~60)
# ---------------------------------------------------------------------------

TABLE_HASHBITS = 20        # bucket-index bits (table has 2^20 buckets)
TABLE_DEPTH = 100          # entries per bucket
TABLE_MAXTIME = 16384      # time modulus (maxtimebits = 14)

# ---------------------------------------------------------------------------
# Matcher defaults (audfprint_match.py:~60-110)
# ---------------------------------------------------------------------------

MATCH_WIN = 2              # +/- delta-t tolerance (frames)
MIN_COUNT = 5              # min aligned hashes to report a match
MAX_MATCHES = 1            # matches reported per query
SEARCH_DEPTH = 100         # candidate tracks examined
TIME_QUANTILE = 0.05       # quantile for --find-time-range span

# Precompute file extensions (SURVEY Appendix B) [H]
PRECOMPEXT = ".afpt"
PRECOMPPKEXT = ".afpk"


def a_decay(density: float, n_hop: int = N_HOP) -> float:
    """Masking-envelope per-frame decay constant.

    Reference: audfprint_analyze.py:~285 (SURVEY §2.3.3 step 1):
      a_dec = (1 - 0.01*(density * sqrt(n_hop/352.8) / 35)) ** (1/OVERSAMP)
    ~0.99512 at defaults (density=20, n_hop=256).
    """
    return (1 - 0.01 * (density * math.sqrt(n_hop / 352.8) / 35.0)) ** (1.0 / OVERSAMP)


def next_pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= n, floored at `lo` (itself a power of two).

    Shared by every padding/bucketing site (matcher Q/qt_cap/ncap,
    fingerprint fetch slices, batch row padding) so the rounding policy
    lives in one place."""
    v = lo
    while v < n:
        v *= 2
    return v


def hann_window(n_fft: int = N_FFT) -> np.ndarray:
    """The reference's off-by-two hann window: np.hanning(n_fft+2)[1:-1].

    Reference: audfprint_analyze.py:~300 (SURVEY §2.3.2) — NOT np.hanning(n_fft);
    this exact choice is part of the bit-compat contract.
    """
    return np.hanning(n_fft + 2)[1:-1]


def gaussian_template(f_sd: float = F_SD, gsize: int | None = None
                      ) -> np.ndarray:
    """Tabulated gaussian bump used for peak spreading.

    Reference: audfprint_analyze.py spreadpeaks (SURVEY §2.3.3 step 4)
    evaluates `val * exp(-0.5*((binvals - pos)/width)**2)` over the FULL
    vector — no truncation (ADVICE r1: round 1 cut the tail at
    int(4*f_sd), flipping rare near-tie threshold comparisons).  Default
    support is therefore +/- (N_BINS-1), i.e. every offset reachable in a
    256-bin spectrum; values exp(-0.5*(i/f_sd)**2) for i in
    [-gsize, gsize], f64-evaluated then cast where needed.  Both the
    oracle and the kernels index this same table so they agree
    bit-for-bit.
    """
    if gsize is None:
        gsize = N_BINS - 1
    return np.exp(-0.5 * ((np.arange(-gsize, gsize + 1) / float(f_sd)) ** 2))


@dataclasses.dataclass
class AnalyzerParams:
    """All knobs of the analysis pipeline (CLI flags map onto these)."""

    density: float = DENSITY
    target_sr: int = TARGET_SR
    n_fft: int = N_FFT
    n_hop: int = N_HOP
    shifts: int = SHIFTS
    maxpksperframe: int = MAX_PKS_PER_FRAME
    maxpairsperpeak: int = MAX_PAIRS_PER_PEAK
    f_sd: float = F_SD
    targetdf: int = TARGET_DF
    mindt: int = MIN_DT
    targetdt: int = TARGET_DT
    hpf_pole: float = HPF_POLE
    fail_on_error: bool = True

    @property
    def a_dec(self) -> float:
        return a_decay(self.density, self.n_hop)

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2

    @property
    def gsize(self) -> int:
        # full-support spreading (see gaussian_template)
        return self.n_bins - 1

    def frame_count(self, n_samples: int) -> int:
        """Frames produced by the no-centering STFT (SURVEY §2.3.2)."""
        if n_samples < self.n_fft:
            return 0
        return 1 + (n_samples - self.n_fft) // self.n_hop


@dataclasses.dataclass
class MatcherParams:
    """All knobs of the matcher (audfprint_match.py:~60-110)."""

    window: int = MATCH_WIN
    threshcount: int = MIN_COUNT
    max_returns: int = MAX_MATCHES
    search_depth: int = SEARCH_DEPTH
    exact_count: bool = False
    find_time_range: bool = False
    time_quantile: float = TIME_QUANTILE
    sort_by_time: bool = False
    verbose: int = 1
