"""Hashable, static pipeline configuration (the port's own copy of
audfprint_tpu/ops/config.py)."""

from __future__ import annotations

from typing import NamedTuple

from audfprint_torch import params as P


class PipelineConfig(NamedTuple):
    """Frozen analysis parameters, one per analyzer configuration."""

    density: float = P.DENSITY
    n_fft: int = P.N_FFT
    n_hop: int = P.N_HOP
    shifts: int = P.SHIFTS
    maxpksperframe: int = P.MAX_PKS_PER_FRAME
    maxpairsperpeak: int = P.MAX_PAIRS_PER_PEAK
    f_sd: float = P.F_SD
    targetdf: int = P.TARGET_DF
    mindt: int = P.MIN_DT
    targetdt: int = P.TARGET_DT
    hpf_pole: float = P.HPF_POLE

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2

    @property
    def a_dec(self) -> float:
        return P.a_decay(self.density, self.n_hop)

    @property
    def gsize(self) -> int:
        # full-support spreading (see params.gaussian_template)
        return self.n_bins - 1

    @classmethod
    def from_params(cls, ap: P.AnalyzerParams) -> "PipelineConfig":
        return cls(
            density=ap.density, n_fft=ap.n_fft, n_hop=ap.n_hop,
            shifts=max(1, ap.shifts), maxpksperframe=ap.maxpksperframe,
            maxpairsperpeak=ap.maxpairsperpeak, f_sd=ap.f_sd,
            targetdf=ap.targetdf, mindt=ap.mindt, targetdt=ap.targetdt,
            hpf_pole=ap.hpf_pole,
        )
