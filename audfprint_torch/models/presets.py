"""Named analyzer presets (port of audfprint_tpu/models/presets.py).

The reference exposes every knob as a CLI flag; these presets capture the
combinations its README recommends for common deployments (BASELINE
configs 2-3).  The table repeats the JAX package's: that module imports
the JAX Analyzer, which the port must not load.
"""

from __future__ import annotations

from audfprint_torch.models.analyzer import Analyzer

PRESETS = {
    # the reference defaults: general-purpose music identification
    "default": dict(density=20.0, shifts=1, maxpairsperpeak=3),
    # noisy/short queries: more shifts + density on the query side
    # (BASELINE config 3: --shifts 4 --density 40)
    "noisy-query": dict(density=40.0, shifts=4, maxpairsperpeak=3),
    # large reference DBs: lower density to stretch table capacity
    "big-library": dict(density=10.0, shifts=1, maxpairsperpeak=2),
    # maximum recall for forensic use: dense peaks, wide fanout
    "high-recall": dict(density=40.0, shifts=4, maxpairsperpeak=6),
}


def make_analyzer(preset: str = "default", **overrides) -> Analyzer:
    """Analyzer for a named preset; keyword overrides (`device` among
    them) replace the preset's values."""
    if preset not in PRESETS:
        raise KeyError(f"unknown preset {preset!r}; "
                       f"choose from {sorted(PRESETS)}")
    kw = dict(PRESETS[preset])
    kw.update(overrides)
    return Analyzer(**kw)
