"""float32 arithmetic under the reference's subnormal rule.

XLA on the CPU, which runs every parity test of the JAX package, executes
with the x86 DAZ and FTZ modes on, and a TPU flushes as well:

  * DAZ: a subnormal input reads as a zero of its own sign (so 1e-39 > 0
    is false and max(1e-39, 0) is 0);
  * FTZ: a result whose magnitude, rounded to 24 bits with an unbounded
    exponent, lies below 2^-126 becomes a zero of its own sign.  So an
    exact product of 2^-126 - 2^-150 is flushed, though rounding onto the
    subnormal grid (what torch does) would give 2^-126, and one of
    2^-126 * (1 - 2^-46) is kept as 2^-126 (tests/test_torch_ftz.py holds
    both against XLA).

The stages that decay toward zero -- the onset HPF and the prune
envelopes -- reach that range after a few minutes of digital silence.
Their plain versions use these helpers on every float operation, and
their kernels the .ftz instructions (csrc/hpf.cu, csrc/prune.cu).  The
helpers are explicit on purpose: torch.set_flush_denormal is process-wide
state and would change every other computation of the process.
"""

from __future__ import annotations

import torch

TINY = 2.0 ** -126                  # the least normal float32
_SCALE = 2.0 ** 24                  # lifts a near-TINY product to normal
_FLUSH_BELOW = TINY * (1.0 - 2.0 ** -25)   # exact results below this flush
_MAX = float(torch.finfo(torch.float32).max)


def flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of their sign (DAZ on an input)."""
    return torch.where(x.abs() < TINY, x * 0.0, x)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a * b with DAZ and FTZ.  Where torch's product rounds to
    +-TINY on the subnormal grid, the exact product may still round below
    TINY at 24 bits; the product with one factor scaled by 2^24 (exact,
    and normal there) decides."""
    a, b = flush(a), flush(b)
    p = a * b
    q = (a * _SCALE) * b
    return torch.where((p.abs() < TINY) | (q.abs() < TINY * _SCALE),
                       p * 0.0, p)


def amax_mul(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """The maximum over `dim` of mul(a, b), without its elementwise cost.
    The rule maps an exact product monotonically (up to the sign of a
    zero), so it is applied once, to the largest product: the maxima of
    the two products that mul forms decide it.  The result equals mul's
    maximum; a zero may differ in sign, as torch's and XLA's maxima of +0
    and -0 already do."""
    a, b = flush(a), flush(b)
    p = (a * b).amax(dim=dim)
    # clamped, so that a zero b gives a zero, not a NaN, in the maximum
    q = ((a * _SCALE).clamp(-_MAX, _MAX) * b).amax(dim=dim)
    return torch.where((p.abs() < TINY) | (q.abs() < TINY * _SCALE),
                       p * 0.0, p)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 a * b + c (one rounding, as a hardware
    FMA) with DAZ and FTZ.  The f64 product of two f32 values is exact,
    and the TwoSum error term makes the f64 sum round to odd, so the cast
    to f32 rounds once, correctly.  That sum lies below _FLUSH_BELOW
    exactly when the exact result does (_FLUSH_BELOW has a short mantissa,
    so rounding to odd never lands on it), and a result at or above it
    rounds to a normal float32."""
    p = flush(a).double() * flush(b).double()
    cd = flush(c).double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return torch.where(s.abs() < _FLUSH_BELOW, s * 0.0, s).to(torch.float32)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a - b with DAZ and FTZ (a subnormal difference is exact, so
    flushing torch's result is the rule)."""
    return flush(flush(a) - flush(b))
