"""The reference's subnormal rule in the port, against the JAX package on
the CPU.

XLA on the CPU runs with DAZ and FTZ: subnormal inputs read as zeros and
subnormal results become zeros of their sign (ops/ftz.py).  The onset HPF
decays through that range after ~100 s of digital silence and the prune
envelopes after minutes of it, so these tests hold the plain versions of
K2, K1f and K1 bit for bit against the JAX functions over long constant
stretches, on inputs that are subnormal already, and on results either
side of 2^-126; and K2's launch plan (spectro.k2_plan) for every shape the
card run checks (chip_smoke.K2_CASES)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from audfprint_tpu.ops import peaks as PKj  # noqa: E402
from audfprint_tpu.ops import spectro as SPj  # noqa: E402
from audfprint_tpu.ops import streaming as JST  # noqa: E402
from audfprint_tpu.ops.config import PipelineConfig  # noqa: E402
from audfprint_torch.ops import cuda_peaks as CP  # noqa: E402
from audfprint_torch.ops import ftz as FTZ  # noqa: E402
from audfprint_torch.ops import peaks as PK  # noqa: E402
from audfprint_torch.ops import spectro as SP  # noqa: E402
from audfprint_torch.ops import streaming as ST  # noqa: E402

torch.set_num_threads(2)
CFG = PipelineConfig()
TINY = np.float32(2.0 ** -126)
POLE = np.float32(SP._pole(CFG))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _silence(rng, B: int, T: int, F: int = 256, head: int = 50,
             scale: float = 1.0) -> np.ndarray:
    """Whitened frames: a sounding head, then the constant that digital
    silence becomes after the log floor."""
    x = (rng.standard_normal((B, T, F)) * 2.0 * scale).astype(np.float32)
    x[:, head:] = np.float32(-3.75 * scale)
    return x


def _boundary_products(n: int, rng) -> tuple:
    """(a, b) float32 pairs whose exact products straddle 2^-126 by a few
    ulps, both signs, plus subnormal and zero operands."""
    a = rng.uniform(0.5, 1.0, n).astype(np.float32)
    b = (np.float64(TINY) / a.astype(np.float64)
         * (1 + rng.uniform(-3e-7, 3e-7, n))).astype(np.float32)
    b = np.where(rng.random(n) < 0.5, b, -b).astype(np.float32)
    sub = np.array([1e-39, -1e-39, 3e-38, 0.0, -0.0], np.float32)
    a = np.concatenate([a, sub, np.array([0x3F7FFFFF], np.uint32).view(
        np.float32)])
    b = np.concatenate([b, np.float32([2.0, 2.0, 0.25, 5.0, 1e-39]),
                        np.float32([TINY])])
    return a, b


def test_ftz_helpers_match_xla_at_the_boundary():
    """ops/ftz.py's mul, fma and sub give XLA's bits, including exact
    results just below 2^-126 that round up to it (kept) and those that
    round onto the subnormal grid (flushed), and subnormal operands."""
    rng = np.random.default_rng(0)
    a, b = _boundary_products(200_000, rng)
    c = np.where(rng.random(len(a)) < 0.5, 0.0,
                 rng.standard_normal(len(a)) * TINY * 0.5).astype(np.float32)
    want_mul = jax.jit(lambda x, y: x * y)(a, b)
    want_fma = jax.jit(lambda x, y, z: z + x * y)(a, b, c)
    want_sub = jax.jit(lambda x, y: x - y)(a, c)
    assert np.array_equal(_bits(FTZ.mul(_t(a), _t(b))), _bits(want_mul))
    assert np.array_equal(_bits(FTZ.fma(_t(a), _t(b), _t(c))),
                          _bits(want_fma))
    assert np.array_equal(_bits(FTZ.sub(_t(a), _t(c))), _bits(want_sub))
    flushed = np.asarray(want_mul) == 0
    assert flushed.sum() > 1000 and (~flushed).sum() > 1000
    # torch alone rounds onto the subnormal grid: the rule is not a no-op
    assert not np.array_equal(_bits(a * b), _bits(want_mul))


@pytest.mark.parametrize("chunks", [None, (0, 1999, 4700, 6000)])
def test_hpf_through_silence_matches_jax(chunks):
    """The HPF over 50 sounding frames then ~100 s of digital silence: y
    decays by the pole into the subnormal range, where the reference
    flushes it to zero.  One pass and carried chunks give its bits."""
    x = _silence(np.random.default_rng(1), 1, 6000)
    want = np.asarray(SPj.hpf(jnp.asarray(x), CFG))
    if chunks is None:
        got = SP.hpf(_t(x), CFG)[0].numpy()
    else:
        parts, carry = [], None
        for a, b in zip(chunks[:-1], chunks[1:]):
            y, carry = SP.hpf(_t(x[:, a:b]), CFG, carry)
            parts.append(y.numpy())
        got = np.concatenate(parts, axis=1)
        assert np.array_equal(_bits(carry[1]), _bits(want[:, -1]))
    assert (want[0, 4500:] == 0).all() and (want[0, 100] != 0).any()
    assert np.array_equal(_bits(got), _bits(want))


def test_hpf_subnormal_and_boundary_inputs_match_jax():
    """Inputs that are subnormal already (read as zeros), values either
    side of 2^-126, and signed zeros: the port's HPF gives XLA's bits."""
    rng = np.random.default_rng(2)
    edge = np.float32([TINY, -TINY, np.nextafter(TINY, np.float32(0)),
                       -np.nextafter(TINY, np.float32(0)),
                       np.nextafter(TINY, np.float32(1)), 1e-39, -1e-39,
                       1e-45, 0.0, -0.0, 1.5 * TINY, 3e-38])
    x = rng.choice(edge, (2, 300, 256)).astype(np.float32)
    x[1, ::7] = (rng.standard_normal((43, 256)) * 1e-37).astype(np.float32)
    want = np.asarray(SPj.hpf(jnp.asarray(x), CFG))
    got = SP.hpf(_t(x), CFG)[0].numpy()
    assert np.array_equal(_bits(got), _bits(want))


def _decay_carry(rng) -> tuple:
    """HPF carries (xprev, yprev) for one row: O(1) values, subnormals,
    and yprev whose exact product with the pole lies a few ulps either
    side of 2^-126 (the reference keeps a result that rounds up to 2^-126
    at 24 bits and flushes one that does not)."""
    xprev = rng.standard_normal((1, 256)).astype(np.float32)
    yprev = (rng.standard_normal((1, 256)) * 3.0).astype(np.float32)
    y0 = np.float32(np.float64(TINY) / np.float64(POLE))
    near = [y0]
    for _ in range(6):
        near = [np.nextafter(near[0], np.float32(0))] + near \
            + [np.nextafter(near[-1], np.float32(1))]
    near = np.float32(near)
    yprev[0, : len(near)] = near
    yprev[0, len(near): 2 * len(near)] = -near
    yprev[0, 40:44] = np.float32([1e-39, -1e-39, 0.0, -0.0])
    xprev[0, 44:48] = np.float32([1e-39, -1e-39, TINY, -TINY])
    return xprev, yprev


def test_peaks_pass_through_silence_vs_chunk_fwd_peaks(monkeypatch):
    """A 4,800-frame chunk of digital silence through JAX's
    chunk_fwd_peaks and the port's, from carries that decay into the
    subnormal range or sit on either side of 2^-126: the HPF's carry out,
    the envelope carried out and every output are bit-exact."""
    rng = np.random.default_rng(3)
    T = 4800
    n = ST.chunk_samples(T, CFG)
    audio = np.zeros((1, n), np.float32)
    nf = np.array([T], np.int32)
    gmax = np.array([0.8], np.float32)
    mean = np.array([-4.5], np.float32)
    xprev, yprev = _decay_carry(rng)
    env = (np.abs(rng.standard_normal((1, 256))) * 3.0).astype(np.float32)
    logm = np.asarray(JST.chunk_logm(jnp.asarray(audio), jnp.asarray(gmax),
                                     CFG))
    packed, env2, xp2, yp2 = JST.chunk_fwd_peaks(
        jnp.asarray(audio), jnp.asarray(nf), jnp.asarray(gmax),
        jnp.asarray(mean), jnp.asarray(xprev), jnp.asarray(yprev),
        jnp.asarray(env), CFG, False)
    wbins, wvalid, wvals, wlast = JST.unpack_fwd_peaks(
        np.asarray(packed), T, CFG.maxpksperframe)
    monkeypatch.setattr(ST, "chunk_logm",
                        lambda a, g, cfg: torch.from_numpy(logm.copy()))
    (bins, valid, vals, last), genv, (gx, gy) = ST.chunk_fwd_peaks(
        _t(audio), _t(nf), _t(gmax), _t(mean), (_t(xprev), _t(yprev)),
        _t(env), torch.from_numpy(PK.gauss_vector(CFG)), CFG, False)
    assert np.array_equal(_bits(gx), _bits(xp2))
    assert np.array_equal(_bits(gy), _bits(yp2))
    assert np.array_equal(valid.numpy(), wvalid)
    assert np.array_equal(bins.numpy(), wbins)
    assert np.array_equal(_bits(vals), _bits(wvals))
    assert np.array_equal(_bits(last), _bits(wlast))
    assert np.array_equal(genv.numpy(), np.asarray(env2))


def test_k1f_plain_through_long_silence_matches_fwd_prune_carry():
    """K1f's plain version over 22,000 frames (~8.5 minutes) of digital
    silence after a sounding head, given JAX's own HPF output: the
    envelope decays into the subnormal range, where the reference flushes
    it, so env_out (the streamed route's carry) is zero on both sides; the
    forward masks agree."""
    x = _silence(np.random.default_rng(4), 1, 22000)
    y = np.asarray(SPj.hpf(jnp.asarray(x), CFG))
    nf = np.array([22000], np.int32)
    mask, env_out = PKj.fwd_prune_carry(jnp.asarray(y), jnp.asarray(nf),
                                        jnp.zeros((1, 256), jnp.float32),
                                        CFG, False)
    yt, nft = _t(y), _t(nf)
    gvec = torch.from_numpy(PK.gauss_vector(CFG))
    env0 = PK.head_envelope(yt, nft, CP._bump_table(gvec, 256))
    lpos, _lval, genv = CP.prune_fwd_carry(CP.candidate_map(yt, nft), env0,
                                           gvec, CFG.a_dec,
                                           CFG.maxpksperframe)
    got = np.zeros((1, 22000, 257), bool)
    p = lpos.numpy()
    b, t, _i = np.nonzero(p >= 0)
    got[b, t, p[b, t, _i]] = True
    assert np.array_equal(got[..., :256], np.asarray(mask))
    assert got.sum() > 20
    assert np.array_equal(_bits(genv), _bits(env_out))


def test_k1f_plain_subnormal_inputs_match_fwd_prune_carry():
    """Candidate values and envelopes that are subnormal already, or
    either side of 2^-126: a subnormal is never a candidate (it reads as
    zero), and the envelope carried out has XLA's bits."""
    rng = np.random.default_rng(5)
    y = (rng.standard_normal((2, 200, 256)) * 2.0).astype(np.float32)
    y[:, ::3] *= np.float32(1e-38)
    y[1, 100:] = rng.choice(np.float32([1e-39, TINY, 2e-38, 0.0]),
                            (100, 256))
    env_in = rng.choice(np.float32([0.0, 1e-39, TINY, 1.1 * TINY, 5e-38,
                                    2.0]), (2, 256)).astype(np.float32)
    nf = np.array([200, 170], np.int32)
    mask, env_out = PKj.fwd_prune_carry(jnp.asarray(y), jnp.asarray(nf),
                                        jnp.asarray(env_in), CFG, True)
    lpos, _lval, genv = CP.prune_fwd_carry(
        CP.candidate_map(_t(y), _t(nf)), _t(env_in),
        torch.from_numpy(PK.gauss_vector(CFG)), CFG.a_dec,
        CFG.maxpksperframe)
    got = np.zeros((2, 200, 257), bool)
    p = lpos.numpy()
    b, t, _i = np.nonzero(p >= 0)
    got[b, t, p[b, t, _i]] = True
    assert np.array_equal(got[..., :256], np.asarray(mask))
    assert np.array_equal(_bits(genv), _bits(env_out))


def test_k1_plain_through_long_silence_matches_find_peaks_mask():
    """The batch path (HPF, K1's plain version, delete-next, slots) over
    a quiet head and 6,000 frames of silence, where both envelopes decay
    into the subnormal range, against JAX's HPF and forward/backward
    prune; and a sounding row beside it."""
    rng = np.random.default_rng(6)
    x = np.concatenate([_silence(rng, 1, 6000, scale=1e-30),
                        _silence(rng, 1, 6000)])
    nf = np.array([6000, 4000], np.int32)
    y = SPj.hpf(jnp.asarray(x), CFG)
    wbins, wvalid = PKj.mask_to_slots(
        PKj.find_peaks_mask(y, jnp.asarray(nf), CFG), CFG)
    gbins, gvalid = CP.find_peaks_slots_fused(_t(x), _t(nf), CFG)
    assert np.array_equal(gvalid.numpy(), np.asarray(wvalid))
    assert np.array_equal(gbins.numpy(), np.asarray(wbins))
    assert gvalid.numpy()[0].sum() >= 10


def test_plain_prune_subnormal_sgram_matches_find_peaks_mask():
    """PK.find_peaks_mask on a spectrogram with subnormal and boundary
    values (read as zeros by the reference's compares and products)."""
    rng = np.random.default_rng(7)
    y = (rng.standard_normal((2, 120, 256)) * 2.0).astype(np.float32)
    y[0, 30:] *= np.float32(1e-38)
    y[1, ::2] = rng.choice(np.float32([1e-39, -1e-39, TINY, 0.0]),
                           (60, 256))
    nf = np.array([120, 90], np.int32)
    want = PKj.find_peaks_mask(jnp.asarray(y), jnp.asarray(nf), CFG)
    got = PK.find_peaks_mask(_t(y), _t(nf), CFG)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---- K2's launch plan ----

@pytest.mark.parametrize("case", chip_smoke.K2_CASES,
                         ids=[c[0] for c in chip_smoke.K2_CASES])
@pytest.mark.parametrize("sms", [132, 114], ids=["SXM", "PCIe"])
def test_k2_plan_covers_every_column_once(case, sms):
    """For every shape the card run checks, on an H100 SXM (132 SMs) and
    PCIe (114): the strips cover each (row, bin) column exactly once, the
    boxes are whole 128-byte multiples of at most 256 frames, shared
    memory stays within a block's 227 KB, and the pad bins (F not a
    multiple of 4) never reach y or the carry: padding, scanning and
    cutting give the unpadded scan's bits."""
    _name, B, T, F, _kind = case
    W = SP.K2_STRIP
    plan = SP.k2_plan(B, T, F, sms)
    assert plan.Fp % 4 == 0 and F <= plan.Fp < F + 4
    assert plan.smem <= SP.K2_MAX_SMEM == 227 * 1024
    assert 0 < plan.frames <= 256 and plan.frames * W * 4 % 128 == 0
    assert plan.frames == (256 if plan.n_strips <= sms else 64)
    seen = np.zeros((B, plan.Fp), np.int64)
    per_row = -(-plan.Fp // W)              # block i's strip, as hpf.cu maps it
    for i in range(plan.n_strips):
        b, f0 = i // per_row, (i % per_row) * W
        assert 0 <= b < B
        seen[b, f0: min(f0 + W, plan.Fp)] += 1
    assert (seen == 1).all()
    rng = np.random.default_rng(B * 7 + F)
    Tc = min(T, 24)
    x = torch.from_numpy(rng.standard_normal((B, Tc, F)).astype(np.float32))
    carry = tuple(torch.from_numpy(rng.standard_normal((B, F)).astype(
        np.float32)) for _ in range(2))
    xk, ck = SP.k2_operands(x, carry, plan.Fp)
    assert xk.shape == (B, Tc, plan.Fp) and xk.data_ptr() % 16 == 0
    yk, (xo, yo) = SP.hpf_plain(xk, CFG, ck)
    y, (xT, yT) = SP.k2_results(yk, xo, yo, F)
    want, (wx, wy) = SP.hpf_plain(x, CFG, carry)
    assert y.shape == (B, Tc, F) and xT.shape == yT.shape == (B, F)
    assert torch.equal(y, want) and torch.equal(xT, wx) and torch.equal(yT, wy)


def test_k2_plan_mirrors_the_kernel():
    """spectro's K2 constants are csrc/hpf.cu's, and the chunk shape gets
    one strip per SM with 256-frame boxes while a batch gets short boxes."""
    import re

    from audfprint_torch.ops import _build

    with open(f"{_build.CSRC}/hpf.cu") as f:
        src = f.read()
    const = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kStrip"] == SP.K2_STRIP == 32
    assert const["kYStages"] == SP.K2_Y_STAGES
    assert const["kMaxSmem"] == SP.K2_MAX_SMEM
    chunk = SP.k2_plan(1, 8192, 256)
    assert (chunk.n_strips, chunk.frames) == (8, 256)
    batch = SP.k2_plan(256, 1535, 256)
    assert batch.n_strips == 2048 and batch.frames < chunk.frames
    # three batch blocks fit an SM's 228 KB (1 KB of it reserved a block)
    assert 3 * (batch.smem + 1024) <= 228 * 1024 < 4 * (batch.smem + 1024)


# ---- the envelope seeds: products flushed after their maximum ----

def _max_mul_case(kind: str, rng) -> tuple:
    """(a (B, n, 1), b (1, n, F)) float32.  In row 0 the products sit a
    few ulps either side of 2^-126, some columns wholly below it; with
    subnormal operands, all below zero, or beside a factor so large that
    the product scaled by 2^24 overflows (and zeros in its columns)."""
    B, n, F = 3, 4, 256
    a = rng.uniform(0.5, 1.0, (B, n, 1))
    shift = rng.choice([0.0, 4e-7], (1, 1, F))
    b = (np.float64(TINY) / a[:1] * (1 + rng.uniform(-3e-7, 3e-7, (1, n, F))
                                     - shift))
    b = np.where(rng.random(b.shape) < 0.2, -b, b)
    a, b = a.astype(np.float32), b.astype(np.float32)
    if kind == "subnormal":
        a[1:, ::2] = np.float32(1e-39)
        b[:, 1::3, ::5] = np.float32(-1e-39)
    elif kind == "negative":
        b = -np.abs(b)
    elif kind == "huge":
        a[:, 3] = np.float32(3e35)
        b[:, 3, ::2] = np.float32(0.0)
        b[:, 3, 1::4] = np.float32(1e-39)
    return a, b


@pytest.mark.parametrize("kind", ["boundary", "subnormal", "negative",
                                  "huge"])
def test_amax_mul_matches_mul_then_max_and_xla(kind):
    """FTZ.amax_mul (flush after the maximum) gives the elementwise
    rule's maximum (FTZ.mul, then amax) and XLA's, bit for bit but for the
    sign of a zero: torch's and XLA's maxima of +0 and -0 differ already."""
    a, b = _max_mul_case(kind, np.random.default_rng(8))
    got = FTZ.amax_mul(_t(a), _t(b), dim=1).numpy()
    each = FTZ.mul(_t(a), _t(b)).amax(dim=1).numpy()
    want = np.asarray(jax.jit(lambda x, y: jnp.max(x * y, axis=1))(a, b))
    assert np.array_equal(got, each) and np.array_equal(got, want)
    nz = want != 0
    assert np.array_equal(_bits(got)[nz], _bits(want)[nz])
    if kind == "boundary":
        assert (want == 0).sum() > 10 and (np.abs(want) == TINY).sum() > 10


@pytest.mark.parametrize("kind", ["boundary", "subnormal", "sounding"])
def test_spread_vector_matches_jax(kind):
    """The envelope seed (head_envelope, tail_envelope) against JAX's
    _spread_vector: v near 2^-126 / the Gaussian's peak, subnormal, or
    O(1), so its bumps flush, read as zeros, or are kept."""
    rng = np.random.default_rng(9)
    g = PK.gauss_vector(CFG)
    v = (rng.standard_normal((4, 256)) * 2.0).astype(np.float32)
    if kind == "boundary":
        # four lone local maxima a row, each sized so that its bump ~20
        # bins off lands a few ulps either side of 2^-126: exact products
        # that round up to 2^-126 on the subnormal grid but not at 24 bits
        # (flushed), and ones that stay
        v = np.zeros((16, 256), np.float32)
        for r in range(16):
            for p in 16 + 64 * np.arange(4) + rng.integers(0, 8, 4):
                d = rng.integers(18, 29)
                x = np.float32(np.float64(TINY) / np.float64(g[CFG.gsize + d]))
                for _ in range(rng.integers(0, 5)):
                    x = np.nextafter(x, np.float32(rng.choice([0.0, 1.0])))
                v[r, p] = x
    elif kind == "subnormal":
        v[:, ::2] = rng.choice(np.float32([1e-39, -1e-39, TINY, 0.0]),
                               (4, 128))
    gtab = PKj._gauss_table(CFG)
    want = np.asarray(PKj._spread_vector(jnp.asarray(v), jnp.asarray(gtab)))
    got = PK._spread_vector(_t(v), _t(gtab)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    if kind == "boundary":      # torch's gradual underflow would keep these
        keep = (_t(v)[:, :, None] * _t(gtab)[None]).amax(dim=1).numpy()
        assert ((keep == TINY) & (want == 0)).sum() > 4
        assert ((keep == TINY) & (want == TINY)).sum() > 4
