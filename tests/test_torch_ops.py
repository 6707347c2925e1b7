"""audfprint_torch ops against the JAX package on the CPU: the same numpy
inputs through both, at small sizes.  Integer stages and the HPF are
bit-exact; the float front end is held to the reference's tolerance
(spectrogram atol=5e-3, rtol=1e-3; end-to-end hash Jaccard > 0.9)."""

from fractions import Fraction

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audfprint_tpu.ops import landmarks as Lj  # noqa: E402
from audfprint_tpu.ops import pallas_peaks as PPj  # noqa: E402
from audfprint_tpu.ops import peaks as PKj  # noqa: E402
from audfprint_tpu.ops import pipeline as pipej  # noqa: E402
from audfprint_tpu.ops import spectro as SPj  # noqa: E402
from audfprint_tpu.ops.config import PipelineConfig  # noqa: E402
from audfprint_torch.ops import _build  # noqa: E402
from audfprint_torch.ops import cuda_peaks as CP  # noqa: E402
from audfprint_torch.ops import ftz as FTZ  # noqa: E402
from audfprint_torch.ops import landmarks as L  # noqa: E402
from audfprint_torch.ops import peaks as PK  # noqa: E402
from audfprint_torch.ops import pipeline as pipe  # noqa: E402
from audfprint_torch.ops import spectro as SP  # noqa: E402
from audfprint_torch.utils.device import resolve_device  # noqa: E402

torch.set_num_threads(2)
CFG = PipelineConfig()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rand_sgram(rng, B=3, T=40, F=256, scale=3.0):
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    for b in range(B):
        for _ in range(6):
            f0 = rng.integers(5, F - 5)
            t0, t1 = sorted(rng.integers(0, T, 2).tolist())
            x[b, t0:t1 + 1, f0] += scale
    return x


def _white_case(seed):
    rng = np.random.default_rng(seed)
    white = _rand_sgram(rng, B=3, T=40)
    if seed == 2:  # quantised: plateaus, ties, consecutive-frame repeats
        white = np.round(white).astype(np.float32)
    return white, np.array([40, 25, 8], np.int32)


def test_whitened_logmag_within_tolerance(audio_5s):
    n = len(audio_5s)
    batch = np.zeros((2, 1 << 16), np.float32)
    batch[0, :n] = audio_5s
    batch[1, : n // 2] = audio_5s[: n // 2]
    lens = np.array([n, n // 2], np.int32)
    nf = np.asarray(pipej.frame_count_device(jnp.asarray(lens), CFG))
    want = np.asarray(SPj.whitened_logmag(jnp.asarray(batch),
                                          jnp.asarray(nf), CFG))
    got = SP.whitened_logmag(_t(batch), _t(nf), CFG).numpy()
    assert got.shape == want.shape
    for b in range(2):
        np.testing.assert_allclose(got[b, : nf[b]], want[b, : nf[b]],
                                   atol=5e-3, rtol=1e-3)


# (seed, B, T, F): the main shape, then K2's edge shapes (ragged and
# padded widths, the widest, B * F below 32, no frame, one frame, fewer
# frames than one box, a row ending inside a box)
HPF_CASES = [(0, 3, 64, 256), (1, 3, 64, 256), (2, 2, 40, 200),
             (3, 2, 40, 258), (4, 1, 40, 20), (5, 1, 30, 1024),
             (6, 2, 0, 256), (7, 2, 1, 256), (8, 3, 5, 256), (9, 1, 300, 256)]


@pytest.mark.parametrize("seed,B,T,F", HPF_CASES)
def test_hpf_bit_exact(seed, B, T, F):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, F)) * 4.0).astype(np.float32)
    cfg = CFG._replace(n_fft=2 * F)          # the JAX scan starts at (B, F)
    want = np.asarray(SPj.hpf(jnp.asarray(x), cfg))
    got = SP.hpf(_t(x), cfg)[0].numpy()
    assert got.shape == want.shape == (B, T, F)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _round_f32(exact: Fraction) -> np.float32:
    """Correct round-to-nearest-even of a rational to float32."""
    x = np.float32(float(exact))
    cands = [np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - exact) for c in cands]
    best = min(err)
    ties = [c for c, e in zip(cands, err) if e == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.uint32)) & 1)


def test_fma_f32_single_rounding():
    """The plain HPF's fused multiply-add rounds once, like the hardware
    FMA the reference's compiled recurrence uses (random and cancelling
    operands, where rounding the product first would differ)."""
    rng = np.random.default_rng(7)
    n = 400
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-8, 8, n)).astype(
        np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    c[: n // 2] = -(a[: n // 2] * b[: n // 2])     # cancellation cases
    got = FTZ.fma(_t(a), _t(b), _t(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_prune_matches_jax(seed):
    """The plain prune (K1's reference) gives the JAX mask bit for bit,
    and the same ascending slots, on the same HPF'd spectrogram."""
    white, nf = _white_case(seed)
    y = np.asarray(SPj.hpf(jnp.asarray(white), CFG))
    want = PKj.find_peaks_mask(jnp.asarray(y), jnp.asarray(nf), CFG)
    got = PK.find_peaks_mask(_t(y), _t(nf), CFG)
    assert np.array_equal(got.numpy(), np.asarray(want))
    wbins, wvalid = PKj.mask_to_slots(want, CFG)
    gbins, gvalid = PK.mask_to_slots(got, CFG)
    assert np.array_equal(gvalid.numpy(), np.asarray(wvalid))
    assert np.array_equal(gbins.numpy(), np.asarray(wbins))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_slots_match_pallas_interpret(seed):
    """find_peaks_slots_fused (the product path: HPF, prologue, the K1
    plain version, delete-next, ascending slots) equals the Pallas
    kernel's path run in interpret mode, including tie-heavy input; the
    pre-rule kept lists agree too."""
    white, nf = _white_case(seed)
    wbins, wvalid = PPj.find_peaks_slots_fused(
        jnp.asarray(white), jnp.asarray(nf), CFG, interpret=True)
    gbins, gvalid = CP.find_peaks_slots_fused(_t(white), _t(nf), CFG)
    assert np.array_equal(gvalid.numpy(), np.asarray(wvalid))
    assert np.array_equal(gbins.numpy(), np.asarray(wbins))
    _pk, wkept = PPj.fused_prune(jnp.asarray(white), jnp.asarray(nf), CFG,
                                 interpret=True)
    gkept = CP.fused_prune(_t(white), _t(nf), CFG)
    assert np.array_equal(gkept.numpy(), np.asarray(wkept))


def test_slots_to_hashes_bit_exact():
    rng = np.random.default_rng(3)
    bins = np.sort(rng.integers(0, 256, (2, 64, 5)), -1).astype(np.int32)
    valid = rng.random((2, 64, 5)) < 0.6
    want = Lj.slots_to_hashes(jnp.asarray(bins), jnp.asarray(valid), CFG)
    got = L.slots_to_hashes(_t(bins), _t(valid), CFG)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("T", [40, 2100])
def test_fingerprint_batch_same_slots(T, monkeypatch):
    """Given the same peak slots, fingerprint_batch's pairing, int64-key
    sort and dedup equal the JAX pipeline's (single-key sort at T <= 2047,
    two-key sort above)."""
    rng = np.random.default_rng(T)
    B = 2
    bins = np.sort(rng.integers(0, 256, (B, T, 5)), -1).astype(np.int32)
    valid = rng.random((B, T, 5)) < 0.5
    monkeypatch.setattr(pipej, "_peak_slots", lambda a, ln, cfg, impl="auto":
                        (jnp.asarray(bins), jnp.asarray(valid), T))
    monkeypatch.setattr(pipe, "_peak_slots", lambda a, ln, cfg:
                        (_t(bins), _t(valid), T))
    audio = np.zeros((B, 1024), np.float32)
    lens = np.full(B, 1024, np.int32)
    want = pipej.fingerprint_batch.__wrapped__(
        jnp.asarray(audio), jnp.asarray(lens), CFG)
    got = pipe.fingerprint_batch(_t(audio), _t(lens), CFG)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _jaccard(a, b) -> float:
    sa = {tuple(r) for r in np.asarray(a).tolist()}
    sb = {tuple(r) for r in np.asarray(b).tolist()}
    return len(sa & sb) / max(1, len(sa | sb))


@pytest.mark.parametrize("shifts", [1, 2])
def test_fingerprint_end_to_end_jaccard(audio_5s, shifts):
    cfg = CFG._replace(shifts=shifts)
    n = len(audio_5s)
    batch = np.zeros((1, 1 << 16), np.float32)
    batch[0, :n] = audio_5s
    want = pipej.fingerprint_numpy(batch, [n], cfg)[0]
    got = pipe.fingerprint_numpy(batch, [n], cfg, "cpu")[0]
    assert len(got) > 50
    assert _jaccard(got, want) > 0.9


def test_int16_staging_is_exact(audio_5s):
    """Raw int16 batches convert on the device to exactly the float32
    samples the host would stage."""
    pcm = np.round(audio_5s * 32767).astype(np.int16)
    n = len(pcm)
    b16 = np.zeros((1, 1 << 16), np.int16)
    b16[0, :n] = pcm
    b32 = (b16.astype(np.float32) / 32768.0).astype(np.float32)
    h16 = pipe.fingerprint_numpy(b16, [n], CFG, "cpu")[0]
    h32 = pipe.fingerprint_numpy(b32, [n], CFG, "cpu")[0]
    assert np.array_equal(h16, h32)


def test_peaks_batch_matches_jax(audio_5s):
    n = len(audio_5s)
    batch = np.zeros((1, 1 << 16), np.float32)
    batch[0, :n] = audio_5s
    cfg = CFG._replace(shifts=2)
    wb, wv = pipej.peaks_batch(jnp.asarray(batch), jnp.asarray([n]), cfg)
    gb, gv = pipe.peaks_batch(_t(batch), _t(np.array([n], np.int32)), cfg)
    assert gb.shape == wb.shape
    # peak sets are what precompute -K stores
    for s in range(2):
        w = {(t, int(np.asarray(wb)[0, s, t, k]))
             for t, k in zip(*np.nonzero(np.asarray(wv)[0, s]))}
        g = {(t, int(gb.numpy()[0, s, t, k]))
             for t, k in zip(*np.nonzero(gv.numpy()[0, s]))}
        assert len(w) > 20 and len(w & g) / len(w | g) > 0.9


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; any other
    device gets the kernel or an error, never a quiet fallback."""
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        SP.hpf(x, CFG)
    with pytest.raises(RuntimeError, match="no kernel"):
        CP.prune_fwd_bwd(x, torch.empty(1, device="meta"),
                         torch.empty((1, 8), device="meta"),
                         torch.empty((1, 8), device="meta"),
                         torch.empty(15, device="meta"), CFG.a_dec, 5)
    with pytest.raises(RuntimeError, match="no kernel"):
        CP.prune_fwd_carry(x, torch.empty((1, 8), device="meta"),
                           torch.empty(15, device="meta"), CFG.a_dec, 5)


def test_kernel_build_is_keyed_by_sources():
    """The library path names a hash of the sources and flags, under the
    checkout's build/ directory, so an edited kernel never loads stale."""
    p1 = _build.library_path()
    assert p1.startswith(_build.BUILD_DIR) and p1.endswith(".so")
    assert p1 == _build.library_path()
    assert "build" in _build.BUILD_DIR.split("/")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1/K2 run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,F", [(4, 300, 256), (2, 700, 200),
                                   (2, 700, 258), (1, 300, 20),
                                   (2, 600, 1024), (2, 1, 256), (3, 5, 256),
                                   (2, 8191, 256), (256, 1535, 256)])
def test_k2_matches_plain_on_card(cuda_device, B, T, F):
    x = torch.randn((B, T, F), generator=torch.Generator().manual_seed(0))
    got = SP.hpf(x.to(cuda_device), CFG)[0]
    want = SP.hpf_plain(x.to(cuda_device), CFG)[0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 2])
def test_k1_matches_plain_on_card(cuda_device, seed):
    white, nf = _white_case(seed)
    _y, m0, env0f, env0b, gvec = CP.prune_inputs(
        _t(white).to(cuda_device), _t(nf).to(cuda_device), CFG)
    args = (m0, _t(nf).to(cuda_device), env0f, env0b, gvec, CFG.a_dec, 5)
    assert torch.equal(CP.prune_fwd_bwd(*args), CP.prune_fwd_bwd_plain(*args))


def _wrapper_case(seed: int, B: int, T: int, F: int):
    """Seeded wrapper-level K1/K1f inputs: m0 with a third of the bins
    candidates-to-be, two envelopes and a 2F - 1 template."""
    rng = np.random.default_rng(seed)
    m0 = np.where(rng.random((B, T, F)) < 0.3,
                  rng.standard_normal((B, T, F)) * 2.0 + 1.0, CP._NEG)
    g = np.exp(-0.5 * (np.arange(-(F - 1), F) / 30.0) ** 2)
    nf = rng.integers(0, T + 1, B)
    return (_t(m0.astype(np.float32)),
            _t(rng.uniform(0, 3, (B, F)).astype(np.float32)),
            _t(rng.uniform(0, 3, (B, F)).astype(np.float32)),
            _t(g.astype(np.float32)), _t(nf.astype(np.int32)))


@pytest.mark.parametrize("F", [200, 258, 5])
def test_kernel_padding_is_invisible(F):
    """The kernels' operands padded to a multiple of 4 bins (m0 with
    _NEG, envelopes with 0, the template re-centred) give the plain
    versions' results on the real bins: kept lists, forward lists and
    the envelope carried out."""
    m0, e0f, e0b, g, nf = _wrapper_case(F, 3, 60, F)
    m0p, (e0fp, e0bp), gp, Fp = CP._kernel_inputs(
        "test", m0, [e0f, e0b], g, 60, 5, lists=True)
    assert Fp % 4 == 0 and Fp - F < 4 and m0p.shape[-1] == Fp
    assert gp.shape == (2 * Fp - 1,)
    assert torch.equal(CP.prune_fwd_bwd_plain(m0p, nf, e0fp, e0bp, gp,
                                              CFG.a_dec, 5),
                       CP.prune_fwd_bwd_plain(m0, nf, e0f, e0b, g,
                                              CFG.a_dec, 5))
    got = CP.prune_fwd_carry_plain(m0p, e0fp, gp, CFG.a_dec, 5)
    want = CP.prune_fwd_carry_plain(m0, e0f, g, CFG.a_dec, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2][:, :F], want[2])


def test_kernel_inputs_refuse_past_the_limits():
    """Padding past MAX_BINS raises a ValueError that names the limit,
    before any launch."""
    m0, e0f, _e0b, g, _nf = _wrapper_case(0, 1, 4, 1023)
    CP._kernel_inputs("test", m0, [e0f], g, 4, 5, lists=False)
    m0, e0f, _e0b, g, _nf = _wrapper_case(0, 1, 4, 1025)
    with pytest.raises(ValueError, match="at most 1024"):
        CP._kernel_inputs("test", m0, [e0f], g, 4, 5, lists=False)


def test_shared_memory_mirror_matches_the_kernel():
    """cuda_peaks' shared-memory arithmetic uses csrc/prune.cu's constants,
    and the main path's K1 keeps its lists in shared memory (two rows per
    SM) while a 3000-frame batch puts them in global memory."""
    import re

    with open(f"{_build.CSRC}/prune.cu") as f:
        src = f.read()
    const = {m.group(1): eval(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = ([\d *]+);", src)}
    assert const["kStages"] == CP._STAGES
    assert const["kStageBytes"] == CP._STAGE_BYTES
    assert const["kMaxSmem"] == CP._MAX_SMEM
    assert const["kListSmemMax"] == CP._LIST_SMEM_MAX
    assert CP._smem_bytes(1535, 256, 5, True) == 32768 + 32 + 2048 + 61400
    assert CP._smem_bytes(1535, 256, 5, True) <= CP._LIST_SMEM_MAX
    assert CP._smem_bytes(3000, 256, 5, True) > CP._LIST_SMEM_MAX
    assert max(CP._smem_bytes(0, F, 16, False)
               for F in range(4, 1025, 4)) < CP._MAX_SMEM
