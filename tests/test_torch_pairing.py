"""Landmark pairing (ops/landmarks.slots_to_hashes) against the JAX package
on the CPU, bit for bit on times, hashes and lvalid.

Each case of chip_smoke.PAIR_CASES goes through
audfprint_tpu.ops.landmarks.slots_to_hashes (jit, CPU) and through two
counterparts: the port's plain version, which slots_to_hashes runs on a
CPU tensor, and `k3_walk`, a numpy transcription of kernel K3's per-anchor
walk (csrc/pair.cu), which cannot run here.  The card holds K3 itself
against the plain version (chip_smoke.py, and the `cuda` test below)."""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from audfprint_tpu.ops import landmarks as Lj  # noqa: E402
from audfprint_tpu.ops.config import PipelineConfig  # noqa: E402
from audfprint_torch.ops import _build  # noqa: E402
from audfprint_torch.ops import landmarks as L  # noqa: E402

CASES = chip_smoke.PAIR_CASES
IDS = [c[0] for c in CASES]


def k3_walk(bins: np.ndarray, valid: np.ndarray, cfg):
    """csrc/pair.cu's algorithm in numpy: each valid anchor walks d =
    mindt .. targetdt - 1 (frame t + slice_start(d)), stops at the first
    frame t + d >= T, and in each frame takes the valid partner slots j =
    0 .. K - 1 with |f2 - f1| < targetdf, until `fanout` are found."""
    B, T, K = bins.shape
    fanout = cfg.maxpairsperpeak
    hashes = np.zeros((B, T, K, fanout), np.int32)
    lvalid = np.zeros((B, T, K, fanout), bool)
    for b, t, k in zip(*np.nonzero(valid)):
        f1 = int(bins[b, t, k])
        count = 0
        for d in range(cfg.mindt, cfg.targetdt):
            pt = t + L.slice_start(d, T, cfg.targetdt)
            if count == fanout or (pt >= T and d >= 0):
                break
            if pt >= T:
                continue
            for j in range(K):
                f2 = int(bins[b, pt, j])
                if valid[b, pt, j] and abs(f2 - f1) < cfg.targetdf:
                    hashes[b, t, k, count] = (((f1 & 0xFF) << 12)
                                              | (((f2 - f1) & 0x3F) << 6)
                                              | (d & 0x3F))
                    lvalid[b, t, k, count] = True
                    count += 1
                    if count == fanout:
                        break
    times = np.broadcast_to(np.arange(T, dtype=np.int32)[None, :, None, None],
                            hashes.shape)
    return times, hashes, lvalid


def _case(name: str):
    _n, B, T, K, fields, kind = CASES[IDS.index(name)]
    cfg = PipelineConfig(**fields)
    rng = np.random.default_rng(IDS.index(name) + 80)
    bins, valid = chip_smoke.pair_input(rng, B, T, K, cfg.n_bins, kind,
                                        cfg.targetdf)
    return bins, valid, cfg


def _port_plain(bins, valid, cfg):
    return [a.numpy() for a in L.slots_to_hashes(torch.from_numpy(bins),
                                                 torch.from_numpy(valid), cfg)]


@pytest.mark.parametrize("impl", ["plain", "k3_walk"])
@pytest.mark.parametrize("name", IDS)
def test_pairing_bit_exact_vs_jax(name, impl):
    bins, valid, cfg = _case(name)
    want = [np.asarray(a) for a in Lj.slots_to_hashes(
        jnp.asarray(bins), jnp.asarray(valid), cfg)]
    got = (_port_plain if impl == "plain" else k3_walk)(bins, valid, cfg)
    for w, g, what in zip(want, got, ("times", "hashes", "lvalid")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert np.array_equal(g, w), what
    if name == "dense within targetdf":      # the fanout fills at d = mindt
        head = slice(0, bins.shape[1] - cfg.mindt)
        assert want[2][:, head].all()
        assert ((want[1][:, head] & 0x3F) == cfg.mindt).all()
    if name.startswith("|df|"):              # both sides of the strict bound
        df = (want[1] >> 6) & 0x3F
        assert (df[want[2]] == cfg.targetdf - 1).any()
        assert not (df[want[2]] == cfg.targetdf).any()
        assert not (df[want[2]] == 64 - cfg.targetdf).any()


def test_cpu_tensor_never_builds_the_kernel(monkeypatch):
    """A CPU tensor takes the plain version and never reaches the build."""
    def refuse():
        raise AssertionError("slots_to_hashes built the kernel for a CPU "
                             "tensor")

    monkeypatch.setattr(_build, "load", refuse)
    bins, valid, cfg = _case("default")
    before = L.launches["pair_scan"]
    got = _port_plain(bins, valid, cfg)
    want = [a.numpy() for a in L.slots_to_hashes_plain(
        torch.from_numpy(bins), torch.from_numpy(valid), cfg)]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert L.launches["pair_scan"] == before


def test_other_devices_raise():
    x = torch.empty((1, 4, 5), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        L.slots_to_hashes(x, x.bool(), PipelineConfig())


def test_signature_mirrors_the_kernel():
    """_build binds pair_scan with csrc/pair.cu's parameters: a pointer
    for each pointer and the stream, an int for each int."""
    with open(f"{_build.CSRC}/pair.cu") as f:
        src = f.read()
    assert "pair.cu" in _build.SOURCES
    params = re.search(r'extern "C" int pair_scan\(([^)]*)\)', src).group(1)
    kinds = [_build._P if "*" in p else _build._I for p in params.split(",")]
    assert kinds == _build._SIGNATURES["pair_scan"]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K3 runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", IDS)
def test_k3_matches_plain_on_card(cuda_device, name):
    bins, valid, cfg = _case(name)
    b, v = torch.from_numpy(bins).to(cuda_device), \
        torch.from_numpy(valid).to(cuda_device)
    got = L.slots_to_hashes(b, v, cfg)
    want = L.slots_to_hashes_plain(b, v, cfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
