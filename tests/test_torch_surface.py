"""The port's public surface against the JAX package's, on the CPU.

One walk over every module of audfprint_tpu/: each public top-level
function and class it defines, and each public method of such a class,
has a same-named counterpart in the port's module of the same path.
EXCLUDED is the whole of what the port does not carry, each entry with its
reason; RENAMED maps the one module whose counterpart has another name.
Then the functions ported last equal their JAX counterparts on the same
numpy inputs."""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import audfprint_tpu  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)

# module of the JAX package -> the port's module, where the names differ
RENAMED = {
    # the TPU kernel's module: K1 and its wrappers are the port's CUDA ones
    "ops.pallas_peaks": "ops.cuda_peaks",
}

# "module" or "module.name" -> why the port does not carry it
EXCLUDED = {
    "utils.jaxconfig":
        "JAX's compile cache and platform set-up; torch has neither",
    "index.device_table.split_wide":
        "the TPU's (lo, hi) uint32 planes; the port's wide plane is int64",
    "index.device_table.join_wide":
        "the TPU's (lo, hi) uint32 planes; the port's wide plane is int64",
    "ops.landmarks.slots_to_hashes_dense":
        "a JAX A/B reference of slots_to_hashes, not on any path",
    "ops.pallas_peaks.find_peaks_mask_fused":
        "a JAX A/B reference of the fused prune, not on any path",
    "ops.streaming.unpack_stats":
        "unpacks the int32 limb block of one relay fetch; the port's sums "
        "are int64 tensors",
    "ops.streaming.unpack_stats_below":
        "unpacks the int32 limb block of one relay fetch; the port's sums "
        "are int64 tensors",
    "ops.streaming.unpack_fwd_peaks":
        "unpacks the int32-packed peak fetch; the port returns the tensors",
    "ops.streaming.chunk_mag_max_rows":
        "only models/streaming._gmax_only calls it, the fallback for int32 "
        "sums that overflow; the port's int64 sums do not",
}


def _jax_modules() -> list:
    return sorted(m.name for m in pkgutil.walk_packages(
        audfprint_tpu.__path__, "audfprint_tpu.")
        if not m.name.endswith("__main__"))


def _port_name(rel: str) -> str:
    return "audfprint_torch." + RENAMED.get(rel, rel)


def _public_defs(mod) -> dict:
    """Public functions and classes defined in `mod` (not imported)."""
    out = {}
    for k, v in vars(mod).items():
        if k.startswith("_") or not callable(v):
            continue
        if getattr(v, "__module__", None) == mod.__name__:
            out[k] = v
    return out


def _public_methods(cls) -> list:
    return [a for a, v in vars(cls).items() if not a.startswith("_") and (
        inspect.isfunction(v)
        or isinstance(v, (staticmethod, classmethod, property)))]


def _surface_gaps() -> list:
    """Every public name of the JAX package with no counterpart in the
    port, as "module" or "module.name" relative to the package."""
    gaps = []
    for name in _jax_modules():
        rel = name[len("audfprint_tpu."):]
        jm = importlib.import_module(name)
        try:
            tm = importlib.import_module(_port_name(rel))
        except ModuleNotFoundError:
            gaps.append(rel)
            continue
        for k, v in _public_defs(jm).items():
            if not hasattr(tm, k):
                gaps.append(f"{rel}.{k}")
            elif inspect.isclass(v):
                gaps += [f"{rel}.{k}.{a}" for a in _public_methods(v)
                         if not hasattr(getattr(tm, k), a)]
    return gaps


def test_every_public_name_has_a_counterpart():
    """The gaps are exactly the exclusion table: nothing else is missing,
    and no entry of the table names something the port has or the JAX
    package lacks."""
    assert sorted(_surface_gaps()) == sorted(EXCLUDED)
    assert all(reason.strip() for reason in EXCLUDED.values())


def test_renamed_module_counterparts():
    """The renamed module's public functions exist under the port's name,
    and ops/pallas_peaks has no namesake in the port."""
    jm = importlib.import_module("audfprint_tpu.ops.pallas_peaks")
    tm = importlib.import_module("audfprint_torch.ops.cuda_peaks")
    names = set(_public_defs(jm)) - {"find_peaks_mask_fused"}
    assert names == {"fused_prune", "find_peaks_slots_fused"}
    assert all(callable(getattr(tm, n)) for n in names)
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module("audfprint_torch.ops.pallas_peaks")


# ---- the functions ported last, against their JAX counterparts -----------

def _batch(seed: int):
    rng = np.random.default_rng(seed)
    x = np.stack([synth_audio(rng, dur_sec=2.0, n_tones=20),
                  synth_audio(rng, dur_sec=2.0, n_tones=20)])
    return x, np.array([x.shape[1], 11025], np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_whitened_spectrogram_matches_jax(seed):
    """hpf(whitened_logmag(...)) under the JAX name: within the front
    end's tolerance of JAX's, and equal to the port's own two stages."""
    from audfprint_torch.ops import pipeline as PLt
    from audfprint_torch.ops import spectro as SPt
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_tpu.ops import pipeline as PLj
    from audfprint_tpu.ops import spectro as SPj
    from audfprint_tpu.ops.config import PipelineConfig as PCj

    x, lens = _batch(seed)
    cfg, cj = PipelineConfig(), PCj()
    nf = np.array([PLj.n_frames_padded_static(int(n), cj) for n in lens],
                  np.int32)
    assert nf.tolist() == [PLt.n_frames_padded_static(int(n), cfg)
                           for n in lens]
    want = np.asarray(SPj.whitened_spectrogram(jnp.asarray(x),
                                               jnp.asarray(nf), cj))
    xt, nft = torch.as_tensor(x), torch.as_tensor(nf)
    got = SPt.whitened_spectrogram(xt, nft, cfg)
    assert got.shape == want.shape
    for b, n in enumerate(nf):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n],
                                   atol=5e-3, rtol=1e-3)
    two = SPt.hpf(SPt.whitened_logmag(xt, nft, cfg), cfg)[0]
    assert torch.equal(got, two)


def test_n_frames_padded_static_matches_jax():
    from audfprint_torch.ops import pipeline as PLt
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_tpu.ops import pipeline as PLj
    from audfprint_tpu.ops.config import PipelineConfig as PCj

    for n_fft, n_hop in ((512, 256), (1024, 128)):
        cfg = PipelineConfig(n_fft=n_fft, n_hop=n_hop)
        cj = PCj(n_fft=n_fft, n_hop=n_hop)
        for n in (0, 1, n_fft - 1, n_fft, n_fft + 1, n_fft + n_hop,
                  331_000, 1 << 20):
            assert PLt.n_frames_padded_static(n, cfg) == \
                PLj.n_frames_padded_static(n, cj)


def test_s16_to_f32_mono_matches_jax():
    """The port's binding of the C entry point equals the JAX package's,
    mono and interleaved stereo; both are None without the library."""
    from audfprint_torch.utils import native as Nt
    from audfprint_tpu.utils import native as Nj

    raw = np.random.default_rng(3).integers(-32768, 32767, 4096).astype(
        np.int16)
    for n_ch in (1, 2, 4):
        got, want = Nt.s16_to_f32_mono(raw, n_ch), Nj.s16_to_f32_mono(
            raw, n_ch)
        assert (got is None) == (Nt.get_lib() is None)
        if got is not None and want is not None:
            assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("use_env_in", [False, True])
def test_fwd_prune_carry_matches_jax(use_env_in):
    """The forward prune with its envelope carry (K1f's plain version on
    the CPU) gives JAX's mask and envelope on tie-heavy input with ragged
    n_frames."""
    from audfprint_torch.ops import peaks as PKt
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_tpu.ops import peaks as PKj
    from audfprint_tpu.ops.config import PipelineConfig as PCj

    rng = np.random.default_rng(7)
    sg = np.round(rng.standard_normal((2, 60, 256)) * 2).astype(
        np.float32) / 2
    nf = np.array([60, 41], np.int32)
    env = np.abs(rng.standard_normal((2, 256))).astype(np.float32)
    mj, ej = PKj.fwd_prune_carry(jnp.asarray(sg), jnp.asarray(nf),
                                 jnp.asarray(env), PCj(), use_env_in)
    mt, et = PKt.fwd_prune_carry(torch.as_tensor(sg), torch.as_tensor(nf),
                                 torch.as_tensor(env), PipelineConfig(),
                                 use_env_in)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert np.array_equal(et.numpy(), np.asarray(ej))
    assert int(mt.sum()) > 50


def _filled_tables(seed: int):
    from audfprint_torch.index.hash_table import HashTable

    rng = np.random.default_rng(seed)
    ht = HashTable(hashbits=10, depth=6, maxtime=1 << 10)
    for i in range(5):
        ht.store_vectorized(f"t{i}", np.stack(
            [rng.integers(0, 1000, 300), rng.integers(0, 1 << 10, 300)],
            axis=1))
    return ht, rng


def test_match_batch_and_get_hits_match_jax():
    """voting.match_batch (= match_batch_sorted) gives the JAX dict,
    dtypes included, and DT.get_hits the JAX gather."""
    from audfprint_torch import params as P
    from audfprint_torch.index import device_table as DT
    from audfprint_torch.match import voting
    from audfprint_tpu.index import device_table as DTj
    from audfprint_tpu.match import voting as Vj

    ht, rng = _filled_tables(4)
    assert voting.match_batch is voting.match_batch_sorted
    assert Vj.match_batch is Vj.match_batch_sorted
    B, Q = 3, 128
    qt = rng.integers(0, 200, (B, Q)).astype(np.int32)
    qh = rng.integers(0, 1 << 10, (B, Q)).astype(np.int32)
    qv = rng.random((B, Q)) < 0.8
    hpi = np.zeros(256, np.int32)
    hpi[:5] = ht.hashesperid
    tcfg, tcj = DT.config_for(ht), DTj.config_for(ht)
    table, counts, _ = DT.table_to_device(ht, "cpu")
    tj, cj, _ = DTj.table_to_device(ht)
    args = [torch.as_tensor(a) for a in (qt, qh, qv)]
    jargs = [jnp.asarray(a) for a in (qt, qh, qv)]
    for g, w in zip(DT.get_hits(table, counts, *args, tcfg),
                    DTj.get_hits(tj, cj, *jargs, tcj)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    mp = P.MatcherParams(max_returns=4, threshcount=2, exact_count=True,
                         find_time_range=True)
    mcfg = voting.MatchConfig.from_params(mp, qt_cap=256, n_ids_cap=256)
    mcj = Vj.MatchConfig(*mcfg)
    got = voting.match_batch(table, counts, torch.as_tensor(hpi), *args,
                             tcfg, mcfg)
    want = Vj.match_batch(tj, cj, jnp.asarray(hpi), *jargs, tcj, mcj)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        assert np.array_equal(got[k].numpy(), w), k
    assert int(np.asarray(want["n_results"]).sum()) > 0


def test_matcher_invalidate_restages():
    """invalidate() drops the cached device table, as in the JAX Matcher:
    counts swapped for new ones without a revision bump are seen only
    after it."""
    from audfprint_torch.match.matcher import Matcher
    from audfprint_tpu.match.matcher import Matcher as Mj

    ht, rng = _filled_tables(5)
    h = np.stack([rng.integers(0, 1000, 100), rng.integers(0, 1024, 100)],
                 axis=1)
    ht.store_vectorized("t0", h)
    q = h[:40]
    m, mj = Matcher(device="cpu", verbose=0), Mj(verbose=0)
    before = m.match_hashes(ht, q)
    assert len(before) and np.array_equal(before, mj.match_hashes(ht, q))
    saved = ht.counts
    ht.counts = np.zeros_like(saved)      # no revision bump
    for mm in (m, mj):
        assert np.array_equal(mm.match_hashes(ht, q), before)
        mm.invalidate()
        assert mm._dev is None
        assert len(mm.match_hashes(ht, q)) == 0
    ht.counts = saved
    for mm in (m, mj):
        mm.invalidate()
        assert np.array_equal(mm.match_hashes(ht, q), before)


def test_fused_ingest_graph_matches_jax():
    """The JAX name and return of the fused ingest: (table, counts, per-
    file unique hash counts), equal to DT.store_batch of JAX's hashes."""
    from audfprint_torch.index import device_table as DT
    from audfprint_torch.models import ingest as It
    from audfprint_torch.ops.config import PipelineConfig
    from audfprint_tpu.index import device_table as DTj
    from audfprint_tpu.models import ingest as Ij
    from audfprint_tpu.ops.config import PipelineConfig as PCj

    x, lens = _batch(9)
    tcfg = DT.TableConfig(hashbits=14, depth=8, maxtimebits=10)
    tcj = DTj.TableConfig(hashbits=14, depth=8, maxtimebits=10)
    table, counts = DT.empty_table(tcfg, "cpu")
    ids = np.array([0, 1], np.int32)
    t2, c2, cnt = It.fused_ingest_graph(
        table, counts, torch.as_tensor(x), torch.as_tensor(lens),
        torch.as_tensor(ids), PipelineConfig(), tcfg)
    assert t2 is table and c2 is counts
    tj, cj = DTj.empty_table(tcj)
    tj, cj, cntj = Ij.fused_ingest_graph(
        tj, cj, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(ids), PCj(),
        tcj)
    assert np.array_equal(cnt.numpy(), np.asarray(cntj))
    assert np.array_equal(table.numpy().view(np.uint32), np.asarray(tj))
    assert np.array_equal(counts.numpy(), np.asarray(cj))
    assert int(cnt.min()) > 0 and int(cnt.sum()) > 30
