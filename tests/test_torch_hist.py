"""audfprint_torch's histogram voting core and the per-entry hashesperid
plane against the JAX package on the CPU, all integers bit for bit
(tolerance 0): match_core / match_batch_hist against JAX's match_batch_hist
and against the port's sorted core across the option matrix, the
id-domain and merged hit-domain candidate selections, build_hpi_plane /
gather_plane on int32 and wide int64 tables, and the Matcher's force_core
and use_hpi_plane switches reaching their core and plane."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audfprint_tpu.index import device_table as DTj  # noqa: E402
from audfprint_tpu.index.hash_table import HashTable  # noqa: E402
from audfprint_tpu.match import matcher as Mj  # noqa: E402
from audfprint_tpu.match import voting as Vj  # noqa: E402
from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.match import voting as V  # noqa: E402
from audfprint_torch.match.matcher import Matcher  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from tests.test_torch_match import TCFG, _queries, _t, _table  # noqa: E402
from tests.test_torch_wide import CFG as WCFG  # noqa: E402
from tests.test_torch_wide import CFGJ as WCFGJ  # noqa: E402
from tests.test_torch_wide import BIG_IDS, _stored_wide  # noqa: E402

torch.set_num_threads(2)


def _hpi(ht, n=16):
    hpi = np.zeros(n, np.int32)
    k = min(n, len(ht.hashesperid))
    hpi[:k] = ht.hashesperid[:k]
    return hpi


def _jax_hist(ht, hpi, qt, qh, qv, mcfg):
    out = Vj.match_batch_hist(
        jnp.asarray(ht.table), jnp.asarray(ht.counts), jnp.asarray(hpi),
        jnp.asarray(qt), jnp.asarray(qh), jnp.asarray(qv),
        DTj.TableConfig(*TCFG), Vj.MatchConfig(*mcfg))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("max_returns", [1, 4])
@pytest.mark.parametrize("sort_by_time", [False, True])
@pytest.mark.parametrize("find_time_range", [False, True])
@pytest.mark.parametrize("exact_count", [False, True])
def test_hist_core_matches_jax_and_sorted(exact_count, find_time_range,
                                          sort_by_time, max_returns):
    """match_batch_hist's dict equals JAX's key by key; the packed hist
    rows equal the port's sorted core's, with and without the hpi plane;
    on duplicate-heavy tables whose counts tie (first-extremum rules)."""
    for seed in range(2):
        ht = _table(seed)
        qt, qh, qv = _queries(seed)
        hpi = _hpi(ht)
        mcfg = V.MatchConfig(
            window=2, search_depth=8, max_returns=max_returns, threshcount=1,
            exact_count=exact_count, find_time_range=find_time_range,
            sort_by_time=sort_by_time, qt_cap=256, n_ids_cap=16,
            modes_cap=max_returns)
        want = _jax_hist(ht, hpi, qt, qh, qv, mcfg)
        table, counts, _cfg = DT.table_to_device(ht, "cpu")
        args = (table, counts, _t(hpi), _t(qt), _t(qh), _t(qv), TCFG, mcfg)
        got = V.match_batch_hist(*args)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k],
                                          err_msg=f"{k} seed={seed}")
        hist = V.match_batch_packed(*args, "hist").numpy()
        plane = DT.build_hpi_plane(table, _t(hpi), TCFG)
        np.testing.assert_array_equal(
            hist, V.match_batch_packed(*args, "sorted").numpy())
        np.testing.assert_array_equal(
            hist, V.match_batch_packed(*args, "sorted", plane).numpy())


@pytest.mark.parametrize("exact_count", [False, True])
def test_candidate_selections_agree(exact_count):
    """The id-domain selection (combiners that are not _ident, no gather)
    and the merged hit-domain selection (with a gather) equal the
    unsharded hit-domain one and JAX's id-domain path."""
    ht = _table(1, n_tracks=7)
    qt, qh, qv = _queries(1)
    hpi = _hpi(ht)
    mcfg = V.MatchConfig(search_depth=4, max_returns=3, threshcount=1,
                         exact_count=exact_count, find_time_range=True,
                         qt_cap=256, n_ids_cap=16, modes_cap=3)
    table, counts, _cfg = DT.table_to_device(ht, "cpu")
    args = (table, counts, _t(hpi), _t(qt), _t(qh), _t(qv), TCFG, mcfg)
    want = V.pack_rows(V.match_core(*args)).numpy()
    ident2 = lambda x: x  # noqa: E731
    idd = V.match_core(*args, sum_all=ident2, min_all=ident2)
    merged = V.match_core(*args, sum_all=ident2, min_all=ident2,
                          gather_all=ident2)
    np.testing.assert_array_equal(V.pack_rows(idd).numpy(), want)
    np.testing.assert_array_equal(V.pack_rows(merged).numpy(), want)
    jid = Vj.match_core(
        jnp.asarray(ht.table), jnp.asarray(ht.counts), jnp.asarray(hpi),
        jnp.asarray(qt), jnp.asarray(qh), jnp.asarray(qv),
        DTj.TableConfig(*TCFG), Vj.MatchConfig(*mcfg), sum_all=ident2,
        min_all=ident2)
    for k, v in jid.items():
        np.testing.assert_array_equal(idd[k].numpy(), np.asarray(v), k)


def test_hist_search_depth_beyond_hits_and_ids():
    """search_depth past H = Q * depth pads invalid candidate slots, as in
    JAX; past n_ids_cap the id-domain path refuses."""
    ht = _table(0, n_tracks=2)
    qt, qh, qv = _queries(0, Q=8)
    hpi = _hpi(ht)
    mcfg = V.MatchConfig(search_depth=100, max_returns=2, threshcount=1,
                         qt_cap=256, n_ids_cap=16)
    table, counts, _cfg = DT.table_to_device(ht, "cpu")
    args = (table, counts, _t(hpi), _t(qt), _t(qh), _t(qv), TCFG, mcfg)
    got = V.match_batch_hist(*args)
    for k, v in _jax_hist(ht, hpi, qt, qh, qv, mcfg).items():
        np.testing.assert_array_equal(got[k].numpy(), v, k)
    with pytest.raises(ValueError, match="search_depth exceeds n_ids_cap"):
        V.match_core(*args, sum_all=lambda x: x, min_all=lambda x: x)
    with pytest.raises(ValueError, match="unknown voting core"):
        V.match_batch_packed(*args, "topk")


@pytest.mark.parametrize("wide", [False, True])
def test_hpi_plane_and_gather_match_jax(wide):
    """build_hpi_plane and gather_plane on an int32 table and on a wide
    int64 one (ids up to 2^20 - 1) equal JAX's on its uint32 / split
    planes, for a whole table and for a shard-local bucket range."""
    rng = np.random.default_rng(3)
    if wide:
        ht, _streams = _stored_wide(11)
        cfg, cfgj = WCFG, WCFGJ
        tj = jnp.asarray(DTj.split_wide(ht.table))
        ncap = 1 << 20
    else:
        ht = _table(2, n_tracks=9)
        cfg, cfgj = TCFG, DTj.TableConfig(*TCFG)
        tj = jnp.asarray(ht.table)
        ncap = 16
    hpi = rng.integers(1, 5000, ncap).astype(np.int32)
    table, _counts, _cfg = DT.table_to_device(ht, "cpu")
    want = np.asarray(DTj.build_hpi_plane(tj, jnp.asarray(hpi), cfgj))
    plane = DT.build_hpi_plane(table, _t(hpi), cfg)
    assert plane.dtype == torch.int32 and plane.shape == table.shape
    np.testing.assert_array_equal(plane.numpy(), want)
    if wide:
        assert set(hpi[BIG_IDS]) <= set(np.unique(want))
    qh = rng.integers(0, 1 << 20, (3, 40)).astype(np.int32)
    half = cfg.n_buckets // 2
    for lo, sl in ((0, slice(None)), (half, slice(half, None))):
        g = DT.gather_plane(plane[sl], _t(qh), cfg, lo)
        w = DTj.gather_plane(jnp.asarray(want[sl]), jnp.asarray(qh), cfgj, lo)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _six_tracks(seed=10, wide=False):
    if wide:
        return _stored_wide(seed)
    ht = HashTable(hashbits=TCFG.hashbits, depth=TCFG.depth,
                   maxtime=TCFG.maxtime, seed=TCFG.seed)
    rng = np.random.default_rng(seed)
    streams = {}
    for i in range(6):
        p = np.stack([np.sort(rng.integers(0, 1024, 200)),
                      rng.integers(0, 1 << 12, 200)], axis=1)
        ht.store_vectorized(f"t{i}", p)
        streams[i] = p
    return ht, streams


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_matcher_cores_and_plane_match_jax(exact, wide):
    """Matcher rows with force_core hist / sorted and the plane on / off,
    on int32 and wide tables, all equal the JAX Matcher's (sorted and
    hist)."""
    ht, streams = _six_tracks(wide=wide)
    queries = [s[:80] - [int(s[0, 0]), 0] for s in list(streams.values())[:3]]
    kw = dict(search_depth=8, exact_count=exact, find_time_range=True,
              max_returns=2, verbose=0)
    want = Mj.Matcher(**kw).match_hashes_batch(ht, queries)
    if not wide:                 # JAX's hist core has no wide-plane case
        mj = Mj.Matcher(**kw)
        mj.force_core = "hist"
        for a, b in zip(want, mj.match_hashes_batch(ht, queries)):
            np.testing.assert_array_equal(a, b)
    for core in (None, "sorted", "hist"):
        for plane in (None, False, True):
            m = Matcher(device="cpu", **kw)
            m.force_core, m.use_hpi_plane = core, plane
            got = m.match_hashes_batch(ht, queries)
            assert (m._device_state(ht)[6] is not None) == bool(plane)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(b, a, f"{core} {plane}")
            assert len(got[0]) and int(got[0][0][0]) == list(streams)[0]


def test_force_core_and_plane_reach_their_paths(monkeypatch):
    """force_core = "hist" goes through voting.match_core and never the
    sorted core, the default the other way round; use_hpi_plane = True
    hands the vote a per-hit hashesperid payload, auto and False none; the
    fused path steps aside for a pinned hist core; an unknown core raises."""
    ht, streams = _six_tracks()
    q = [streams[2][:60] - [int(streams[2][0, 0]), 0]]
    calls = []
    real_core, real_rle = V.match_core, V._vote_rle

    def core(*a, **kw):
        calls.append("hist")
        return real_core(*a, **kw)

    def rle(key, qt_f, hpi_f, *a, **kw):
        calls.append("sorted+plane" if hpi_f is not None else "sorted")
        return real_rle(key, qt_f, hpi_f, *a, **kw)

    monkeypatch.setattr(V, "match_core", core)
    monkeypatch.setattr(V, "_vote_rle", rle)
    for force, plane, want in ((None, None, ["sorted"]),
                               ("hist", None, ["hist"]),
                               ("sorted", True, ["sorted+plane"]),
                               (None, False, ["sorted"]),
                               ("hist", True, ["hist"])):
        m = Matcher(device="cpu", verbose=0, search_depth=8)
        m.force_core, m.use_hpi_plane = force, plane
        calls.clear()
        rows = m.match_hashes_batch(ht, q)
        assert calls == want and int(rows[0][0][0]) == 2
    m = Matcher(device="cpu", verbose=0)
    m.force_core = "hist"
    assert m.match_samples_fused(Analyzer(device="cpu"), ht,
                                 [np.zeros(22050, np.float32)]) is None
    m.force_core = "topk"
    with pytest.raises(ValueError, match="unknown voting core"):
        m.match_hashes_batch(ht, q)


def test_hist_budget_splits_batches_identically(capsys):
    """A budget below the hist core's per-row envelope splits the batch
    into sub-batches of 1 with the same rows, and says which core."""
    ht, streams = _six_tracks()
    queries = [s[:80] - [int(s[0, 0]), 0] for s in streams.values()]
    whole = Matcher(device="cpu", search_depth=8)
    whole.force_core = "hist"
    split = Matcher(device="cpu", search_depth=8)
    split.force_core = "hist"
    split.mem_budget_bytes = 1
    a = whole.match_hashes_batch(ht, queries)
    b = split.match_hashes_batch(ht, queries)
    assert "using the hist voting core, splitting 6 queries into " \
        "sub-batches of 1" in capsys.readouterr().out
    for i, (ra, rb) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(ra, rb)
        assert int(ra[0][0]) == i
