"""audfprint_torch/parallel on 8 logical CPU shards against the JAX package
on its 8 host devices and against the single-device paths, all integers
bit for bit (tolerance 0): the cases of tests/test_sharded.py (store,
match in the exact / time-range / sort-by-time grid, the selection stress
at several search depths, the envelope fallback, the RLE exchange and the
Matcher's default) and of tests/test_sharded_merge.py, plus the mesh's
collectives against numpy, a wide table, ShardedStore, make_mesh /
resolve_ndev and a failing shard."""

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audfprint_tpu.index import device_table as DTj  # noqa: E402
from audfprint_tpu.index.hash_table import HashTable  # noqa: E402
from audfprint_tpu.match import matcher as Mj  # noqa: E402
from audfprint_tpu.match import voting as Vj  # noqa: E402
from audfprint_tpu.parallel import sharded as Sj  # noqa: E402
from audfprint_torch import cli  # noqa: E402
from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.match import voting as V  # noqa: E402
from audfprint_torch.match.matcher import Matcher  # noqa: E402
from audfprint_torch.ops import pipeline as pipe  # noqa: E402
from audfprint_torch.ops.config import PipelineConfig  # noqa: E402
from audfprint_torch.parallel import mesh as M  # noqa: E402
from audfprint_torch.parallel import sharded  # noqa: E402
from audfprint_torch.utils.timing import Stages  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)
TCFG = DT.TableConfig(hashbits=12, depth=8, maxtimebits=10, seed=0)
TCFGJ = DTj.TableConfig(*TCFG)
NDEV = 8


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= NDEV
    return Sj.make_mesh(NDEV)


@pytest.fixture(scope="module")
def mesh():
    return sharded.make_mesh(devices=["cpu"] * NDEV)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _streams(rng, B=6, L=300, hash_range=1 << 12, p_valid=0.9):
    t = rng.integers(0, TCFG.maxtime, (B, L)).astype(np.int32)
    h = rng.integers(0, hash_range, (B, L)).astype(np.int32)
    v = rng.random((B, L)) < p_valid
    return t, h, v, np.arange(B, dtype=np.int32)


def _stored(t, h, v, ids):
    """The streams stored on one device: (torch table, counts), and the
    same as JAX arrays."""
    tab, cnt = DT.empty_table(TCFG, "cpu")
    DT.store_batch(tab, cnt, _t(t), _t(h), _t(v), _t(ids), TCFG)
    tj, cj = DTj.store_batch(*DTj.empty_table(TCFGJ), *map(
        jnp.asarray, (t, h, v, ids)), TCFGJ)
    assert np.array_equal(tab.numpy().view(np.uint32), np.asarray(tj))
    return tab, cnt, tj, cj


def _queries(t, h, v, B, n_src, Q=128):
    tq = np.zeros((B, Q), np.int32)
    hq = np.zeros((B, Q), np.int32)
    vq = np.zeros((B, Q), bool)
    for b in range(n_src):
        src = (b + 1) % t.shape[0]
        idx = np.nonzero(v[src])[0][:100]
        tq[b, :len(idx)] = np.maximum(0, t[src, idx] - 50)
        hq[b, :len(idx)] = h[src, idx]
        vq[b, :len(idx)] = True
    return tq, hq, vq


# ---- the collectives -----------------------------------------------------

@pytest.mark.parametrize("split,concat", [(0, 1), (0, 0), (1, 0)])
def test_all_to_all_is_source_major(mesh, split, concat):
    """Tiled all_to_all: shard d receives piece d of every shard's split,
    concatenated in shard order (numpy reference), bool payloads too."""
    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 1000, (16, 24)) for _ in range(NDEV)]
    got = mesh.all_to_all([_t(x) for x in xs], split, concat)
    for d in range(NDEV):
        want = np.concatenate(
            [np.split(x, NDEV, axis=split)[d] for x in xs], axis=concat)
        assert np.array_equal(got[d].numpy(), want)
    bs = [_t(x % 2 == 0) for x in xs]
    gb = mesh.all_to_all(bs, split, concat)
    assert gb[3].dtype == torch.bool
    assert np.array_equal(gb[3].numpy(), got[3].numpy() % 2 == 0)
    with pytest.raises(ValueError, match="does not split over 8 shards"):
        mesh.all_to_all([_t(x[:12]) for x in xs], 0, 1)


def test_all_gather_and_all_reduce(mesh):
    rng = np.random.default_rng(1)
    xs = [rng.integers(-50, 50, (3, 5)).astype(np.int32)
          for _ in range(NDEV)]
    ts = [_t(x) for x in xs]
    for axis in (0, 1):
        got = mesh.all_gather(ts, axis)
        assert len(got) == NDEV
        assert np.array_equal(got[5].numpy(), np.concatenate(xs, axis=axis))
    s = mesh.all_reduce(ts, "sum")
    assert s[0].dtype == torch.int32
    assert np.array_equal(s[7].numpy(), np.sum(xs, axis=0))
    assert np.array_equal(mesh.all_reduce(ts, "min")[2].numpy(),
                          np.min(xs, axis=0))
    with pytest.raises(ValueError, match="unknown reduction"):
        mesh.all_reduce(ts, "max")


def test_spmd_combiners_and_a_failing_shard(mesh):
    """Mesh.spmd runs one body per shard with collectives that meet; a
    shard that raises fails the call instead of leaving the others
    waiting."""
    def body(cx, x):
        total = cx.sum_all(x)
        low = cx.min_all(x)
        return cx.index, int(total), int(low), cx.gather_all(x[None, None])

    xs = [torch.tensor(10 + i) for i in range(NDEV)]
    out = mesh.spmd(body, xs)
    assert [o[0] for o in out] == list(range(NDEV))
    assert {o[1] for o in out} == {sum(range(10, 18))}
    assert {o[2] for o in out} == {10}
    assert out[4][3].tolist() == [list(range(10, 18))]

    def bad(cx, x):
        if cx.index == 5:
            raise RuntimeError("shard 5 failed")
        return cx.sum_all(x)

    with pytest.raises(RuntimeError, match="shard 5 failed"):
        mesh.spmd(bad, xs)


def test_spmd_meetings_under_thread_switching():
    """Many collectives in a row on 16 shards (more threads than cores)
    with a short switch interval: every shard reads every round's own
    result, never a neighbouring round's."""
    import sys

    mesh16 = sharded.make_mesh(16, ["cpu"])
    rounds = 60

    def body(cx, x):
        seen = []
        for r in range(rounds):
            seen.append(int(cx.sum_all(x + r)))
            seen.append(int(cx.min_all(x * (r + 1))))
        return seen

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = mesh16.spmd(body, [torch.tensor(i + 1) for i in range(16)])
    finally:
        sys.setswitchinterval(old)
    want = []
    for r in range(rounds):
        want += [sum(range(1, 17)) + 16 * r, r + 1]
    assert all(o == want for o in out)


def test_make_mesh_and_resolve_ndev():
    """make_mesh keeps the JAX signature: shards go round-robin on the
    devices given, a repeated device is a logical shard; resolve_ndev
    takes an explicit count as it is and counts devices otherwise (1 on
    the CPU)."""
    m = sharded.make_mesh(4, ["cpu"])
    assert (m.size, m.n_local, m.first) == (4, 4, 0)
    assert [str(d) for d in m.devices] == ["cpu"] * 4
    assert sharded.make_mesh(devices=["cpu"] * 3).size == 3
    assert sharded.make_mesh(3, ["cpu", "meta"]).devices == [
        torch.device("cpu"), torch.device("meta"), torch.device("cpu")]
    assert sharded.resolve_ndev(4) == Sj.resolve_ndev(4) == 4
    assert sharded.resolve_ndev(None, "cpu") == 1
    assert sharded.resolve_ndev(0, torch.device("cpu")) == 1
    assert sharded.mesh_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        assert sharded.resolve_ndev(None) == 1
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.make_mesh(2)
    ht = HashTable(hashbits=12, depth=8)
    with pytest.raises(ValueError, match="hashbits=12 table not divisible "
                                         "over 3 devices"):
        sharded.upload_sharded(ht, sharded.make_mesh(3, ["cpu"]))


# ---- store ------------------------------------------------------------------

def test_sharded_store_matches_single_and_jax(mesh, jmesh, rng):
    t, h, v, ids = _streams(rng)
    tab, cnt, _tj, _cj = _stored(t, h, v, ids)
    tabN, cntN = sharded.empty_sharded_table(mesh, TCFG)
    store = sharded.sharded_store_fn(mesh, TCFG)
    store(tabN, cntN, t, h, v, ids)
    jt, jc = Sj.sharded_store_fn(jmesh, TCFGJ)(
        *Sj.empty_sharded_table(jmesh, TCFGJ), *map(jnp.asarray,
                                                    (t, h, v, ids)))
    got = sharded.gather_sharded(mesh, tabN)
    assert np.array_equal(got, tab.numpy())
    assert np.array_equal(got.view(np.uint32), np.asarray(jt))
    assert np.array_equal(sharded.gather_sharded(mesh, cntN), np.asarray(jc))
    assert [x.shape for x in tabN] == [(512, 8)] * NDEV


def test_sharded_store_class_matches_host(mesh, rng):
    """ShardedStore over two chunks of files equals the sequential host
    store, names and hashesperid included; a wide table too."""
    for kw in ({}, {"idbits": 24}):
        want = HashTable(hashbits=12, depth=8, maxtime=1024, **kw)
        ht = HashTable(hashbits=12, depth=8, maxtime=1024, **kw)
        st = sharded.ShardedStore(ht, mesh)
        assert st.table[0].dtype == (torch.int64 if kw else torch.int32)
        files = [(f"f{i}", np.stack([rng.integers(0, 1024, 250),
                                     rng.integers(0, 256, 250)], axis=1))
                 for i in range(5)]
        for name, h in files:
            want.store_vectorized(name, h)
        st.store_chunk(files[:3])
        st.store_chunk(files[3:])
        st.store_chunk([])
        st.finalize()
        assert ht.table.dtype == want.table.dtype
        assert np.array_equal(ht.table, want.table)
        assert np.array_equal(ht.counts, want.counts)
        assert np.array_equal(ht.hashesperid, want.hashesperid)
        assert ht.names == want.names and int(ht.counts.max()) > 8


# ---- match ------------------------------------------------------------------

@pytest.mark.parametrize("exact,timerange,sbt", [
    (False, False, False), (True, True, False), (True, True, True)])
def test_sharded_match_matches_single_and_jax(mesh, jmesh, rng, exact,
                                              timerange, sbt):
    """sharded_match_fn (the hist core, partials summed over 8 shards)
    against JAX's on 8 devices and the port's single-device vote."""
    t, h, v, ids = _streams(rng, B=4, L=400)
    tab, cnt, tj, cj = _stored(t, h, v, ids)
    hpi = np.full(32, 400, np.int32)
    tq, hq, vq = _queries(t, h, v, 3, 3)
    mcfg = V.MatchConfig(search_depth=8, max_returns=3, qt_cap=1024,
                         n_ids_cap=32, exact_count=exact,
                         find_time_range=timerange, sort_by_time=sbt)
    tjN, cjN = Sj.shard_table(jmesh, tj, cj)
    want = Sj.sharded_match_fn(jmesh, TCFGJ, Vj.MatchConfig(*mcfg))(
        tjN, cjN, *map(jnp.asarray, (hpi, tq, hq, vq)))
    tabN, cntN = sharded.shard_table(mesh, tab, cnt)
    got = sharded.sharded_match_fn(mesh, TCFG, mcfg)(tabN, cntN, hpi, tq, hq,
                                                     vq)
    one = V.match_core_sorted(tab, cnt, _t(hpi), _t(tq), _t(hq), _t(vq),
                              TCFG, mcfg)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert np.array_equal(got[k].numpy(), one[k].numpy()), k
    assert int(got["n_results"].sum()) >= 3


def test_sharded_single_device_fast_path(rng):
    """A 1-shard mesh takes the identity combiners (hit-domain selection);
    it equals the plain core and the id-domain selection."""
    t, h, v, ids = _streams(rng, B=4, L=400)
    tab, cnt, _tj, _cj = _stored(t, h, v, ids)
    hpi = np.full(32, 400, np.int32)
    tq, hq, vq = t[:3, :128].copy(), h[:3, :128].copy(), v[:3, :128].copy()
    mcfg = V.MatchConfig(search_depth=8, max_returns=3, qt_cap=1024,
                         n_ids_cap=32, exact_count=True,
                         find_time_range=True)
    mesh1 = sharded.make_mesh(1, ["cpu"])
    seen = {}

    def spy(cx):
        seen.update(sharded._combiners(cx))
        return 0

    mesh1.spmd(lambda cx, _x: spy(cx), [0])
    assert seen["sum_all"] is V._ident and "gather_all" not in seen
    t1, c1 = sharded.shard_table(mesh1, tab, cnt)
    got = sharded.sharded_match_fn(mesh1, TCFG, mcfg)(t1, c1, hpi, tq, hq, vq)
    args = (tab, cnt, _t(hpi), _t(tq), _t(hq), _t(vq), TCFG, mcfg)
    want = V.match_core_sorted(*args)
    ident2 = lambda x: x  # noqa: E731
    want_id = V.match_core(*args, sum_all=ident2, min_all=ident2)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k].numpy()), k
        assert np.array_equal(got[k].numpy(), want_id[k].numpy()), k


def test_dp_fingerprint_sharded(mesh):
    """Each shard fingerprinting its row of the batch gives
    fingerprint_batch's whole result."""
    rng = np.random.default_rng(0)
    cfg = PipelineConfig()
    B, N = 8, 40960
    audio = np.stack([synth_audio(rng, dur_sec=N / 11025.0)[:N]
                      for _ in range(B)])
    lengths = np.full(B, N, np.int32)
    lengths[3] = 30000
    got = sharded.dp_fingerprint_fn(mesh, cfg)(audio, lengths)
    want = pipe.fingerprint_batch(_t(audio), _t(lengths), cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3].min()) > 20
    with pytest.raises(ValueError, match="does not split over 8 shards"):
        sharded.dp_fingerprint_fn(mesh, cfg)(audio[:6], lengths[:6])


def _stress(rng_seed=99):
    rng = np.random.default_rng(rng_seed)
    t, h, v, ids = _streams(rng, B=16, L=200, hash_range=256, p_valid=2.0)
    return t, h, v, ids, np.full(128, 200, np.int32)      # equal hpi: ties


@pytest.mark.parametrize("SD,exact", [(2, False), (8, True), (64, False)])
def test_sharded_selection_stress(mesh, jmesh, SD, exact):
    """Hashes from a tiny range: every bucket holds many ids, weighted
    counts tie heavily (broken id-desc), every id's hits split over the
    shards, SD below and above the number of candidates.  The merged
    per-shard selection equals JAX's and the single-device core."""
    t, h, v, ids, hpi = _stress()
    tab, cnt, tj, cj = _stored(t, h, v, ids)
    tq, hq, vq = t[:4, :64].copy(), h[:4, :64].copy(), np.ones((4, 64), bool)
    mcfg = V.MatchConfig(search_depth=SD, max_returns=min(SD, 4),
                         qt_cap=1024, n_ids_cap=128, exact_count=exact,
                         threshcount=1)
    want = Sj.sharded_match_fn(jmesh, TCFGJ, Vj.MatchConfig(*mcfg))(
        *Sj.shard_table(jmesh, tj, cj), *map(jnp.asarray, (hpi, tq, hq, vq)))
    tabN, cntN = sharded.shard_table(mesh, tab, cnt)
    got = sharded.sharded_match_fn(mesh, TCFG, mcfg)(tabN, cntN, hpi, tq, hq,
                                                     vq)
    one = V.match_core_sorted(tab, cnt, _t(hpi), _t(tq), _t(hq), _t(vq),
                              TCFG, mcfg)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert np.array_equal(got[k].numpy(), one[k].numpy()), k


def _six_tracks(rng):
    ht = HashTable(hashbits=12, depth=8, maxtime=1024)
    streams = []
    for i in range(6):
        p = np.stack([np.sort(rng.integers(0, 1024, 200)),
                      rng.integers(0, 1 << 12, 200)], axis=1)
        ht.store_vectorized(f"t{i}", p)
        streams.append(p)
    return ht, [s[:80] - [int(s[0, 0]), 0] for s in streams[:3]]


def test_sharded_matcher_envelope_fallback(rng, capsys):
    """A query past the memory envelope of the mesh's hist core drops to
    one device with the same rows (the note fires); the fallback's device
    state is cached per table revision."""
    ht, queries = _six_tracks(rng)
    want = Mj.Matcher(ndev=1, verbose=0, search_depth=8).match_hashes_batch(
        ht, queries)
    m8 = Matcher(ndev=NDEV, verbose=1, search_depth=8, device="cpu")
    m8.force_core = "hist"
    m8.mem_budget_bytes = 1
    got = m8.match_hashes_batch(ht, queries)
    assert "single-device" in capsys.readouterr().out
    fb = m8._fallback_dev
    m8.match_hashes_batch(ht, queries)
    assert m8._fallback_dev is fb and m8._device_state(ht)[5].size == NDEV
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exact,timerange,sbt,plane", [
    (False, False, False, False), (False, True, False, True),
    (True, True, False, False), (True, True, True, True)])
def test_sharded_rle_matches_single_and_jax(mesh, jmesh, rng, exact,
                                            timerange, sbt, plane):
    """The RLE exchange (all_to_all of the hits, _vote_rle on batch slices)
    equals JAX's on 8 devices and the single-device packed sorted core,
    with and without the hpi plane; rows 5..7 are empty."""
    t, h, v, ids = _streams(rng, B=6, L=400)
    tab, cnt, tj, cj = _stored(t, h, v, ids)
    hpi = np.full(32, 400, np.int32)
    tq, hq, vq = _queries(t, h, v, 8, 5)
    mcfg = V.MatchConfig(search_depth=8, max_returns=3, qt_cap=1024,
                         n_ids_cap=32, exact_count=exact,
                         find_time_range=timerange, sort_by_time=sbt)
    tjN, cjN = Sj.shard_table(jmesh, tj, cj)
    jargs = (tjN, cjN, jnp.asarray(hpi))
    if plane:
        jargs += (DTj.build_hpi_plane(tjN, jnp.asarray(hpi), TCFGJ),)
    want = np.asarray(Sj.sharded_match_rle_packed_cached(
        jmesh, TCFGJ, Vj.MatchConfig(*mcfg), plane)(
        *jargs, *map(jnp.asarray, (tq, hq, vq))))
    tabN, cntN = sharded.shard_table(mesh, tab, cnt)
    args = (tabN, cntN, hpi)
    if plane:
        args += ([DT.build_hpi_plane(x, _t(hpi), TCFG) for x in tabN],)
    got = sharded.sharded_match_rle_packed_cached(mesh, TCFG, mcfg, plane)(
        *args, tq, hq, vq).numpy()
    one = V.match_batch_packed(tab, cnt, _t(hpi), _t(tq), _t(hq), _t(vq),
                               TCFG, mcfg, "sorted").numpy()
    hist = sharded.sharded_match_packed_cached(mesh, TCFG, mcfg)(
        tabN, cntN, hpi, tq, hq, vq).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, one) and np.array_equal(hist, one)
    assert got[:5, 0, 6].all() and not got[5:, :, 6].any()


def test_sharded_rle_selection_stress(mesh, jmesh):
    """Tiny hash range: heavy cross-shard candidate ties through the RLE
    exchange."""
    t, h, v, ids, hpi = _stress()
    tab, cnt, tj, cj = _stored(t, h, v, ids)
    tq = np.zeros((8, 64), np.int32)
    hq = np.zeros((8, 64), np.int32)
    vq = np.zeros((8, 64), bool)
    tq[:4], hq[:4], vq[:4] = t[:4, :64], h[:4, :64], True
    mcfg = V.MatchConfig(search_depth=64, max_returns=4, qt_cap=1024,
                         n_ids_cap=128, exact_count=True, threshcount=1)
    want = np.asarray(Sj.sharded_match_rle_packed_cached(
        jmesh, TCFGJ, Vj.MatchConfig(*mcfg), False)(
        *Sj.shard_table(jmesh, tj, cj), *map(jnp.asarray,
                                             (hpi, tq, hq, vq))))
    tabN, cntN = sharded.shard_table(mesh, tab, cnt)
    got = sharded.sharded_match_rle_packed_cached(mesh, TCFG, mcfg, False)(
        tabN, cntN, hpi, tq, hq, vq).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("exact", [False, True])
def test_sharded_matcher_rle_default(rng, exact):
    """Matcher(ndev=8) goes through the RLE exchange by default (B = 3
    padded to 8); with the plane too; rows equal the JAX Matcher(ndev=8)'s
    and Matcher(ndev=1)'s."""
    ht, queries = _six_tracks(rng)
    kw = dict(verbose=0, search_depth=8, exact_count=exact,
              find_time_range=True)
    want = Mj.Matcher(ndev=NDEV, **kw).match_hashes_batch(ht, queries)
    one = Matcher(ndev=1, device="cpu", **kw).match_hashes_batch(ht, queries)
    for plane in (None, True):
        m8 = Matcher(ndev=NDEV, device="cpu", **kw)
        m8.use_hpi_plane = plane
        got = m8.match_hashes_batch(ht, queries)
        state = m8._device_state(ht)
        assert state[5].size == NDEV and len(state[0]) == NDEV
        assert (state[6] is not None) == bool(plane)
        for a, b, c in zip(want, got, one):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, b)


def test_matcher_ndev_not_divisible_notes_once(rng, capsys):
    """ndev that does not divide the table: the JAX package's note, once,
    and the single-device rows."""
    ht, queries = _six_tracks(rng)
    m = Matcher(ndev=3, device="cpu", search_depth=8)
    got = m.match_hashes_batch(ht, queries)
    m.match_hashes_batch(ht, queries)
    assert capsys.readouterr().out.count(
        "Note: hashbits=12 table not divisible over 3 devices; matching "
        "single-device") == 1
    assert m._device_state(ht)[5] is None
    for a, b in zip(got, Matcher(device="cpu", search_depth=8, verbose=0)
                    .match_hashes_batch(ht, queries)):
        np.testing.assert_array_equal(a, b)


def test_sharded_wide_table_match(mesh):
    """A wide (int64) table sharded over 8 shards: RLE rows with and
    without the plane equal the single-device rows."""
    from tests.test_torch_wide import _stored_wide

    ht, streams = _stored_wide(5)
    queries = [s[20:90] - [int(s[20, 0]), 0] for s in streams.values()]
    kw = dict(verbose=0, search_depth=8, find_time_range=True, device="cpu")
    want = Matcher(ndev=1, **kw).match_hashes_batch(ht, queries)
    for plane in (None, True):
        m = Matcher(ndev=NDEV, **kw)
        m.use_hpi_plane = plane
        got = m.match_hashes_batch(ht, queries)
        assert m._device_state(ht)[0][0].dtype == torch.int64
        for (i, _s), a, b in zip(streams.items(), want, got):
            np.testing.assert_array_equal(a, b)
            assert int(b[0][0]) == i


# ---- merge ------------------------------------------------------------------

def _ht(rng, names, hash_range=1 << 12, n=200, **kw):
    ht = HashTable(hashbits=TCFG.hashbits, depth=TCFG.depth,
                   maxtime=TCFG.maxtime, **kw)
    for name in names:
        ht.store(name, np.stack([rng.integers(0, TCFG.maxtime, n),
                                 rng.integers(0, hash_range, n)],
                                axis=1).astype(np.int32))
    return ht


@pytest.mark.parametrize("idbits", [0, 24])
def test_sharded_merge_matches_host_and_jax(mesh, jmesh, rng, idbits):
    """sharded_merge_fn replaying entry_streams equals HashTable.merge and
    JAX's sharded merge; entry_streams' int64 words are JAX's uint32
    entries (or its joined lo / hi planes for a wide table)."""
    kw = {"idbits": idbits} if idbits else {}
    ht_a, ht_b = _ht(rng, ["a0", "a1"], **kw), _ht(rng, ["b0", "b1", "b2"],
                                                    **kw)
    want = _ht(rng, [], **kw)
    want.merge(ht_a)
    want.merge(ht_b)
    hs, es, vs = sharded.entry_streams(ht_b, id_offset=len(ht_a.names))
    hj, ej, vj = Sj.entry_streams(ht_b, id_offset=len(ht_a.names))
    assert np.array_equal(hs, hj) and np.array_equal(vs, vj)
    assert es.dtype == np.int64
    assert np.array_equal(es.astype(np.uint64),
                          DTj.join_wide(ej) if idbits else ej)
    table, counts, cfg = sharded.upload_sharded(ht_a, mesh)
    sharded.sharded_merge_fn(mesh, cfg)(table, counts, hs, es, vs)
    t_got = sharded.gather_sharded(mesh, table)
    assert np.array_equal(t_got.view(want.table.dtype), want.table)
    keep = ht_b.counts <= TCFG.depth
    assert np.array_equal(sharded.gather_sharded(mesh, counts)[keep],
                          want.counts[keep])
    if not idbits:
        jt, _jc = Sj.sharded_merge_fn(jmesh, TCFGJ)(
            *Sj.shard_table(jmesh, jnp.asarray(ht_a.table),
                            jnp.asarray(ht_a.counts)),
            jnp.asarray(hj), jnp.asarray(ej), jnp.asarray(vj))
        assert np.array_equal(t_got.view(np.uint32), np.asarray(jt))


def test_cli_device_merge_chain_matches_host(rng, tmp_path):
    """cli.do_merge over 8 shards equals the chained host merge, a source
    whose buckets overflow included: the device counts are synced to the
    true pressure between sources."""
    ht_a = _ht(rng, ["a0", "a1"])
    ht_b = _ht(rng, ["b0", "b1"], hash_range=16, n=400)
    assert (ht_b.counts > TCFG.depth).any()
    paths = []
    for i, src in enumerate((ht_b, _ht(rng, ["c0"]))):
        paths.append(str(tmp_path / f"src{i}.pklz"))
        src.save(paths[-1])

    def start():
        ht = _ht(rng, [])
        ht.table[:] = ht_a.table
        ht.counts[:] = ht_a.counts
        ht.names = list(ht_a.names)
        ht.hashesperid = ht_a.hashesperid.copy()
        return ht

    want = start()
    for p in paths:
        want.merge(HashTable(p))
    got, msgs = start(), []
    stages = Stages()
    cli.do_merge(got, paths, SimpleNamespace(ndev=NDEV), msgs.append, stages,
                 device="cpu")
    assert np.array_equal(got.table, want.table)
    assert np.array_equal(got.counts, want.counts)
    assert got.names == want.names
    assert np.array_equal(got.hashesperid, want.hashesperid)
    assert len(msgs) == 2 and msgs[0].startswith("merged ")
    assert {"upload", "merge", "download"} <= set(stages.totals)
