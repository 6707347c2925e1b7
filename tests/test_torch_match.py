"""audfprint_torch index + vote + matcher against the JAX package and the
numpy oracle on the CPU, at small tables (hashbits=12, depth=8,
maxtimebits=10).  The hit gather and the vote are bit-exact across the
option matrix."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audfprint_tpu import params as P  # noqa: E402
from audfprint_tpu.index import device_table as DTj  # noqa: E402
from audfprint_tpu.index.hash_table import HashTable  # noqa: E402
from audfprint_tpu.match import matcher as Mj  # noqa: E402
from audfprint_tpu.match import voting as Vj  # noqa: E402
from audfprint_tpu.oracle import match as om  # noqa: E402
from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.match import voting as V  # noqa: E402
from audfprint_torch.match.matcher import Matcher  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402

torch.set_num_threads(2)
TCFG = DT.TableConfig(hashbits=12, depth=8, maxtimebits=10, seed=0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _table(seed: int, n_tracks: int = 5) -> HashTable:
    rng = np.random.default_rng(100 + seed)
    ht = HashTable(hashbits=TCFG.hashbits, depth=TCFG.depth,
                   maxtime=TCFG.maxtime, seed=TCFG.seed)
    for i in range(n_tracks):
        pairs = np.stack([rng.integers(0, 200, 80),
                          rng.integers(0, 64, 80)], axis=1)
        ht.store_vectorized(f"t{i}", pairs.astype(np.int64))
    return ht


def _queries(seed: int, Q: int = 128):
    """Two duplicate-heavy query rows (test_multimode's construction)."""
    rng = np.random.default_rng(200 + seed)
    q = np.unique(np.stack([rng.integers(0, 150, 90),
                            rng.integers(0, 64, 90)], axis=1), axis=0)[:Q]
    n1 = min(40, Q)
    qt = np.zeros((2, Q), np.int32)
    qh = np.zeros((2, Q), np.int32)
    qv = np.zeros((2, Q), bool)
    qt[0, :len(q)], qh[0, :len(q)], qv[0, :len(q)] = q[:, 0], q[:, 1], True
    qt[1, :n1], qh[1, :n1], qv[1, :n1] = q[:n1, 0] + 5, q[:n1, 1], True
    return qt, qh, qv


@pytest.mark.parametrize("maxtimebits", [10, 14])
def test_get_hits_local_bit_exact(maxtimebits):
    """Entries with the top bit set (ids >= 2^17 at maxtimebits=14) decode
    as logical shifts, like the JAX uint32 decode."""
    cfg = DT.TableConfig(hashbits=12, depth=8, maxtimebits=maxtimebits)
    rng = np.random.default_rng(maxtimebits)
    table = rng.integers(0, 2**32, (1 << 12, 8), dtype=np.uint64).astype(
        np.uint32)
    table[:64] |= np.uint32(1 << 31)
    counts = rng.integers(0, 12, 1 << 12).astype(np.int32)
    qt = rng.integers(0, 3000, (3, 64)).astype(np.int32)
    qh = rng.integers(0, 1 << 20, (3, 64)).astype(np.int32)
    qh[0, :16] = np.arange(16)              # buckets with top-bit entries
    qv = rng.random((3, 64)) < 0.8
    want = DTj.get_hits_local(jnp.asarray(table), jnp.asarray(counts),
                              jnp.asarray(qt), jnp.asarray(qh),
                              jnp.asarray(qv), DTj.TableConfig(*cfg))
    tab_dev = _t(table.view(np.int32))
    got = DT.get_hits_local(tab_dev, _t(counts), _t(qt), _t(qh), _t(qv), cfg)
    if maxtimebits == 14:
        assert int(np.asarray(want[0]).max()) >= 1 << 17
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _vote_both(ht, qt, qh, qv, mcfg):
    hpi = np.zeros(16, np.int32)
    hpi[: len(ht.hashesperid)] = ht.hashesperid
    want = np.asarray(Vj.match_batch_packed(
        jnp.asarray(ht.table), jnp.asarray(ht.counts), jnp.asarray(hpi),
        jnp.asarray(qt), jnp.asarray(qh), jnp.asarray(qv),
        DTj.TableConfig(*TCFG), Vj.MatchConfig(*mcfg), "sorted"))
    table, counts, _cfg = DT.table_to_device(ht, "cpu")
    got = V.match_batch_packed(table, counts, _t(hpi), _t(qt), _t(qh),
                               _t(qv), TCFG, mcfg).numpy()
    return want, got


@pytest.mark.parametrize("max_returns", [1, 4])
@pytest.mark.parametrize("sort_by_time", [False, True])
@pytest.mark.parametrize("find_time_range", [False, True])
@pytest.mark.parametrize("exact_count", [False, True])
def test_vote_matches_jax(exact_count, find_time_range, sort_by_time,
                          max_returns):
    """match_batch_packed(core="sorted") bit-exact against JAX across
    approx / exact count, time range, sort-by-time and max_returns, on
    random duplicate-heavy tables; the window sweep runs on the plain
    option set."""
    windows = (1, 2, 3) if not (find_time_range or sort_by_time) else (2,)
    for seed in range(2):
        ht = _table(seed)
        qt, qh, qv = _queries(seed)
        for W in windows:
            mcfg = V.MatchConfig(
                window=W, search_depth=8, max_returns=max_returns,
                threshcount=1, exact_count=exact_count,
                find_time_range=find_time_range, sort_by_time=sort_by_time,
                qt_cap=256, n_ids_cap=16, modes_cap=max_returns)
            want, got = _vote_both(ht, qt, qh, qv, mcfg)
            np.testing.assert_array_equal(
                got, want, err_msg=f"seed={seed} W={W}")


def test_vote_search_depth_beyond_hits():
    """search_depth > H = Q*depth: the extra candidate slots are invalid."""
    ht = _table(0, n_tracks=2)
    qt, qh, qv = _queries(0, Q=8)
    mcfg = V.MatchConfig(search_depth=100, max_returns=2, threshcount=1,
                         qt_cap=256, n_ids_cap=16)
    want, got = _vote_both(ht, qt, qh, qv, mcfg)
    np.testing.assert_array_equal(got, want)


def _oracle_case_two_offsets():
    ht = HashTable(hashbits=TCFG.hashbits, depth=TCFG.depth,
                   maxtime=TCFG.maxtime, seed=TCFG.seed)
    rng = np.random.default_rng(5)
    hashes = rng.choice(1 << 12, size=40, replace=False)
    track = np.concatenate([
        np.stack([100 + np.arange(20), hashes[:20]], axis=1),
        np.stack([500 + np.arange(20), hashes[20:]], axis=1)])
    ht.store_vectorized("song.wav", track.astype(np.int64))
    q = np.concatenate([
        np.stack([np.arange(20), hashes[:20]], axis=1),
        np.stack([np.arange(20), hashes[20:]], axis=1)]).astype(np.int32)
    return ht, q


def _oracle_case_tie():
    ht = HashTable(hashbits=TCFG.hashbits, depth=TCFG.depth,
                   maxtime=TCFG.maxtime, seed=TCFG.seed)
    rng = np.random.default_rng(7)
    hs = rng.choice(1 << 12, size=10, replace=False)
    pairs = np.stack([50 + np.arange(10), hs], axis=1).astype(np.int64)
    ht.store_vectorized("low.wav", pairs)
    ht.store_vectorized("high.wav", pairs)
    return ht, np.stack([np.arange(10), hs], axis=1).astype(np.int32)


def _oracle_case_long_query():
    ht = HashTable(hashbits=TCFG.hashbits, depth=TCFG.depth,
                   maxtime=TCFG.maxtime, seed=TCFG.seed)
    rng = np.random.default_rng(9)
    hs = rng.choice(1 << 12, size=60, replace=False)
    ht.store_vectorized("t.wav", np.stack(
        [np.arange(60) % TCFG.maxtime, hs], axis=1).astype(np.int64))
    q = np.stack([12700 + np.arange(60), hs], axis=1)
    early = np.stack([np.arange(50),
                      rng.choice(1 << 12, size=50, replace=False)], axis=1)
    return ht, np.concatenate([early, q]).astype(np.int32)


@pytest.mark.parametrize("case", [_oracle_case_two_offsets, _oracle_case_tie,
                                  _oracle_case_long_query])
@pytest.mark.parametrize("exact", [False, True])
def test_matcher_matches_oracle(case, exact):
    """Matcher.match_hashes equals the numpy oracle: two offsets of one
    track, the tie that breaks to the higher id, a query past the old
    8192-frame cap."""
    ht, q = case()
    mp = P.MatcherParams(max_returns=2, exact_count=exact, threshcount=5,
                         search_depth=8, find_time_range=True)
    want = om.match_hashes(ht, q, mp)
    m = Matcher(window=mp.window, threshcount=mp.threshcount,
                max_returns=mp.max_returns, search_depth=mp.search_depth,
                exact_count=exact, find_time_range=True, device="cpu")
    np.testing.assert_array_equal(m.match_hashes(ht, q), want)


def test_matcher_batch_equals_jax_and_splits_identically(capsys):
    ht = HashTable(hashbits=TCFG.hashbits, depth=TCFG.depth,
                   maxtime=TCFG.maxtime, seed=TCFG.seed)
    rng = np.random.default_rng(10)
    queries = []
    for i in range(6):
        hs = rng.choice(1 << 12, size=20, replace=False)
        ht.store_vectorized(f"t{i}.wav", np.stack(
            [100 * i + np.arange(20), hs], axis=1).astype(np.int64))
        queries.append(np.stack([np.arange(20), hs], axis=1).astype(np.int32))
    want = Mj.Matcher(threshcount=5, search_depth=8).match_hashes_batch(
        ht, queries)
    m = Matcher(threshcount=5, search_depth=8, device="cpu")
    got = m.match_hashes_batch(ht, queries)
    m2 = Matcher(threshcount=5, search_depth=8, device="cpu")
    m2.mem_budget_bytes = 1
    split = m2.match_hashes_batch(ht, queries)
    assert "splitting 6 queries into sub-batches of 1" in capsys.readouterr().out
    for w, g, s in zip(want, got, split):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(s, w)
        assert w.shape[0] == 1


def test_fused_path_equals_two_stage():
    """The fused fingerprint+match path returns the two-stage path's rows,
    including rows re-matched past a low static query cap."""
    from tests.conftest import synth_audio

    rng = np.random.default_rng(11)
    an = Analyzer(device="cpu")
    ht = HashTable(hashbits=14, depth=20, maxtime=4096)
    tracks = [synth_audio(rng, dur_sec=6.0, n_tones=40) for _ in range(3)]
    for i, h in enumerate(an.samples_batch2hashes(tracks)):
        ht.store_vectorized(f"track{i}", h)
    qs = [tracks[i][256 * 30: 256 * 30 + 3 * 11025] for i in range(3)]
    m = Matcher(device="cpu")
    res, nhash = m.match_samples_fused(an, ht, qs)
    base = an.samples_batch2hashes(qs)
    want = m.match_hashes_batch(ht, base)
    assert nhash == [len(h) for h in base]
    for i, (r, w) in enumerate(zip(res, want)):
        np.testing.assert_array_equal(r, w)
        assert r[0, 0] == i
    m.fused_qcap = 8                     # every row re-matches two-stage
    res2, _ = m.match_samples_fused(an, ht, qs)
    for r, w in zip(res2, want):
        np.testing.assert_array_equal(r, w)


def test_wide_table_int64_plane_gather():
    """A wide table (--idbits 24, once refused) uploads as one int64 plane
    whose gather decodes the host's ids and dts."""
    ht = HashTable(hashbits=10, depth=4, maxtime=1024, idbits=24)
    ht.names = [None] * ((1 << 23) + 1)
    ht.hashesperid = np.zeros(len(ht.names), np.int64)
    ht.names[1 << 23] = "big"
    ht._invalidate_index()
    ht.store_vectorized("big", [(700, 5), (20, 9)])
    ht.store_vectorized("small", [(3, 5)])
    table, counts, cfg = DT.table_to_device(ht, "cpu")
    assert cfg.wide and table.dtype == torch.int64
    qt = np.array([[100, 0]], np.int32)
    qh = np.array([[5, 9]], np.int32)
    ids, dts, hv = DT.get_hits_local(table, counts, _t(qt), _t(qh),
                                     _t(np.ones((1, 2), bool)), cfg)
    got = [(int(i), int(t), q) for q in range(2) for i, t, v in
           zip(ids[0, q], dts[0, q], hv[0, q]) if v]
    want = [(int(r[0]), int(r[1]), int(r[2] == 9))
            for r in ht.get_hits(np.stack([qt[0], qh[0]], axis=1))]
    assert got == want == [((1 << 23), 600, 0), ((1 << 23) + 1, -97, 0),
                           ((1 << 23), 20, 1)]
