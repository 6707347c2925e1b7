"""The scans of ops/scan.py (kernel K4, csrc/scan.cu) against the JAX
package on the CPU, bit for bit (integers: tolerance 0).

Each case of chip_smoke.SCAN_CASES, cut to CPU size, goes in each op and
direction (chip_smoke.SCAN_OPS) through the JAX scans the port replaces
(jax.lax.cummax, jax.lax.cummin between flips, jnp.cumsum, and
associative_scan(jnp.maximum) for 1-D rows, all in int64) and through two
counterparts: the port's plain version, which seg_scan runs on a CPU
tensor, and `k4_tile_walk`, a numpy transcription of K4's two launches
with small tiles, which cannot run here.  Then the call sites: with
seg_scan's kernel branch stood in for by the transcription on the CPU,
the vote (sorted approx, exact, time range, plane on and off, hist), the
device store and the routed ingest's send buffers equal the JAX package's
on the same seeded inputs, each vote launches K4 once a site, and a
replayed fused graph adds its recorded K4 launches.  The card holds K4
itself against the plain version (chip_smoke.py, and the `cuda` test
below)."""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from audfprint_tpu.index import device_table as DTj  # noqa: E402
from audfprint_tpu.match import voting as Vj  # noqa: E402
from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.match import voting as V  # noqa: E402
from audfprint_torch.models import ingest as ING  # noqa: E402
from audfprint_torch.ops import _build  # noqa: E402
from audfprint_torch.ops import scan as SC  # noqa: E402
from tests.test_torch_hist import _hpi  # noqa: E402
from tests.test_torch_match import TCFG, _queries, _t, _table  # noqa: E402

torch.set_num_threads(2)

CASES = chip_smoke.SCAN_CASES
IDS = [c[0] for c in CASES]
I64 = np.iinfo(np.int64)
IDENTITY = {"max": I64.min, "min": I64.max, "add": 0}
UFUNC = {"max": np.maximum, "min": np.minimum, "add": np.add}


def _case(name: str) -> np.ndarray:
    """The case's input, cut to CPU size: at most 4 rows (1-D stays 1-D)
    and 2 tiles + 3 elements a row, so every cut row still crosses K4's
    tile border."""
    i = IDS.index(name)
    _name, shape, kind = CASES[i]
    cut = tuple(min(d, 4) for d in shape[:-1]) + (
        min(shape[-1], 2 * chip_smoke.SCAN_TILE + 3),)
    return chip_smoke.scan_input(np.random.default_rng(100 + i), cut, kind)


def _jax_scan(x: np.ndarray, op: str, reverse: bool) -> np.ndarray:
    """The JAX package's own scans, in int64."""
    with jax.enable_x64(True):
        a = jnp.asarray(x)
        if reverse:
            a = jnp.flip(a, -1)
        if op == "max":
            y = jax.lax.cummax(a, axis=a.ndim - 1)
        elif op == "min":
            y = jax.lax.cummin(a, axis=a.ndim - 1)
        else:
            y = jnp.cumsum(a, axis=-1)
        if reverse:
            y = jnp.flip(y, -1)
        return np.asarray(y)


def k4_tile_walk(x: np.ndarray, op: str, reverse: bool = False,
                 tile: int = 8, warps: int = 2, lanes: int = 2,
                 stats: dict | None = None) -> np.ndarray:
    """csrc/scan.cu's algorithm in numpy, step for step, with a tile of
    `tile` elements (8 here, so that every case crosses tile borders; the
    kernel's is chip_smoke.SCAN_TILE with 8 warps of 32 lanes).  The row
    is taken in the scan's order (reversed for a reverse scan) and padded
    with the identity to whole tiles.
      A. a tile's aggregate: the op over its elements (skipped when a row
         is one tile);
      B. per tile, the carry: the op over the row's earlier aggregates;
         each warp owns tile / warps consecutive elements and walks them
         2 * lanes at a time, two a lane: the pair's scan, an inclusive
         shuffle scan of the pair totals over the lanes, the exclusive
         prefix from the lane below, the warp's running total of earlier
         steps; then the warp totals, and each element gets the carry,
         the earlier warps' totals and its own prefix.
    stats, when given, receives the aggregates and the carries."""
    f, ident = UFUNC[op], IDENTITY[op]
    shape = x.shape
    if x.size == 0:
        return np.empty(shape, np.int64)
    H = shape[-1]
    rows = x.reshape(-1, H)
    if reverse:
        rows = rows[:, ::-1]
    span = tile // warps
    steps = span // (2 * lanes)
    assert steps * 2 * lanes * warps == tile
    nt = -(-H // tile)
    pad = np.full((rows.shape[0], nt * tile), ident, np.int64)
    pad[:, :H] = rows
    # (row, tile, warp, step, lane, pair)
    v = pad.reshape(rows.shape[0], nt, warps, steps, lanes, 2)
    with np.errstate(over="ignore"):
        agg = (f.reduce(v.reshape(rows.shape[0], nt, tile), axis=-1)
               if nt > 1 else None)
        carry = np.full((rows.shape[0], nt), ident, np.int64)
        for t in range(1, nt):
            carry[:, t] = f.reduce(agg[:, :t], axis=1)
        a, b = v[..., 0], f(v[..., 0], v[..., 1])
        incl = b.copy()
        o = 1
        while o < lanes:
            incl[..., o:] = f(incl[..., :-o], incl[..., o:])
            o *= 2
        excl = np.concatenate(
            [np.full(incl.shape[:-1] + (1,), ident, np.int64),
             incl[..., :-1]], axis=-1)
        run = np.full(incl.shape[:3], ident, np.int64)
        out = np.empty_like(v)
        for s in range(steps):
            pre = f(run[..., None], excl[:, :, :, s])
            out[:, :, :, s, :, 0] = f(pre, a[:, :, :, s])
            out[:, :, :, s, :, 1] = f(pre, b[:, :, :, s])
            run = f(run, incl[:, :, :, s, -1])
        pre = carry[..., None].repeat(warps, axis=-1)
        for w in range(1, warps):
            pre[..., w] = f(pre[..., w - 1], run[..., w - 1])
        out = f(out, pre[..., None, None, None])
    if stats is not None:
        stats.update(aggregates=agg, carries=carry)
    y = out.reshape(rows.shape[0], nt * tile)[:, :H]
    if reverse:
        y = y[:, ::-1]
    return np.ascontiguousarray(y).reshape(shape)


@pytest.mark.parametrize("name", IDS)
def test_plain_matches_jax(name):
    """seg_scan on a CPU tensor (the plain version) against JAX's scans,
    each op and direction; 1-D rows also against associative_scan
    (jnp.maximum), the device store's and the routed ingest's form."""
    x = _case(name)
    for op, rev in chip_smoke.SCAN_OPS:
        got = SC.seg_scan(torch.from_numpy(x), op, rev)
        assert got.dtype == torch.int64 and tuple(got.shape) == x.shape
        np.testing.assert_array_equal(got.numpy(), _jax_scan(x, op, rev),
                                      err_msg=f"{op} reverse={rev}")
    if x.ndim == 1:
        with jax.enable_x64(True):
            want = np.asarray(jax.lax.associative_scan(jnp.maximum,
                                                       jnp.asarray(x)))
        np.testing.assert_array_equal(SC.cummax(torch.from_numpy(x)).numpy(),
                                      want)


@pytest.mark.parametrize("name", IDS)
def test_tile_walk_matches_plain(name):
    """k4_tile_walk (8-element tiles) against the plain version, each op
    and direction."""
    x = _case(name)
    for op, rev in chip_smoke.SCAN_OPS:
        want = SC.seg_scan_plain(torch.from_numpy(x), op, rev).numpy()
        np.testing.assert_array_equal(k4_tile_walk(x, op, rev), want,
                                      err_msg=f"{op} reverse={rev}")


@pytest.mark.parametrize("tile,warps,lanes", [(8, 1, 2), (16, 2, 2),
                                              (32, 2, 4)])
def test_tile_walk_geometries(tile, warps, lanes):
    """The transcription at other tile geometries (more steps a warp, more
    lanes) on ragged rows, and its aggregates and carries: each carry is
    the op over the row's earlier tiles."""
    rng = np.random.default_rng(tile + warps + lanes)
    x = chip_smoke.scan_input(rng, (3, 5 * tile + 3), "random")
    for op, rev in chip_smoke.SCAN_OPS:
        stats = {}
        got = k4_tile_walk(x, op, rev, tile, warps, lanes, stats)
        want = SC.seg_scan_plain(torch.from_numpy(x), op, rev).numpy()
        np.testing.assert_array_equal(got, want)
        ends = want[:, ::-1] if rev else want     # in the scan's order
        np.testing.assert_array_equal(stats["carries"][:, 1:],
                                      ends[:, tile - 1::tile])
        order = x[:, ::-1] if rev else x
        np.testing.assert_array_equal(
            stats["aggregates"][:, 0],
            SC.seg_scan_plain(torch.from_numpy(
                np.ascontiguousarray(order[:, :tile])), op).numpy()[:, -1])


def test_cpu_tensor_never_builds_the_kernel(monkeypatch):
    """A CPU tensor takes the plain version and never reaches the build."""
    def refuse():
        raise AssertionError("seg_scan built the kernel for a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    before = SC.launches["seg_scan"]
    x = torch.from_numpy(_case("(1, tile+1)"))
    for op, rev in chip_smoke.SCAN_OPS:
        np.testing.assert_array_equal(
            SC.seg_scan(x, op, rev).numpy(),
            SC.seg_scan_plain(x, op, rev).numpy())
    assert SC.cummin(x, reverse=True).shape == x.shape
    assert SC.launches["seg_scan"] == before


def test_other_devices_and_ops_raise():
    x = torch.empty((2, 5), dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        SC.seg_scan(x, "max")
    with pytest.raises(ValueError, match="not one of"):
        SC.seg_scan(torch.zeros((2, 5), dtype=torch.int64), "prod")


def test_signature_and_tile_mirror_the_kernel():
    """_build binds seg_scan with csrc/scan.cu's parameters (a pointer for
    each pointer and the stream, a long long for B and H, an int for op
    and reverse), and the tile of ops/scan.py and chip_smoke is the
    kernel's."""
    with open(f"{_build.CSRC}/scan.cu") as f:
        src = f.read()
    assert "scan.cu" in _build.SOURCES
    params = re.search(r'extern "C" int seg_scan\(([^)]*)\)', src).group(1)
    kinds = [_build._P if "*" in p else
             _build._L if "long long" in p else _build._I
             for p in params.split(",")]
    assert kinds == _build._SIGNATURES["seg_scan"]
    assert len(kinds) == 8
    tile = re.search(r"constexpr int kTile = (\d+);", src).group(1)
    assert int(tile) == SC.TILE == chip_smoke.SCAN_TILE


# ---- the call sites, with the kernel branch stood in for by the walk

def _walk_as_kernel(x, op, reverse=False):
    """What seg_scan's CUDA branch does, on the CPU: the transcription of
    K4, counted as one launch."""
    SC.launches["seg_scan"] += 1
    return torch.from_numpy(k4_tile_walk(x.numpy(), op, reverse))


@pytest.fixture()
def walked(monkeypatch):
    monkeypatch.setattr(SC, "seg_scan_plain", _walk_as_kernel)
    SC.launches["seg_scan"] = 0
    yield
    SC.launches["seg_scan"] = 0


def _sites(mcfg) -> int:
    """K4 launches of one sorted-core vote: the id runs' and the (id, bin)
    runs' starts and ends (4), the run-end and segment-rank sums (2); in
    the approx vote dtmin's copy and the segmented best (2); in the exact
    one the merged weights' sum and, per mode slot, the segmented best
    and the final copy (a second best when time-sorted); and per mode
    slot of the time range, the mode's copy and the aligned sum."""
    Mc = max(1, mcfg.modes_cap) if mcfg.exact_count else 1
    n = 6
    if not mcfg.exact_count:
        n += 2
    else:
        n += 1 + Mc * (3 if mcfg.sort_by_time else 2)
    if mcfg.find_time_range:
        n += 2 * Mc
    return n


@pytest.mark.parametrize("exact_count,find_time_range,sort_by_time", [
    (False, False, False), (False, True, False), (True, False, False),
    (True, True, False), (True, False, True)])
def test_vote_through_the_walk_matches_jax(walked, exact_count,
                                           find_time_range, sort_by_time):
    """match_batch_packed's rows, sorted core with the hpi plane off and
    on and hist core, equal JAX's; one sorted vote launches K4 once a
    site, the hist core twice (its candidates' run starts and ends)."""
    for seed in range(2):
        ht = _table(seed)
        qt, qh, qv = _queries(seed)
        hpi = _hpi(ht)
        mcfg = V.MatchConfig(
            window=2, search_depth=8, max_returns=4, threshcount=1,
            exact_count=exact_count, find_time_range=find_time_range,
            sort_by_time=sort_by_time, qt_cap=256, n_ids_cap=16,
            modes_cap=4)
        want = np.asarray(Vj.match_batch_packed(
            jnp.asarray(ht.table), jnp.asarray(ht.counts), jnp.asarray(hpi),
            jnp.asarray(qt), jnp.asarray(qh), jnp.asarray(qv),
            DTj.TableConfig(*TCFG), Vj.MatchConfig(*mcfg), "sorted"))
        table, counts, _cfg = DT.table_to_device(ht, "cpu")
        args = (table, counts, _t(hpi), _t(qt), _t(qh), _t(qv), TCFG, mcfg)
        plane = DT.build_hpi_plane(table, _t(hpi), TCFG)
        for core, pl, n in (("sorted", None, _sites(mcfg)),
                            ("sorted", plane, _sites(mcfg)),
                            ("hist", None, 2)):
            SC.launches["seg_scan"] = 0
            got = V.match_batch_packed(*args, core, pl).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{core} "
                                          f"plane={pl is not None}")
            assert SC.launches["seg_scan"] == n, (core, mcfg)


def test_store_through_the_walk_matches_jax(walked):
    """DT.store_batch's table and counts equal JAX's, two stores into one
    table with the reservoir engaged; one launch (the run starts) a
    store."""
    cfg = DT.TableConfig(hashbits=14, depth=4, seed=3)
    cfgj = DTj.TableConfig(hashbits=14, depth=4, seed=3)
    rng = np.random.default_rng(14)
    tj, cj = DTj.empty_table(cfgj)
    tab, cnt = DT.empty_table(cfg, "cpu")
    for step in range(2):
        tt = rng.integers(0, cfg.maxtime * 2, (6, 700)).astype(np.int32)
        hh = rng.integers(0, 1 << 9, (6, 700)).astype(np.int32)
        vv = rng.random((6, 700)) < 0.85
        ids = (np.arange(6) + step * 6 + 5).astype(np.int32)
        tj, cj = DTj.store_batch(tj, cj, jnp.asarray(tt), jnp.asarray(hh),
                                 jnp.asarray(vv), jnp.asarray(ids), cfgj)
        SC.launches["seg_scan"] = 0
        DT.store_batch(tab, cnt, torch.from_numpy(tt), torch.from_numpy(hh),
                       torch.from_numpy(vv), torch.from_numpy(ids), cfg)
        assert SC.launches["seg_scan"] == 1
        assert np.array_equal(tab.numpy().view(np.uint32), np.asarray(tj))
        assert np.array_equal(cnt.numpy(), np.asarray(cj))
    assert int(cnt.max()) > 4


def _jax_route(hf, entry, vf, n_local: int, ndev: int, cap: int):
    """The send buffers of audfprint_tpu/models/ingest.py's routed ingest
    (its stable sort by destination, associative_scan(maximum) of the run
    starts, the rank and the dropping scatter), in int64."""
    with jax.enable_x64(True):
        hf, entry, vf = (jnp.asarray(a) for a in (hf, entry, vf))
        n = hf.shape[0]
        dest = jnp.where(vf, hf // n_local, ndev)
        iota = jnp.arange(n)
        ds, hs, es = jax.lax.sort((dest, hf, entry), num_keys=1,
                                  is_stable=True)
        first = jnp.concatenate([jnp.ones((1,), bool), ds[1:] != ds[:-1]])
        run_start = jax.lax.associative_scan(jnp.maximum,
                                             jnp.where(first, iota, 0))
        rank = iota - run_start
        ok = ~jnp.any((ds < ndev) & (rank >= cap))
        wv = (ds < ndev) & (rank < cap)
        slot = jnp.where(wv, ds * cap + rank, ndev * cap)
        bufs = [jnp.zeros((ndev * cap,), a.dtype).at[slot].set(a, mode="drop")
                for a in (hs, es, wv)]
        return [np.asarray(b).reshape(ndev, cap) for b in bufs], bool(ok)


@pytest.mark.parametrize("cap", [64, 8])
def test_route_through_the_walk_matches_jax(walked, cap):
    """The routed ingest's send buffers (_route) and its overflow flag
    equal the JAX package's routing on the same streams; one launch (the
    run starts) a route."""
    rng = np.random.default_rng(cap)
    cfg = DT.TableConfig(hashbits=12, depth=8)
    tt = rng.integers(0, cfg.maxtime * 2, (3, 64)).astype(np.int32)
    hh = rng.integers(0, cfg.n_buckets, (3, 64)).astype(np.int32)
    vv = rng.random((3, 64)) < 0.85
    hf, entry, vf = ING._pack_entries(
        torch.from_numpy(tt), torch.from_numpy(hh), torch.from_numpy(vv),
        torch.from_numpy(np.array([5, 9, 70], np.int32)), cfg)
    ops, ok = ING._route(hf, entry, vf, 1 << 10, 4, cap)
    assert SC.launches["seg_scan"] == 1
    want, ok_j = _jax_route(hf.numpy(), entry.numpy(), vf.numpy(), 1 << 10,
                            4, cap)
    assert bool(ok) == ok_j and ok_j == (cap == 64)
    for g, w in zip(ops, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_replayed_fused_graph_adds_its_k4_launches(walked, monkeypatch):
    """Through test_torch_graphs.py's RecordingGraph: the fused path's
    capture records the vote's K4 launches (one a site), and each replay
    adds exactly those, so every site of the captured vote went through
    seg_scan."""
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match import matcher as M
    from audfprint_torch.models.analyzer import Analyzer
    from tests.conftest import synth_audio
    from tests.test_torch_graphs import _recorded

    _recorded(monkeypatch)
    rng = np.random.default_rng(14)
    tracks = [synth_audio(rng, dur_sec=4.0, n_tones=40) for _ in range(2)]
    an = Analyzer(device="cpu")
    ht = HashTable(hashbits=14, depth=20, maxtime=4096)
    for i, h in enumerate(an.samples_batch2hashes(tracks)):
        ht.store_vectorized(f"t{i}", h)
    m = M.Matcher(device="cpu", verbose=0)
    queries = [t[: 2 * 11025] for t in tracks]
    first = m.match_samples_fused(an, ht, queries)       # capture
    (key,) = m._graphs.keys()
    recorded = m._graphs._entries[key].launches
    n = {k: v for (_i, k), v in recorded.items()}["seg_scan"]
    mcfg = m._mcfg(M._QT_FLOOR, m._device_state(ht)[4])
    assert n == _sites(mcfg)
    SC.launches["seg_scan"] = 0
    again = m.match_samples_fused(an, ht, queries)       # replay
    assert SC.launches["seg_scan"] == n
    assert list(again[1]) == list(first[1])
    assert all(np.array_equal(a, b) for a, b in zip(again[0], first[0]))
    assert all(len(r) and int(r[0][0]) == i for i, r in enumerate(again[0]))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K4 runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", IDS)
def test_k4_matches_plain_on_card(cuda_device, name):
    i = IDS.index(name)
    _name, shape, kind = CASES[i]
    x = torch.from_numpy(chip_smoke.scan_input(
        np.random.default_rng(100 + i), shape, kind)).to(cuda_device)
    for op, rev in chip_smoke.SCAN_OPS:
        got = SC.seg_scan(x, op, rev)
        want = SC.seg_scan_plain(x, op, rev)
        assert got.dtype == want.dtype and torch.equal(got, want)
