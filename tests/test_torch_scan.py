"""The scans of ops/scan.py (kernel K4, csrc/scan.cu) against the JAX
package on the CPU, bit for bit (integers: tolerance 0).

Each case of chip_smoke.SCAN_CASES, cut to CPU size, goes in each op and
direction (chip_smoke.SCAN_OPS) through the JAX scans the port replaces
(jax.lax.cummax, jax.lax.cummin between flips, jnp.cumsum, and
associative_scan(jnp.maximum) for 1-D rows, all in int64) and through two
counterparts: the port's plain version, which seg_scan runs on a CPU
tensor, and `k4_tile_walk`, a numpy transcription of K4's single pass
with decoupled look-back (small tiles, the tiles arriving in a given
order, each look-back seeing whatever statuses its predecessors have
published by then), which cannot run here.  Then the call sites: with
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
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

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


ORDERS = ("in order", "reversed within windows", "random")
NONE, AGGREGATE, INCLUSIVE = 0, 1, 2     # csrc/scan.cu Status


def arrival(total: int, how: str, window: int, seed: int = 0) -> np.ndarray:
    """Tile ids in the order their blocks publish: as the counter hands
    them out; reversed within runs of 3 look-back windows (a tile then
    publishes before the predecessors it looks back over); or a seeded
    random permutation.  Blocks run concurrently, so any order can
    happen on the card."""
    ids = np.arange(total)
    if how == "in order":
        return ids
    if how == "reversed within windows":
        span = 3 * window
        return np.concatenate([ids[i:i + span][::-1]
                               for i in range(0, total, span)] or [ids])
    return np.random.default_rng(seed).permutation(total)


def _wrap(op: str):
    """The op on Python ints, the add wrapping modulo 2^64."""
    if op == "max":
        return max
    if op == "min":
        return min
    return lambda a, b: (a + b + 2**63) % 2**64 - 2**63


def _look_back(agg: list, op: str, order, window: int,
               stats: dict) -> list:
    """Steps 1 and 3 of the kernel for the tiles of every row: the
    published slots (a status and its value, read together) and the
    look-back, tile by tile in arrival order.
    agg[r][t] is tile t's aggregate in row r; returns the carries (the op
    over the row's earlier tiles).  A tile publishes its aggregate (the
    row's first tile its inclusive prefix; the row's last tile nothing)
    when it arrives, then looks back over windows of `window`
    predecessors, one a lane: a window is ready when no lane nearer than
    its nearest inclusive prefix shows no status; it folds those lanes'
    aggregates and that prefix, or all lanes' aggregates and steps back a
    window.  A window that is not ready waits: the tile retries whenever
    one of its lanes up to the nearest missing status publishes, as the
    kernel's spin would see it.  It then publishes its inclusive prefix."""
    f, ident = _wrap(op), IDENTITY[op]
    rows, nt = len(agg), len(agg[0])
    # a tile's slot: (status, value), overwritten by its second publication
    slot = [[(NONE, None)] * nt for _ in range(rows)]
    pub = {AGGREGATE: [[None] * nt for _ in range(rows)],
           INCLUSIVE: [[None] * nt for _ in range(rows)]}
    carry = [[ident] * nt for _ in range(rows)]
    state, waiters, queue = {}, {}, []

    def publish(r, t, s, v):
        pub[s][r][t] = v
        slot[r][t] = (s, v)
        queue.extend(waiters.pop((r, t), ()))

    def attempt(r, t) -> bool:
        p, excl = state[r, t]
        while True:
            # one load a lane: the slot's status and value together
            lanes = [(p - lane, *(slot[r][p - lane] if p - lane >= 0
                                  else (INCLUSIVE, ident)))
                     for lane in range(window)]
            k = next((ln for ln, (_i, st, _v) in enumerate(lanes)
                      if st == INCLUSIVE), window)
            missing = next((ln for ln, (_i, st, _v) in enumerate(lanes[:k])
                            if st == NONE), None)
            if missing is not None:
                state[r, t] = (p, excl)
                stats["waits"] += 1
                for i, _st, _v in lanes[:missing + 1]:
                    waiters.setdefault((r, i), set()).add((r, t))
                return False
            for i, st, v in lanes[:k + 1]:
                if i >= 0:
                    excl = f(excl, v)
                    stats["folded"][st] += 1
            stats["windows"] += 1
            if k < window:
                carry[r][t] = excl
                if t != nt - 1:
                    publish(r, t, INCLUSIVE, f(excl, agg[r][t]))
                return True
            p -= window

    pending = set()
    for tid in order:
        r, t = divmod(int(tid), nt)
        if nt == 1:
            continue
        if t == 0:
            publish(r, 0, INCLUSIVE, agg[r][0])
        else:
            if t != nt - 1:
                publish(r, t, AGGREGATE, agg[r][t])
            state[r, t] = (t - 1, ident)
            pending.add((r, t))
            queue.append((r, t))
        while queue:
            w = queue.pop()
            if w in pending and attempt(*w):
                pending.discard(w)
    assert not pending, f"look-backs never finished: {sorted(pending)[:4]}"
    stats["published"] = pub
    return carry


def k4_tile_walk(x: np.ndarray, op: str, reverse: bool = False,
                 tile: int = 32, warps: int = 2, lanes: int = 4,
                 window: int = 4, order: str = "in order", seed: int = 0,
                 stats: dict | None = None) -> np.ndarray:
    """csrc/scan.cu's single pass in numpy, step for step, with a tile of
    `tile` elements, `warps` warps of `lanes` lanes and look-back windows
    of `window` tiles (32, 2, 4 and 4 here, so that every case crosses
    many tiles and windows; the kernel's are chip_smoke.SCAN_TILES with 8
    warps of 32 lanes, 4 at the small tile, and windows of 32).  The row
    is taken in the scan's order (reversed for a reverse scan) and padded
    with the identity to whole tiles; tiles are numbered row-major and
    publish in the `arrival` order `order`.
      2. each tile on its own: each warp owns tile / warps consecutive
         elements and walks them 2 * lanes at a time, two a lane: the
         pair's scan, an inclusive shuffle scan of the pair totals over
         the lanes, the exclusive prefix from the lane below, the warp's
         running total of earlier steps; the warp totals give the
         tile's aggregate;
      1, 3. the statuses and the look-back (_look_back) give each tile
         its carry; each element gets the carry, the earlier warps'
         totals and its own prefix.
    stats, when given, receives the aggregates, the carries, the
    published statuses' values and the look-backs' waits, windows and
    lanes folded by status."""
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
        agg = f.reduce(run, axis=-1)
        st = dict(waits=0, windows=0, folded={AGGREGATE: 0, INCLUSIVE: 0})
        carry = np.array(_look_back(
            agg.tolist(), op, arrival(agg.size, order, window, seed),
            window, st), np.int64).reshape(agg.shape)
        pre = np.empty_like(run)
        pre[..., 0] = carry
        for w in range(1, warps):
            pre[..., w] = f(pre[..., w - 1], run[..., w - 1])
        out = f(pre[..., None, None, None], out)
    if stats is not None:
        stats.update(st, aggregates=agg, carries=carry)
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
    """k4_tile_walk (32-element tiles, windows of 4) against the plain
    version and JAX, each op and direction, with the tiles arriving in
    order, reversed within windows and in a seeded random order."""
    x = _case(name)
    for op, rev in chip_smoke.SCAN_OPS:
        want = SC.seg_scan_plain(torch.from_numpy(x), op, rev).numpy()
        np.testing.assert_array_equal(want, _jax_scan(x, op, rev))
        for i, order in enumerate(ORDERS):
            np.testing.assert_array_equal(
                k4_tile_walk(x, op, rev, order=order, seed=IDS.index(name)
                             + i), want,
                err_msg=f"{op} reverse={rev} {order}")


@pytest.mark.parametrize("tile,warps,lanes", [(8, 1, 2), (16, 2, 2),
                                              (32, 2, 4)])
def test_tile_walk_geometries(tile, warps, lanes):
    """The transcription at other tile geometries (more steps a warp, more
    lanes) and look-back windows on ragged rows, and what it publishes:
    each carry and each published inclusive prefix is the op over the
    row's tiles up to there, each published aggregate the op over its
    tile."""
    rng = np.random.default_rng(tile + warps + lanes)
    x = chip_smoke.scan_input(rng, (3, 37 * tile + 3), "random")
    for op, rev in chip_smoke.SCAN_OPS:
        want = SC.seg_scan_plain(torch.from_numpy(x), op, rev).numpy()
        ends = want[:, ::-1] if rev else want     # in the scan's order
        order = x[:, ::-1] if rev else x
        for window in (1, 3, 32):
            for how in ORDERS:
                stats = {}
                got = k4_tile_walk(x, op, rev, tile, warps, lanes, window,
                                   how, window, stats)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{window} {how}")
                np.testing.assert_array_equal(stats["carries"][:, 1:],
                                              ends[:, tile - 1::tile])
                incl = stats["published"][INCLUSIVE]
                aggs = stats["published"][AGGREGATE]
                for r in range(x.shape[0]):
                    for t in range(38 - 1):          # the last publishes none
                        assert incl[r][t] == ends[r, (t + 1) * tile - 1]
                        if t:
                            assert aggs[r][t] == UFUNC[op].reduce(
                                order[r, t * tile:(t + 1) * tile])
                    assert incl[r][37] is None and aggs[r][37] is None


def test_look_back_sees_each_status():
    """In order, each look-back reads one window and finds its
    predecessor's inclusive prefix in lane 0; reversed within windows,
    tiles publish before their predecessors, so look-backs wait, fold
    aggregates and step back over several windows; random orders lie
    between.  Every order gives the same carries."""
    x = chip_smoke.scan_input(np.random.default_rng(3), (2, 32 * 61),
                              "random")
    seen = {}
    for how in ORDERS:
        stats = {}
        k4_tile_walk(x, "add", order=how, seed=5, stats=stats)
        seen[how] = stats
    tiles = 2 * (61 - 1)                   # the tiles that look back
    ordered = seen["in order"]
    assert ordered["waits"] == 0 and ordered["windows"] == tiles
    assert ordered["folded"] == {AGGREGATE: 0, INCLUSIVE: tiles}
    rev = seen["reversed within windows"]
    assert rev["waits"] > 0 and rev["windows"] > tiles
    assert rev["folded"][AGGREGATE] > 0
    assert seen["random"]["waits"] > 0
    for how in ORDERS[1:]:
        np.testing.assert_array_equal(seen[how]["carries"],
                                      ordered["carries"])


def test_tile_walk_at_the_kernels_geometry():
    """The transcription at the kernel's own geometry (the small tile with
    4 warps, the medium and large ones with 8, of 32 lanes, windows of
    32) in a random order, on the one-query vote row at full width (50
    small tiles), the mesh row (100 medium tiles) and rows of 9 large
    tiles, each op and direction."""
    small, medium, large = chip_smoke.SCAN_TILES
    warps = {small: 4, medium: 8, large: 8}
    for shape, tile in (((1, 51200), small), ((1, 204800), medium),
                        ((2, 9 * large + 1), large),
                        ((2, 9 * large + 1), small)):
        x = chip_smoke.scan_input(np.random.default_rng(tile), shape,
                                  "run starts")
        for op, rev in chip_smoke.SCAN_OPS:
            np.testing.assert_array_equal(
                k4_tile_walk(x, op, rev, tile, warps[tile], 32, 32, "random",
                             tile),
                SC.seg_scan_plain(torch.from_numpy(x), op, rev).numpy(),
                err_msg=f"{shape} tile {tile} {op} reverse={rev}")


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(rows=st.integers(0, 4), width=st.integers(0, 90),
       kind=st.sampled_from(["random", "extremes", "negatives", "runs",
                             "run starts"]),
       geometry=st.sampled_from([(8, 2, 2), (16, 2, 4), (16, 1, 2)]),
       window=st.sampled_from([1, 2, 4, 32]),
       order=st.sampled_from(ORDERS), seed=st.integers(0, 2**16),
       one_d=st.booleans())
def test_tile_walk_ragged_shapes(rows, width, kind, geometry, window, order,
                                 seed, one_d):
    """hypothesis: the transcription equals the plain version on ragged
    (rows, width) and 1-D shapes, every kind of input, each op and
    direction, any geometry, window and arrival order."""
    shape = (width,) if one_d else (rows, width)
    if width == 0:
        kind = "random"                   # run kinds start a run at 0
    x = chip_smoke.scan_input(np.random.default_rng(seed), shape, kind)
    tile, warps, lanes = geometry
    for op, rev in chip_smoke.SCAN_OPS:
        np.testing.assert_array_equal(
            k4_tile_walk(x, op, rev, tile, warps, lanes, window, order, seed),
            SC.seg_scan_plain(torch.from_numpy(x), op, rev).numpy())


def test_plan_spreads_serving_rows():
    """ops/scan.plan: the largest tile that gives SPREAD blocks, else the
    small one: the large tile streams the big inputs, the smaller ones
    spread the serving rows (the one-query vote row in 50 blocks, not
    13; the mesh row in 100, not 50), and short calls take the small
    tile; workspace_words is 2 words and a 2-word slot a tile, none for
    one tile a row."""
    small, medium, large = SC.TILES
    assert SC.plan(1, 51200) == small and -(-51200 // small) == 50
    assert SC.plan(1, 204800) == medium and -(-204800 // medium) == 100
    assert SC.plan(4, 51200) == medium
    assert SC.plan(64, 51200) == large
    assert SC.plan(1441, 25600) == large
    assert SC.plan(1, 5894400) == large
    assert SC.plan(1, 1) == small and SC.plan(99, small) == small
    assert SC.plan(SC.SPREAD, 300) == large       # one tile a row
    for _key, shape in chip_smoke.SCAN_TIMED:
        H = shape[-1]
        B = int(np.prod(shape[:-1], dtype=np.int64))
        tile = SC.plan(B, H)
        assert B * -(-H // tile) >= SC.SPREAD or tile == small, shape
    assert SC.workspace_words(3, small, small) == 0
    assert SC.workspace_words(3, small + 1, small) == 2 + 2 * 3 * 2
    assert SC.workspace_words(1, 5894400, large) == 2 + 2 * 1440


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
    each pointer and the stream, a long long for B and H, an int for the
    tile, op and reverse), the tiles of ops/scan.py and chip_smoke are
    the kernel's, and ops/scan.workspace_words is the kernel's layout
    (the counter, an unused word and a 16-byte slot a tile, all zeroed
    by the entry)."""
    with open(f"{_build.CSRC}/scan.cu") as f:
        src = f.read()
    assert "scan.cu" in _build.SOURCES
    params = re.search(r'extern "C" int seg_scan\(([^)]*)\)', src).group(1)
    kinds = [_build._P if "*" in p else
             _build._L if "long long" in p else _build._I
             for p in params.split(",")]
    assert kinds == _build._SIGNATURES["seg_scan"]
    assert len(kinds) == 9 and "int tile" in params
    tiles = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                  for k in ("kTileSmall", "kTileMedium", "kTileLarge"))
    assert tiles == SC.TILES == chip_smoke.SCAN_TILES
    assert chip_smoke.SCAN_TILE == tiles[-1]
    assert re.search(r"constexpr int kThreadsSmall = 128;", src)
    assert re.search(r"constexpr int kThreadsLarge = 256;", src)
    assert re.search(r"constexpr int kWindow = 32;", src)
    # the counter, an unused word, then a 16-byte slot a tile
    assert "slots = chained ? counter + 2 " in src
    assert "slot = slots + 2 * id;" in src
    assert "(size_t)(2 + 2 * total) * sizeof(long long)" in src
    # one kernel a call holds "seg_scan" in a profile
    assert len(re.findall(r"__global__[^(]*\(", src)) == 1
    assert len(re.findall(r"<<<", src)) == 1


# ---- the call sites, with the kernel branch stood in for by the walk

def _walk_as_kernel(x, op, reverse=False):
    """What seg_scan's CUDA branch does, on the CPU: the transcription of
    K4 (tiles arriving in a random order seeded by the call's count),
    counted as one launch."""
    SC.launches["seg_scan"] += 1
    return torch.from_numpy(k4_tile_walk(x.numpy(), op, reverse,
                                         order="random",
                                         seed=SC.launches["seg_scan"]))


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
        want = SC.seg_scan_plain(x, op, rev)
        for tile in (None,) + SC.TILES:
            got = SC.seg_scan(x, op, rev, tile=tile)
            assert got.dtype == want.dtype and torch.equal(got, want), tile
