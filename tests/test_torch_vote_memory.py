"""The voting cores' memory envelopes on the CPU: the peak of live tensor
bytes of match_batch_packed, counted by a dispatch mode, stays within
what Matcher._sorted_bytes_per_row budgets for the sorted core (with the
hpi plane too) and Matcher._voting_bytes_per_row for the histogram core,
for every option set, and splitting a batch by the budget leaves the rows
unchanged."""

import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.index.hash_table import HashTable  # noqa: E402
from audfprint_torch.match import voting as V  # noqa: E402
from audfprint_torch.match.matcher import Matcher  # noqa: E402

torch.set_num_threads(2)


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages that operators return while the mode is on,
    counted when a storage first appears and dropped when the last tensor
    holding it is collected; `peak` is the most live at once."""

    def __init__(self):
        super().__init__()
        self.live = {}                 # storage address -> [bytes, tensors]
        self.cur = self.peak = 0

    def _drop(self, key):
        ent = self.live[key]
        ent[1] -= 1
        if ent[1] == 0:
            del self.live[key]
            self.cur -= ent[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st.data_ptr()
            if key == 0:
                continue
            if key not in self.live:
                self.live[key] = [st.nbytes(), 0]
                self.cur += st.nbytes()
            self.live[key][1] += 1
            weakref.finalize(t, self._drop, key)
        self.peak = max(self.peak, self.cur)
        return out


B, Q, DEPTH = 4, 256, 32
TCFG = DT.TableConfig(hashbits=10, depth=DEPTH, maxtimebits=12, seed=0)
OPTIONS = {
    "approx": {},
    "exact": {"exact_count": True},
    "time-range": {"find_time_range": True},
    "exact+time-range": {"exact_count": True, "find_time_range": True,
                         "max_returns": 4},
    "exact+sort-by-time": {"exact_count": True, "sort_by_time": True,
                           "max_returns": 4},
}


def _inputs(seed: int):
    """A full table (every bucket at depth) and B rows of Q valid hashes,
    so that every row has Q * depth hits."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 200, (1 << TCFG.hashbits, DEPTH))
    ts = rng.integers(0, TCFG.maxtime, (1 << TCFG.hashbits, DEPTH))
    table = torch.from_numpy(((ids << TCFG.maxtimebits) | ts).astype(np.int32))
    counts = torch.full((1 << TCFG.hashbits,), DEPTH + 5, dtype=torch.int32)
    hpi = torch.full((256,), 100, dtype=torch.int32)
    qt = torch.from_numpy(rng.integers(0, 1500, (B, Q)).astype(np.int32))
    qh = torch.from_numpy(rng.integers(0, 1 << 20, (B, Q)).astype(np.int32))
    return table, counts, hpi, qt, qh, torch.ones((B, Q), dtype=torch.bool)


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_sorted_core_peak_within_estimate(opt):
    """Peak live bytes of one vote call <= B rows x _sorted_bytes_per_row."""
    kw = OPTIONS[opt]
    m = Matcher(device="cpu", **kw)
    mcfg = m._mcfg(2048, 256)
    table, counts, hpi, qt, qh, qv = _inputs(3)
    with LiveBytes() as lb:
        V.match_batch_packed(table, counts, hpi, qt, qh, qv, TCFG, mcfg)
    per_row = m._sorted_bytes_per_row(TCFG, Q)
    hit_words = lb.peak / (B * Q * DEPTH * 8)
    assert lb.peak <= B * per_row, (
        f"{opt}: peak {hit_words:.2f} int64 words per hit, budget "
        f"{per_row / (Q * DEPTH * 8):.0f}")
    # the tracker sees the core's arrays: at least the packed hit keys
    assert hit_words >= 2


@pytest.mark.parametrize("opt", list(OPTIONS))
def test_sorted_core_with_plane_peak_within_estimate(opt):
    """The per-hit hashesperid payload of the hpi plane fits the same
    budget."""
    m = Matcher(device="cpu", **OPTIONS[opt])
    table, counts, hpi, qt, qh, qv = _inputs(4)
    plane = DT.build_hpi_plane(table, hpi, TCFG)
    with LiveBytes() as lb:
        V.match_batch_packed(table, counts, hpi, qt, qh, qv, TCFG,
                             m._mcfg(2048, 256), "sorted", plane)
    assert lb.peak <= B * m._sorted_bytes_per_row(TCFG, Q)


@pytest.mark.parametrize("search_depth", [8, 100])
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_hist_core_peak_within_estimate(opt, search_depth):
    """Peak live bytes of one hist-core call <= B rows x
    _voting_bytes_per_row, and not so far below that the estimate counts
    buffers the core does not make: at least 2 of its (SD + 1) x nbins
    int32 buffers at SD = 100."""
    m = Matcher(device="cpu", search_depth=search_depth, **OPTIONS[opt])
    mcfg = m._mcfg(2048, 256)
    table, counts, hpi, qt, qh, qv = _inputs(5)
    with LiveBytes() as lb:
        V.match_batch_packed(table, counts, hpi, qt, qh, qv, TCFG, mcfg,
                             "hist")
    per_row = m._voting_bytes_per_row(TCFG, 2048, Q)
    assert lb.peak <= B * per_row, (
        f"{opt}: peak {lb.peak / B / 2**20:.2f} MiB a row, budget "
        f"{per_row / 2**20:.2f}")
    if search_depth == 100:
        buf = (search_depth + 1) * (TCFG.maxtime + 2048) * 4
        assert 2 * buf * B <= lb.peak
        assert per_row <= 3 * lb.peak / B


def test_envelopes_count_shards_that_share_a_device():
    """On a mesh whose shards share one device the hist envelope is held
    once per shard, and the sorted one gains the exchanged operands."""
    from audfprint_torch.parallel import sharded

    m = Matcher(device="cpu", find_time_range=True)
    mesh = sharded.make_mesh(4, ["cpu"])
    one = m._voting_bytes_per_row(TCFG, 2048, Q)
    assert m._voting_bytes_per_row(TCFG, 2048, Q, mesh) == 4 * one
    unit = Q * DEPTH * 8
    assert (m._sorted_bytes_per_row(TCFG, Q, mesh)
            - m._sorted_bytes_per_row(TCFG, Q)) == 2 * 4 * 2 * unit


def test_live_bytes_tracker_counts_and_frees():
    """The tracker adds an operator's output and drops it when collected."""
    with LiveBytes() as lb:
        a = torch.zeros(1000, dtype=torch.int64)
        b = a + 1
        del a
        c = b.view(10, 100)            # a view: the same storage
        del b
        assert lb.cur == 8000
        del c
    assert lb.peak == 16000 and lb.cur == 0


def _table(seed: int):
    """Eight tracks of 300 (t, hash) pairs in a small table, and the
    pairs."""
    rng = np.random.default_rng(seed)
    ht = HashTable(hashbits=12, depth=16, maxtime=1 << 12)
    tracks = []
    for i in range(8):
        pairs = np.stack([rng.integers(0, 400, 300),
                          rng.integers(0, 1 << 12, 300)], axis=1)
        ht.store_vectorized(f"t{i}", pairs.astype(np.int64))
        tracks.append(pairs)
    return ht, tracks


@pytest.mark.parametrize("opt", ["approx", "exact+time-range"])
def test_rows_equal_split_and_whole(opt, capsys):
    """Rows are the same with the budget forced to sub-batches of 1 and
    with one batch."""
    ht, tracks = _table(7)
    rng = np.random.default_rng(8)
    queries = []
    for i in range(6):             # excerpts of tracks 0..5, shifted in time
        sel = tracks[i][rng.random(300) < 0.4]
        sel = sel[sel[:, 0] >= 30]
        queries.append(np.stack([sel[:, 0] - 30, sel[:, 1]], axis=1))
    whole = Matcher(device="cpu", **OPTIONS[opt])
    split = Matcher(device="cpu", **OPTIONS[opt])
    split.mem_budget_bytes = 1
    a = whole.match_hashes_batch(ht, queries)
    b = split.match_hashes_batch(ht, queries)
    assert "sub-batches of 1" in capsys.readouterr().out
    assert whole.sub_batch(6, DT.config_for(ht), 128) == 8
    assert [int(r[0, 0]) for r in a] == list(range(6))
    for ra, rb in zip(a, b):
        assert np.array_equal(ra, rb)
