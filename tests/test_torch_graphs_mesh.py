"""The sharded paths' graph caches on the CPU, through test_torch_graphs'
RecordingGraph stand-in for torch.cuda.CUDAGraph (graphs.captures
patched to True), on a 4-shard logical mesh of the CPU
(sharded.make_mesh(4, ["cpu"])): the Matcher's fused mesh match
(`_mesh_graphs`), its two-stage mesh vote through the RLE hit exchange
(plane on and off) and the histogram core (`_mesh_votes`), the
histogram envelope's fallback to one device (`_votes`), DeviceIngest's
routed ingest, store of host hashes and overflow replay, and
ShardedStore.store_chunk.  The shards' tables and counts are the
graphs' state; the stand-in's recording run puts back every shard
tensor, as a real capture runs nothing, so a key's first call that
stored twice would show here.

Held, array for array, tolerance 0 (integer stages): each replay
against the eager mesh function, against one device and against the
JAX package's sharded function on 4 of its forced host devices
(Sj.make_mesh(4)); the hist replay 20 times under a short thread switch
interval (its shards run on threads that meet at each collective); no
upload from pageable memory and no host array inside a capture; and a
mesh over two devices or two processes captures nothing."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audfprint_tpu.index import device_table as DTj  # noqa: E402
from audfprint_tpu.index.hash_table import HashTable as HTj  # noqa: E402
from audfprint_tpu.match import voting as Vj  # noqa: E402
from audfprint_tpu.models import ingest as INGj  # noqa: E402
from audfprint_tpu.models.analyzer import Analyzer as Aj  # noqa: E402
from audfprint_tpu.parallel import sharded as Sj  # noqa: E402
from audfprint_torch import cli  # noqa: E402
from audfprint_torch import params as P  # noqa: E402
from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.index.hash_table import HashTable  # noqa: E402
from audfprint_torch.match import matcher as M  # noqa: E402
from audfprint_torch.match import voting as V  # noqa: E402
from audfprint_torch.models import ingest as ING  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from audfprint_torch.parallel import mesh as MS  # noqa: E402
from audfprint_torch.parallel import sharded  # noqa: E402
from audfprint_torch.utils import graphs  # noqa: E402
from audfprint_torch.utils.audio import audio_write_wav  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402
from tests.test_torch_graphs import (  # noqa: E402,F401
    SR, _recorded, recorded)

torch.set_num_threads(2)
CPU = torch.device("cpu")
NDEV = 4
QCAP = 512
TABLE = dict(hashbits=13, depth=16, maxtime=4096)
SMALL = dict(hashbits=12, depth=2, maxtime=4096)
WAVS = [f"w{i}.wav" for i in range(4)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_graphs():
    """Every test starts and ends with no graph held on the CPU device."""
    graphs.clear(CPU)
    yield
    graphs.clear(CPU)


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= NDEV
    return Sj.make_mesh(NDEV)


@pytest.fixture(scope="module")
def db():
    """Four 5 s tracks stored by both packages from equal hashes, and three
    3 s queries cut from them (padded to 4 rows on the mesh)."""
    rng = np.random.default_rng(13)
    tracks = [synth_audio(rng, dur_sec=5.0, n_tones=40) for _ in range(4)]
    an, anj = Analyzer(device="cpu"), Aj()
    hashes = an.samples_batch2hashes(tracks)
    ht, htj = HashTable(**TABLE), HTj(**TABLE)
    for i, (h, w) in enumerate(zip(hashes, anj.samples_batch2hashes(tracks))):
        assert np.array_equal(h, w)
        ht.store_vectorized(f"track{i}", h)
        htj.store_vectorized(f"track{i}", w)
    qs = [tracks[i][256 * 20: 256 * 20 + 3 * SR] for i in range(3)]
    qh = an.samples_batch2hashes(qs)
    assert max(len(h) for h in qh) <= QCAP
    return dict(tracks=tracks, hashes=hashes, an=an, anj=anj, ht=ht,
                htj=htj, qs=qs, qh=qh)


def _delta(before: dict) -> dict:
    return {k: graphs.counts[k] - before[k] for k in before}


def _assert_rows(got: list, want: list):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _jax_state(db, jmesh, ncap: int, plane: bool) -> tuple:
    """JAX's sharded (table, counts, hpi[, plane]) of the same database."""
    tj, cj, tcfgj = Sj.upload_sharded(db["htj"], jmesh)
    hpi = np.zeros(ncap, np.int32)
    hpi[: len(db["htj"].hashesperid)] = db["htj"].hashesperid
    hpij = jnp.asarray(hpi)
    extra = (DTj.build_hpi_plane(tj, hpij, tcfgj),) if plane else ()
    return (tj, cj, hpij) + extra, tcfgj


def _padded(hash_lists: list, rows: int) -> tuple:
    """The (rows, Q) query columns and qt_cap Matcher._match_padded makes
    of these hash lists."""
    Q = P.next_pow2(max(len(h) for h in hash_lists), 128)
    maxt = max(int(h[:, 0].max()) + 1 for h in hash_lists)
    tt = np.zeros((rows, Q), np.int32)
    hh = np.zeros((rows, Q), np.int32)
    vv = np.zeros((rows, Q), bool)
    for b, h in enumerate(hash_lists):
        tt[b, : len(h)], hh[b, : len(h)], vv[b, : len(h)] = h[:, 0], \
            h[:, 1], True
    return (tt, hh, vv), P.next_pow2(maxt, M._QT_FLOOR)


def _mesh_matcher(plane=False, core="sorted", **kw):
    m = M.Matcher(ndev=NDEV, device="cpu", **{"verbose": 0, **kw})
    m.use_hpi_plane = True if plane else None
    m.force_core = "hist" if core == "hist" else None
    m.fused_qcap = QCAP
    return m


# ---- the Matcher ------------------------------------------------------------

@pytest.mark.parametrize("plane", [False, True])
def test_mesh_fused_match_replays_three_ways(db, jmesh, recorded,
                                             monkeypatch, plane):
    """The fused mesh match's first call captures its key (rows padded to
    the mesh size, the mesh itself in the key) after the budget rule with
    the mesh's bytes, the second replays; the rows equal Matcher(ndev=1)'s
    and the replayed (B, max_returns + 1, 7) output equals the eager mesh
    function's and JAX's sharded_fused_match_cached's."""
    an, ht, qs = db["an"], db["ht"], db["qs"]
    m = _mesh_matcher(plane)
    rooms = []
    reserve = graphs.GraphCache.reserve
    monkeypatch.setattr(
        graphs.GraphCache, "reserve", lambda self, calls, budget=None: (
            rooms.append(self._need(calls)), reserve(self, calls, budget))[1])
    before = dict(graphs.counts)
    first = m.match_samples_fused(an, ht, qs)
    assert _delta(before) == {"captures": 1, "replays": 0,
                              "budget_clears": 0}
    again = m.match_samples_fused(an, ht, qs)
    assert _delta(before)["replays"] == 1 and not m._graphs.keys()
    one = M.Matcher(ndev=1, device="cpu", verbose=0)
    one.use_hpi_plane, one.fused_qcap = m.use_hpi_plane, QCAP
    want = one.match_samples_fused(an, ht, qs)
    for got in (first, again):
        _assert_rows(got[0], want[0])
        assert got[1] == want[1] == [len(h) for h in db["qh"]]
    assert sum(len(r) > 0 for r in want[0]) == 3

    table, counts, hpi, tcfg, ncap, mesh, pl = m._device_state(ht)
    (key,) = m._mesh_graphs.keys()
    assert key[2][0] is mesh and mesh.size == NDEV and key[0][0][0][0] == 4
    assert (pl is not None) == plane and key[1][3] is (not plane)
    assert rooms[0] == m._sorted_bytes_per_row(tcfg, QCAP, mesh) * 4
    _i, batch, lens = an.stage_groups(qs)[0]
    batch, lens = M._pad_rows((batch, lens), NDEV)
    mcfg = m._mcfg(M._QT_FLOOR, ncap)
    state = (table, counts, hpi, pl)
    static = (mesh, an.config, tcfg, mcfg, QCAP)
    replayed = m._mesh_graphs((batch, lens), state, static).numpy()
    assert _delta(before)["replays"] == 2
    eager = M._mesh_fused_match(torch.from_numpy(batch),
                                torch.from_numpy(lens), *state,
                                *static).numpy()
    jargs, tcfgj = _jax_state(db, jmesh, ncap, plane)
    jout = Sj.sharded_fused_match_cached(
        jmesh, db["anj"].config, tcfgj, Vj.MatchConfig(*mcfg), QCAP, plane)(
        *jargs, jnp.asarray(batch), jnp.asarray(lens))
    np.testing.assert_array_equal(replayed, eager)
    np.testing.assert_array_equal(replayed, np.asarray(jout))


VOTE_CASES = {
    # name: (core, plane, Matcher keywords)
    "rle": ("sorted", False, {}),
    "rle, plane, time range": ("sorted", True, dict(find_time_range=True)),
    "rle, exact": ("sorted", False, dict(exact_count=True)),
    "hist": ("hist", False, {}),
    "hist, exact, time range": ("hist", False, dict(
        exact_count=True, find_time_range=True)),
}


@pytest.mark.parametrize("case", list(VOTE_CASES))
def test_mesh_vote_replays_three_ways(db, jmesh, recorded, case):
    """The two-stage mesh vote (the RLE hit exchange, plane on and off,
    and the histogram core with its partials summed over the shards)
    captures on its first call and replays on the second; the rows equal
    Matcher(ndev=1)'s, and the replayed (B, max_returns, 7) output equals
    the eager mesh function's and JAX's sharded function's."""
    core, plane, kw = VOTE_CASES[case]
    ht, qh = db["ht"], db["qh"]
    m = _mesh_matcher(plane, core, **kw)
    before = dict(graphs.counts)
    first = m.match_hashes_batch(ht, qh)
    again = m.match_hashes_batch(ht, qh)
    assert _delta(before) == {"captures": 1, "replays": 1,
                              "budget_clears": 0}
    want = M.Matcher(ndev=1, device="cpu", verbose=0,
                     **kw).match_hashes_batch(ht, qh)
    _assert_rows(first, want)
    _assert_rows(again, want)
    assert sum(len(r) > 0 for r in want) == 3

    table, counts, hpi, tcfg, ncap, mesh, pl = m._device_state(ht)
    (key,) = m._mesh_votes.keys()
    assert key[2][0] is mesh and key[2][3] == core
    inputs, qt_cap = _padded(qh, 4)
    mcfg = m._mcfg(qt_cap, ncap)
    state = (table, counts, hpi, pl if core == "sorted" else None)
    static = (mesh, tcfg, mcfg, core)
    replayed = m._mesh_votes(inputs, state, static).numpy()
    assert _delta(before)["replays"] == 2
    eager = M._mesh_vote(*map(torch.from_numpy, inputs), *state,
                         *static).numpy()
    jargs, tcfgj = _jax_state(db, jmesh, ncap, plane)
    mcfgj = Vj.MatchConfig(*mcfg)
    q = tuple(map(jnp.asarray, inputs))
    if core == "sorted":
        jout = Sj.sharded_match_rle_packed_cached(jmesh, tcfgj, mcfgj,
                                                  plane)(*jargs, *q)
    else:
        jout = Sj.sharded_match_packed_cached(jmesh, tcfgj, mcfgj)(
            *jargs, *q)
    np.testing.assert_array_equal(replayed, eager)
    np.testing.assert_array_equal(replayed, np.asarray(jout))


def test_mesh_hist_replays_under_thread_switching(db, recorded):
    """The histogram core's shards run on threads that meet at each
    collective; its replay, 20 times with a switch interval of 10 us,
    gives the captured call's rows every time."""
    ht, qh = db["ht"], db["qh"]
    m = _mesh_matcher(core="hist", exact_count=True, find_time_range=True)
    want = m.match_hashes_batch(ht, qh)
    before = dict(graphs.counts)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runs = [m.match_hashes_batch(ht, qh) for _ in range(20)]
    finally:
        sys.setswitchinterval(old)
    assert _delta(before) == {"captures": 0, "replays": 20,
                              "budget_clears": 0}
    for rows in runs:
        _assert_rows(rows, want)


def test_mesh_envelope_fallback_replays(db, recorded, capsys):
    """A query past the mesh hist core's memory envelope drops to one
    device, whose vote replays its captured graph (Matcher._votes) on the
    fallback's cached device state: a budget of 1 byte makes every query
    its own sub-batch of one key, the first captured and the others
    replayed, with Matcher(ndev=1)'s rows."""
    ht, qh = db["ht"], db["qh"]
    m = _mesh_matcher(core="hist", verbose=1)
    m.mem_budget_bytes = 1
    before = dict(graphs.counts)
    got = m.match_hashes_batch(ht, qh)
    assert "single-device" in capsys.readouterr().out
    again = m.match_hashes_batch(ht, qh)
    assert _delta(before)["captures"] == 1
    assert _delta(before)["replays"] == 2 * len(qh) - 1
    assert len(m._votes.keys()) == 1 and not m._mesh_votes.keys()
    want = M.Matcher(ndev=1, device="cpu", verbose=0).match_hashes_batch(
        ht, qh)
    _assert_rows(got, want)
    _assert_rows(again, want)


class _TorchSeen:
    """torch as a module of the mesh paths sees it: every tensor made from
    a host value (torch.tensor, torch.as_tensor of anything but a tensor)
    while `recording` is set is noted in `seen`."""

    def __init__(self, recording: list, seen: list):
        self._recording, self._seen = recording, seen

    def __getattr__(self, name):
        return getattr(torch, name)

    def tensor(self, data, *a, **kw):
        if self._recording:
            self._seen.append(("tensor", data))
        return torch.tensor(data, *a, **kw)

    def as_tensor(self, data, *a, **kw):
        if self._recording and not isinstance(data, torch.Tensor):
            self._seen.append(("as_tensor", type(data).__name__))
        return torch.as_tensor(data, *a, **kw)


def test_captured_mesh_calls_upload_nothing(db, monkeypatch):
    """Inside a capture the mesh paths' own modules make no tensor from a
    host value: no upload from pageable memory (which waits for the
    stream and cannot be captured; the sharded candidate selection's
    sentinel was one) and no host array reaching split_batch or
    Mesh.replicate.  Covered: the fused mesh match, the hist vote, the
    routed ingest, its overflow replay and the store of host hashes."""
    _recorded(monkeypatch)
    recording, seen, selections = [], [], []
    record = graphs._record

    def recording_record(fn, device, pool):
        recording.append(True)
        try:
            return record(fn, device, pool)
        finally:
            recording.pop()

    select = V._select_candidates_hits_sharded

    def counted_select(*a, **kw):
        if recording:
            selections.append(1)
        return select(*a, **kw)

    monkeypatch.setattr(graphs, "_record", recording_record)
    for mod in (V, M, sharded, MS, ING, DT):
        monkeypatch.setattr(mod, "torch", _TorchSeen(recording, seen))
    monkeypatch.setattr(V, "_select_candidates_hits_sharded", counted_select)

    an, ht, tracks = db["an"], db["ht"], db["tracks"]
    before = dict(graphs.counts)
    _mesh_matcher().match_samples_fused(an, ht, db["qs"])
    _mesh_matcher(core="hist").match_hashes_batch(ht, db["qh"])
    ing = ING.DeviceIngest(HashTable(**SMALL), an, NDEV, cap_override=4)
    ing.consume_chunk(ing.dispatch_chunk(
        [("a.wav", "wav", tracks[0]), ("b.pre", "stream",
                                       (db["hashes"][1], 5.0))], print))
    assert ing.replays == 1
    assert len(selections) == NDEV
    # the fused match, the hist vote, the routed ingest, its overflow
    # replay and the store of host hashes
    assert _delta(before)["captures"] == 5
    assert seen == []


# ---- DeviceIngest and ShardedStore ------------------------------------------

def _ingest(mod, an, ht, chunks, **kw):
    """Chunks of (name, kind, payload) through a DeviceIngest of `mod` (the
    port's or JAX's) on 4 shards, then finalize -> (ingest, rows)."""
    ing = mod.DeviceIngest(ht, an, NDEV, **kw)
    rows = [ing.consume_chunk(ing.dispatch_chunk(c, report=print))
            for c in chunks]
    ing.finalize()
    return ing, rows


def _host(db, names: list, kw=SMALL) -> HashTable:
    """The sequential host store of these names ("w2.wav": track 2's
    hashes)."""
    ht = HashTable(**kw)
    for name in names:
        ht.store_vectorized(name, db["hashes"][int(name[1])])
    return ht


def _assert_same(got, want):
    for a in ("table", "counts", "hashesperid"):
        np.testing.assert_array_equal(np.asarray(getattr(got, a)),
                                      np.asarray(getattr(want, a)))
    assert list(got.names)[: len(want.names)] == list(want.names)


def _chunks(db) -> list:
    """Two chunks of two tracks (one key), then one of host hashes."""
    t = db["tracks"]
    return [[("w0.wav", "wav", t[0]), ("w1.wav", "wav", t[1])],
            [("w2.wav", "wav", t[2]), ("w3.wav", "wav", t[3])],
            [("p1.wav", "stream", (db["hashes"][1], 5.0))]]


def test_mesh_routed_ingest_replays_three_ways(db, monkeypatch):
    """The routed fused ingest on 4 shards: the first chunk captures the
    key, the second replays it, the host hashes' store captures its own;
    the table, counts and hashesperid equal the eager mesh ingest's, the
    sequential host store's and JAX's DeviceIngest(ndev=4)'s."""
    an, chunks = db["an"], _chunks(db)
    with monkeypatch.context() as mp:
        mp.setattr(graphs, "captures", lambda device: False)
        eager = HashTable(**SMALL)
        _ingest(ING, an, eager, chunks)
    _recorded(monkeypatch)
    before = dict(graphs.counts)
    ht = HashTable(**SMALL)
    ing, rows = _ingest(ING, an, ht, chunks)
    assert _delta(before) == {"captures": 2, "replays": 1,
                              "budget_clears": 0}
    (key,) = ing._ingest.keys()
    assert key[2][0] is ing.mesh and key[2][-1] is None
    assert len(ing._store.keys()) == 1 and ing.replays == 0
    _assert_same(ht, eager)
    _assert_same(ht, _host(db, WAVS + ["p1.wav"]))
    assert [[n for _, n, _ in r] for r in rows] == [
        [len(db["hashes"][i]) for i in ids] for ids in ((0, 1), (2, 3), (1,))]
    assert int(ht.counts.max()) > ht.depth          # the reservoir ran
    htj = HTj(**SMALL)
    _ingest(INGj, db["anj"], htj, chunks)
    _assert_same(ht, htj)


def test_mesh_first_ingest_call_stores_once(db, recorded):
    """A key's first call warms, captures and returns the warm-up run's
    output: one chunk stored through a fresh mesh ingest, and one
    segment of host hashes, give the host store's table with nothing
    replayed."""
    before = dict(graphs.counts)
    ht = HashTable(**SMALL)
    _ingest(ING, db["an"], ht, [_chunks(db)[0], _chunks(db)[2]])
    assert _delta(before) == {"captures": 2, "replays": 0,
                              "budget_clears": 0}
    _assert_same(ht, _host(db, ["w0.wav", "w1.wav", "p1.wav"]))


def test_mesh_overflow_replay_replays(db, recorded):
    """A routing cap of 4 (DeviceIngest's cap_override, part of the
    ingest's key) overflows every chunk: the masked routed pass and the
    overflow replay (dp fingerprint + replicated store) each capture on
    the first chunk and replay on the second; the table equals the host
    store's."""
    before = dict(graphs.counts)
    ht = HashTable(**SMALL)
    ing, rows = _ingest(ING, db["an"], ht, _chunks(db)[:2], cap_override=4)
    assert ing.replays == 2
    assert _delta(before) == {"captures": 2, "replays": 2,
                              "budget_clears": 0}
    (key,) = ing._ingest.keys()
    assert key[2][-1] == 4 and len(ing._replay.keys()) == 1
    _assert_same(ht, _host(db, WAVS))
    assert [n for r in rows for _, n, _ in r] == [
        len(h) for h in db["hashes"]]


@pytest.mark.parametrize("idbits", [0, 20])
def test_sharded_store_chunk_replays(db, recorded, idbits):
    """ShardedStore.store_chunk on 4 shards: two chunks of one padded
    shape, the first captured and the second replayed, equal the host
    store, for an int32 and a wide table."""
    kw = dict(SMALL, idbits=idbits) if idbits else SMALL
    files = [(f"f{i}", db["hashes"][i]) for i in range(4)]
    before = dict(graphs.counts)
    ht = HashTable(**kw)
    st = sharded.ShardedStore(ht, sharded.make_mesh(NDEV, ["cpu"]))
    st.store_chunk(files[:2])
    st.store_chunk(files[2:])
    st.finalize()
    assert _delta(before) == {"captures": 1, "replays": 1,
                              "budget_clears": 0}
    want = HashTable(**kw)
    for name, h in files:
        want.store_vectorized(name, h)
    _assert_same(ht, want)


# ---- meshes that stay eager -------------------------------------------------

def test_mesh_over_two_devices_captures_nothing(db, recorded, monkeypatch):
    """Shards on two devices ("cpu" and "cpu:0" are two devices to torch):
    their caches do not replay, and the fused and two-stage matches,
    the routed ingest and ShardedStore run eagerly with one device's rows
    and the host store's table, capturing nothing."""
    two = [CPU, torch.device("cpu", 0)]
    monkeypatch.setattr(sharded, "mesh_devices", lambda device: two)
    an, ht = db["an"], db["ht"]
    one = M.Matcher(ndev=1, device="cpu", verbose=0)
    one.fused_qcap = QCAP
    want_fused = one.match_samples_fused(an, ht, db["qs"])
    want = one.match_hashes_batch(ht, db["qh"])
    before = dict(graphs.counts)
    for core in ("sorted", "hist"):
        m = _mesh_matcher(core=core)
        assert m._device_state(ht)[5].devices == two * 2
        _assert_rows(m.match_hashes_batch(ht, db["qh"]), want)
    _assert_rows(_mesh_matcher().match_samples_fused(an, ht, db["qs"])[0],
                 want_fused[0])
    got = HashTable(**SMALL)
    _ingest(ING, an, got, _chunks(db))
    _assert_same(got, _host(db, WAVS + ["p1.wav"]))
    st_ht = HashTable(**SMALL)
    st = sharded.ShardedStore(st_ht, sharded.make_mesh(NDEV, two))
    st.store_chunk([("w0.wav", db["hashes"][0])])
    st.finalize()
    _assert_same(st_ht, _host(db, ["w0.wav"]))
    assert not st._graphs.replays
    assert _delta(before)["captures"] == 0


_TWO_PROCESSES = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from audfprint_torch.index.hash_table import HashTable
from audfprint_torch.match.matcher import Matcher
from audfprint_torch.models.analyzer import Analyzer
from audfprint_torch.models.ingest import DeviceIngest
from audfprint_torch.parallel import multihost, sharded
from audfprint_torch.utils import graphs

pid, port = int(sys.argv[1]), int(sys.argv[2])
multihost.initialize(f"localhost:{port}", 2, pid, backend="gloo",
                     timeout_s=120)
rng = np.random.default_rng(5)
clips = [0.1 * rng.standard_normal(3 * 11025).astype(np.float32)
         for _ in range(2)]
an = Analyzer(device="cpu")
hashes = an.samples_batch2hashes(clips)
ht = HashTable(hashbits=12, depth=8, maxtime=4096)
for i, h in enumerate(hashes):
    ht.store_vectorized(f"c{i}", h)
want = Matcher(ndev=1, device="cpu", verbose=0).match_hashes_batch(ht, hashes)


def refuse(*a, **kw):
    raise AssertionError("a mesh across processes tried to capture")


# every device captures, as on the card: only the mesh gate stands between
# these calls and a capture
graphs.captures = lambda device: True
graphs._warm = graphs._record = refuse
for core in (None, "hist"):
    m = Matcher(ndev=4, device="cpu", verbose=0)
    m.force_core = core
    got = m.match_hashes_batch(ht, hashes)
    assert m._device_state(ht)[5].nproc == 2
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
m = Matcher(ndev=4, device="cpu", verbose=0)
m.fused_qcap = 4096
got = m.match_samples_fused(an, ht, clips)[0]
assert all(np.array_equal(a, b) for a, b in zip(got, want))
ing = DeviceIngest(HashTable(hashbits=12, depth=8, maxtime=4096), an, 4)
ing.consume_chunk(ing.dispatch_chunk(
    [(f"c{i}", "wav", c) for i, c in enumerate(clips)]
    + [("p0", "stream", (hashes[0], 3.0))], print))
st = sharded.ShardedStore(HashTable(hashbits=12, depth=8, maxtime=4096),
                          sharded.make_mesh(4, ["cpu"]))
st.store_chunk([("c0", hashes[0])])
assert not st._graphs.replays
print("CAPTURES", graphs.counts["captures"])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_mesh_over_two_processes_captures_nothing():
    """Two gloo processes x 2 shards, every device capturing as on the
    card (graphs.captures True, a capture refused outright): the two-stage
    and fused matches (one device's rows), the routed ingest and
    ShardedStore run eagerly and capture nothing."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_PROCESSES, str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for i in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        assert "CAPTURES 0" in out, out[-4000:]


# ---- the CLI ----------------------------------------------------------------

def test_cli_ndev_records_the_mesh_graphs(db, tmp_path, monkeypatch):
    """`new --ndev 4` and `match --ndev 4` with the graphs captured: their
    --json-metrics count the mesh keys' captures and replays (chunks and
    queries of one key come in twos: --batchsize 2 and 1), and the lines
    and the database equal a run that captures nothing and --ndev 1."""
    wavs = []
    for i, x in enumerate(db["tracks"]):
        wavs.append(str(tmp_path / f"w{i}.wav"))
        audio_write_wav(wavs[-1], x, SR)
    queries = []
    for i, x in enumerate(db["qs"][:2]):
        queries.append(str(tmp_path / f"q{i}.wav"))
        audio_write_wav(queries[-1], x, SR)
    out = {}
    for mode in ("eager", "graphs", "one"):
        with pytest.MonkeyPatch.context() as mp:
            if mode == "graphs":
                _recorded(mp)
            else:
                mp.setattr(graphs, "captures", lambda device: False)
            nd = ["--ndev", "1" if mode == "one" else str(NDEV)]
            db_path = str(tmp_path / f"{mode}.pklz")
            lines, metrics = [], {}
            for cmd in (["new", "-d", db_path, "--batchsize", "2", *wavs],
                        ["match", "-d", db_path, "--batchsize", "1",
                         *queries]):
                before = dict(graphs.counts)
                mj = str(tmp_path / f"{mode}_{cmd[0]}.json")
                assert cli.main([*cmd, *nd, "-o", mj + ".txt",
                                 "--json-metrics", mj],
                                device="cpu") == 0
                with open(mj) as f:
                    g = json.load(f)["graphs"]
                metrics[cmd[0]] = {k: g[k] - before[k] for k in before}
                with open(mj + ".txt") as f:
                    lines += [ln for ln in f.read().splitlines()
                              if not ln.startswith("Processed ")]
            out[mode] = (HashTable(db_path), lines, metrics)
    (ht, lines, metrics) = out["graphs"]
    for other in ("eager", "one"):
        _assert_same(ht, out[other][0])
        assert lines == [ln.replace(f"{other}.pklz", "graphs.pklz")
                         for ln in out[other][1]]
        assert all(v == 0 for m in out[other][2].values() for v in m.values())
    assert metrics["new"]["captures"] == 1 and metrics["new"]["replays"] == 1
    assert metrics["match"]["captures"] == 1
    assert metrics["match"]["replays"] == 1
    assert sum(ln.startswith("Matched") for ln in lines) == 2
