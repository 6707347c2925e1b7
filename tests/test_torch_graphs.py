"""The fused path's graph cache (audfprint_torch/utils/graphs.py) on the
CPU, where no CUDA graph can be captured: RecordingGraph stands in for
torch.cuda.CUDAGraph.  Its capture runs the function once, keeps the
output as the static output and puts back every tensor the function was
given (a real capture runs nothing, so a function that writes its state
must leave it as it was); its replay runs the function again on the
static input buffers and writes the static output in place, as a replay
does on the card.  So the cache's own logic runs here: the key, staging
into the static buffers, the clone after each replay, dropping graphs
with the device state, counting a replay's kernel launches, the memory
budget and warmup's captures.  The rows through the cache equal direct
_fused_match_graph calls and the JAX package's match_samples_fused, bit
for bit."""

import os
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audfprint_tpu.index.hash_table import HashTable as HTj  # noqa: E402
from audfprint_tpu.match.matcher import Matcher as Mj  # noqa: E402
from audfprint_tpu.models.analyzer import Analyzer as Aj  # noqa: E402
from audfprint_torch import cli  # noqa: E402
from audfprint_torch.index.hash_table import HashTable  # noqa: E402
from audfprint_torch.match import matcher as M  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from audfprint_torch.ops import cuda_peaks as CP  # noqa: E402
from audfprint_torch.ops import landmarks as L  # noqa: E402
from audfprint_torch.ops import peaks as PK  # noqa: E402
from audfprint_torch.ops import pipeline as pipe  # noqa: E402
from audfprint_torch.ops import spectro as SP  # noqa: E402
from audfprint_torch.parallel import sharded  # noqa: E402
from audfprint_torch.utils.audio import audio_write_wav  # noqa: E402
from audfprint_torch.utils.timing import Stages  # noqa: E402
from audfprint_torch.utils import graphs  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)
SR = 11025


COUNTERS = pipe.launch_counters()


def _outputs(out) -> tuple:
    if out is None:
        return ()
    return out if isinstance(out, tuple) else (out,)


class RecordingGraph:
    """A CPU stand-in for torch.cuda.CUDAGraph (see the module docstring).
    Its recording run leaves every tensor the function was given (fn is a
    functools.partial), a mesh's lists of shard tensors included, as it
    found it.  A replay writes every static output in place (one tensor,
    a tuple of them, or none) and leaves the launch counters as they
    were: a real replay runs no Python, and the cache adds the launches
    recorded at capture."""

    def __init__(self, fn):
        self.fn = fn
        given = [a for arg in getattr(fn, "args", ())
                 for a in (arg if isinstance(arg, (list, tuple)) else (arg,))
                 if isinstance(a, torch.Tensor)]
        saved = [a.clone() for a in given]
        self.out = fn()
        for a, s in zip(given, saved):
            a.copy_(s)
        self.replays = 0

    def replay(self):
        before = [dict(d) for d in COUNTERS]
        for static, new in zip(_outputs(self.out), _outputs(self.fn())):
            static.copy_(new)
        for d, b in zip(COUNTERS, before):
            d.update(b)
        self.replays += 1


# the threads that captured, while they captured
CAPTURING: set = set()


def _record(fn, device, pool):
    CAPTURING.add(threading.current_thread())
    try:
        g = RecordingGraph(fn)
    finally:
        CAPTURING.discard(threading.current_thread())
    return g, g.out, pool if pool is not None else object(), 0


def _recorded(mp) -> None:
    """Make every graph cache capture on the CPU, through RecordingGraph."""
    mp.setattr(graphs, "captures", lambda device: True)
    mp.setattr(graphs, "_warm", lambda fn, device: fn())
    mp.setattr(graphs, "_record", _record)


@pytest.fixture()
def recorded(monkeypatch):
    _recorded(monkeypatch)


def to_pcm(x):
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def db():
    """Three 6 s tracks stored by both packages from equal hashes, and
    3 s queries cut from them."""
    rng = np.random.default_rng(11)
    tracks = [synth_audio(rng, dur_sec=6.0, n_tones=40) for _ in range(3)]
    an, anj = Analyzer(device="cpu"), Aj()
    ht = HashTable(hashbits=14, depth=20, maxtime=4096)
    htj = HTj(hashbits=14, depth=20, maxtime=4096)
    for i, (h, w) in enumerate(zip(an.samples_batch2hashes(tracks),
                                   anj.samples_batch2hashes(tracks))):
        assert np.array_equal(h, w)
        ht.store_vectorized(f"track{i}", h)
        htj.store_vectorized(f"track{i}", w)
    qs = [tracks[i][256 * 30: 256 * 30 + 3 * SR] for i in range(3)]
    return dict(tracks=tracks, an=an, anj=anj, ht=ht, htj=htj, qs=qs)


def _only_key(m) -> tuple:
    keys = m._graphs.keys()
    assert len(keys) == 1, keys
    return keys[0]


# each field of the key, read out of a key
PARTS = {
    "rows": lambda k: k[0][0][0][0],
    "bucket": lambda k: k[0][0][0][1],
    "dtype": lambda k: k[0][0][1],
    "plane": lambda k: k[1],
    "pcfg": lambda k: k[2][0],
    "tcfg": lambda k: k[2][1],
    "mcfg": lambda k: k[2][2],
    "qcap": lambda k: k[2][3],
}


def _variant(field, db):
    """(matcher, analyzer, table, signals) that differ from the baseline
    in `field` of the key alone."""
    m = M.Matcher(device="cpu", verbose=0)
    an, ht, sigs = db["an"], db["ht"], db["qs"][:1]
    if field == "rows":
        sigs = db["qs"][:2]
    elif field == "bucket":
        sigs = [db["tracks"][0][: 7 * SR]]       # 98,304 samples, not 65,536
    elif field == "dtype":
        sigs = [to_pcm(sigs[0])]
    elif field == "plane":
        m.use_hpi_plane = True
    elif field == "pcfg":
        an = Analyzer(device="cpu", maxpairsperpeak=2)
    elif field == "tcfg":
        ht = HashTable(hashbits=14, depth=10, maxtime=4096)
        for i, h in enumerate(db["an"].samples_batch2hashes(db["tracks"])):
            ht.store_vectorized(f"track{i}", h)
    elif field == "mcfg":
        m.threshcount = 3
    elif field == "qcap":
        m.fused_qcap = 512
    return m, an, ht, sigs


@pytest.fixture(scope="module")
def base_key(db):
    with pytest.MonkeyPatch.context() as mp:
        _recorded(mp)
        m, an, ht, sigs = _variant(None, db)
        m.match_samples_fused(an, ht, sigs)
        return _only_key(m)


@pytest.mark.parametrize("field", list(PARTS))
def test_key_fields(field, db, base_key, recorded):
    """Each field of the key alone makes a new key, int16 against float32
    input included; the other fields stay as they were."""
    m, an, ht, sigs = _variant(field, db)
    if field == "bucket":             # a longer bucket would raise qcap too
        m.fused_qcap = PARTS["qcap"](base_key)
    res, _ = m.match_samples_fused(an, ht, sigs)
    key = _only_key(m)
    differ = {f for f, part in PARTS.items() if part(key) != part(base_key)}
    assert differ == {field}
    if field == "dtype":
        assert PARTS["dtype"](key) == "<i2" and PARTS["dtype"](base_key) \
            == "<f4"
    want = m.match_hashes_batch(ht, an.samples_batch2hashes(sigs))
    for r, w in zip(res, want):
        np.testing.assert_array_equal(r, w)


def test_invalidate_and_table_change_drop_graphs(db, recorded):
    """invalidate() drops every graph; a stored track (a new table
    revision, uploaded anew) drops the graphs that read the old tensors,
    and the next call captures against the new table."""
    an, qs = db["an"], db["qs"][:1]
    ht = HashTable(hashbits=14, depth=20, maxtime=4096)
    hashes = an.samples_batch2hashes(db["tracks"])
    for i, h in enumerate(hashes[:2]):
        ht.store_vectorized(f"track{i}", h)
    m = M.Matcher(device="cpu", verbose=0)
    m.match_samples_fused(an, ht, qs)
    old_table = m._device_state(ht)[0]
    assert m._graphs.keys() and m._graphs._state[0] is old_table
    m.invalidate()
    assert m._graphs.keys() == [] and m._graphs._state == ()
    m.match_samples_fused(an, ht, qs)
    assert len(m._graphs.keys()) == 1
    ht.store_vectorized("track2", hashes[2])
    res, _ = m.match_samples_fused(an, ht, db["qs"])
    new_table = m._device_state(ht)[0]
    assert new_table is not old_table
    assert m._graphs._state[0] is new_table
    assert len(m._graphs.keys()) == 1           # the old key is gone
    want = m.match_hashes_batch(ht, an.samples_batch2hashes(db["qs"]))
    for r, w in zip(res, want):
        np.testing.assert_array_equal(r, w)
    assert len(res[2]) and res[2][0][0] == 2    # the new track is found


def test_same_key_groups_queued_before_resolve(db, recorded):
    """Two groups of one key in one call, and two calls of one key queued
    before either resolves, each give their own rows: every replay's
    output is cloned before the next replay writes the static one."""
    an = Analyzer(device="cpu")
    an.max_batch_rows = 1                       # one group per query
    m = M.Matcher(device="cpu", verbose=0)
    qs = db["qs"]
    want = m.match_hashes_batch(db["ht"], an.samples_batch2hashes(qs))
    h1 = m.match_samples_fused_async(an, db["ht"], qs)
    h2 = m.match_samples_fused_async(an, db["ht"], qs[::-1])
    assert len(h1[1]) == 3 and len(m._graphs.keys()) == 1
    r2, _ = m.match_fused_resolve(an, db["ht"], h2)
    r1, _ = m.match_fused_resolve(an, db["ht"], h1)
    assert [int(r[0][0]) for r in r1] == [0, 1, 2]
    for got in (r1, r2[::-1]):
        for r, w in zip(got, want):
            np.testing.assert_array_equal(r, w)


def test_warmup_captures_its_keys(db, recorded, capsys):
    """warmup captures each bucket at sub-batch sizes 1 and --batchsize's
    power of two, for float32 and int16 PCM input, and returns the JAX
    package's count (one fingerprint batch per duration plus two match
    paths per batch size; test_torch_serving holds the CLI line against
    the JAX CLI's)."""
    args = cli.make_parser().parse_intermixed_args(
        ["warmup", "-d", "x.pklz", "--warm-durations", "3", "--batchsize",
         "2"])
    m = M.Matcher(device="cpu", verbose=0)
    n = cli.do_warmup(db["ht"], db["an"], m, args, print)
    assert n == 1 + 2 * 2
    got = {(k[0][0][0][0], k[0][0][0][1], k[0][0][1])
           for k in m._graphs.keys()}
    assert got == {(b, 65536, d) for b in (1, 2) for d in ("<f4", "<i2")}
    assert "warmed 3 s bucket (batch sizes [1, 2])" in capsys.readouterr().out
    # a listen request of that bucket replays a warm graph
    m.match_samples_fused(db["an"], db["ht"], [to_pcm(db["qs"][0])])
    assert len(m._graphs.keys()) == 4


@pytest.mark.parametrize("kw", [
    {}, {"find_time_range": True},
    {"exact_count": True, "sort_by_time": True, "max_returns": 2}],
    ids=["default", "find_time_range", "exact_count+sort_by_time"])
def test_rows_through_cache_equal_direct_and_jax(kw, db, recorded):
    """Float32 and int16 queries through the cache: each replayed output
    equals a direct _fused_match_graph call on the same input, and the
    rows equal the JAX package's match_samples_fused bit for bit."""
    an, ht = db["an"], db["ht"]
    rng = np.random.default_rng(23)
    noisy = [(q + 0.05 * rng.standard_normal(len(q))).astype(np.float32)
             for q in db["qs"]]
    m = M.Matcher(device="cpu", verbose=0, **kw)
    table, counts, hpi, tcfg, ncap, _mesh, plane = m._device_state(ht)
    mcfg = m._mcfg(M._QT_FLOOR, ncap)
    for sigs in (noisy, [to_pcm(q) for q in noisy]):
        h = m.match_samples_fused_async(an, ht, sigs)
        for (_idxs, out), (_i, batch, lens) in zip(h[1],
                                                   an.stage_groups(sigs)):
            qcap = M._next_pow2(
                int(batch.shape[1] / SR * an.density * 1.5) + 64, 128)
            direct = M._fused_match_graph(
                torch.as_tensor(batch), torch.as_tensor(lens), table,
                counts, hpi, plane, an.config, tcfg, mcfg, qcap)
            assert torch.equal(out, direct)
        got, nh = m.match_fused_resolve(an, ht, h)
        want, nhj = Mj(verbose=0, **kw).match_samples_fused(
            db["anj"], db["htj"], sigs)
        assert nh == nhj
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert len(m._graphs.keys()) == 2


def test_replay_counts_its_launches(recorded):
    """A capture's wrapper counts become the graph's own: the warm-up
    launches count, the capture (which launches nothing) does not, and
    every replay adds them once.  The first call returns the warm-up
    run's output: three calls are one warm-up and two replays."""
    def fn(a, n, s, k):
        L.launches["pair_scan"] += 1
        return a.sum(dim=1) * k + s

    cache = graphs.GraphCache(fn, "cpu")
    s = torch.tensor(3.0)
    before = L.launches["pair_scan"]
    outs = [cache((np.full((2, 4), v, np.float32), np.zeros(2, np.int32)),
                  (s,), (2.0,)) for v in (1, 2, 3)]
    assert L.launches["pair_scan"] - before == 1 + 2
    assert [o.tolist() for o in outs] == [[11.0] * 2, [19.0] * 2,
                                          [27.0] * 2]
    assert cache.held_bytes == 2 * 4 * 4 + 2 * 4   # the static inputs
    ((shapes, nones, static),) = cache.keys()
    assert shapes == (((2, 4), "<f4"), ((2,), "<i4"))
    assert nones == (False,) and static == (2.0,)


@pytest.mark.parametrize("place", ["cpu device", "mesh over two devices"])
def test_eager_placement_runs_fn_past_the_budget(monkeypatch, place):
    """A cache whose placement captures nothing, a CPU device or a mesh
    over two devices ("cpu" and "cpu:0", every device capturing as on
    the card), runs fn directly on a call whose nbytes is far past the
    budget beside what the device holds: no capture, no replay, no
    budget clear, and the plain function's rows; the device's inputs
    arrive as tensors there, the mesh's as given."""
    if place == "cpu device":
        where, given = torch.device("cpu"), torch.Tensor
    else:
        monkeypatch.setattr(graphs, "captures", lambda device: True)
        where = sharded.make_mesh(
            4, [torch.device("cpu"), torch.device("cpu", 0)])
        given = np.ndarray

    def refuse(*a, **kw):
        raise AssertionError("a placement that captures nothing captured")

    monkeypatch.setattr(graphs, "_warm", refuse)
    monkeypatch.setattr(graphs, "_record", refuse)
    monkeypatch.setattr(graphs, "budget_bytes", lambda device: 1)
    monkeypatch.setattr(graphs, "held_bytes", lambda device: 1 << 40)
    seen = []

    def fn(t, h, table, k):
        seen.append((type(t), type(h)))
        return torch.as_tensor(t) * k + torch.as_tensor(h) + table

    cache = graphs.GraphCache(fn, where)
    t = np.arange(8, dtype=np.int32).reshape(2, 4)
    h = np.full((2, 4), 5, np.int32)
    table = torch.ones((2, 4), dtype=torch.int32)
    before = dict(graphs.counts)
    out = cache((t, h), (table,), (3,), nbytes=1 << 40)
    assert not cache.replays and cache.keys() == []
    assert graphs.counts == before
    assert seen == [(given, given)]
    assert torch.equal(out, torch.as_tensor(t) * 3 + torch.as_tensor(h) + 1)


def test_cpu_device_captures_nothing(db):
    """A CPU device runs _fused_match_graph directly: nothing captured,
    nothing held."""
    m = M.Matcher(device="cpu", verbose=0)
    res, _ = m.match_samples_fused(db["an"], db["ht"], db["qs"])
    assert m._graphs.keys() == [] and m._graphs.held_bytes == 0
    assert [int(r[0][0]) for r in res] == [0, 1, 2]


def test_failed_capture_raises(db, monkeypatch):
    """A failed capture raises; no entry is kept and nothing runs in its
    place."""
    _recorded(monkeypatch)

    def broken(fn, device, pool):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs, "_record", broken)
    m = M.Matcher(device="cpu", verbose=0)
    with pytest.raises(RuntimeError, match="capture failed"):
        m.match_samples_fused(db["an"], db["ht"], db["qs"])
    assert m._graphs.keys() == []


def test_budget_counts_the_cache(db, recorded, monkeypatch):
    """What the caches on the device hold counts against the fused path's
    budget (GraphCache.admit): a captured key replays with nothing to
    fit; a new key that would not fit beside what they hold clears them
    all (counted) and is captured; keys past the budget on their own
    take the two-stage path (None)."""
    m = M.Matcher(device="cpu", verbose=0)
    an, ht, qs = db["an"], db["ht"], db["qs"]
    m.match_samples_fused(an, ht, qs[:1])
    first = m._graphs.keys()
    m.mem_budget_bytes = 1 << 30
    monkeypatch.setattr(graphs._shared(m.device), "pool_bytes",
                        m.mem_budget_bytes)
    clears = graphs.counts["budget_clears"]
    assert m.match_samples_fused(an, ht, qs[1:2]) is not None
    assert graphs.counts["budget_clears"] == clears
    assert m._graphs.keys() == first
    res, _ = m.match_samples_fused(an, ht, qs[:2])
    assert graphs.counts["budget_clears"] == clears + 1
    assert len(m._graphs.keys()) == 1 and m._graphs.keys() != first
    assert [int(r[0][0]) for r in res] == [0, 1]
    _t, _c, _h, tcfg, _n, _mesh, _p = m._device_state(ht)
    m.mem_budget_bytes = m._sorted_bytes_per_row(tcfg, 128) * 2 - 1
    m.fused_qcap = 128
    assert m.match_samples_fused(an, ht, qs[:2]) is None


def test_gauss_vector_upload_made_once():
    """The prune's bump template is uploaded once per configuration and
    device (an upload per call waits for the stream and cannot be
    captured), with the values the per-call upload had."""
    cfg = Analyzer(device="cpu").config
    g = CP.gauss_vector_on(cfg, torch.device("cpu"))
    assert CP.gauss_vector_on(cfg, torch.device("cpu")) is g
    assert torch.equal(g, torch.as_tensor(PK.gauss_vector(cfg)))


def test_constants_outlive_other_configurations(db, recorded):
    """The constants a graph reads by address (the prune's bump template,
    the analysis window) are kept for the life of the process: after
    nine other configurations the first key's are the same tensors, and
    its graph replays with the same rows and no new capture."""
    an, ht, qs = db["an"], db["ht"], db["qs"][:1]
    dev = torch.device("cpu")
    m = M.Matcher(device="cpu", verbose=0)
    first, _ = m.match_samples_fused(an, ht, qs)
    gvec = CP.gauss_vector_on(an.config, dev)
    win = SP.hann_window(an.config.n_fft, dev)
    others = [n for n in range(1, 11) if n != an.maxpairsperpeak][:9]
    for i, n in enumerate(others):
        cfg = an.config._replace(maxpairsperpeak=n + 10)
        CP.gauss_vector_on(cfg, dev)
        SP.hann_window(an.config.n_fft + 2 * (i + 1), dev)
        m.match_samples_fused(Analyzer(device="cpu", maxpairsperpeak=n),
                              ht, qs)
    assert CP.gauss_vector_on(an.config, dev) is gvec
    assert SP.hann_window(an.config.n_fft, dev) is win
    keys = m._graphs.keys()
    again, _ = m.match_samples_fused(an, ht, qs)
    assert m._graphs.keys() == keys
    for r, w in zip(again, first):
        np.testing.assert_array_equal(r, w)


def test_streamed_file_beside_a_capture(db, recorded, monkeypatch,
                                        tmp_path):
    """`match` of [3 s, 7 s past --stream-above, 3 s] at --batchsize 1:
    while chunk 0's fused call captures, the decode thread reads chunk 1.
    Its streamed route runs on the device, so it runs on the dispatching
    thread and never during a capture; the lines equal a matcher's that
    captures nothing."""
    paths = []
    for name, x in (("q0", db["qs"][0]), ("long", db["tracks"][1][: 7 * SR]),
                    ("q1", db["qs"][2])):
        paths.append(os.path.join(tmp_path, f"{name}.wav"))
        audio_write_wav(paths[-1], x, SR)
    args = cli.make_parser().parse_intermixed_args(
        ["match", "-d", "x.pklz", "--stream-above", "5", "--batchsize", "1",
         *paths])
    an = cli.setup_analyzer(args, "cpu")
    streamed = []
    real = an.wavfiles2hashes_streaming

    def watched(names):
        streamed.append((threading.current_thread(), set(CAPTURING)))
        return real(names)

    monkeypatch.setattr(an, "wavfiles2hashes_streaming", watched)
    m = M.Matcher(device="cpu", verbose=0)
    lines: list = []
    cli.do_match(db["ht"], an, m, paths, args, lines.append, Stages())
    assert streamed == [(threading.current_thread(), set())]
    assert len(m._graphs.keys()) == 1             # q0 captured, q1 replayed
    monkeypatch.setattr(graphs, "captures", lambda device: False)
    want: list = []
    cli.do_match(db["ht"], an, M.Matcher(device="cpu", verbose=0), paths,
                 args, want.append, Stages())
    assert lines == want
    assert lines == [f"{p}\ttrack{i}" for i, p in enumerate(paths)]
