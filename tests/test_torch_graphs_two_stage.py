"""The two-stage path's graph caches on the CPU: the Matcher's vote
(Matcher._votes, a GraphCache of matcher._two_stage_vote, the JAX
package's jitted match_batch_packed) and the Analyzer's fingerprint
(Analyzer._graphs, a GraphCache of pipeline.fingerprint_batch_compact_k),
through test_torch_graphs' RecordingGraph stand-in for
torch.cuda.CUDAGraph.  Held here: each key field of both caches, dropping
the vote's graphs with the table, rows through the caches against direct
calls and the JAX package (batch, windowed, sweep; sorted and hist core,
hpi plane on and off), both outputs of the fingerprint cloned after each
replay, the budget rule shared by every cache on a device, warmup's
keys, a fresh `match --listen` replaying on its first request, and the
captures made on the dispatching thread only."""

import io
import json
import os
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audfprint_tpu.match.matcher import Matcher as Mj  # noqa: E402
from audfprint_torch import cli  # noqa: E402
from audfprint_torch.index.hash_table import HashTable  # noqa: E402
from audfprint_torch.match import matcher as M  # noqa: E402
from audfprint_torch.match import voting  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from audfprint_torch.ops import pipeline as pipe  # noqa: E402
from audfprint_torch.utils import graphs  # noqa: E402
from audfprint_torch.utils.audio import audio_write_wav  # noqa: E402
from audfprint_torch.utils.timing import Stages  # noqa: E402
from tests.test_torch_graphs import (  # noqa: E402,F401
    CAPTURING, SR, _recorded, db, recorded, to_pcm)

CPU = torch.device("cpu")


def _only(cache) -> tuple:
    keys = cache.keys()
    assert len(keys) == 1, keys
    return keys[0]


def _qhashes(db, n=1):
    return db["an"].samples_batch2hashes(db["qs"][:n])


# each field of a vote key: ((tt, hh, vv) shapes and dtypes), which state
# entries are None, (tcfg, mcfg, core); qt_cap rides in mcfg
VOTE_PARTS = {
    "rows": lambda k: k[0][0][0][0],
    "Q": lambda k: k[0][0][0][1],
    "qt_cap": lambda k: k[2][1].qt_cap,
    "tcfg": lambda k: k[2][0],
    "mcfg": lambda k: k[2][1]._replace(qt_cap=0),
    "core": lambda k: k[2][2],
    "plane": lambda k: k[1][3],
}


def _vote_variant(field, db):
    """(matcher, table, hash lists) that differ from the baseline in
    `field` of the vote key alone."""
    m = M.Matcher(device="cpu", verbose=0)
    ht = db["ht"]
    q = _qhashes(db, 2)
    hl = q[:1]
    if field == "rows":
        hl = q
    elif field == "Q":
        # the same frames under other hashes, past 128 rows
        h = q[0]
        hl = [np.concatenate([h ^ np.array([0, j << 16], np.int32)
                              for j in range(128 // len(h) + 1)])]
    elif field == "qt_cap":
        hl = [q[0] + np.array([2048, 0], np.int32)]
    elif field == "tcfg":
        ht = HashTable(hashbits=14, depth=10, maxtime=4096)
        for i, h in enumerate(db["an"].samples_batch2hashes(db["tracks"])):
            ht.store_vectorized(f"track{i}", h)
    elif field == "mcfg":
        m.threshcount = 3
    elif field == "core":
        m.force_core = "hist"
    elif field == "plane":
        m.use_hpi_plane = True
    return m, ht, hl


@pytest.fixture(scope="module")
def vote_base(db):
    with pytest.MonkeyPatch.context() as mp:
        _recorded(mp)
        m, ht, hl = _vote_variant(None, db)
        m.match_hashes_batch(ht, hl)
        return _only(m._votes)


@pytest.mark.parametrize("field", list(VOTE_PARTS))
def test_vote_key_fields(field, db, vote_base, recorded):
    """Each field of the vote's key alone makes a new key; the rows equal
    the eager vote's (a matcher on a device that captures nothing)."""
    m, ht, hl = _vote_variant(field, db)
    got = m.match_hashes_batch(ht, hl)
    key = _only(m._votes)
    differ = {f for f, part in VOTE_PARTS.items()
              if part(key) != part(vote_base)}
    assert differ == {field}
    assert m._graphs.keys() == []            # the fused cache is untouched
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "captures", lambda device: False)
        eager = M.Matcher(device="cpu", verbose=0)
        for attr in ("threshcount", "force_core", "use_hpi_plane"):
            setattr(eager, attr, getattr(m, attr))
        want = eager.match_hashes_batch(ht, hl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


FP_PARTS = {
    "rows": lambda k: k[0][0][0][0],
    "bucket": lambda k: k[0][0][0][1],
    "dtype": lambda k: k[0][0][1],
    "cfg": lambda k: k[2][0],
    "k": lambda k: k[2][1],
}


@pytest.mark.parametrize("field", list(FP_PARTS))
def test_fingerprint_key_fields(field, db, recorded, monkeypatch):
    """Each field of the fingerprint's key alone makes a new key, and the
    replayed outputs equal a direct fingerprint_batch_compact_k call on
    the same batch."""
    def run(an, sigs):
        an.samples_batch2hashes(sigs)
        return _only(an._graphs)

    base = run(Analyzer(device="cpu"), db["qs"][:1])
    an, sigs = Analyzer(device="cpu"), db["qs"][:1]
    if field == "rows":
        sigs = db["qs"][:2]
    elif field == "bucket":
        sigs = [db["tracks"][0]]                  # 66,150 samples
        # a longer bucket would raise k too
        monkeypatch.setattr(an, "_hash_cap_estimate",
                            lambda d: FP_PARTS["k"](base))
    elif field == "dtype":
        sigs = [to_pcm(sigs[0])]
    elif field == "cfg":
        an = Analyzer(device="cpu", maxpairsperpeak=2)
    elif field == "k":
        monkeypatch.setattr(an, "_hash_cap_estimate", lambda d: 64)
    handle = an.fingerprint_async(sigs)
    key = _only(an._graphs)
    differ = {f for f, part in FP_PARTS.items() if part(key) != part(base)}
    assert differ == {field}
    (_idxs, (buf, th)), = handle[1]
    (_i, batch, lens), = an.stage_groups(sigs)
    wbuf, wth = pipe.fingerprint_batch_compact_k(
        torch.as_tensor(batch), torch.as_tensor(lens), an.config,
        key[2][1])
    assert torch.equal(buf, wbuf) and torch.equal(th, wth)


def test_invalidate_and_table_change_drop_vote_graphs(db, recorded):
    """invalidate() drops the vote's graphs with the fused ones; a stored
    track (a new table revision, uploaded anew) drops the graphs that
    read the old tensors, and the next call captures against the new
    table.  The Analyzer's graphs read no table and stay."""
    an = db["an"]
    hashes = an.samples_batch2hashes(db["tracks"])
    ht = HashTable(hashbits=14, depth=20, maxtime=4096)
    for i, h in enumerate(hashes[:2]):
        ht.store_vectorized(f"track{i}", h)
    q = _qhashes(db, 3)
    m = M.Matcher(device="cpu", verbose=0)
    m.match_hashes_batch(ht, q)
    old_table = m._device_state(ht)[0]
    assert m._votes.keys() and m._votes._state[0] is old_table
    fp_keys = an._graphs.keys()
    m.invalidate()
    assert m._votes.keys() == [] and m._votes._state == ()
    m.match_hashes_batch(ht, q)
    assert len(m._votes.keys()) == 1
    ht.store_vectorized("track2", hashes[2])
    got = m.match_hashes_batch(ht, q)
    new_table = m._device_state(ht)[0]
    assert new_table is not old_table and m._votes._state[0] is new_table
    assert len(m._votes.keys()) == 1
    assert an._graphs.keys() == fp_keys
    assert [int(r[0][0]) for r in got] == [0, 1, 2]


class _Shared:
    """The port's analyzer for the JAX matcher too, so both match the
    same variant hashes (the port's come through its graph cache, held
    against the eager function in test_fingerprint_key_fields)."""

    def __init__(self, an):
        self.an = an

    def samples_batch2hashes(self, sigs):
        return self.an.samples_batch2hashes(sigs)


@pytest.mark.parametrize("plane", [False, True], ids=["plane-off",
                                                      "plane-on"])
@pytest.mark.parametrize("core", ["sorted", "hist"])
def test_rows_through_caches_equal_direct_and_jax(core, plane, db,
                                                  recorded):
    """The two-stage path through both caches: each replayed vote output
    equals a direct match_batch_packed call on the same padded inputs,
    and the rows of match_hashes_batch, match_hashes_windowed and
    match_samples_sweep equal the JAX package's bit for bit."""
    an, ht, htj = db["an"], db["ht"], db["htj"]
    rng = np.random.default_rng(29)
    noisy = [(q + 0.05 * rng.standard_normal(len(q))).astype(np.float32)
             for q in db["qs"]]
    kw = {"force_core": core if core == "hist" else None,
          "use_hpi_plane": plane}

    def pair(**extra):
        m, mj = M.Matcher(device="cpu", verbose=0), Mj(verbose=0)
        for k, v in {**kw, **extra}.items():
            setattr(m, k, v)
            setattr(mj, k, v)
        return m, mj

    m, mj = pair()
    hl = an.samples_batch2hashes(noisy + [to_pcm(q) for q in db["qs"]])
    got, want = m.match_hashes_batch(ht, hl), mj.match_hashes_batch(htj, hl)
    assert len(m._votes.keys()) == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the replayed output against a direct call on the same inputs
    table, counts, hpi, tcfg, ncap, _mesh, hp = m._device_state(ht)
    B, Q = 8, 128
    tt, hh = np.zeros((B, Q), np.int32), np.zeros((B, Q), np.int32)
    vv = np.zeros((B, Q), bool)
    for b, h in enumerate(hl[:B]):
        h = h[:Q]
        tt[b, : len(h)], hh[b, : len(h)], vv[b, : len(h)] = h[:, 0], \
            h[:, 1], True
    mcfg = m._mcfg(M._QT_FLOOR, ncap)
    state = (table, counts, hpi, hp if core == "sorted" else None)
    out = m._votes((tt, hh, vv), state, (tcfg, mcfg, core))
    direct = voting.match_batch_packed(
        table, counts, hpi, torch.as_tensor(tt), torch.as_tensor(hh),
        torch.as_tensor(vv), tcfg, mcfg, core, state[3])
    assert torch.equal(out, direct)
    # windowed: a 12 s recording of two tracks, 3 s windows, 1.5 s hop
    rec = np.concatenate([db["tracks"][1], db["tracks"][2]])
    h = an.samples2hashes(rec)
    fps = SR / 256.0
    m, mj = pair()
    got = m.match_hashes_windowed(ht, h, len(rec) / SR, 3.0, fps, 1.5)
    want = mj.match_hashes_windowed(htj, h, len(rec) / SR, 3.0, fps, 1.5)
    assert len(got) == len(want) > 4
    for (t0, rows, n, wd), (t0w, rows_w, nw, wdw) in zip(got, want):
        assert (t0, n, wd) == (t0w, nw, wdw)
        np.testing.assert_array_equal(rows, np.asarray(rows_w))
    assert got[0][1][0][0] == 1 and got[-1][1][0][0] == 2
    # the sweep: variants fingerprinted in one batch through the cache
    m, mj = pair()
    samples = [noisy[0], to_pcm(db["qs"][1]), None]
    base = an.samples_batch2hashes(samples[:2]) + [hl[2]]
    got = m.match_samples_sweep(an, ht, samples, 2.0, base_hashes=base)
    want = mj.match_samples_sweep(_Shared(an), htj, samples, 2.0,
                                  base_hashes=base)
    for (rr, f, nh), (rw, fw, nw) in zip(got, want):
        np.testing.assert_array_equal(rr, np.asarray(rw))
        assert (f, nh) == (fw, nw)
    assert [int(rr[0][0]) for rr, _f, _n in got] == [0, 1, 2]


def test_fingerprint_th_cloned_queued_twice(db, recorded, monkeypatch):
    """fingerprint_async returns (buf, th) a group; th is read only for a
    row with more than k unique hashes, when the handle resolves.  Two
    calls of one key queued before either resolves keep their own th:
    every output of a replay is cloned.  With buf's clone alone (the
    mutation below) the first call's long rows read the second call's
    th."""
    an = Analyzer(device="cpu")
    monkeypatch.setattr(an, "_hash_cap_estimate", lambda d: 16)
    a, b = db["qs"][:2], [db["qs"][2], db["qs"][0][::-1].copy()]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "captures", lambda device: False)
        want = (an.samples_batch2hashes(a), an.samples_batch2hashes(b))
    assert min(len(h) for h in want[0] + want[1]) > 16   # all past k

    def queued_twice():
        h1, h2 = an.fingerprint_async(a), an.fingerprint_async(b)
        assert len(an._graphs.keys()) == 1
        return an.fingerprint_resolve(h1), an.fingerprint_resolve(h2)

    for got, w in zip(queued_twice(), want):
        for g, x in zip(got, w):
            np.testing.assert_array_equal(g, x)
    real = graphs._clone

    def buf_only(out):
        return (out[0].clone(), out[1]) if isinstance(out, tuple) \
            else real(out)

    monkeypatch.setattr(graphs, "_clone", buf_only)
    got = queued_twice()
    assert not all(np.array_equal(g, x) for g, x in zip(got[0], want[0]))


def test_budget_rule_spans_every_cache(db, recorded, monkeypatch):
    """One budget for every graph on a device: graphs.held_bytes counts
    the vote's, the fingerprint's and the fused path's caches together;
    a new key of any of them that would not fit beside what they hold
    clears them all (counted) and is captured; a captured key replays
    without a clear."""
    graphs.clear(CPU)
    an, ht = Analyzer(device="cpu"), db["ht"]
    m = M.Matcher(device="cpu", verbose=0)
    hl = an.samples_batch2hashes(db["qs"][:1])
    m.match_hashes_batch(ht, hl)
    m.match_samples_fused(an, ht, db["qs"][:1])
    caches = (an._graphs, m._votes, m._graphs)
    assert all(len(c.keys()) == 1 for c in caches)
    h2 = an.samples_batch2hashes(db["qs"][1:3])
    assert [len(c.keys()) for c in caches] == [2, 1, 1]
    assert graphs.held_bytes(CPU) == sum(c.input_bytes for c in caches) > 0
    shared = graphs._shared(CPU)
    monkeypatch.setattr(shared, "pool_bytes", 1 << 30)
    m.mem_budget_bytes = (1 << 30) + sum(c.input_bytes for c in caches)
    clears = graphs.counts["budget_clears"]
    # captured keys: nothing new, no clear
    m.match_hashes_batch(ht, hl)
    an.samples_batch2hashes(db["qs"][:1])
    assert graphs.counts["budget_clears"] == clears
    # a new vote key (2 rows) clears every cache, then is captured alone
    got = m.match_hashes_batch(ht, h2)
    assert graphs.counts["budget_clears"] == clears + 1
    assert [len(c.keys()) for c in caches] == [0, 1, 0]
    assert _only(m._votes)[0][0][0][0] == 2
    assert [int(r[0][0]) for r in got] == [1, 2]
    # past the Analyzer's budget, its new key clears them too
    monkeypatch.setattr(shared, "pool_bytes", 1 << 30)
    monkeypatch.setattr(graphs, "budget_bytes", lambda device: 1 << 30)
    an.samples_batch2hashes([to_pcm(db["qs"][0])])
    assert graphs.counts["budget_clears"] == clears + 2
    assert [len(c.keys()) for c in caches] == [1, 0, 0]
    # below the budget nothing clears
    monkeypatch.setattr(graphs, "budget_bytes", lambda device: 1 << 40)
    an.samples_batch2hashes(db["qs"][:2])
    assert graphs.counts["budget_clears"] == clears + 2
    assert len(an._graphs.keys()) == 2


def test_warmup_captures_two_stage_keys(db, recorded):
    """warmup at --warm-durations 3 --batchsize 2 captures, beside the
    fused path's four keys, the fingerprint of its two float32 clips and
    the vote at sub-batch sizes 1 and 2; its count stays the JAX
    package's."""
    args = cli.make_parser().parse_intermixed_args(
        ["warmup", "-d", "x.pklz", "--warm-durations", "3", "--batchsize",
         "2"])
    an, m = Analyzer(device="cpu"), M.Matcher(device="cpu", verbose=0)
    n = cli.do_warmup(db["ht"], an, m, args, lambda msg: None)
    assert n == 1 + 2 * 2
    assert len(m._graphs.keys()) == 4
    fp = {(k[0][0][0], k[0][0][1]) for k in an._graphs.keys()}
    assert ((2, 65536), "<f4") in fp
    assert {k[0][0][0][0] for k in m._votes.keys()} == {1, 2}


def _save_db(db, path):
    db["ht"].save(path, params=db["an"].params_dict())


def test_fresh_listen_replays_first_request(db, recorded, tmp_path,
                                            monkeypatch, capsys):
    """`match --listen` in a fresh CLI call (a fresh Analyzer and Matcher)
    captures warmup's keys before it reads its first line: every request
    of a warm key replays, nothing is captured while it serves
    (--json-metrics listen_graph_captures), and its stdout lines equal
    batch mode's."""
    dbp = os.path.join(tmp_path, "db.pklz")
    _save_db(db, dbp)
    capsys.readouterr()
    paths = []
    for i, q in enumerate(db["qs"] + [db["qs"][0][: 2 * SR]]):
        paths.append(os.path.join(tmp_path, f"q{i}.wav"))
        audio_write_wav(paths[-1], q, SR)
    flags = ["--warm-durations", "3", "--batchsize", "2"]
    mj = os.path.join(tmp_path, "m.json")
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(
        p + "\n" for p in paths)))
    replays = graphs.counts["replays"]
    assert cli.main(["match", "-d", dbp, "--listen", "--json-metrics", mj,
                     *flags], device="cpu") == 0
    served = capsys.readouterr().out.splitlines()
    with open(mj) as f:
        caps = json.load(f)["listen_graph_captures"]
    assert caps["serving"] == 0 and caps["warm"] >= 4 + 2 + 1
    # the warm-up's captures replay nothing (a key's first call returns
    # its warm-up run's output); each served batch of two requests replays
    assert graphs.counts["replays"] - replays >= len(paths) // 2
    monkeypatch.setattr(graphs, "captures", lambda device: False)
    assert cli.main(["match", "-d", dbp, *flags, *paths],
                    device="cpu") == 0
    batch = capsys.readouterr().out.splitlines()

    def lines(out):
        return [ln for ln in out if not ln.startswith("Processed ")]

    assert lines(served) == lines(batch)
    assert len(lines(served)) == len(paths) + 1         # "Read fprints"
    assert [ln.split(" as ")[1].split()[0] for ln in lines(served)[1:]] \
        == ["track0", "track1", "track2", "track0"]


def test_two_stage_captures_on_the_dispatching_thread(db, recorded,
                                                      monkeypatch, tmp_path):
    """`match --speed-sweep 2 --stream-above 5 --batchsize 1` of [3 s,
    7 s streamed, 3 s]: the fingerprint and the vote (two-stage: a sweep
    needs the samples) capture on the thread that dispatches, never on
    the decode thread, and the streamed file runs outside every capture;
    the lines equal a matcher's that captures nothing."""
    paths = []
    for name, x in (("q0", db["qs"][0]), ("long", db["tracks"][1][: 7 * SR]),
                    ("q1", db["qs"][2])):
        paths.append(os.path.join(tmp_path, f"{name}.wav"))
        audio_write_wav(paths[-1], x, SR)
    args = cli.make_parser().parse_intermixed_args(
        ["match", "-d", "x.pklz", "--speed-sweep", "2", "--stream-above",
         "5", "--batchsize", "1", *paths])
    an = cli.setup_analyzer(args, "cpu")
    threads, streamed = set(), []
    real_record = graphs._record

    def watched_record(fn, device, pool):
        threads.add(threading.current_thread())
        return real_record(fn, device, pool)

    real_stream = an.wavfiles2hashes_streaming

    def watched_stream(names):
        streamed.append((threading.current_thread(), set(CAPTURING)))
        return real_stream(names)

    monkeypatch.setattr(graphs, "_record", watched_record)
    monkeypatch.setattr(an, "wavfiles2hashes_streaming", watched_stream)
    m = M.Matcher(device="cpu", verbose=0)
    lines: list = []
    cli.do_match(db["ht"], an, m, paths, args, lines.append, Stages())
    main = threading.current_thread()
    assert threads == {main} and streamed == [(main, set())]
    assert m._votes.keys() and an._graphs.keys() and not m._graphs.keys()
    monkeypatch.setattr(graphs, "captures", lambda device: False)
    want: list = []
    cli.do_match(db["ht"], an, M.Matcher(device="cpu", verbose=0), paths,
                 args, want.append, Stages())
    assert lines == want
    assert lines == [f"{p}\ttrack{i}" for i, p in enumerate(paths)]
