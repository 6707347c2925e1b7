"""The port's tracer (audfprint_torch/utils/timing.py) on the CPU.

Held: a span that is off reads no clock, calls no torch function, hands
out one shared object and records nothing; spans that are on give
parents, ids and self times that add up, per thread; under
torch.profiler each span is a user_annotation range of the exported
Chrome trace with the tracer's own duration; a DeviceIngest run (eager,
and through test_torch_graphs' RecordingGraph stand-in for a captured
graph) emits its chunk spans once a chunk under the chunk's sequence
number and stores the same table with the tracer on and off; the
tracer's means and one-time events that the benchmark reads; chip_smoke
leaving the spans' device-timeline annotations out of device time; and
the CLI's --json-metrics and --profile."""

import glob
import json
import os
import threading
import time
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from audfprint_torch import cli  # noqa: E402
from audfprint_torch.index.hash_table import HashTable  # noqa: E402
from audfprint_torch.models import ingest as ING  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from audfprint_torch.utils import graphs, timing  # noqa: E402
from audfprint_torch.utils.audio import audio_write_wav  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402
from tests.test_torch_graphs import _recorded, to_pcm  # noqa: E402

CPU = torch.device("cpu")
SR = 11025


@pytest.fixture()
def tracer(monkeypatch):
    """A fresh process-wide tracer, off, for the test."""
    tr = timing.Tracer()
    monkeypatch.setattr(timing, "TRACER", tr)
    return tr


def _busy(seconds: float) -> None:
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


# ---- off ---------------------------------------------------------------

def _kept(fn, n: int = 10_000) -> int:
    """Bytes allocated and not freed over n calls of fn (tracemalloc)."""
    fn(0)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for i in range(n):
            fn(i)
        return tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()


def test_span_off_records_and_allocates_nothing(tracer, monkeypatch):
    """Off, span() hands out one shared no-op: no clock read, no torch
    call, no object kept, nothing recorded; count() counts nothing."""
    def boom(*a, **k):
        raise AssertionError("an off span reached the clock or torch")

    class NoClock:
        perf_counter_ns = perf_counter = staticmethod(boom)

    monkeypatch.setattr(timing, "time", NoClock)
    monkeypatch.setattr(timing._profiler, "record_function", boom)
    assert timing.span("a") is timing.span("b", id=3)

    def spans(i):
        with timing.span("ingest.dispatch", id=i):
            timing.count("graph.h2d_bytes", 8)

    # bytes still held after 10,000 calls, against a loop of no-ops
    assert _kept(spans) == _kept(lambda i: None)
    s = tracer.summary()
    assert s["spans"] == {} and s["counters"] == {}
    assert s["span_records"] == [] and s["span_records_dropped"] == 0


# ---- on ----------------------------------------------------------------

def test_span_on_nesting_ids_and_self_times(tracer):
    """Parents are the innermost open span of the thread, ids default to
    the parent's, a span's total less its self time is its children's
    total, and a Stages stage is the span stage.<name> around them, its
    time kept by the stage alone."""
    tracer.on = True
    stages = timing.Stages()
    with stages.time("dispatch"):
        with timing.span("a", id=7):
            _busy(0.002)
            with timing.span("b"):
                _busy(0.002)
                with timing.span("c", id=9):
                    _busy(0.001)
            with timing.span("b"):
                _busy(0.001)

    def other():
        with timing.span("t"):
            pass

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    rec = {}
    for name, id_, parent, t0, t1 in tracer.records:
        rec.setdefault(name, []).append((id_, parent, t1 - t0))
    assert [r[:2] for r in rec["c"]] == [(9, "b")]
    assert [r[:2] for r in rec["b"]] == [(7, "a"), (7, "a")]
    assert rec["a"][0][:2] == (7, "stage.dispatch")
    assert rec["stage.dispatch"][0][:2] == (None, None)
    assert rec["t"][0][:2] == (None, None)
    tot, own = tracer.total_ns, tracer.self_ns
    assert tot["a"] - own["a"] == tot["b"]
    assert tot["b"] - own["b"] == tot["c"]
    assert own["c"] == tot["c"] and tracer.calls["b"] == 2
    assert "stage.dispatch" not in tot and "stage.dispatch" not in own
    assert min(own.values()) >= 0
    assert stages.counts["dispatch"] == 1
    ((_n, _i, _p, t0, t1),) = [r for r in tracer.records
                               if r[0] == "stage.dispatch"]
    assert stages.totals["dispatch"] == (t1 - t0) / 1e9
    assert stages.totals["dispatch"] >= tot["a"] / 1e9
    s = tracer.summary()["spans"]
    assert s["b"]["calls"] == 2
    assert s["a"]["self_s"] == pytest.approx(own["a"] / 1e9)


def test_spans_are_profiler_ranges(tracer, tmp_path):
    """Under torch.profiler (CPU activity) with the tracer off, each span
    records and is a user_annotation event of its name whose duration is
    the tracer's within 1 ms; spans stop recording with the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("outer", id=1):
            _busy(0.003)
            with timing.span("inner"):
                _busy(0.002)
            with timing.span("inner"):
                _busy(0.001)
    with timing.span("after"):
        pass
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    got = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            got.setdefault(e["name"], []).append(float(e["dur"]) / 1e3)
    mine = {}
    for name, _id, _p, t0, t1 in sorted(tracer.records, key=lambda r: r[3]):
        mine.setdefault(name, []).append((t1 - t0) / 1e6)
    assert set(mine) == {"outer", "inner"}
    for name, ms in mine.items():
        assert len(got.get(name, [])) == len(ms), name
        for a, b in zip(sorted(got[name]), sorted(ms)):
            assert abs(a - b) < 1.0, (name, a, b)


# ---- DeviceIngest --------------------------------------------------------

def _clips():
    rng = np.random.default_rng(41)
    return [to_pcm(synth_audio(rng, dur_sec=2.0 + 0.25 * i, n_tones=30))
            for i in range(7)]


def _ingest(graphed: bool, on: bool) -> dict:
    """Three chunks (3, 3 and 1 clips) through a DeviceIngest on the CPU,
    then finalize, with a fresh tracer on or off -> its results and the
    tracer."""
    clips = _clips()
    chunks = [[(f"c{i}.wav", "wav", clips[i]) for i in idx]
              for idx in ((0, 1, 2), (3, 4, 5), (6,))]
    with pytest.MonkeyPatch.context() as mp:
        tr = timing.Tracer()
        mp.setattr(timing, "TRACER", tr)
        if graphed:
            _recorded(mp)
        graphs.clear(CPU)
        tr.on = on
        ht = HashTable(hashbits=10, depth=8, maxtime=4096)
        ing = ING.DeviceIngest(ht, Analyzer(device="cpu"))
        rows, handle = [], None
        for c in chunks:                  # one chunk ahead, as the CLI
            h = ing.dispatch_chunk(c, report=print)
            if handle is not None:
                rows.append(ing.consume_chunk(handle))
            handle = h
        rows.append(ing.consume_chunk(handle))
        ing.finalize()
        tr.on = False
        graphs.clear(CPU)
    return {"table": ht.table.copy(), "counts": ht.counts.copy(),
            "hpi": np.asarray(ht.hashesperid).copy(), "rows": rows,
            "names": list(ht.names), "tracer": tr}


@pytest.fixture(scope="module")
def ingests():
    return {(g, on): _ingest(g, on) for g in (False, True)
            for on in (False, True)}


@pytest.mark.parametrize("graphed", [False, True])
def test_device_ingest_spans_once_a_chunk(ingests, graphed):
    """ingest.dispatch over ingest.stage and ingest.ids (and, through the
    graph cache, graph.pin then graph.launch after a key's first call,
    which is the one-time event graph.capture, tracer on or off; and
    ingest.slot_wait where a chunk takes a slot again: the third, one
    ahead, whose key is the first's), ingest.consume over
    ingest.counts_fetch, each once a chunk under the chunk's sequence
    number; the table, counts, hashes per id and rows equal the
    tracer-off run's."""
    off, on = ingests[(graphed, False)], ingests[(graphed, True)]
    for k in ("table", "counts", "hpi"):
        np.testing.assert_array_equal(on[k], off[k])
    assert on["rows"] == off["rows"] and on["names"] == off["names"]
    assert off["tracer"].records == []
    by_id: dict = {}
    for name, id_, parent, _t0, _t1 in on["tracer"].records:
        by_id.setdefault(id_, []).append((name, parent))
    replay = [("graph.pin", "ingest.dispatch"),
              ("graph.launch", "ingest.dispatch")]
    for seq in range(3):            # one key: captured, then replayed
        graph = replay if graphed and seq > 0 else []
        reused = [("ingest.slot_wait", "ingest.dispatch")] if seq == 2 \
            else []
        want = [*reused,
                ("ingest.stage", "ingest.dispatch"),
                ("ingest.ids", "ingest.dispatch"),
                *graph,
                ("ingest.dispatch", None),
                ("ingest.counts_fetch", "ingest.consume"),
                ("ingest.consume", None)]
        assert sorted(by_id[seq]) == sorted(want), seq
    assert by_id[None] == [("ingest.finalize", None)]
    s = on["tracer"].summary()
    assert s["spans"]["ingest.dispatch"]["calls"] == 3
    assert (s["counters"].get("graph.h2d_bytes", 0) > 0) == graphed
    assert s["counters"]["ingest.slot_made"] == 2
    assert s["counters"]["ingest.slot_reused"] == 1
    for tr in (off["tracer"], on["tracer"]):
        assert tr.events.get("graph.capture", [0, 0])[1] == int(graphed)
    assert "graph.capture" not in s["spans"]


@pytest.mark.parametrize("name", [
    "ingest.stage", "graph.pin", "graph.launch", "ingest.counts_fetch",
    "graph.capture"])
def test_tracer_reads(ingests, name):
    """What the benchmark reads of the tracer: a span's mean ms a call
    (its total over its calls) and a one-time event's seconds, positive
    from a small ingest through the graph cache, None from an empty
    tracer."""
    tr, empty = ingests[(True, True)]["tracer"], timing.Tracer()
    if name == "graph.capture":
        v = tr.event_s(name)
        assert v == tr.events[name][0] and empty.event_s(name) is None
    else:
        # three chunks; the first captured the graph, which the others
        # replayed
        n = 2 if name.startswith("graph.") else 3
        v = tr.mean_ms(name)
        assert tr.calls[name] == n and empty.mean_ms(name) is None
        assert v == pytest.approx(tr.total_ns[name] / n / 1e6)
    assert isinstance(v, float) and v > 0


def test_chip_smoke_device_events_leave_out_spans():
    """chip_smoke's device events, which its device ms and top kernels
    sum, hold the profile's CUDA kernels and copies and none of the
    user annotations that the program's spans put on the device's
    timeline."""
    import chip_smoke

    cuda = torch.autograd.DeviceType.CUDA
    evs = [SimpleNamespace(name="k", device_type=cuda,
                           is_user_annotation=False),
           SimpleNamespace(name="graph.launch", device_type=cuda,
                           is_user_annotation=True),
           SimpleNamespace(name="aten::copy_",
                           device_type=torch.autograd.DeviceType.CPU,
                           is_user_annotation=False)]
    prof = SimpleNamespace(events=lambda: evs)
    assert [e.name for e in chip_smoke._device_events(torch, prof)] == ["k"]


# ---- the CLI -------------------------------------------------------------

@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_wavs")
    paths = []
    for i, x in enumerate(_clips()[:3]):
        p = str(d / f"s{i}.wav")
        audio_write_wav(p, x.astype(np.float32) / 32768.0, SR)
        paths.append(p)
    return paths


def test_cli_json_metrics_writes_the_tracer(wavs, tmp_path, monkeypatch,
                                             tracer):
    """new --device-store --json-metrics (graphs through the stand-in):
    the stages as before, each span's total and self seconds and calls
    (ingest.* over graph.*; the stages, their parents, in stage_seconds
    alone), the counters, the capture event, the span records and every
    kernel's launch count (K4's seg_scan too); the tracer is off again
    after the command."""
    _recorded(monkeypatch)
    graphs.clear(CPU)
    mj = str(tmp_path / "m.json")
    assert cli.main(["new", "-d", str(tmp_path / "db.pklz"), "-h", "10",
                     "--device-store", "--batchsize", "2", "--json-metrics", mj,
                     *wavs], device="cpu") == 0
    graphs.clear(CPU)
    assert tracer.on is False
    with open(mj) as f:
        m = json.load(f)
    assert {"analyze", "dispatch", "store"} <= set(m["stage_seconds"])
    sp = m["spans"]
    assert sp["ingest.dispatch"]["calls"] == 2
    assert sp["ingest.consume"]["calls"] == 2
    assert sp["ingest.finalize"]["calls"] == 1
    assert not any(k.startswith("stage.") for k in sp)
    for v in sp.values():
        assert 0 <= v["self_s"] <= v["total_s"] + 1e-9
    # stage_seconds are rounded to 0.1 ms
    assert m["stage_seconds"]["dispatch"] + 5e-5 >= \
        sp["ingest.dispatch"]["total_s"]
    assert m["counters"]["graph.h2d_bytes"] > 0
    assert m["events"]["graph.capture"]["calls"] == 1   # one key: 8 rows
    parents = {(r["name"], r["parent"]) for r in m["span_records"]}
    assert ("ingest.dispatch", "stage.dispatch") in parents
    assert ("ingest.consume", "stage.analyze") in parents
    assert {"hpf_scan", "prune_fwd_bwd", "prune_fwd_carry", "pair_scan",
            "seg_scan"} <= set(m["kernel_launches"])


def test_cli_profile_trace_has_program_ranges(wavs, tmp_path, tracer):
    """new --device-store --profile DIR: the Chrome trace holds the
    program's spans as ranges, the tracer itself being off."""
    prof = str(tmp_path / "prof")
    assert cli.main(["new", "-d", str(tmp_path / "db.pklz"), "-h", "10",
                     "--device-store", "--profile", prof, *wavs],
                    device="cpu") == 0
    (path,) = glob.glob(os.path.join(prof, "*.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"stage.dispatch", "ingest.dispatch", "ingest.stage",
            "ingest.ids", "ingest.consume", "ingest.counts_fetch",
            "ingest.finalize", "stage.save"} <= names
    assert tracer.on is False and tracer.calls["ingest.dispatch"] == 1
