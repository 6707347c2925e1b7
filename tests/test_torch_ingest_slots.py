"""DeviceIngest's staging slots on the CPU (models/ingest._Slot): a chunk
staged into a slot that an earlier chunk of its key wrote holds exactly
the batch a freshly zeroed array would (stale row tails and rows past the
chunk zeroed, int16 rows of a mixed chunk scaled to float32); the slots
follow the caller's in-flight depth, at most two are kept free; and
every run below stores, bit for bit, the table, counts and hashes per id
of the sequential host store (one device, and the mesh's forced overflow
replay reading a reused slot), with the slot counters in --json-metrics."""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audfprint_tpu.index.hash_table import HashTable  # noqa: E402
from audfprint_torch import cli  # noqa: E402
from audfprint_torch.models import ingest as ING  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from audfprint_torch.utils import timing  # noqa: E402
from audfprint_torch.utils.audio import audio_write_wav  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402
from tests.test_torch_graphs import to_pcm  # noqa: E402
from tests.test_torch_ingest import (SMALL, _assert_tables_equal,  # noqa
                                     _host_reference)

SR = 11025


def _pcm(seed, durs, n_tones=30):
    rng = np.random.default_rng(seed)
    return [to_pcm(synth_audio(rng, dur_sec=d, n_tones=n_tones))
            for d in durs]


def _numpy_batch(sigs, Bp, blen):
    """The padded batch as a fresh zeroed array holds it (the staging
    before slots)."""
    all_i16 = all(s.dtype == np.int16 for s in sigs if len(s))
    batch = np.zeros((Bp, blen), np.int16 if all_i16 else np.float32)
    for row, s in enumerate(sigs):
        if not all_i16 and s.dtype == np.int16:
            s = s.astype(np.float32) / float(1 << 15)
        batch[row, : len(s)] = s
    return batch


@pytest.fixture()
def tracer(monkeypatch):
    tr = timing.Tracer()
    tr.on = True
    monkeypatch.setattr(timing, "TRACER", tr)
    return tr


def _chunk(names, sigs):
    return [(n, "wav", s) for n, s in zip(names, sigs)]


def _run(ing, chunks, depth):
    """Dispatch `depth` chunks ahead of the one consumed -> the rows in
    chunk order."""
    rows, pending = [], []
    for c in chunks:
        pending.append(ing.dispatch_chunk(c, report=print))
        if len(pending) > depth - 1:
            rows.extend(ing.consume_chunk(pending.pop(0)))
    for h in pending:
        rows.extend(ing.consume_chunk(h))
    return rows


@pytest.mark.parametrize("nblocks", [1, 3])
def test_slot_fill_equals_a_fresh_batch(nblocks):
    """A run of chunks of one key through one slot, each shorter or
    longer than the last and with fewer rows, then a mixed-dtype slot,
    in one thread and in blocks of rows on a pool: after each fill the
    slot's batch and lengths are the fresh zeroed array's bit for bit,
    and `written` is each row's length."""
    rng = np.random.default_rng(3)
    Bp, blen = 8, 4096
    slot = ING._Slot((Bp, blen, torch.int16), Bp, False)
    pool = ThreadPoolExecutor(nblocks)
    for n_rows, hi in ((8, 4096), (5, 1500), (7, 4000), (2, 10), (6, 0)):
        sigs = [rng.integers(-2**15, 2**15, rng.integers(0, hi + 1),
                             dtype=np.int16) for _ in range(n_rows)]
        slot.fill(sigs, pool, nblocks)
        np.testing.assert_array_equal(slot.batch.numpy(),
                                      _numpy_batch(sigs, Bp, blen))
        lens = [len(s) for s in sigs] + [0] * (Bp - n_rows)
        np.testing.assert_array_equal(slot.lens.numpy(), lens)
        np.testing.assert_array_equal(slot.written, lens)
    fslot = ING._Slot((Bp, blen, torch.float32), Bp, False)
    for hi in (4096, 900):
        sigs = [rng.integers(-2**15, 2**15, hi, dtype=np.int16),
                rng.standard_normal(hi // 2).astype(np.float32),
                rng.integers(-2**15, 2**15, hi // 3, dtype=np.int16)]
        fslot.fill(sigs, pool, nblocks)
        want = _numpy_batch(sigs, Bp, blen)
        assert want.dtype == np.float32
        assert fslot.batch.numpy().tobytes() == want.tobytes()
    pool.shutdown()


def test_reused_slot_stores_shorter_chunk(tracer):
    """A chunk of long tracks, then one of fewer, shorter tracks of the
    same key through the same slot (its stale tails and the rows past the
    chunk zeroed), one ahead: the tables and rows of the sequential host
    store."""
    an = Analyzer(device="cpu")
    long_, short = _pcm(11, [5.0, 4.5, 5.2, 4.8, 5.0]), _pcm(12, [2.0, 1.5])
    names = [f"l{i}.wav" for i in range(5)] + ["s0.wav", "s1.wav"]
    want = _host_reference(an, names, long_ + short, **SMALL)
    ht = HashTable(**SMALL)
    ing = ING.DeviceIngest(ht, an)
    h0 = ing.dispatch_chunk(_chunk(names[:5], long_), report=print)
    slot = h0[0][4]
    rows = ing.consume_chunk(h0)
    h1 = ing.dispatch_chunk(_chunk(names[5:], short), report=print)
    assert h1[0][4] is slot
    np.testing.assert_array_equal(slot.batch.numpy(),
                                  _numpy_batch(short, 8, 65536))
    rows += ing.consume_chunk(h1)
    ing.finalize()
    _assert_tables_equal(ht, want)
    assert [nh for _, nh, _ in rows] == [int(x) for x in want.hashesperid]
    assert tracer.counters["ingest.slot_made"] == 1
    assert tracer.counters["ingest.slot_reused"] == 1


@pytest.mark.parametrize("depth", [2, 3])
def test_slots_follow_in_flight_depth(depth, tracer):
    """Six chunks of one key dispatched `depth` ahead of the one consumed:
    `depth` slots made, the others reused, two kept free at the end; the
    table, hashes per id and rows of the sequential host store."""
    an = Analyzer(device="cpu")
    sigs = _pcm(20 + depth, [1.0 + 0.25 * (i % 4) for i in range(12)])
    names = [f"d{i}.wav" for i in range(12)]
    want = _host_reference(an, names, sigs, **SMALL)
    ht = HashTable(**SMALL)
    ing = ING.DeviceIngest(ht, an)
    chunks = [_chunk(names[i: i + 2], sigs[i: i + 2])
              for i in range(0, 12, 2)]
    rows = _run(ing, chunks, depth)
    ing.finalize()
    _assert_tables_equal(ht, want)
    assert [n for n, _, _ in rows] == names
    assert [nh for _, nh, _ in rows] == [int(x) for x in want.hashesperid]
    assert tracer.counters["ingest.slot_made"] == depth
    assert tracer.counters["ingest.slot_reused"] == 6 - depth
    assert len(ing._free) == 2


def test_mesh_overflow_replay_reads_reused_slot(tracer):
    """On 8 shards under a routing cap that overflows, a second chunk
    reuses the first's slot and its replay reads the slot's new rows:
    the table of the sequential host store."""
    an = Analyzer(device="cpu")
    first, second = _pcm(31, [3.0, 3.2, 2.8, 3.1]), _pcm(32, [2.0, 1.8])
    names = [f"m{i}.wav" for i in range(6)]
    want = _host_reference(an, names, first + second, **SMALL)
    ht = HashTable(**SMALL)
    ing = ING.DeviceIngest(ht, an, 8, cap_override=4)
    rows = ing.consume_chunk(ing.dispatch_chunk(_chunk(names[:4], first),
                                                report=print))
    h = ing.dispatch_chunk(_chunk(names[4:], second), report=print)
    assert int(h[0][3][-1]) == 0, "cap=4 must overflow"
    rows += ing.consume_chunk(h)
    ing.finalize()
    assert ing.replays == 2
    assert tracer.counters["ingest.slot_reused"] == 1
    _assert_tables_equal(ht, want)
    assert [nh for _, nh, _ in rows] == [int(x) for x in want.hashesperid]


def test_mixed_dtype_chunk(tracer):
    """An int16 chunk, then a chunk mixing int16 and float32 rows (a
    float32 slot of its own, int16 rows scaled as the analyzer scales
    them), then int16 again (the first slot reused), one ahead: the table
    and rows of the sequential host store over the same signals."""
    an = Analyzer(device="cpu")
    pcm = _pcm(41, [2.0, 2.5, 1.5, 2.2, 1.8])
    rng = np.random.default_rng(42)
    flt = synth_audio(rng, dur_sec=2.3, n_tones=30).astype(np.float32)
    sigs = [pcm[0], pcm[1], pcm[2], flt, pcm[3], pcm[4]]
    names = [f"x{i}.wav" for i in range(6)]
    want = _host_reference(an, names, sigs, **SMALL)
    ht = HashTable(**SMALL)
    ing = ING.DeviceIngest(ht, an)
    h0 = ing.dispatch_chunk(_chunk(names[:2], sigs[:2]), report=print)
    h1 = ing.dispatch_chunk(_chunk(names[2:4], sigs[2:4]), report=print)
    assert h1[0][4].batch.dtype == torch.float32
    np.testing.assert_array_equal(h1[0][4].batch.numpy(),
                                  _numpy_batch(sigs[2:4], 8, 65536))
    rows = ing.consume_chunk(h0)
    h2 = ing.dispatch_chunk(_chunk(names[4:], sigs[4:]), report=print)
    assert h2[0][4] is h0[0][4]
    rows += ing.consume_chunk(h1) + ing.consume_chunk(h2)
    ing.finalize()
    _assert_tables_equal(ht, want)
    assert [nh for _, nh, _ in rows] == [int(x) for x in want.hashesperid]
    assert tracer.counters["ingest.slot_made"] == 2
    assert tracer.counters["ingest.slot_reused"] == 1


def test_cli_json_metrics_counts_slots(tmp_path, monkeypatch):
    """new --device-store over three one-track chunks of one key, one
    ahead: --json-metrics counts 2 slots made and 1 reused, beside the
    ingest spans; the database equals the host store's."""
    paths = []
    for i, x in enumerate(_pcm(51, [2.0, 2.25, 2.5])):
        p = str(tmp_path / f"w{i}.wav")
        audio_write_wav(p, x.astype(np.float32) / 32768.0, SR)
        paths.append(p)
    monkeypatch.setattr(timing, "TRACER", timing.Tracer())
    mj = str(tmp_path / "m.json")
    db_host, db_dev = str(tmp_path / "h.pklz"), str(tmp_path / "d.pklz")
    assert cli.main(["new", "-d", db_host, "-h", "10", *paths],
                    device="cpu") == 0
    assert cli.main(["new", "-d", db_dev, "-h", "10", "--device-store",
                     "--batchsize", "1", "--json-metrics", mj, *paths],
                    device="cpu") == 0
    with open(mj) as f:
        m = json.load(f)
    assert m["counters"]["ingest.slot_made"] == 2
    assert m["counters"]["ingest.slot_reused"] == 1
    assert m["spans"]["ingest.slot_wait"]["calls"] == 1
    assert m["spans"]["ingest.dispatch"]["calls"] == 3
    _assert_tables_equal(HashTable(db_dev), HashTable(db_host))
