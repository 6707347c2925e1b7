"""The single-device ingest paths' graph caches on the CPU, through
test_torch_graphs' RecordingGraph stand-in for torch.cuda.CUDAGraph
(graphs.captures patched to True): DeviceIngest's fused ingest and its
store of host hashes (table and counts are the graphs' state, written in
place), the streamed route's chunk passes and pairing
(models/streaming.StreamGraphs) and `precompute -K`'s peaks_batch
(Analyzer._peaks).  The stand-in's recording run puts back every tensor
the function was given, as a real capture runs nothing, so a key's first
call that stored twice would show here.

Held, array for array: tables and counts against the eager DeviceIngest,
the host HashTable.store and JAX's DeviceIngest; store_packed_local's
fixed-size scatter against its boolean-mask form; streamed hashes against
the eager route and JAX's wavfile2hashes_streaming with the whitening
stats pinned; the pairing's power-of-two buckets against the unpadded
call; samples_batch2peaks against the eager call and JAX's."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audfprint_tpu.index.hash_table import HashTable as HTj  # noqa: E402
from audfprint_tpu.models import ingest as INGj  # noqa: E402
from audfprint_tpu.models import streaming as JSTM  # noqa: E402
from audfprint_tpu.models.analyzer import Analyzer as Aj  # noqa: E402
from audfprint_torch import cli  # noqa: E402
from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.index.hash_table import HashTable  # noqa: E402
from audfprint_torch.models import ingest as ING  # noqa: E402
from audfprint_torch.models import streaming as STM  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from audfprint_torch.ops import streaming as ST  # noqa: E402
from audfprint_torch.ops.config import PipelineConfig  # noqa: E402
from audfprint_torch.utils import formats, graphs  # noqa: E402
from audfprint_torch.utils.audio import audio_write_wav  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402
from tests.test_streaming import _synth_music  # noqa: E402
from tests.test_torch_graphs import (  # noqa: E402,F401
    SR, _recorded, recorded, to_pcm)

torch.set_num_threads(2)
CPU = torch.device("cpu")
CFG = PipelineConfig()


@pytest.fixture(autouse=True)
def fresh_graphs():
    """Every test starts and ends with no graph held on the CPU device
    (the streamed route's caches live for the process)."""
    graphs.clear(CPU)
    yield
    graphs.clear(CPU)


# ---- store_packed_local ----------------------------------------------------

def _store_masked(table, counts, hashes, entry, valid, cfg, bucket_lo=0):
    """store_packed_local as it was before its scatter had a fixed size:
    the surviving rows picked by a boolean mask and the counts by
    bincount (both read a size back to the host)."""
    n_local, depth = table.shape
    h = (hashes.to(torch.int64) & ((1 << cfg.hashbits) - 1)) - bucket_lo
    v = valid & (h >= 0) & (h < n_local)
    n = h.shape[0]
    hkey = torch.where(v, h, n_local)
    hs, order = torch.sort(hkey, stable=True)
    es = entry.to(torch.int64)[order]
    idx = torch.arange(n)
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = hs[1:] != hs[:-1]
    rank = idx - torch.cummax(torch.where(first, idx, 0), dim=0).values
    pos = counts.to(torch.int64)[torch.clamp(hs, max=n_local - 1)] + rank
    slot = torch.where(
        pos < depth, pos,
        DT.reservoir_slot_device(hs + bucket_lo, torch.clamp(pos, min=depth),
                                 cfg.seed))
    skey = torch.where((slot < depth) & (hs < n_local), slot, depth)
    key2, perm = torch.sort(hs * (depth + 1) + skey, stable=True)
    last = torch.ones(n, dtype=torch.bool)
    last[:-1] = key2[1:] != key2[:-1]
    hs2, sk2 = hs[perm], skey[perm]
    do = last & (sk2 < depth) & (hs2 < n_local)
    es2 = es[perm][do]
    table[hs2[do], sk2[do]] = es2 if cfg.wide else DT._as_int32(es2)
    counts += torch.bincount(hkey, minlength=n_local + 1)[:n_local].to(
        counts.dtype)


STORE_CASES = {
    # name: (hashbits, depth, idbits, rows, buckets hit, valid share, lo)
    "reservoir overflow": (8, 4, 0, 3000, 64, 0.9, 0),
    "full buckets, wide": (8, 4, 20, 3000, 64, 0.9, 0),
    "sparse": (12, 8, 0, 500, 4096, 0.8, 0),
    "shard-local range": (10, 3, 0, 2000, 1024, 0.85, 512),
    "no valid row": (8, 4, 0, 300, 256, 0.0, 0),
    "empty batch": (8, 4, 0, 0, 256, 0.9, 0),
}


@pytest.mark.parametrize("case", list(STORE_CASES))
def test_store_packed_local_equals_masked_form(case):
    """Three incremental stores into one table (the first into an empty
    one), each bit-equal to the boolean-mask form: buckets filled past
    their depth into the reservoir, ids past 2^17 (the uint32 top bit),
    a wide plane, a shard's bucket range, rows that all drop, none."""
    hb, depth, idbits, n, nb, pv, lo = STORE_CASES[case]
    cfg = DT.TableConfig(hashbits=hb, depth=depth, idbits=idbits, seed=5)
    rng = np.random.default_rng(len(case))
    n_local = cfg.n_buckets - lo
    got = DT.empty_table(cfg, "cpu")
    got = (got[0][:n_local].clone(), got[1][:n_local].clone())
    want = (got[0].clone(), got[1].clone())
    for step in range(3):
        h = torch.from_numpy(rng.integers(0, nb, n).astype(np.int32))
        ids = rng.integers(0, 1 << (idbits or 18), n)
        ids[: n // 4] |= 1 << 17
        t = rng.integers(0, cfg.maxtime, n)
        e = torch.from_numpy((ids.astype(np.int64) << cfg.maxtimebits) | t)
        if not cfg.wide:
            e = e & 0xFFFFFFFF
        v = torch.from_numpy(rng.random(n) < pv)
        DT.store_packed_local(*got, h, e, v, cfg, lo)
        _store_masked(*want, h, e, v, cfg, lo)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if n and pv:
        assert int(got[1].max()) > depth or case == "sparse"
    else:
        assert int(got[1].sum()) == 0 and not got[0].any()


# ---- DeviceIngest ----------------------------------------------------------

def _ingest(mod, an, ht, chunks):
    """Chunks of (name, kind, payload) through a DeviceIngest of `mod`
    (the port's or JAX's) on one device, then finalize -> (the ingest,
    each chunk's rows)."""
    ing = (mod.DeviceIngest(ht, an) if mod is ING
           else mod.DeviceIngest(ht, an, 1))
    rows = [ing.consume_chunk(ing.dispatch_chunk(c, report=print))
            for c in chunks]
    ing.finalize()
    return ing, rows


def _tables(ht) -> tuple:
    return (np.asarray(ht.table), np.asarray(ht.counts),
            np.asarray(ht.hashesperid), list(ht.names))


def _assert_same(got, want):
    g, w = _tables(got), _tables(want)
    for a, b in zip(g[:3], w[:3]):
        np.testing.assert_array_equal(a, b)
    assert g[3][: len(w[3])] == w[3]


@pytest.fixture(scope="module")
def clips():
    """Six 3-3.6 s clips (one bucket length) and two of 7 s (another)."""
    rng = np.random.default_rng(21)
    short = [synth_audio(rng, dur_sec=3.0 + 0.3 * (i % 3), n_tones=40)
             for i in range(6)]
    long_ = [synth_audio(rng, dur_sec=7.0, n_tones=60) for _ in range(2)]
    return short, long_


@pytest.mark.parametrize("idbits", [0, 20])
def test_device_ingest_cache_matches_eager_host_and_jax(clips, tmp_path,
                                                        idbits, monkeypatch):
    """Two chunks of one key, then a chunk of a second key, then two
    segments of host hashes (an .afpt file and a streamed file's hashes)
    through _dispatch_pre: the captured graphs give the table and counts
    of the eager DeviceIngest, of the sequential host store and of JAX's
    DeviceIngest, for an int32 and a wide (--idbits 20) table."""
    short, long_ = clips
    an = Analyzer(device="cpu")
    pre = str(tmp_path / "pre.afpt")
    h_pre = an.samples_batch2hashes([long_[0][: 5 * SR]])[0]
    formats.hashes_save(pre, h_pre)
    h_str = an.samples_batch2hashes([short[0][::-1].copy()])[0]
    wav = {f"{c}{i}.wav": x for c, xs in (("a", short[:3]), ("b", short[3:]),
                                          ("c", long_))
           for i, x in enumerate(xs)}
    chunks = [[(n, "wav", wav[n]) for n in wav if n[0] == c] for c in "abc"]
    chunks += [[(pre, "pre", None), ("s0.wav", "stream", (h_str, 3.0))],
               [("s1.wav", "stream", (h_pre[::2].copy(), 2.0)),
                (pre, "pre", None)]]
    hashes = dict(zip(wav, an.samples_batch2hashes(list(wav.values()))))
    hashes.update({pre: h_pre, "s0.wav": h_str, "s1.wav": h_pre[::2]})
    kw = dict(hashbits=8, depth=4, maxtime=4096, idbits=idbits)

    eager = HashTable(**kw)
    _ingest(ING, an, eager, chunks)

    _recorded(monkeypatch)
    replays = graphs.counts["replays"]
    ht = HashTable(**kw)
    ing, rows = _ingest(ING, an, ht, chunks)
    # keys: the 3 s and the 7 s buckets, one shape of host hashes; the
    # second chunk of each key replays
    assert len(ing._ingest.keys()) == 2 and len(ing._store.keys()) == 1
    assert graphs.counts["replays"] - replays == 2
    _assert_same(ht, eager)

    host = HashTable(**kw)
    for c, rs in zip(chunks, rows):
        assert [n for n, _, _ in rs] == [n for n, _, _ in c]
        for name, nh, _dur in rs:
            host.store_vectorized(name, hashes[name])
            assert nh == len(hashes[name])
    _assert_same(ht, host)
    assert int(host.counts.max()) > host.depth        # the reservoir ran

    htj = HTj(**kw)
    _ingest(INGj, Aj(), htj, chunks)
    _assert_same(ht, htj)


def test_first_call_of_a_key_stores_once(clips, recorded):
    """A key's first call warms, captures and returns the warm-up run's
    output without replaying: one chunk stored through a fresh cache (and
    one segment of host hashes) gives the host store's table, and nothing
    replayed."""
    short, _long = clips
    an = Analyzer(device="cpu")
    kw = dict(hashbits=8, depth=4, maxtime=4096)
    h = an.samples_batch2hashes(short[:3])
    want = HashTable(**kw)
    for i, hh in enumerate(h):
        want.store_vectorized(f"a{i}.wav", hh)
    want.store_vectorized("s.wav", h[0][::3])
    replays = graphs.counts["replays"]
    ht = HashTable(**kw)
    _ingest(ING, an, ht, [
        [(f"a{i}.wav", "wav", x) for i, x in enumerate(short[:3])],
        [("s.wav", "stream", (h[0][::3].copy(), 1.0))]])
    _assert_same(ht, want)
    assert graphs.counts["replays"] == replays


# ---- the streamed route ----------------------------------------------------

@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tgraphs_stream")
    out = {}
    for name, sec, seed in (("a", 9.0, 3), ("b", 10.0, 4)):
        p = str(d / f"{name}.wav")
        audio_write_wav(p, _synth_music(sec, seed=seed), SR)
        out[name] = p
    return out


def _pinned_stats(path, cfg):
    """Per-shift (gmax, mean) from the port's own stats pass on the CPU:
    pinning them makes both packages whiten with the same two floats."""
    src = STM.open_stream_source(path, SR)
    try:
        gmax, mean = STM._stats_pass(
            STM._ChunkReader([src], cfg, 1 << 14, CPU), cfg)
    finally:
        src.close()
    return [(float(g), float(m)) for g, m in zip(gmax, mean)]


@pytest.mark.parametrize("shifts", [1, 4])
@pytest.mark.parametrize("chunk", [512, 256, 96])
def test_streamed_route_through_caches(wavs, monkeypatch, chunk, shifts):
    """One chunk, two chunks (the last partial) and many chunks (the last
    partial), shifts 1 and 4: the hashes through the caches equal the
    eager route's, and JAX's with the whitening stats pinned; the
    caches hold one stats key, one or two peaks keys and one pairing
    key."""
    cfg = CFG._replace(shifts=shifts)
    path = wavs["a"]
    stats = _pinned_stats(path, cfg)
    eager, d0 = STM.wavfile2hashes_streaming(path, cfg, SR, CPU, chunk)
    pinned, _ = STM.wavfile2hashes_streaming(path, cfg, SR, CPU, chunk,
                                             stats)
    _recorded(monkeypatch)
    got, d1 = STM.wavfile2hashes_streaming(path, cfg, SR, CPU, chunk)
    got_p, _ = STM.wavfile2hashes_streaming(path, cfg, SR, CPU, chunk,
                                            stats)
    assert d0 == d1 and len(eager) > 50
    assert np.array_equal(got, eager) and np.array_equal(got_p, pinned)
    sg = STM.stream_graphs(CPU)
    nchunks = -(-int(9.0 * SR / cfg.n_hop) // chunk)
    assert len(sg.stats.keys()) == 1 and len(sg.pair.keys()) == 1
    assert len(sg.peaks.keys()) == min(2, nchunks)
    want, _ = JSTM.wavfile2hashes_streaming(path, cfg, SR, chunk_frames=chunk,
                                            stats=stats)
    assert np.array_equal(got_p, want)


def test_second_streamed_file_captures_no_key(wavs, recorded):
    """A second file of the same chunk size replays every key the first
    captured: its chunks share the stats and peaks keys, and its pairing
    falls in the same power-of-two bucket."""
    a, _ = STM.wavfile2hashes_streaming(wavs["a"], CFG, SR, CPU, 128)
    caps = graphs.counts["captures"]
    replays = graphs.counts["replays"]
    b, _ = STM.wavfile2hashes_streaming(wavs["b"], CFG, SR, CPU, 128)
    assert graphs.counts["captures"] == caps
    assert graphs.counts["replays"] - replays > 4
    graphs.clear(CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "captures", lambda device: False)
        assert np.array_equal(
            b, STM.wavfile2hashes_streaming(wavs["b"], CFG, SR, CPU, 128)[0])
    assert len(a) > 50 and len(b) > 50


def _kept(rng, S, T, K, n_bins=256):
    """Random kept peaks per shift: (t ascending, bin ascending in a
    frame), one shift left inactive."""
    kept = []
    for s in range(S):
        if s == 1:
            kept.append(None)
            continue
        tt, pp = [], []
        for t in range(T):
            n = int(rng.integers(0, K + 1)) if rng.random() < 0.6 else 0
            b = np.sort(rng.choice(n_bins, n, replace=False))
            tt += [t] * n
            pp += b.tolist()
        kept.append((np.asarray(tt, np.int64), np.asarray(pp, np.int64)))
    return kept


@pytest.mark.parametrize("T", [1, 37, 128, 300])
def test_pair_pow2_buckets_equal_unpadded(T, recorded):
    """_pair_on_device pads the frames and the anchors to powers of two
    (at least 128): its rows equal pair_kept_slots on the exact (Tmax, A)
    shape."""
    rng = np.random.default_rng(T)
    S, K = 3, CFG.maxpksperframe
    kept = _kept(rng, S, T, K)
    got = STM._pair_on_device(kept, T, CFG, CPU)
    (key,) = STM.stream_graphs(CPU).pair.keys()
    (slots_k, anchors_k), _, _ = key
    assert slots_k[0][1] == max(128, 1 << (T - 1).bit_length())
    A = max(len(x[0]) for x in kept if x is not None)
    assert anchors_k[0][1] == max(128, 1 << (A - 1).bit_length())
    slots = np.zeros((S, T, K), np.int16)
    anchors = np.zeros((S, A), np.int64)
    for s, x in enumerate(kept):
        if x is None:
            continue
        t, p = x
        slot = np.arange(len(t)) - np.searchsorted(t, t)
        slots[s, t, slot] = p + 1
        anchors[s, : len(t)] = t * K + slot
    g = ST.pair_kept_slots(torch.from_numpy(slots), torch.from_numpy(anchors),
                           CFG).numpy()
    want = []
    for s, x in enumerate(kept):
        if x is None or not len(x[0]):
            continue
        gs = g[s, : len(x[0])]
        lv = (gs >> 20) > 0
        tt = np.broadcast_to(x[0][:, None], gs.shape)[lv]
        want.append(np.stack([tt, (gs & 0xFFFFF)[lv]], 1).astype(np.int32))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# ---- precompute -K -----------------------------------------------------------

def test_samples_batch2peaks_through_cache(clips, monkeypatch):
    """`precompute -K`'s batched peaks through the cache, float32 and int16
    (two keys), replayed on the second call: the eager call's peaks and
    JAX's samples_batch2peaks."""
    short, long_ = clips
    sigs = short[:3] + [long_[0]]
    an = Analyzer(device="cpu")
    eager = an.samples_batch2peaks(sigs)
    eager16 = an.samples_batch2peaks([to_pcm(x) for x in sigs])
    _recorded(monkeypatch)
    replays = graphs.counts["replays"]
    for _ in range(2):
        assert an.samples_batch2peaks(sigs) == eager
        assert an.samples_batch2peaks([to_pcm(x) for x in sigs]) == eager16
    groups = len(an.stage_groups(sigs))
    assert len(an._peaks.keys()) == 2 * groups
    assert graphs.counts["replays"] - replays == 2 * groups
    assert Aj().samples_batch2peaks(sigs) == eager
    assert sum(map(len, eager)) > 100


# ---- the CLI -------------------------------------------------------------------

def test_cli_records_the_new_caches(clips, tmp_path, monkeypatch):
    """`new --device-store` over WAVs and a streamed WAV, and `precompute
    -K`, with the graphs captured: --json-metrics records captures and
    replays past those of a run that captures nothing (the counts are
    the process's), and the database and the peak files equal that
    run's."""
    short, long_ = clips
    wavs = []
    for i, x in enumerate(short[:4] + long_):
        wavs.append(str(tmp_path / f"w{i}.wav"))
        audio_write_wav(wavs[-1], x, SR)
    flags = ["--stream-above", "6.5", "--stream-chunk", "128",
             "--batchsize", "3"]
    out = {}
    for mode in ("eager", "graphs"):
        with pytest.MonkeyPatch.context() as mp:
            if mode == "graphs":
                _recorded(mp)
            else:
                mp.setattr(graphs, "captures", lambda device: False)
            db, pdir = str(tmp_path / f"{mode}.pklz"), str(tmp_path / mode)
            assert cli.main(["new", "-d", db, "-h", "12", "--device-store",
                             "--json-metrics", pdir + ".json", *flags,
                             *wavs], device="cpu") == 0
            with open(pdir + ".json") as f:
                counts = json.load(f)["graphs"]
            assert cli.main(["precompute", "-K", "-p", pdir, *flags,
                             *wavs[:4]], device="cpu") == 0
            peaks = [formats.peaks_load(os.path.join(pdir, os.path.normpath(
                os.path.splitext(w)[0] + ".afpk").lstrip(os.sep)))
                for w in wavs[:4]]
            out[mode] = (HashTable(db), counts, peaks)
    (ht, counts, peaks), (ht_e, counts_e, peaks_e) = out["graphs"], \
        out["eager"]
    _assert_same(ht, ht_e)
    assert counts["captures"] > counts_e["captures"]
    assert counts["replays"] > counts_e["replays"]
    assert peaks == peaks_e and min(map(len, peaks)) > 20
