"""The streamed route (models/streaming.py) against the benchmark's plain
reference (portbench/reference), on the CPU at small sizes.

- portbench/reference/long.py, the reference's analyzer for 2 h files,
  equals analyze.track_keys bit for bit.
- A seeded 40 s int16 WAV streamed in chunks of 64 and 256 frames, with
  the whitening stats pinned to the reference's own (the `stats` hook),
  gives the reference's hashes bit for bit; unpinned, its hash count
  stays within the long.stream cell's track_hashes_gap limit.
- The same files through DeviceIngest at maxtime 2^19, in cli's order
  (_decode_chunk, _stream_chunk, dispatch_chunk, consume_chunk), leave the
  table reference.table.build gives at maxtimebits 19, bit for bit.
- The route's spans and counters record while the tracer is on, and not
  while it is off.
- The native backward prune and the oracle it falls back to keep the same
  peaks on the route, and stream.bwd_native counts the native calls."""

import json
import os
import shutil
import tempfile
import wave
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audfprint_torch import cli
from audfprint_torch.index.hash_table import HashTable
from audfprint_torch.models import streaming as STM
from audfprint_torch.models.analyzer import Analyzer
from audfprint_torch.models.ingest import DeviceIngest
from audfprint_torch.ops.config import PipelineConfig
from audfprint_torch.utils import native, timing
from portbench import corpus
from portbench.reference import analyze as RA
from portbench.reference import long as RL
from portbench.reference import table as RT

SR = 11025
CFG = PipelineConfig()
CPU = torch.device("cpu")
AN = {"density": 20, "shifts": 1, "fanout": 3}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = ("stream.read", "stream.stats", "stream.peaks", "stream.fetch",
         "stream.bwd_prune", "stream.pair")


def _tracks(seed: int, n: int, dur_s: float) -> torch.Tensor:
    return corpus.tracks(n, dur_s, corpus.generator(seed, "cpu"), "cpu")


def _write(path: str, x: np.ndarray) -> str:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.ascontiguousarray(x, "<i2").tobytes())
    return path


@pytest.fixture(scope="module")
def wavs():
    """Two seeded 40 s int16 WAVs: (paths, samples)."""
    x = _tracks(2_400_000_007, 2, 40.0).numpy()
    with tempfile.TemporaryDirectory() as d:
        yield [_write(os.path.join(d, f"rec{i}.wav"), r)
               for i, r in enumerate(x)], x


def _keys(rows: np.ndarray) -> np.ndarray:
    """(n, 2) (t, hash) rows -> sorted keys (t << 20) | hash."""
    return np.sort((rows[:, 0].astype(np.int64) << 20) | rows[:, 1])


def _reference_stats(x: np.ndarray) -> list:
    """The reference's whitening stats of one track: [(max |STFT|, mean
    log magnitude)], as analyze.spectrogram computes them."""
    a = torch.from_numpy(x)[None].float() / 32768.0
    mag = torch.fft.rfft(a.unfold(1, RA.N_FFT, RA.N_HOP) * RA.hann("cpu"),
                         dim=-1).abs()
    mx = mag.amax()
    return [(mx.item(), torch.log(torch.maximum(mag, mx / 1e6)).mean().item())]


@pytest.mark.parametrize("seed,n,dur,analyzer,dtype,silence", [
    (1, 3, 40.0, AN, torch.float32, False),
    (2, 2, 12.0, {"density": 20, "shifts": 2, "fanout": 3}, torch.float32,
     True),
    (3, 2, 12.0, {"density": 40, "shifts": 1, "fanout": 3}, torch.bfloat16,
     False),
    (4, 2, 0.03, AN, torch.float32, False),
])
def test_long_reference_equals_analyze(seed, n, dur, analyzer, dtype,
                                       silence):
    """The long reference's recast loops (HPF, topk-ranked forward prune,
    keep patterns of the backward prune) give analyze.track_keys' keys bit
    for bit: float32 and bfloat16, two shifts, digital silence (the HPF's
    flush) and a track shorter than a frame."""
    x = _tracks(seed, n, dur)
    if silence:
        x[1, 30000:60000] = 0
    want = RA.track_keys(x, analyzer, dtype)
    got = RL.track_keys(x, analyzer, dtype)
    assert [len(k) for k in got] == [len(k) for k in want]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dur < 1 or min(len(k) for k in want) > 50


@pytest.mark.parametrize("chunk", [64, 256])
def test_streamed_route_equals_reference(wavs, chunk):
    """Pinned to the reference's whitening stats, the streamed route's
    hashes are the reference's bit for bit; unpinned (its exact integer
    mean against the reference's float32 reduction), the hash count stays
    within the cell's track_hashes_gap limit."""
    paths, x = wavs
    with open(os.path.join(ROOT, "portbench", "limits",
                           "long.stream.json")) as f:
        limit = json.load(f)["track_hashes_gap"]
    want = RA.track_keys(torch.from_numpy(x[:1]), AN)[0].numpy()
    got, dur = STM.wavfile2hashes_streaming(paths[0], CFG, SR, CPU, chunk,
                                            stats=_reference_stats(x[0]))
    assert dur == pytest.approx(40.0) and len(want) > 300
    assert np.array_equal(_keys(got), want)
    free, _ = STM.wavfile2hashes_streaming(paths[0], CFG, SR, CPU, chunk)
    assert abs(len(free) - len(want)) / len(want) <= limit


def test_device_store_at_maxtime_2_19_equals_reference_table(wavs):
    """cli's order of the streamed ingest into DeviceIngest at maxtime
    2^19 (entries (id << 19) | t) leaves the reference's table of the
    hashes _stream_chunk returned, slot for slot, and the per-file counts
    consume_chunk reports."""
    paths, _x = wavs
    an = Analyzer(device="cpu")
    an.stream_above_sec, an.stream_chunk_frames = 10.0, 256
    ht = HashTable(hashbits=16, depth=100, maxtime=1 << 19)
    di = DeviceIngest(ht, an, ndev=1)

    def report(msg):
        raise AssertionError(msg)

    ordered = cli._decode_chunk(an, SimpleNamespace(ncores=None), report,
                                paths)
    assert [k for _n, k, _d in ordered] == ["stream", "stream"]
    ordered = cli._stream_chunk(an, report, ordered)
    rows = di.consume_chunk(di.dispatch_chunk(ordered, report))
    keys = [torch.from_numpy(_keys(d[0])) for _n, _k, d in ordered]
    assert [n for _name, n, _d in rows] == [len(k) for k in keys]
    want = RT.build(keys, hashbits=16, depth=100, maxtimebits=19)
    got = RT.from_dense(di.table, di.counts, want.hashes_per_id, 19)
    assert torch.equal(got.slot_key, want.slot_key)
    assert torch.equal(got.entry, want.entry)
    assert torch.equal(got.counts, want.counts)
    assert int((got.entry >> 19).max()) == 1


@pytest.fixture
def tracer():
    timing.TRACER.reset()
    yield timing.TRACER
    timing.TRACER.on = False
    timing.TRACER.reset()


def test_route_spans_and_counters(wavs, tracer):
    """On: every span of the route records; stream.chunks counts both
    passes' chunks; stream.cache_hits the chunks the device cache serves
    (the peaks pass's and the floor corrections'); the peak counters the
    backward prune's input and output.  Off: nothing records."""
    paths, _x = wavs
    tracer.on = True
    STM.wavfile2hashes_streaming(paths[0], CFG, SR, CPU, 256)
    sm = tracer.summary()
    src = STM.open_stream_source(paths[0], SR)
    nchunks = STM._ChunkReader([src], CFG, 256, CPU).nchunks
    src.close()
    c = sm["counters"]
    assert set(SPANS) <= set(sm["spans"])
    assert sm["spans"]["stream.read"]["calls"] == nchunks
    assert c["stream.chunks"] == 2 * nchunks
    assert c["stream.cache_hits"] == nchunks + c.get("stream.below", 0)
    assert c["stream.fwd_peaks"] > c["stream.kept_peaks"] > 0
    assert "stream.fallback" not in c
    tracer.on = False
    tracer.reset()
    STM.wavfile2hashes_streaming(paths[0], CFG, SR, CPU, 256)
    sm = tracer.summary()
    assert sm["spans"] == {} and sm["counters"] == {}


def test_uncached_reader_reads_every_chunk_again(wavs, tracer):
    """A _ChunkReader with no device cache serves nothing from it: each
    pass reads and uploads every chunk (stream.read), no cache hit."""
    paths, _x = wavs
    src = STM.open_stream_source(paths[0], SR)
    try:
        rd = STM._ChunkReader([src], CFG, 256, CPU, cache_bytes=0)
        tracer.on = True
        gmax, mean = STM._stats_pass(rd, CFG)
        STM._peaks_pass(rd, CFG, gmax, mean)
    finally:
        src.close()
    c = tracer.summary()["counters"]
    assert c.get("stream.cache_hits", 0) == 0
    assert c["stream.chunks"] == 2 * rd.nchunks
    assert (tracer.calls["stream.read"]
            == 2 * rd.nchunks + c.get("stream.below", 0))


@pytest.mark.parametrize("shifts", [1, 2])
def test_native_bwd_prune_on_the_route(wavs, tracer, shifts, monkeypatch):
    """kept_peaks with the native backward prune and with the library
    taken away (the oracle's fallback) keep the same peaks and give the
    same hashes; stream.bwd_native counts one call an active shift with
    the library and none without."""
    if native.get_lib() is None and shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    paths, _x = wavs
    cfg = CFG._replace(shifts=shifts)
    runs = []
    for with_lib in (True, False):
        if not with_lib:
            monkeypatch.setattr(native, "get_lib", lambda: None)
        tracer.reset()
        tracer.on = True
        kept, tmax, _dur = STM.kept_peaks(paths[0], cfg, SR, 256, CPU)
        rows = np.unique(np.concatenate(
            STM._pair_on_device(kept, tmax, cfg, CPU)), axis=0)
        tracer.on = False
        runs.append((kept, rows, tracer.counters["stream.bwd_native"],
                     tracer.calls["stream.bwd_prune"]))
    (k1, h1, n1, c1), (k2, h2, n2, c2) = runs
    active = sum(k is not None for k in k1)
    assert active == shifts and len(k1) == len(k2) == shifts
    for a, b in zip(k1, k2):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert len(h1) > 100 and np.array_equal(h1, h2)
    assert n1 == c1 == active and n2 == 0 and c2 == active
