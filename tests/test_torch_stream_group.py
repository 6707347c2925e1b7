"""The streamed route's group entry
(models/streaming.wavfiles2hashes_streaming) on the CPU: files run as rows of one stats pass and one peaks pass, and
each file's hashes and duration equal what it gives alone, bit for bit.

- Groups of int16 mono WAVs (staged as int16) and of mixed formats (a
  wrong-rate and a stereo WAV: staged as float32), with a file shorter than
  one chunk, one under n_fft (no frame), an all-zero one and one whose
  silence takes the floor correction, at shifts 1 and 4 and chunks of 128
  and 300 frames.
- The f64 mean fallback is decided per file: forcing it in one file's row
  changes that file's mean alone, and a floor-correction residual in a
  file whose own rows flag no chunk changes nothing.
- stream.groups / stream.group_files and the rows of the stats pass (a
  group of 3 shares the 4-file key).
- A file that does not open, or whose reads fail during the passes, is
  reported by cli._stream_chunk and the others are stored.
- `new --device-store` over 4 long WAVs in one chunk leaves the table of
  storing them one chunk each."""

import json
import os
import wave

import numpy as np
import pytest
import torch

from audfprint_torch import cli
from audfprint_torch.index.hash_table import HashTable
from audfprint_torch.models import streaming as STM
from audfprint_torch.models.analyzer import Analyzer
from audfprint_torch.ops import streaming as ST
from audfprint_torch.ops.config import PipelineConfig
from audfprint_torch.utils import graphs, timing
from audfprint_torch.utils.audio import audio_write_wav
from tests.conftest import synth_audio

torch.set_num_threads(2)
SR = 11025
CFG = PipelineConfig()
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream_group")
    rng = np.random.default_rng(27)

    def wav(name, x, sr=SR):
        path = str(d / f"{name}.wav")
        audio_write_wav(path, x, sr)
        return path

    gappy = synth_audio(rng, 7.0, n_tones=40)
    gappy[: SR] = 0.0
    gappy[4 * SR: 4 * SR + SR // 2] = 0.0
    out = {"music": wav("music", synth_audio(rng, 9.0, n_tones=50)),
           "music2": wav("music2", synth_audio(rng, 6.5, n_tones=40)),
           "short": wav("short", synth_audio(rng, 2.0)),
           "tiny": wav("tiny", synth_audio(rng, 0.03)),
           "zeros": wav("zeros", np.zeros(5 * SR, np.float32)),
           "gappy": wav("gappy", gappy),
           "rate": wav("rate", synth_audio(rng, 5.0, sr=44100, n_tones=30),
                       44100)}
    st = synth_audio(rng, 6.0, n_tones=40)
    pcm = np.stack([st, st[::-1]], axis=1) * (1 << 15)
    out["stereo"] = str(d / "stereo.wav")
    with wave.open(out["stereo"], "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.clip(pcm, -32768, 32767).astype("<i2").tobytes())
    return out


@pytest.fixture
def tracer():
    timing.TRACER.reset()
    timing.TRACER.on = True
    yield timing.TRACER
    timing.TRACER.on = False
    timing.TRACER.reset()


_ALONE: dict = {}


def _alone(path, cfg=CFG, chunk=128):
    """One file through the single-file entry, a group of one."""
    key = (path, cfg, chunk)
    if key not in _ALONE:
        _ALONE[key] = STM.wavfile2hashes_streaming(path, cfg, SR, CPU, chunk)
    return _ALONE[key]


MIXES = {"int16": ("music", "short", "tiny", "zeros", "gappy"),
         "mixed": ("music2", "rate", "stereo", "gappy", "short")}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("shifts,chunk", [(1, 128), (1, 300), (4, 128),
                                          (4, 300)])
def test_group_equals_each_file_alone(files, mix, shifts, chunk):
    """Every file's hashes and duration from one group are the ones it
    gives alone, bit for bit."""
    cfg = CFG._replace(shifts=shifts)
    names = [files[k] for k in MIXES[mix]]
    got = STM.wavfiles2hashes_streaming(names, cfg, SR, CPU, chunk)
    assert len(got) == len(names)
    for name, (h, dur) in zip(names, got):
        want, wdur = _alone(name, cfg, chunk)
        assert dur == wdur
        assert h.dtype == np.int32 and np.array_equal(h, want), name
    sizes = {k: len(h) for k, (h, _d) in zip(MIXES[mix], got)}
    assert sizes.get("tiny", 0) == sizes.get("zeros", 0) == 0
    assert sizes["gappy"] > 30 and sizes["short"] > 10
    assert (sizes.get("music", 0) or sizes["music2"]) > 50


_FORCED = {"stats": (0, 1), "below_flagged": (1, 3), "below_unflagged": (3, 7)}


@pytest.mark.parametrize("case", sorted(_FORCED))
def test_fallback_decided_per_file(files, monkeypatch, tracer, case):
    """A split residual forced into one shift row (shifts 2) sends only
    that row's file to the f64 fallback: in the stats pass, or in the floor
    correction of a chunk that file's own rows flag (the gappy file's).  A
    residual in the correction's rows of a file that flags no chunk, as
    the file alone would never run the correction, changes nothing."""
    cfg = CFG._replace(shifts=2)
    names = [files[k] for k in ("music", "gappy", "music2", "short")]
    srcs = [STM.open_stream_source(n, SR) for n in names]
    try:
        rd = STM._ChunkReader(srcs, cfg, 128, CPU)
        gmax0, mean0 = STM._stats_pass(rd, cfg)
        corrected = []
        for f, name in enumerate(names):
            alone = STM._ChunkReader([srcs[f]], cfg, 128, CPU)
            tracer.reset()
            g1, m1 = STM._stats_pass(alone, cfg)
            corrected.append(tracer.counters.get("stream.below", 0) > 0)
            assert np.array_equal(g1, gmax0[rd.rows(f)])
            assert np.array_equal(m1, mean0[rd.rows(f)]), name
        f, row = _FORCED[case]
        assert corrected[1] and not corrected[3]

        def force(out):
            *rest, rm = out
            rm = rm.clone()
            rm[row] = 1.0
            return (*rest, rm)

        if case == "stats":
            cache = STM.stream_graphs(CPU).stats
            real = cache.fn
            monkeypatch.setattr(cache, "fn", lambda *a: force(real(*a)))
        else:
            real_below = ST.chunk_stats_below
            monkeypatch.setattr(ST, "chunk_stats_below",
                                lambda *a: force(real_below(*a)))
        monkeypatch.setattr(STM, "_exact_mean_fallback",
                            lambda rd, cfg, g: np.full(len(rd.offs), 7.0,
                                                       np.float32))
        tracer.reset()
        gmax, mean = STM._stats_pass(rd, cfg)
    finally:
        for s in srcs:
            s.close()
    falls = case != "below_unflagged"
    want = mean0.copy()
    if falls:
        want[rd.rows(f)] = 7.0
    assert np.array_equal(gmax, gmax0) and np.array_equal(mean, want)
    c = tracer.counters
    assert c.get("stream.fallback", 0) == int(falls)
    assert c.get("stream.below", 0) > 0 or case == "stats"


@pytest.mark.parametrize("n", [1, 3, 4])
def test_group_counters_and_rows(files, monkeypatch, tracer, n):
    """stream.groups / stream.group_files read 1 / n, and the stats pass
    runs on the group's files padded to a power of two, times the shifts:
    a group of 3 takes the 4-file rows."""
    cfg = CFG._replace(shifts=2)
    cache = STM.stream_graphs(CPU).stats
    real, rows = cache.fn, []

    def watched(audio, *rest):
        rows.append(audio.shape[0])
        return real(audio, *rest)

    monkeypatch.setattr(cache, "fn", watched)
    names = [files[k] for k in ("music", "music2", "gappy", "short")][:n]
    got = STM.wavfiles2hashes_streaming(names, cfg, SR, CPU, 300)
    assert all(not isinstance(g, Exception) for g in got)
    c = tracer.counters
    assert (c["stream.groups"], c["stream.group_files"]) == (1, n)
    assert set(rows) == {2 * (1 << (n - 1).bit_length())}


@pytest.mark.parametrize("limit", ["budget", "cache"])
def test_groups_split_where_the_budget_or_the_cache_ends(
        files, monkeypatch, tracer, limit):
    """Four files whose group of 4 would pass the graphs' budget, or the
    device cache of uploaded chunks, run as two groups of 2, each file's
    hashes as alone."""
    names = [files[k] for k in ("music", "music2", "gappy", "short")]
    want = [_alone(n, chunk=300) for n in names]
    Nc = ST.chunk_samples(300, CFG)
    if limit == "budget":
        monkeypatch.setattr(graphs, "budget_bytes",
                            lambda device: STM._chunk_bytes(2, Nc, CFG))
    else:
        # 2 chunks of 2 int16 rows: the longest file's 386 frames
        monkeypatch.setattr(STM._ChunkReader.__init__, "__defaults__",
                            (2 * 2 * Nc * 2,))
    tracer.reset()
    got = STM.wavfiles2hashes_streaming(names, CFG, SR, CPU, 300)
    c = tracer.counters
    assert (c["stream.groups"], c["stream.group_files"]) == (2, 4)
    for (h, dur), (wh, wdur) in zip(got, want):
        assert np.array_equal(h, wh) and dur == wdur


@pytest.mark.parametrize("where", ["open", "pass"])
def test_unreadable_file_is_reported_and_the_others_stored(
        files, tmp_path, monkeypatch, tracer, where):
    """A file that does not open is left out before the passes; one whose
    reads fail during the passes sends its group's files through one at
    a time.  cli._stream_chunk reports that file alone and returns the
    others' hashes, equal to each alone."""
    good = [files["music"], files["music2"]]
    if where == "open":
        bad = str(tmp_path / "notwav.wav")
        with open(bad, "wb") as fh:
            fh.write(b"RIFF\x00\x00not a wave file")
    else:
        bad = files["gappy"]
        real_open = STM.open_stream_source

        def opener(name, sr):
            src = real_open(name, sr)
            if name == bad:
                def boom(*_a):
                    raise OSError("read failed")
                src.read = src.read_i16 = boom
            return src

        monkeypatch.setattr(STM, "open_stream_source", opener)
    an = Analyzer(device="cpu", fail_on_error=False)
    an.stream_chunk_frames = 128
    lines: list = []
    ordered = [(good[0], "stream", None), (bad, "stream", None),
               ("x.afpt", "pre", None), (good[1], "stream", None)]
    out = cli._stream_chunk(an, lines.append, ordered)
    assert tracer.counters["stream.groups"] == (1 if where == "open" else 4)
    assert [(n, k) for n, k, _d in out] == [(n, k) for n, k, _d in ordered]
    assert out[1][2] is None and out[2][2] is None
    assert len(lines) == 1 and lines[0].startswith(f"Error reading {bad}: ")
    for (name, _k, d) in (out[0], out[3]):
        want, wdur = _alone(name)
        assert np.array_equal(d[0], want) and d[1] == wdur
    an.fail_on_error = True
    with pytest.raises((OSError, STM.StreamUnsupported)):
        cli._stream_chunk(an, lines.append, ordered)


def test_cli_device_store_group_equals_one_by_one(tmp_path):
    """`new --device-store --stream-above 10` over 4 long WAVs in one
    chunk (one group of 4) leaves the table, counts and lines of one file
    a chunk (4 groups of 1)."""
    rng = np.random.default_rng(8)
    wavs = []
    for i, dur in enumerate((12.0, 16.0, 11.0, 14.0)):
        wavs.append(str(tmp_path / f"long{i}.wav"))
        audio_write_wav(wavs[-1], synth_audio(rng, dur, n_tones=60), SR)
    got = {}
    for batch in (4, 1):
        db = str(tmp_path / f"b{batch}.pklz")
        metrics = str(tmp_path / f"b{batch}.json")
        opfile = tmp_path / f"b{batch}.txt"
        assert cli.main(["new", "-d", db, "-h", "16", "--device-store",
                         "--stream-above", "10", "--stream-chunk", "256",
                         "--batchsize", str(batch), "--json-metrics",
                         metrics, "-o", str(opfile), *wavs],
                        device="cpu") == 0
        with open(metrics) as f:
            c = json.load(f)["counters"]
        lines = [ln for ln in opfile.read_text().splitlines()
                 if not ln.startswith("Processed ")]
        got[batch] = (HashTable(db), lines,
                      (c["stream.groups"], c["stream.group_files"]))
    (t4, l4, c4), (t1, l1, c1) = got[4], got[1]
    assert c4 == (1, 4) and c1 == (4, 4)
    np.testing.assert_array_equal(t4.counts, t1.counts)
    np.testing.assert_array_equal(t4.table, t1.table)
    np.testing.assert_array_equal(t4.hashesperid, t1.hashesperid)
    assert t4.names == t1.names == wavs
    assert l4 == l1 and len(l4) == 4
    assert min(t4.hashesperid[:4]) > 100
    assert os.path.getsize(wavs[1]) > 16 * SR
