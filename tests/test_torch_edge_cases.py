"""tests/test_edge_cases.py's nine cases through the port on the CPU
(utils.audio, Analyzer, Matcher, HashTable), each compared with the JAX
package's result on the same input: decoded arrays equal, hash arrays
equal, rows equal.  WAV variants (8/16/24/32-bit, stereo), an empty DB and
an empty query, a merge of mismatched geometry, time wrap past maxtime,
empty / short / silent audio, and a truncated WAV."""

import wave

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audfprint_tpu.index.hash_table import HashTable as HTj  # noqa: E402
from audfprint_tpu.match.matcher import Matcher as Mj  # noqa: E402
from audfprint_tpu.models.analyzer import Analyzer as Aj  # noqa: E402
from audfprint_tpu.utils import audio as AIOj  # noqa: E402
from audfprint_torch.index.hash_table import HashTable  # noqa: E402
from audfprint_torch.match.matcher import Matcher  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from audfprint_torch.utils import audio as audio_io  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402
from tests.test_edge_cases import _write_wav  # noqa: E402

torch.set_num_threads(2)
SR = 11025


def _an():
    return Analyzer(device="cpu")


def _m(**kw):
    return Matcher(device="cpu", **kw)


@pytest.mark.parametrize("sampwidth,nch", [(1, 1), (2, 2), (3, 1), (4, 1)])
def test_wav_variants_decode(tmp_path, rng, sampwidth, nch):
    """Each width and channel count decodes to JAX's array on the Python
    and the native path, keeps the JAX test's bar, and fingerprints to
    JAX's hashes."""
    x = synth_audio(rng, dur_sec=1.5)
    p = str(tmp_path / f"v{sampwidth}_{nch}.wav")
    _write_wav(p, x, sampwidth, nch)
    d, sr = audio_io.audio_read(p, sr=SR)
    dj, _ = AIOj.audio_read(p, sr=SR)
    assert sr == SR and len(d) == len(x)
    assert d.dtype == dj.dtype and np.array_equal(d, dj)
    assert np.corrcoef(d, x)[0, 1] > 0.98
    nat = audio_io.read_wav_batch([p], sr=SR)
    natj = AIOj.read_wav_batch([p], sr=SR)
    assert (nat is None) == (natj is None)
    if nat is not None:
        assert (nat[0] is None) == (natj[0] is None)
        if nat[0] is not None:
            np.testing.assert_array_equal(nat[0], d)
            np.testing.assert_array_equal(nat[0], natj[0])
    h = _an().wavfile2hashes(p)
    assert len(h) > 10 and np.array_equal(h, Aj().wavfile2hashes(p))


def test_empty_db_match():
    """An empty table gives no rows, and so does an empty query against a
    populated one, in both packages and in a batch beside a real query."""
    q = np.stack([np.arange(20), np.arange(20) * 7], axis=1).astype(np.int32)
    empty = np.zeros((0, 2), np.int32)
    for HT, M in ((HashTable, _m), (HTj, Mj)):
        ht = HT(hashbits=12, depth=4, maxtime=1024)
        assert len(M().match_hashes(ht, q)) == 0
        ht.store("a", q)
        assert len(M().match_hashes(ht, empty)) == 0
    ht = HashTable(hashbits=12, depth=4, maxtime=1024)
    ht.store("a", q)
    htj = HTj(hashbits=12, depth=4, maxtime=1024)
    htj.store("a", q)
    got = _m().match_hashes_batch(ht, [empty, q, empty])
    want = Mj().match_hashes_batch(htj, [empty, q, empty])
    assert [len(r) for r in got] == [0, 1, 0]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_merge_geometry_mismatch_raises():
    a = HashTable(hashbits=12, depth=4, maxtime=1024)
    for other in (HashTable(hashbits=10, depth=4, maxtime=1024),
                  HashTable(hashbits=12, depth=8, maxtime=1024),
                  HashTable(hashbits=12, depth=4, maxtime=512)):
        with pytest.raises(ValueError):
            a.merge(other)
    assert a.totalhashes() == 0 and a.names == []


def test_time_wrap_still_matches(rng):
    """A 20 s track stored at maxtime=512 aliases mod 512; a clip from
    frame 600 matches at rank 0 at the wrapped offset 88, with JAX's hashes
    and rows."""
    maxtime = 512
    x = synth_audio(rng, dur_sec=20.0, n_tones=140)
    an = _an()
    h = an.samples2hashes(x)
    assert h[:, 0].max() > maxtime
    assert np.array_equal(h, Aj().samples2hashes(x))
    start = 256 * 600
    clip = x[start: start + 4 * SR].copy()
    qh = an.samples2hashes(clip)
    assert np.array_equal(qh, Aj().samples2hashes(clip))
    rows = {}
    for tag, HT, M in (("port", HashTable, _m), ("jax", HTj, Mj)):
        ht = HT(hashbits=16, depth=30, maxtime=maxtime)
        ht.store_vectorized("wrap", h)
        rows[tag] = M().match_hashes(ht, qh)
    assert np.array_equal(rows["port"], rows["jax"])
    r = rows["port"]
    assert len(r) == 1 and r[0][0] == 0
    assert abs(r[0][2] - (600 % maxtime)) <= 2


@pytest.mark.parametrize("n", [0, 100, SR], ids=["empty", "short", "silent"])
def test_analyzer_empty_and_short_audio(n):
    """0 samples, fewer than n_fft, and a second of digital silence give no
    hashes (the oracle passes raw zeros through), as in JAX."""
    x = np.zeros(n, np.float32)
    h = _an().samples2hashes(x)
    assert h.shape == (0, 2) and h.shape == Aj().samples2hashes(x).shape
    batch = _an().samples_batch2hashes([x, synth_audio(
        np.random.default_rng(3), dur_sec=2.0), x])
    assert [len(b) == 0 for b in batch] == [True, False, True]


def test_truncated_wav_tolerated(tmp_path):
    """A data chunk ending mid-sample decodes with the partial sample
    dropped on both read paths, to JAX's arrays; a missing file is a
    DecodeError on both."""
    rng = np.random.default_rng(30)
    x = (0.1 * rng.standard_normal(SR)).astype(np.float32)
    p = str(tmp_path / "t.wav")
    audio_io.audio_write_wav(p, x, SR)
    raw = open(p, "rb").read()
    pt = str(tmp_path / "trunc.wav")
    open(pt, "wb").write(raw[:-1])
    with wave.open(pt, "rb") as w:
        assert w.getsampwidth() == 2
    d, _ = audio_io.audio_read(pt, sr=SR)
    assert d.dtype == np.float32 and len(d) == SR - 1
    assert np.array_equal(d, AIOj.audio_read(pt, sr=SR)[0])
    d2, _ = audio_io.audio_read_staged(pt, sr=SR)
    assert d2.dtype == np.int16 and len(d2) == SR - 1
    assert np.array_equal(d2, AIOj.audio_read_staged(pt, sr=SR)[0])
    assert np.array_equal(_an().wavfile2hashes(pt), Aj().wavfile2hashes(pt))
    for fn in (audio_io.audio_read, audio_io.audio_read_staged):
        with pytest.raises(audio_io.DecodeError):
            fn(str(tmp_path / "missing.wav"), sr=SR)
