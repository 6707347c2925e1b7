"""audfprint_torch CLI on the CPU: the golden session byte for byte, the
port running without JAX in a fresh process, every JAX CLI flag accepted,
--ndev 8 (new, add, merge, newmerge, match) giving --ndev 1's lines and
databases, and long WAVs streaming."""

import functools
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from audfprint_tpu.utils.audio import audio_write_wav  # noqa: E402
from audfprint_torch import cli  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from tests import test_golden_cli as G  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_golden_cli_session_through_port(tmp_path, capsys, monkeypatch):
    """tests/test_golden_cli.py's session, every command routed to
    audfprint_torch.cli.main(..., device="cpu"), reproduces
    tests/golden/cli_session.txt byte for byte."""
    import audfprint_tpu.cli as jax_cli

    monkeypatch.setattr(jax_cli, "main",
                        functools.partial(cli.main, device="cpu"))
    out = G._session(str(tmp_path), lambda: capsys.readouterr().out)
    got = G._normalize(out, [tmp_path])
    with open(G.GOLDEN) as f:
        assert got == f.read(), "port CLI output drifted from the golden"


_NO_JAX_DRIVE = r"""
import importlib, pkgutil, sys
import audfprint_torch
for m in pkgutil.walk_packages(audfprint_torch.__path__, "audfprint_torch."):
    if m.name != "audfprint_torch.__main__":
        importlib.import_module(m.name)
from audfprint_torch.cli import main
d = sys.argv[1]
assert main(["new", "-d", d + "/db.pklz", "-h", "16", d + "/a.wav",
             d + "/b.wav"], device="cpu") == 0
assert main(["match", "-d", d + "/db.pklz", "-h", "16", d + "/q.wav"],
            device="cpu") == 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("NO_JAX_OK")
"""


def test_port_runs_without_jax(tmp_path):
    """A fresh process imports every module of the port and runs new +
    match on the CPU without ever importing jax."""
    rng = np.random.default_rng(3)
    a = synth_audio(rng, dur_sec=6.0, n_tones=40)
    b = synth_audio(rng, dur_sec=6.0, n_tones=40)
    audio_write_wav(str(tmp_path / "a.wav"), a, 11025)
    audio_write_wav(str(tmp_path / "b.wav"), b, 11025)
    audio_write_wav(str(tmp_path / "q.wav"), b[256 * 20: 256 * 20 + 33075],
                    11025)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_DRIVE, str(tmp_path)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert "b.wav at 0.5 s" in proc.stdout and "at rank 0" in proc.stdout


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    """Two 4 s songs in a -h 12 database, and a 3 s query of the second."""
    d = tmp_path_factory.mktemp("flags")
    rng = np.random.default_rng(12)
    songs = [synth_audio(rng, dur_sec=4.0, n_tones=40) for _ in range(2)]
    wavs = [str(d / f"s{i}.wav") for i in range(2)]
    for w, x in zip(wavs, songs):
        audio_write_wav(w, x, 11025)
    q = str(d / "q.wav")
    audio_write_wav(q, songs[1][256 * 10: 256 * 10 + 3 * 11025], 11025)
    db = str(d / "db.pklz")
    assert cli.main(["new", "-d", db, "-h", "12", "-o", str(d / "o.txt"),
                     *wavs], device="cpu") == 0
    return d, db, q


@pytest.mark.parametrize("extra", [
    ["warmup"], ["new", "--device-store", "--ndev", "2"],
    ["match", "--ndev", "2"],
    ["match", "--listen"], ["match", "--windowed", "5"],
    ["match", "--speed-sweep", "3"], ["match", "-I"],
    ["new", "--profile", "trace"]])
def test_once_refused_features_run(extra, small_db, capsys,
                                        monkeypatch):
    """Every flag of the JAX CLI, once refused here, now runs through the
    port: warmup, --listen, --windowed, --speed-sweep, -I, --profile, and
    --ndev 2 (a sharded device store whose database equals the host
    store's; a sharded match)."""
    d, db, q = small_db
    files = [q]
    if extra[:2] == ["new", "--device-store"]:
        from audfprint_tpu.index.hash_table import HashTable
        nd = str(d / "nd.pklz")
        assert cli.main(["new", "-d", nd, "-h", "12", *extra[1:],
                         str(d / "s0.wav"), str(d / "s1.wav")],
                        device="cpu") == 0
        a, b = HashTable(nd), HashTable(db)
        assert np.array_equal(a.table, b.table) and a.names == b.names
        assert np.array_equal(a.counts, b.counts)
        return
    if extra == ["warmup"]:
        extra, files = ["warmup", "--warm-durations", "3",
                        "--batchsize", "2"], []
    elif "--listen" in extra:
        monkeypatch.setattr("sys.stdin", io.StringIO(q + "\n"))
        files = []
    elif "--profile" in extra:
        extra = ["new", "--profile", str(d / "trace")]
        db = str(d / "prof.pklz")
        files = [str(d / "s0.wav")]
    argv = [extra[0], "-d", db, "-h", "12", *extra[1:], *files]
    if "-I" in extra:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    assert cli.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    if extra[0] == "warmup":
        assert "warmed 3 s bucket (batch sizes [1, 2])" in out
    elif extra[0] == "new":
        assert f"profiler trace written to {d / 'trace'}" in out
        assert os.listdir(d / "trace")
    else:
        assert re.search(r"Matched \S+q\.wav( t=0\.0s)? .* as \S+s1\.wav",
                         out), out
        if "-I" in extra:
            assert "matplotlib not available; skipping" in out


def test_wide_table_saves_uint64(tmp_path, capsys):
    """`new --idbits 24` (past 32 - maxtimebits) saves a wide database
    with uint64 entries, once refused here."""
    from audfprint_tpu.index.hash_table import HashTable

    wav = str(tmp_path / "a.wav")
    audio_write_wav(wav, synth_audio(np.random.default_rng(2), dur_sec=3.0),
                    11025)
    db = str(tmp_path / "db.pklz")
    assert cli.main(["new", "-d", db, "-h", "10", "--idbits", "24", wav],
                    device="cpu") == 0
    assert "Saved fprints for 1 files" in capsys.readouterr().out
    ht = HashTable(db)
    assert ht.wide and ht.idbits == 24 and ht.table.dtype == np.uint64
    assert ht.counts.sum() > 0


def test_long_wav_takes_streamed_route(tmp_path):
    """A WAV past stream_above_sec is no longer refused: it takes the
    streamed route, and an all-zero one yields no hashes."""
    path = str(tmp_path / "long.wav")
    audio_write_wav(path, np.zeros(3 * 11025, np.float32), 11025)
    an = Analyzer(device="cpu")
    an.stream_above_sec = 1.0
    assert an._should_stream(path)
    assert an.wavfile2hashes(path).shape == (0, 2)
    assert an.soundfiledur == 3.0


def test_analyzer_file_api_matches_jax(tmp_path):
    """glob2hashtable, wavfile2peaks and the .afpk branch of
    wavfile2hashes give the JAX Analyzer's results (host table arrays
    included)."""
    from audfprint_tpu.index.hash_table import HashTable
    from audfprint_tpu.models.analyzer import Analyzer as JaxAnalyzer
    from audfprint_tpu.utils import formats

    rng = np.random.default_rng(8)
    for i in range(2):
        audio_write_wav(str(tmp_path / f"s{i}.wav"),
                        synth_audio(rng, dur_sec=5.0, n_tones=30), 11025)
    ja, ta = JaxAnalyzer(), Analyzer(device="cpu")
    pattern = str(tmp_path / "s*.wav")
    hj = ja.glob2hashtable(pattern, HashTable(hashbits=14, depth=20))
    ht = ta.glob2hashtable(pattern, HashTable(hashbits=14, depth=20))
    assert ht.names == hj.names
    assert np.array_equal(ht.table, hj.table)
    assert np.array_equal(ht.counts, hj.counts)
    wav = str(tmp_path / "s1.wav")
    peaks = ta.wavfile2peaks(wav)
    assert peaks == ja.wavfile2peaks(wav) and len(peaks) > 20
    afpk = str(tmp_path / "s1.afpk")
    formats.peaks_save(afpk, peaks)
    assert np.array_equal(ta.wavfile2hashes(afpk), ja.wavfile2hashes(afpk))
    assert ta.soundfiledur == ja.soundfiledur


def test_matcher_helpers_match_jax():
    from audfprint_tpu.match import matcher as Mj
    from audfprint_torch.match import matcher as M

    assert M.sweep_factors(3.4) == Mj.sweep_factors(3.4)
    h = np.stack([np.arange(0, 900, 3), np.arange(300) * 7], axis=1)
    want = Mj.slice_hash_windows(h, 21.0, 5.0, 11025 / 256, 2.0)
    got = M.slice_hash_windows(h, 21.0, 5.0, 11025 / 256, 2.0)
    assert len(got) == len(want) > 3
    for (t0, s, d), (t0w, sw, dw) in zip(got, want):
        assert (t0, d) == (t0w, dw) and np.array_equal(s, sw)


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if not ln.startswith("Processed ")]


def test_cli_ndev_equals_single_device(tmp_path, capsys):
    """new, add, merge, newmerge and match (plain and -R -X) with --ndev 8
    print --ndev 1's lines and save its databases, bucket overflow
    included (-h 6 -b 2); --json-metrics records the kernels' counts."""
    from audfprint_tpu.index.hash_table import HashTable

    rng = np.random.default_rng(30)
    wavs = []
    for i in range(4):
        x = synth_audio(rng, dur_sec=4.0, n_tones=40)
        wavs.append(str(tmp_path / f"s{i}.wav"))
        audio_write_wav(wavs[-1], x, 11025)
        if i == 1:
            audio_write_wav(str(tmp_path / "q.wav"),
                            x[256 * 20: 256 * 20 + 2 * 11025], 11025)
    common = ["-h", "6", "-b", "2", "-t", "4096", "-N", "2"]
    q = str(tmp_path / "q.wav")
    out = {}
    for n in (1, 8):
        def db(k):
            return str(tmp_path / f"{k}.n{n}.pklz")
        nd = ["--ndev", str(n), *common]
        capsys.readouterr()
        for argv in (["new", "-d", db("a"), *nd, "--json-metrics",
                      str(tmp_path / f"m{n}.json"), *wavs[:2]],
                     ["add", "-d", db("a"), *nd, wavs[2]],
                     ["new", "-d", db("b"), *nd, wavs[3], wavs[0]],
                     ["merge", "-d", db("a"), *nd, db("b")],
                     ["newmerge", "-d", db("c"), *nd, db("a"), db("b")],
                     ["match", "-d", db("a"), *nd, q],
                     ["match", "-d", db("c"), *nd, "-R", "-X", "-x", "3", q]):
            assert cli.main(argv, device="cpu") == 0
        out[n] = [ln.replace(f".n{n}.", ".n.") for ln in _lines(capsys)]
    assert out[1] == out[8]
    assert any(re.search(r"Matched \S+q\.wav .* as \S+s1\.wav .* rank 0", ln)
               for ln in out[8])
    for k in "abc":
        a, b = (HashTable(str(tmp_path / f"{k}.n{n}.pklz")) for n in (1, 8))
        assert np.array_equal(a.table, b.table), k
        assert np.array_equal(a.counts, b.counts), k
        assert np.array_equal(a.hashesperid, b.hashesperid), k
        assert a.names == b.names
    assert int(HashTable(str(tmp_path / "c.n8.pklz")).counts.max()) > 2
    import json
    with open(tmp_path / "m8.json") as f:
        assert set(json.load(f)["kernel_launches"]) >= {
            "hpf_scan", "prune_fwd_bwd", "pair_scan"}


def test_cli_ndev_not_divisible_notes_and_falls_back(tmp_path, capsys):
    """--ndev 3 does not divide a 2^12 table: new and merge say so and use
    the host paths, match says so once and matches on one device."""
    rng = np.random.default_rng(31)
    x = synth_audio(rng, dur_sec=4.0, n_tones=40)
    wav, q = str(tmp_path / "s.wav"), str(tmp_path / "q.wav")
    audio_write_wav(wav, x, 11025)
    audio_write_wav(q, x[256 * 20: 256 * 20 + 2 * 11025], 11025)
    db, db2 = str(tmp_path / "a.pklz"), str(tmp_path / "b.pklz")
    common = ["-h", "12", "--ndev", "3"]
    assert cli.main(["new", "-d", db, *common, wav], device="cpu") == 0
    assert ("Note: hashbits=12 table not divisible over 3 devices; using "
            "host store") in capsys.readouterr().out
    assert cli.main(["newmerge", "-d", db2, *common, db], device="cpu") == 0
    assert "not divisible over 3 devices; using host merge" in \
        capsys.readouterr().out
    assert cli.main(["match", "-d", db, *common, q, q], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("matching single-device") == 1
    assert out.count("at rank 0") == 2
