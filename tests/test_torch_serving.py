"""audfprint_torch serving modes against the JAX package on the CPU:
`match --windowed` (broadcast monitoring), `--speed-sweep`, `--listen`,
`warmup`, `--profile`, `-I`/`-J`/`--sonify` and the analyzer presets.

Matcher.match_hashes_windowed and match_samples_sweep equal JAX's rows
bit for bit on the same hashes; the CLI prints the JAX CLI's lines with
only timings masked; the sonify WAV equals JAX's byte for byte."""

import glob
import io
import json
import os
import re
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audfprint_tpu import cli as jcli  # noqa: E402
from audfprint_tpu.index.hash_table import HashTable  # noqa: E402
from audfprint_tpu.match import matcher as Mj  # noqa: E402
from audfprint_tpu.models import presets as PRj  # noqa: E402
from audfprint_tpu.models.analyzer import Analyzer as JaxAnalyzer  # noqa: E402
from audfprint_tpu.utils.audio import (_resample, audio_read,  # noqa: E402
                                       audio_write_wav)
from audfprint_torch import cli  # noqa: E402
from audfprint_torch.match.matcher import Matcher  # noqa: E402
from audfprint_torch.models import presets as PR  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)
SR = 11025
COMMON = ["-h", "16", "-b", "20", "-t", "4096"]


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """tests/test_cli.py's fixture audio (three 6 s tracks, a noisy 3 s
    query of track1, a noise query), a +4% speed-changed copy of the
    query, a 12 s broadcast recording (track0, dead air, track2) and the
    database of the three tracks."""
    rng = np.random.default_rng(99)
    d = tmp_path_factory.mktemp("serving")
    tracks = []
    for i in range(3):
        x = synth_audio(rng, dur_sec=6.0, n_tones=50)
        audio_write_wav(str(d / f"track{i}.wav"), x, SR)
        tracks.append(x)
    q = tracks[1][2 * SR: 5 * SR] + 0.02 * rng.standard_normal(
        3 * SR).astype(np.float32)
    audio_write_wav(str(d / "query.wav"), q * 0.7, SR)
    audio_write_wav(str(d / "noise.wav"), 0.1 * rng.standard_normal(3 * SR),
                    SR)
    clip, _ = audio_read(str(d / "query.wav"), sr=SR)
    audio_write_wav(str(d / "sped.wav"), _resample(clip, 104, 100), SR)
    rec = np.concatenate([
        tracks[0][: 4 * SR],
        0.01 * np.random.default_rng(5).standard_normal(4 * SR).astype(
            np.float32),
        tracks[2][SR: 5 * SR]])
    audio_write_wav(str(d / "broadcast.wav"), rec, SR)
    db = str(d / "db.pklz")
    assert cli.main(["new", "-d", db, *COMMON, "-o", str(d / "new.out"),
                     *(str(d / f"track{i}.wav") for i in range(3))],
                    device="cpu") == 0
    return SimpleNamespace(
        dir=str(d), db=db, query=str(d / "query.wav"),
        noise=str(d / "noise.wav"), sped=str(d / "sped.wav"),
        broadcast=str(d / "broadcast.wav"))


def _port_main(argv):
    return cli.main(argv, device="cpu")


def _run(main, argv, capsys, fx):
    """stdout of one CLI command, paths and timings masked."""
    capsys.readouterr()
    assert main([str(a) for a in argv]) == 0
    out = capsys.readouterr().out.replace(fx.dir + os.sep, "<DIR>/")
    out = re.sub(r"in \d+\.\d s sec = \d+\.\d+ x RT",
                 "in <T> s sec = <R> x RT", out)
    return re.sub(r"compiled/cached in \d+\.\d s",
                  "compiled/cached in <T> s", out)


def _results(out: str) -> list:
    return [ln for ln in out.splitlines()
            if ln.startswith(("Matched", "NOMATCH"))]


# -- library: windowed and sweep rows ----------------------------------------

def test_match_hashes_windowed_matches_jax(fx):
    an = Analyzer(device="cpu")
    h = an.wavfile2hashes(fx.broadcast)
    dur = an.soundfiledur
    ht = HashTable(fx.db)
    fps = SR / 256.0
    want = Mj.Matcher().match_hashes_windowed(ht, h, dur, 4.0, fps, 2.0)
    got = Matcher(device="cpu").match_hashes_windowed(ht, h, dur, 4.0, fps,
                                                      2.0)
    assert len(got) == len(want) == 5
    for (t0, rows, n, wd), (t0w, rows_w, nw, wdw) in zip(got, want):
        assert (t0, n, wd) == (t0w, nw, wdw)
        np.testing.assert_array_equal(rows, rows_w)
    assert got[0][1][0][0] == 0 and got[-1][1][0][0] == 2


class _StubAnalyzer:
    """Hands both matchers the same hashes for the same samples: each
    distinct signal is fingerprinted once, by the port's analyzer."""

    def __init__(self):
        self.an = Analyzer(device="cpu")
        self.memo = {}

    def samples_batch2hashes(self, sigs):
        out = []
        for s in sigs:
            key = (s.dtype.str, s.tobytes())
            if key not in self.memo:
                self.memo[key] = self.an.samples_batch2hashes([s])[0]
            out.append(self.memo[key])
        return out


def test_match_samples_sweep_matches_jax_on_same_hashes(fx):
    """Rows, winning factor and hash count equal JAX's for an int16 query,
    a +4% query and a base-hashes-only entry (None samples)."""
    q16 = np.fromfile(fx.query, np.int16)[22:]       # the raw PCM
    sped, _ = audio_read(fx.sped, sr=SR)
    ht = HashTable(fx.db)
    stub = _StubAnalyzer()
    samples = [q16, sped, None]
    want = Mj.Matcher().match_samples_sweep(stub, ht, samples, 4.0)
    got = Matcher(device="cpu").match_samples_sweep(stub, ht, samples, 4.0)
    assert len(got) == len(want) == 3
    for (rr, f, nh), (rw, fw, nw) in zip(got, want):
        np.testing.assert_array_equal(rr, rw)
        assert (f, nh) == (fw, nw)
    assert got[1][1] != 1.0 and got[2][2] == 0
    # 2 queries x 8 variants fingerprinted once each, plus the bases
    assert len(stub.memo) == 2 + 2 * 8


def test_speed_sweep_end_to_end_matches_jax(fx):
    """Each package's own analyzer and matcher: the +4% query wins at the
    same factor with the same rank-0 id."""
    sped, _ = audio_read(fx.sped, sr=SR)
    ht = HashTable(fx.db)
    (rw, fw, _), = Mj.Matcher().match_samples_sweep(JaxAnalyzer(), ht,
                                                    [sped], 4.0)
    (rr, f, _), = Matcher(device="cpu").match_samples_sweep(
        Analyzer(device="cpu"), ht, [sped], 4.0)
    assert f == fw != 1.0
    assert len(rr) and int(rr[0][0]) == int(rw[0][0]) == 1


# -- CLI: the JAX CLI's lines -------------------------------------------------

@pytest.mark.parametrize("mode", ["speed-sweep", "windowed", "listen",
                                  "warmup"])
def test_cli_serving_lines_match_jax(mode, fx, capsys, monkeypatch):
    stdin = None
    if mode == "speed-sweep":
        argv = ["match", "-d", fx.db, *COMMON, "--speed-sweep", "4",
                fx.sped, fx.query, fx.noise]
    elif mode == "windowed":
        argv = ["match", "-d", fx.db, *COMMON, "--windowed", "4",
                "--window-hop", "2", fx.broadcast]
    elif mode == "listen":
        argv = ["match", "-d", fx.db, *COMMON, "--listen"]
        stdin = f"{fx.query}\n\n{fx.noise}\n{fx.sped}\n"
    else:
        argv = ["warmup", "-d", fx.db, *COMMON, "--warm-durations", "3",
                "--batchsize", "2"]
    outs = []
    for main in (jcli.main, _port_main):
        if stdin is not None:
            monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        outs.append(_run(main, argv, capsys, fx))
    want, got = outs
    assert got == want
    if mode == "speed-sweep":
        assert re.search(r"sped\.wav .* as <DIR>/track1\.wav .* rank 0 "
                         r"\(speed \+4%\)", got), got
        assert "NOMATCH <DIR>/noise.wav" in got
    elif mode == "windowed":
        lines = _results(got)
        assert len(lines) == 5
        assert "t=0.0s" in lines[0] and "track0.wav" in lines[0]
        assert "t=8.0s" in lines[4] and "track2.wav" in lines[4]
        assert "Processed 1 files (12.0 s total dur)" in got
    elif mode == "listen":
        assert len(_results(got)) == 3
        assert "Processed 3 files (8.9 s total dur)" in got
    else:
        assert "warmed 3 s bucket (batch sizes [1, 2])" in got
        assert re.search(r"warmup: \d+ serving graphs compiled/cached in "
                         r"<T> s", got)


@pytest.mark.parametrize("argv", [
    ["match", "--windowed", "4", "--speed-sweep", "2"], ["warmup"]])
def test_cli_refuses_like_jax(argv, fx, capsys):
    """--windowed with --speed-sweep, and warmup without --dbase, exit 2
    with the JAX CLI's message."""
    if argv[0] == "match":
        argv = argv[:1] + ["-d", fx.db] + argv[1:] + [fx.broadcast]
    assert jcli.main(argv) == 2
    want = capsys.readouterr().err
    assert _port_main(argv) == 2
    assert capsys.readouterr().err == want and want


# -- the listen loop (ports of tests/test_cli.py's listen tests) -----------

def test_listen_reports_bad_request_and_serves_on(fx, capsys):
    """A missing file is reported and the next request still serves;
    fail_on_error is restored after the loop."""
    args = cli.make_parser().parse_intermixed_args(
        ["match", "-d", fx.db, *COMMON, "--listen"])
    an = cli.setup_analyzer(args, "cpu")
    assert an.fail_on_error
    lines = []
    n, dur = cli.do_listen(
        HashTable(fx.db), an, cli.setup_matcher(args, "cpu"), args,
        lines.append, cli.Stages(), None,
        stream=io.StringIO(f"{fx.dir}/nope.wav\n{fx.query}\n"))
    assert an.fail_on_error
    assert (n, dur) == (1, 3.0)
    assert lines[0].startswith(f"Error reading {fx.dir}/nope.wav")
    assert lines[1].startswith(f"Matched {fx.query} ")


def test_listen_mixed_inputs_keep_input_order(fx, tmp_path, capsys,
                                              monkeypatch):
    """A backlog interleaving precomputed .afpt inputs with WAVs emits
    every result in input order, equal to batch mode."""
    pre = str(tmp_path / "pre")
    assert _port_main(["precompute", "-p", pre, *COMMON, fx.query]) == 0
    afpt = glob.glob(os.path.join(pre, "**", "query.afpt"),
                     recursive=True)[0]
    queries = [fx.query, afpt, fx.noise, afpt, fx.query, afpt, fx.noise]
    batch = _run(_port_main, ["match", "-d", fx.db, *COMMON, *queries],
                 capsys, fx)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(q + "\n" for q in queries)))
    served = _run(_port_main, ["match", "-d", fx.db, *COMMON, "--listen"],
                  capsys, fx)
    got = _results(served)
    assert got == _results(batch) and len(got) == len(queries)
    for ln, q in zip(got, queries):
        assert q.replace(fx.dir + os.sep, "<DIR>/") in ln


def test_listen_opfile_flushes_per_query(fx, tmp_path, monkeypatch):
    """With -o, an interactive caller (write a path, wait for its result,
    write the next) sees each answer in the opfile before it sends the
    next request: the drain serves an empty backlog at once."""
    opfile = tmp_path / "served.txt"

    class Interactive(io.StringIO):
        sent = 0

        def __iter__(self):
            return self

        def __next__(self):
            deadline = time.time() + 120
            while self.sent > 0:
                txt = opfile.read_text() if opfile.exists() else ""
                if txt.count("Matched") >= self.sent:
                    break
                assert time.time() < deadline, "serving loop stalled"
                time.sleep(0.01)
            line = self.readline()
            if not line:
                raise StopIteration
            self.sent += 1
            return line

    monkeypatch.setattr("sys.stdin", Interactive(f"{fx.query}\n" * 3))
    assert _port_main(["match", "-d", fx.db, *COMMON, "-o", str(opfile),
                       "--listen"]) == 0
    assert opfile.read_text().count("Matched") == 3


def test_listen_batches_backlog(fx, capsys, monkeypatch):
    """A backlogged stdin is served in fewer do_match calls than queries,
    in input order."""
    queries = [fx.query, fx.noise, fx.query, fx.query, fx.noise, fx.query]
    calls = []
    real = cli.do_match

    def probe(ht, analyzer, matcher, names, *a, **kw):
        if not calls:
            time.sleep(0.05)     # let the reader thread queue the backlog
        calls.append(list(names))
        return real(ht, analyzer, matcher, names, *a, **kw)

    monkeypatch.setattr(cli, "do_match", probe)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(q + "\n" for q in queries)))
    served = _run(_port_main, ["match", "-d", fx.db, *COMMON, "--listen"],
                  capsys, fx)
    assert [n for c in calls for n in c] == queries
    assert len(calls) <= 3, calls
    assert len(_results(served)) == len(queries)


# -- diagnostics and --profile -----------------------------------------------

def test_sonify_wav_equals_jax(fx, tmp_path):
    ht = HashTable(fx.db)
    want = Mj.Matcher().sonify_match(JaxAnalyzer(), ht, fx.query,
                                     out_wav=str(tmp_path / "jax.wav"))
    got = Matcher(device="cpu").sonify_match(
        Analyzer(device="cpu"), ht, fx.query,
        out_wav=str(tmp_path / "port.wav"))
    with open(want, "rb") as a, open(got, "rb") as b:
        data = b.read()
        assert data == a.read() and len(data) > 44 + 2 * 3 * SR - 4


def test_cli_sonify_writes_wav(fx, tmp_path, capsys):
    q = str(tmp_path / "q.wav")
    with open(fx.query, "rb") as src, open(q, "wb") as dst:
        dst.write(src.read())
    out = _run(_port_main, ["match", "-d", fx.db, *COMMON, "--sonify", q],
               capsys, fx)
    assert f"sonify_match: wrote {q}.sonify.wav" in out
    assert os.path.getsize(q + ".sonify.wav") > 44


def test_illustrate_without_matplotlib_skips(fx, capsys, monkeypatch):
    """-I on a machine without matplotlib prints the JAX package's skip
    line, and matching goes on."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = _run(_port_main, ["match", "-d", fx.db, *COMMON, "-I", fx.query],
               capsys, fx)
    assert "illustrate_match: matplotlib not available; skipping" in out
    assert "Matched <DIR>/query.wav" in out


def test_illustrate_i_and_j_write_different_pngs(fx, tmp_path):
    pytest.importorskip("matplotlib")
    ht = HashTable(fx.db)
    an = Analyzer(device="cpu")
    m = Matcher(device="cpu")
    plain = m.illustrate_match(an, ht, fx.query, show=False, hpf=False,
                               out_png=str(tmp_path / "i.png"))
    hpf = m.illustrate_match(an, ht, fx.query, show=False, hpf=True,
                             out_png=str(tmp_path / "j.png"))
    jax_png = Mj.Matcher().illustrate_match(
        JaxAnalyzer(), ht, fx.query, show=False, hpf=False,
        out_png=str(tmp_path / "jax_i.png"))
    with open(plain, "rb") as a, open(hpf, "rb") as b, \
            open(jax_png, "rb") as c:
        pa, pb, pc = a.read(), b.read(), c.read()
    assert pa[:8] == b"\x89PNG\r\n\x1a\n" and pa != pb
    assert pa == pc


def test_cli_profile_writes_trace(fx, tmp_path, capsys):
    prof = str(tmp_path / "prof")
    out = _run(_port_main, ["match", "-d", fx.db, *COMMON, "--profile", prof,
                            fx.query], capsys, fx)
    assert f"profiler trace written to {prof}" in out
    assert "Matched <DIR>/query.wav" in out
    traces = glob.glob(os.path.join(prof, "*.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) > 10


@pytest.mark.parametrize("preset", sorted(PRj.PRESETS))
def test_presets_match_jax(preset):
    assert PR.PRESETS[preset] == PRj.PRESETS[preset]
    an = PR.make_analyzer(preset, device="cpu")
    assert an.params_dict() == PRj.make_analyzer(preset).params_dict()
    assert an.device.type == "cpu"
    if preset == "noisy-query":
        assert (an.density, an.shifts) == (40.0, 4)


def test_presets_override_and_unknown():
    an = PR.make_analyzer("noisy-query", device="cpu", density=30.0)
    assert (an.density, an.shifts) == (30.0, 4)
    with pytest.raises(KeyError, match="unknown preset"):
        PR.make_analyzer("nope", device="cpu")


# -- on the card -----------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sweep_and_windows_on_card_equal_cpu(cuda_device, fx):
    sped, _ = audio_read(fx.sped, sr=SR)
    ht = HashTable(fx.db)
    got = Matcher(device=cuda_device).match_samples_sweep(
        Analyzer(device=cuda_device), ht, [sped], 4.0)
    want = Matcher(device="cpu").match_samples_sweep(
        Analyzer(device="cpu"), ht, [sped], 4.0)
    np.testing.assert_array_equal(got[0][0], want[0][0])
    assert got[0][1:] == want[0][1:]
