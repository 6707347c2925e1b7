"""The JAX package's behavioural contract held against the port on the CPU:
the duplicate-heavy store and match of tests/test_fuzz_compat.py, the
.afdb cycle of tests/test_afdb.py through the port's CLI, the upstream
.pklz interchange and the vectorised merge and remove of
tests/test_upstream_pklz.py, the fake-ffmpeg plumbing of
tests/test_ffmpeg_path.py, and the native loader cases of
tests/test_native.py.  Each scenario runs both packages on the same numpy
inputs and compares exactly where the JAX test does."""

import gzip
import hashlib
import os
import pickle
import re
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from audfprint_tpu import params as Pj  # noqa: E402
from audfprint_tpu.index import device_table as DTj  # noqa: E402
from audfprint_tpu.index.hash_table import HashTable as HTj  # noqa: E402
from audfprint_tpu.match import voting as Vj  # noqa: E402
from audfprint_tpu.oracle import match as OMj  # noqa: E402
from audfprint_tpu.utils import audio as AIOj  # noqa: E402
from audfprint_torch import params as P  # noqa: E402
from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.index.hash_table import (  # noqa: E402
    AFDB_MAGIC, UPSTREAM_HT_VERSION, UPSTREAM_OLD_COMPAT, HashTable)
from audfprint_torch.match import voting  # noqa: E402
from audfprint_torch.oracle import match as om  # noqa: E402
from audfprint_torch.utils import audio as audio_io  # noqa: E402
from audfprint_torch.utils import native  # noqa: E402
from tests import test_ffmpeg_path as FF  # noqa: E402
from tests import test_native as NAT  # noqa: E402
from tests import test_upstream_pklz as UP  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)
SR = 11025


# ---- duplicate-heavy store and match (tests/test_fuzz_compat.py) ---------

def _dup_streams(rng):
    return [np.stack([rng.integers(0, 64, 300), rng.integers(0, 16, 300)],
                     axis=1).astype(np.int32) for _ in range(4)]


@pytest.mark.parametrize("core", ["sorted", "hist"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_duplicate_heavy_store_and_match(seed, core):
    """A hashbits=8, depth=4, maxtimebits=8 table where every bucket
    overflows its reservoir: DT.store_batch equals the host HashTable (the
    port's and JAX's), and voting.match_batch (the sorted core) or
    match_batch_packed(core="hist") equals oracle.match.match_hashes, and
    JAX's rows, in all 8 combinations of exact x time range x sort by
    time."""
    rng = np.random.default_rng(seed)
    tcfg = DT.TableConfig(hashbits=8, depth=4, maxtimebits=8)
    tcj = DTj.TableConfig(hashbits=8, depth=4, maxtimebits=8)
    ht = HashTable(hashbits=8, depth=4, maxtime=256)
    htj = HTj(hashbits=8, depth=4, maxtime=256)
    streams = _dup_streams(rng)
    for i, pairs in enumerate(streams):
        ht.store(f"t{i}", pairs)
        htj.store(f"t{i}", pairs)
    assert int(ht.counts.max()) > 4 * ht.depth
    table, counts = DT.empty_table(tcfg, "cpu")
    tt = torch.as_tensor(np.stack([s[:, 0] for s in streams]))
    hh = torch.as_tensor(np.stack([s[:, 1] for s in streams]))
    DT.store_batch(table, counts, tt, hh, torch.ones((4, 300), dtype=bool),
                   torch.arange(4, dtype=torch.int32), tcfg)
    assert np.array_equal(table.numpy().view(np.uint32), ht.table)
    assert np.array_equal(counts.numpy(), ht.counts)
    assert np.array_equal(ht.table, htj.table)

    q = np.unique(np.stack([rng.integers(0, 32, 60),
                            rng.integers(0, 16, 60)], axis=1).astype(
        np.int32), axis=0)
    Q = 64
    qt, qh, qv = (np.zeros((1, Q), np.int32), np.zeros((1, Q), np.int32),
                  np.zeros((1, Q), bool))
    qt[0, :len(q)], qh[0, :len(q)], qv[0, :len(q)] = q[:, 0], q[:, 1], True
    hpi = np.zeros(16, np.int32)
    hpi[:4] = ht.hashesperid
    args = [torch.as_tensor(a) for a in (hpi, qt, qh, qv)]
    tj, cj = DTj.table_to_device(htj)[:2]
    n_rows = 0
    for exact in (False, True):
        for timerange in (False, True):
            for sbt in (False, True):
                mp = P.MatcherParams(search_depth=8, max_returns=4,
                                     threshcount=1, exact_count=exact,
                                     find_time_range=timerange,
                                     sort_by_time=sbt)
                want = om.match_hashes(ht, q, mp)
                assert np.array_equal(want, OMj.match_hashes(
                    htj, q, Pj.MatcherParams(**vars(mp))))
                mcfg = voting.MatchConfig.from_params(mp, qt_cap=64,
                                                      n_ids_cap=16)
                if core == "sorted":
                    out = voting.match_batch(table, counts, *args, tcfg,
                                             mcfg)
                    n = int(out["n_results"][0])
                    got = np.stack([out[k][0].numpy() for k in (
                        "ids", "filtcount", "mode_dt", "rawcount", "min_t",
                        "max_t")], axis=1)[:n]
                    outj = Vj.match_batch(
                        tj, cj, *[jnp.asarray(a) for a in (hpi, qt, qh, qv)],
                        tcj, Vj.MatchConfig(*mcfg))
                    for k in outj:
                        assert np.array_equal(out[k].numpy(),
                                              np.asarray(outj[k])), k
                else:
                    packed = voting.match_batch_packed(
                        table, counts, *args, tcfg, mcfg, core="hist")
                    n = int(packed[0, :, 6].sum())
                    got = packed[0, :n, :6].numpy()
                assert np.array_equal(got, want), \
                    f"seed {seed} exact={exact} tr={timerange} sbt={sbt}"
                n_rows += n
    assert n_rows > 8


# ---- the .afdb cycle (tests/test_afdb.py) ---------------------------------

def _small_ht(cls, n_tracks=5, n=60, seed=3):
    rng = np.random.default_rng(seed)
    ht = cls(hashbits=12, depth=6, maxtime=1024)
    for i in range(n_tracks):
        ht.store_vectorized(f"t{i}", np.stack(
            [np.sort(rng.integers(0, 1024, n)).astype(np.int32),
             rng.integers(0, 1 << 12, n).astype(np.int32)], axis=1))
    ht.params.update({"density": 20.0, "samplerate": 11025})
    return ht


@pytest.mark.parametrize("writer, reader", [(HashTable, HTj),
                                            (HTj, HashTable)],
                         ids=["port-to-jax", "jax-to-port"])
def test_afdb_roundtrip_across_packages(tmp_path, writer, reader):
    """An .afdb written by one package loads in the other (magic sniffed,
    under a .pklz name too) with equal arrays, names, params and geometry,
    and get_hits agrees with the .pklz load."""
    ht = _small_ht(writer)
    p, pz = str(tmp_path / "db.afdb"), str(tmp_path / "db.pklz")
    ht.save(p)
    assert open(p, "rb").read(8) == AFDB_MAGIC
    ht.save(pz)
    sniffed = str(tmp_path / "actually_afdb.pklz")
    ht._save_afdb(sniffed)
    for path in (p, sniffed):
        back = reader(path)
        assert np.array_equal(np.asarray(back.table), ht.table)
        assert np.array_equal(np.asarray(back.counts), ht.counts)
        assert back.names == ht.names and back.params["density"] == 20.0
        assert np.array_equal(back.hashesperid, ht.hashesperid)
        assert (back.hashbits, back.depth, back.maxtime) == (
            ht.hashbits, ht.depth, ht.maxtime)
    filled = np.nonzero(ht.counts)[0][:20]
    q = np.stack([np.zeros(len(filled), np.int64), filled], axis=1)
    assert np.array_equal(reader(p).get_hits(q), reader(pz).get_hits(q))


def test_afdb_mutation_after_load_and_resave(tmp_path):
    """The port's copy-on-write memmap: store and remove after load leave
    the file alone, a re-save over the backing file keeps the live maps
    readable, and the results equal JAX's on the same edits."""
    tabs = {}
    for tag, cls in (("port", HashTable), ("jax", HTj)):
        d = tmp_path / tag
        d.mkdir()
        p = str(d / "db.afdb")
        _small_ht(cls).save(p)
        digest0 = hashlib.sha256(open(p, "rb").read()).hexdigest()
        back = cls(p)
        rng = np.random.default_rng(7)
        back.store_vectorized("extra", np.stack(
            [np.sort(rng.integers(0, 1024, 40)).astype(np.int32),
             rng.integers(0, 1 << 12, 40).astype(np.int32)], axis=1))
        back.remove("t0")
        assert hashlib.sha256(open(p, "rb").read()).hexdigest() == digest0
        back.save(p)                         # over the backing file
        assert int(np.asarray(back.counts).sum()) > 0
        again = cls(p)
        assert again.names == back.names
        tabs[tag] = again
    assert np.array_equal(np.asarray(tabs["port"].table),
                          np.asarray(tabs["jax"].table))
    assert tabs["port"].names == tabs["jax"].names


def test_afdb_name_index_and_duplicates(tmp_path):
    """load() rebuilds the name index at an equal names-list length, and
    a duplicate name after merge resolves to the first id and is removed
    first, as in the JAX package."""
    rng = np.random.default_rng(51)

    def pairs(n=20):
        return np.stack([rng.integers(0, 256, n),
                         rng.integers(0, 1 << 10, n)], axis=1)

    other = HashTable(hashbits=10, depth=4, maxtime=256)
    for n in ("C.wav", "D.wav"):
        other.store_vectorized(n, pairs())
    path = str(tmp_path / "other.pklz")
    other.save(path)
    ht = HashTable(hashbits=10, depth=4, maxtime=256)
    for n in ("A.wav", "B.wav"):
        ht.store_vectorized(n, pairs())
    assert ht.name_to_id("A.wav") == 0
    ht.load(path)
    assert ht.name_to_id("C.wav") == 0
    ht.store_vectorized("C.wav", pairs(10))
    assert ht.names == ["C.wav", "D.wav"] and ht.hashesperid[0] == 30
    with pytest.raises(ValueError):
        ht.name_to_id("A.wav")
    a = HashTable(hashbits=10, depth=4, maxtime=256)
    b = HashTable(hashbits=10, depth=4, maxtime=256)
    a.store_vectorized("shared.wav", pairs())
    b.store_vectorized("shared.wav", pairs())
    a.merge(b)
    assert a.name_to_id("shared.wav") == 0
    a.remove("shared.wav")
    assert a.names[0] is None and a.name_to_id("shared.wav") == 1


def _mask(out: str, d) -> str:
    out = out.replace(str(d) + os.sep, "<DIR>/")
    out = re.sub(r"\d+\.\d+ s", "<T> s", out)
    return re.sub(r"\d+\.\d+ x RT", "<R> x RT", out)


def test_afdb_cli_cycle_matches_jax(tmp_path, capsys):
    """new -> .afdb -> add over the backing file -> match through the
    port's CLI prints the JAX CLI's lines, and the two .afdb files hold
    equal tables."""
    from audfprint_torch import cli
    from audfprint_tpu import cli as jcli

    rng = np.random.default_rng(99)
    tracks = []
    for i in range(3):
        tracks.append(synth_audio(rng, dur_sec=6.0, n_tones=50))
        audio_io.audio_write_wav(str(tmp_path / f"track{i}.wav"),
                                 tracks[-1], SR)
    q = tracks[2][2 * SR: 5 * SR] + 0.02 * rng.standard_normal(
        3 * SR).astype(np.float32)
    audio_io.audio_write_wav(str(tmp_path / "query.wav"), q * 0.7, SR)
    small = ["-h", "16", "-b", "20", "-t", "4096"]
    wav = [str(tmp_path / f"track{i}.wav") for i in range(3)]
    outs = {}
    for tag, main in (("port", lambda a: cli.main(a, device="cpu")),
                      ("jax", jcli.main)):
        db = str(tmp_path / f"{tag}.afdb")
        capsys.readouterr()
        assert main(["new", "-d", db, *small, *wav[:2]]) in (0, None)
        assert open(db, "rb").read(8) == AFDB_MAGIC
        assert main(["add", "-d", db, *small, wav[2]]) in (0, None)
        assert main(["match", "-d", db, *small,
                     str(tmp_path / "query.wav")]) in (0, None)
        outs[tag] = _mask(capsys.readouterr().out, tmp_path).replace(
            f"{tag}.afdb", "<DB>")
    assert outs["port"] == outs["jax"]
    assert any(ln.startswith("Matched") and "track2.wav" in ln
               for ln in outs["port"].splitlines()), outs["port"]
    a, b = HashTable(str(tmp_path / "port.afdb")), HTj(str(
        tmp_path / "jax.afdb"))
    assert a.names == b.names and len(a.names) == 3
    assert np.array_equal(np.asarray(a.table), np.asarray(b.table))


# ---- upstream .pklz interchange (tests/test_upstream_pklz.py) -------------

def test_load_upstream_instance():
    """An upstream class-instance pickle loads into the port's schema as
    it does into JAX's, with every non-overflowed entry retrievable."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "upstream.pklz")
        entries = UP._make_upstream_pklz(path)
        ht, htj = HashTable(path), HTj(path)
    assert (ht.hashbits, ht.depth, ht.maxtimebits) == (16, 8, 10)
    assert ht.names == htj.names == ["trackA.mp3", "trackB.mp3"]
    assert ht.hashesperid.tolist() == [20, 20]
    assert ht.params == htj.params
    assert ht.params["loaded_from_upstream_version"] == UPSTREAM_HT_VERSION
    assert np.array_equal(ht.table, htj.table)
    for id_, h, t in entries:
        hits = ht.get_hits(np.array([[0, h]], np.int32))
        if int(ht.counts[h]) <= ht.depth:
            assert ((hits[:, 0] == id_) & (hits[:, 1] == t)).any()


def test_load_upstream_old_and_too_old(tmp_path):
    """An old-compat pickle without maxtimebits defaults to 14; one older
    than the compat floor is refused."""
    path = str(tmp_path / "old.pklz")
    prev = sys.modules.get("hash_table")
    mod, cls = UP._fresh_upstream_class()
    sys.modules["hash_table"] = mod
    try:
        obj = cls()
        obj.ht_version = UPSTREAM_OLD_COMPAT
        obj.hashbits, obj.depth = 12, 4
        obj.table = np.zeros((1 << 12, 4), np.uint32)
        obj.counts = np.zeros(1 << 12, np.int32)
        obj.names, obj.params = [], {}
        with gzip.open(path, "wb") as f:
            pickle.dump(obj, f, protocol=2)
    finally:
        if prev is None:
            del sys.modules["hash_table"]
        else:
            sys.modules["hash_table"] = prev
    ht = HashTable(path)
    assert ht.maxtimebits == 14 and ht.maxtime == 16384
    assert len(ht.hashesperid) == 0
    ancient = str(tmp_path / "ancient.pklz")
    UP._make_upstream_pklz(ancient, version=UPSTREAM_OLD_COMPAT - 1)
    with pytest.raises(ValueError, match="predates"):
        HashTable(ancient)


def test_save_upstream_read_by_upstream_loader(tmp_path):
    """save_upstream writes the upstream class instance (read back by a
    plain pickle.load with an independent hash_table module), equal to the
    JAX package's export, and loads back into both packages."""
    ht = HashTable(hashbits=16, depth=8, maxtime=1024)
    htj = HTj(hashbits=16, depth=8, maxtime=1024)
    rng = np.random.default_rng(3)
    pairs = np.stack([rng.integers(0, 1024, 30),
                      rng.integers(0, 1 << 16, 30)], axis=1)
    ht.store_vectorized("song.wav", pairs)
    htj.store_vectorized("song.wav", pairs)
    path, pj = str(tmp_path / "export.pklz"), str(tmp_path / "j.pklz")
    ht.save_upstream(path, params={"density": 20.0})
    htj.save_upstream(pj, params={"density": 20.0})
    assert getattr(sys.modules.get("hash_table"), "__file__", None) \
        is not None or "hash_table" not in sys.modules
    prev = sys.modules.get("hash_table")
    mod, cls = UP._fresh_upstream_class()
    sys.modules["hash_table"] = mod
    try:
        objs = []
        for p in (path, pj):
            with gzip.open(p, "rb") as f:
                objs.append(pickle.load(f))
    finally:
        if prev is None:
            del sys.modules["hash_table"]
        else:
            sys.modules["hash_table"] = prev
    obj, objj = objs
    assert type(obj) is cls
    assert obj.ht_version == UPSTREAM_HT_VERSION
    assert (obj.hashbits, obj.depth, obj.maxtimebits) == (16, 8, 10)
    assert obj.names == ["song.wav"] and obj.hashesperid.dtype == np.uint32
    assert not hasattr(obj, "maxtime") and not hasattr(obj, "seed")
    assert vars(obj).keys() == vars(objj).keys()
    np.testing.assert_array_equal(obj.table, ht.table)
    np.testing.assert_array_equal(obj.table, objj.table)
    for cls_ in (HashTable, HTj):
        back = cls_(path)
        assert np.array_equal(back.table, ht.table)
        assert back.names == ht.names and back.maxtime == ht.maxtime


def _random_tables(seed, n_tracks, n_pairs):
    out = []
    for cls in (HashTable, HTj):
        rng = np.random.default_rng(seed)
        ht = cls(hashbits=10, depth=4, maxtime=256)
        for i in range(n_tracks):
            ht.store_vectorized(f"t{seed}_{i}.wav", np.stack(
                [rng.integers(0, 256, n_pairs),
                 rng.integers(0, 1 << 10, n_pairs)], axis=1))
        out.append(ht)
    return out


def _same(a, b) -> bool:
    return (np.array_equal(a.table, b.table)
            and np.array_equal(a.counts, b.counts) and a.names == b.names
            and np.array_equal(a.hashesperid, b.hashesperid))


@pytest.mark.parametrize("n_pairs", [50, 2000])   # 2000 forces overflow
def test_vectorized_merge_matches_jax_and_loop(n_pairs):
    """The port's merge equals JAX's and the per-bucket loop reference."""
    a, aj = _random_tables(1, 3, n_pairs)
    b, bj = _random_tables(2, 2, n_pairs)
    ref = HTj(hashbits=10, depth=4, maxtime=256)
    ref.table, ref.counts = a.table.copy(), a.counts.copy()
    ref.names, ref.hashesperid = list(a.names), a.hashesperid.copy()
    a.merge(b)
    aj.merge(bj)
    UP._merge_loop_reference(ref, bj)
    assert _same(a, aj) and _same(a, ref)


@pytest.mark.parametrize("n_pairs", [50, 2000])
@pytest.mark.parametrize("victim", [0, 1, 2])
def test_vectorized_remove_matches_jax_and_loop(n_pairs, victim):
    """The port's remove equals JAX's and the per-bucket loop reference."""
    a, aj = _random_tables(3, 3, n_pairs)
    ref = HTj(hashbits=10, depth=4, maxtime=256)
    ref.table, ref.counts = a.table.copy(), a.counts.copy()
    ref.names, ref.hashesperid = list(a.names), a.hashesperid.copy()
    name = a.names[victim]
    a.remove(name)
    aj.remove(name)
    UP._remove_loop_reference(ref, name)
    assert _same(a, aj) and _same(a, ref)


# ---- the ffmpeg decode path, faked (tests/test_ffmpeg_path.py) ------------

def _fake_path(tmp_path, monkeypatch, body):
    fake = FF._install_fake_ffmpeg(tmp_path, body)
    monkeypatch.setenv("PATH", fake + os.pathsep + os.environ.get("PATH",
                                                                   ""))


@pytest.mark.parametrize("channels, sr, n", [(1, 11025, 1000), (2, 8000, 8)],
                         ids=["mono", "stereo-mixdown"])
def test_fake_ffmpeg_decode(tmp_path, monkeypatch, channels, sr, n):
    """The fake ffmpeg's PCM (with 2,000 stderr lines to drain) decodes to
    JAX's array, mean-mixed for two channels."""
    _fake_path(tmp_path, monkeypatch, FF._pcm_emitter(n))
    f = str(tmp_path / "song.mp3")
    x, got_sr = audio_io.audio_read(f, sr=sr, channels=channels)
    xj, _ = AIOj.audio_read(f, sr=sr, channels=channels)
    assert got_sr == sr and x.dtype == np.float32
    assert np.array_equal(x, xj)
    raw = (np.arange(n) % 256 * 64).astype(np.float32) / (1 << 15)
    np.testing.assert_allclose(
        x, raw if channels == 1 else raw.reshape(-1, 2).mean(axis=1))


def test_fake_ffmpeg_failure_and_missing(tmp_path, monkeypatch):
    """A failing ffmpeg surfaces its stderr as CommunicationError; with no
    ffmpeg on PATH the error is NotInstalledError; both are DecodeErrors."""
    _fake_path(tmp_path, monkeypatch,
               'echo "boom: unreadable garbage" >&2\nexit 1\n')
    with pytest.raises(audio_io.CommunicationError, match="boom"):
        audio_io.audio_read(str(tmp_path / "bad.mp3"), sr=11025, channels=1)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(audio_io.NotInstalledError):
        audio_io.audio_read(str(tmp_path / "x.mp3"), sr=11025, channels=1)
    assert issubclass(audio_io.NotInstalledError, audio_io.DecodeError)
    assert issubclass(audio_io.CommunicationError, audio_io.DecodeError)


def test_fake_ffmpeg_command_shape(tmp_path, monkeypatch):
    """ffmpeg -i <f> -f s16le -ar SR -ac CH -, as the JAX package calls it."""
    argfile = tmp_path / "args.txt"
    _fake_path(tmp_path, monkeypatch,
               f'echo "$@" > {argfile}\n' + FF._pcm_emitter(4))
    f = str(tmp_path / "q.m4a")
    audio_io.audio_read(f, sr=11025, channels=1)
    args = argfile.read_text().split()
    assert args == ["-i", f, "-f", "s16le", "-ar", "11025", "-ac", "1", "-"]
    AIOj.audio_read(f, sr=11025, channels=1)
    assert argfile.read_text().split() == args


def test_decode_many_mixed_chunk(tmp_path, monkeypatch):
    """A chunk mixing a WAV and a non-WAV decodes both through the port's
    cli._decode_many, to JAX's arrays."""
    from audfprint_torch import cli
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_tpu import cli as jcli
    from audfprint_tpu.models.analyzer import Analyzer as Aj

    wav = str(tmp_path / "a.wav")
    audio_io.audio_write_wav(wav, synth_audio(np.random.default_rng(12),
                                              dur_sec=1.0), 11025)
    _fake_path(tmp_path, monkeypatch, FF._pcm_emitter(500))
    names = [wav, str(tmp_path / "b.mp3")]
    out = cli._decode_many(Analyzer(device="cpu"), names, 1, print)
    outj = jcli._decode_many(Aj(), names, 1, print)
    assert [len(o) for o in out] == [11025, 500]
    assert all(np.array_equal(a, b) for a, b in zip(out, outj))


# ---- the native host loader (tests/test_native.py) -------------------------

@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("nat")
    paths = []
    for i in range(4):
        p = str(d / f"w{i}.wav")
        audio_io.audio_write_wav(p, synth_audio(rng, dur_sec=1.0 + i * 0.3),
                                 SR)
        paths.append(p)
    return paths


def test_native_lib_builds_and_converts():
    """The port's library builds (g++ is present wherever the JAX test
    runs), and s16_to_f32_mono equals buf_to_float and JAX's binding."""
    from audfprint_tpu.utils import native as Nj

    assert native.get_lib() is not None, "g++ build of audfp_host failed"
    raw = np.random.default_rng(20260816).integers(
        -32768, 32767, 4096).astype(np.int16)
    got = native.s16_to_f32_mono(raw, 1)
    assert np.array_equal(got, audio_io.buf_to_float(raw.tobytes(), 2))
    assert np.array_equal(got, Nj.s16_to_f32_mono(raw, 1))


def test_batch_loader_matches_python(wavs, tmp_path):
    """read_wav_batch equals audio_read file by file and JAX's batch; a
    broken file is flagged None, not crashed on."""
    bad = str(tmp_path / "bad.wav")
    open(bad, "wb").write(b"RIFFxxxxWAVEjunk")
    out = audio_io.read_wav_batch(wavs + [bad], sr=SR)
    outj = AIOj.read_wav_batch(wavs + [bad], sr=SR)
    assert out is not None and out[-1] is None and outj[-1] is None
    for p, got, gj in zip(wavs, out, outj):
        want, wsr = audio_io.audio_read(p, sr=SR)
        assert wsr == SR and np.array_equal(got, want)
        assert np.array_equal(got, gj)


def test_malformed_fmt_chunk_rejected(tmp_path, wavs):
    """A fmt chunk below the 16-byte PCM minimum is flagged, in both."""
    raw, _ = NAT._wav_bytes(fmt_size=8)
    bad = str(tmp_path / "shortfmt.wav")
    open(bad, "wb").write(raw)
    for reader in (audio_io.read_wav_batch, AIOj.read_wav_batch):
        out = reader(wavs + [bad], sr=SR)
        assert out is not None and out[-1] is None
        assert all(o is not None for o in out[:-1])


def test_truncated_data_chunk_native_decodes_prefix(tmp_path):
    """A data chunk declared past the end of the file decodes the frames
    on disk, sized by the clamped bound, equal to JAX's."""
    import struct
    raw, data = NAT._wav_bytes(n_frames=256, n_ch=1)
    raw = raw.replace(b"data" + struct.pack("<I", len(data)),
                      b"data" + struct.pack("<I", 0x7FFFFFF0))
    p = str(tmp_path / "stream.wav")
    open(p, "wb").write(raw)
    out = audio_io.read_wav_batch([p], sr=None)
    assert out is not None and len(out[0]) == 256
    assert np.array_equal(out[0], AIOj.read_wav_batch([p], sr=None)[0])
