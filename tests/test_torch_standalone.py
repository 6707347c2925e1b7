"""audfprint_torch stands alone: no module of the port, and not
chip_smoke.py, imports JAX or the JAX package; a fresh process that refuses
those imports outright runs `new` then `match`; and the host modules the
port keeps its own copies of (params, ops.config, index.hash_table,
utils.{audio, formats, native, prng, timing}, oracle/) agree with their
originals on the same numpy inputs, all on the CPU.  The scan walks the
whole package, parallel/, oracle/match.py and compat/ included."""

import ast
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from audfprint_tpu import params as Pj  # noqa: E402
from audfprint_tpu.index.hash_table import HashTable as HTj  # noqa: E402
from audfprint_tpu.oracle import analyze as OAj  # noqa: E402
from audfprint_tpu.oracle import match as OMj  # noqa: E402
from audfprint_tpu.parallel import sharded as SHj  # noqa: E402
from audfprint_tpu.ops.config import PipelineConfig as PCj  # noqa: E402
from audfprint_tpu.utils import audio as Aj  # noqa: E402
from audfprint_tpu.utils import formats as Fj  # noqa: E402
from audfprint_tpu.utils import native as Nj  # noqa: E402
from audfprint_tpu.utils import prng as PRj  # noqa: E402
from audfprint_tpu.utils.timing import Stages as Sj  # noqa: E402
from audfprint_torch import params as Pt  # noqa: E402
from audfprint_torch.index.hash_table import HashTable as HTt  # noqa: E402
from audfprint_torch.oracle import analyze as OAt  # noqa: E402
from audfprint_torch.oracle import match as OMt  # noqa: E402
from audfprint_torch.parallel import sharded as SHt  # noqa: E402
from audfprint_torch.ops.config import PipelineConfig as PCt  # noqa: E402
from audfprint_torch.utils import audio as At  # noqa: E402
from audfprint_torch.utils import formats as Ft  # noqa: E402
from audfprint_torch.utils import native as Nt  # noqa: E402
from audfprint_torch.utils import prng as PRt  # noqa: E402
from audfprint_torch.utils.timing import Stages as St  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("jax", "jaxlib", "audfprint_tpu")


def _port_sources() -> list:
    out = []
    for d, _dirs, files in os.walk(os.path.join(ROOT, "audfprint_torch")):
        out += [os.path.relpath(os.path.join(d, f), ROOT)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py"]


def _imported_roots(tree: ast.AST) -> list:
    """Top-level package of every import in the tree, function bodies
    included, and of importlib.import_module / __import__ calls on a
    literal name."""
    roots = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots += [(a.name.split(".")[0], node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append((node.module.split(".")[0], node.lineno))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            roots.append((node.args[0].value.split(".")[0], node.lineno))
    return roots


@pytest.mark.parametrize("rel", _port_sources())
def test_source_imports_no_jax(rel):
    """No import of jax, jaxlib or audfprint_tpu anywhere in the file."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), rel)
    bad = [(m, ln) for m, ln in _imported_roots(tree) if m in REFUSED]
    assert not bad, f"{rel} imports {bad}"


def test_import_scan_covers_the_sharded_slice():
    """The files this scan must reach are among the sources it walks."""
    rels = set(_port_sources())
    assert {"audfprint_torch/parallel/mesh.py",
            "audfprint_torch/parallel/sharded.py",
            "audfprint_torch/parallel/multihost.py",
            "audfprint_torch/oracle/match.py", "chip_smoke.py"} <= rels


def test_import_scan_covers_compat():
    """The upstream-named surface (compat/) is among the sources scanned,
    every one of its seven modules."""
    rels = set(_port_sources())
    assert {f"audfprint_torch/compat/{m}.py" for m in (
        "__init__", "audfprint", "audfprint_analyze", "audfprint_match",
        "audio_read", "hash_table", "stft")} <= rels


def test_import_scan_sees_nested_imports():
    """The scan above catches imports inside functions and by name."""
    src = ("def f():\n    from audfprint_tpu import params\n"
           "def g():\n    import importlib\n"
           "    return importlib.import_module('jax.numpy')\n")
    assert {m for m, _ in _imported_roots(ast.parse(src))} >= {
        "audfprint_tpu", "jax"}


_REFUSING_DRIVE = r"""
import importlib, importlib.abc, pkgutil, sys
REFUSED = ("jax", "jaxlib", "audfprint_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"{name} is refused in this process")
        return None


sys.meta_path.insert(0, Refuse())
import audfprint_torch
for m in pkgutil.walk_packages(audfprint_torch.__path__, "audfprint_torch."):
    if m.name != "audfprint_torch.__main__":
        importlib.import_module(m.name)
from audfprint_torch.cli import main
from audfprint_torch.utils.audio import audio_write_wav
import numpy as np
d = sys.argv[1]
x = np.load(d + "/songs.npy")
for i in range(2):
    audio_write_wav(d + f"/s{i}.wav", x[i], 11025)
audio_write_wav(d + "/q.wav", x[1][256 * 20: 256 * 20 + 33075], 11025)
assert main(["new", "-d", d + "/db.pklz", "-h", "14", d + "/s0.wav",
             d + "/s1.wav"], device="cpu") == 0
assert main(["match", "-d", d + "/db.pklz", "-h", "14", d + "/q.wav"],
            device="cpu") == 0
left = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not left, left
print("STANDALONE_OK")
"""


def test_cli_runs_with_jax_refused(tmp_path):
    """A fresh process whose importer refuses jax, jaxlib and audfprint_tpu
    imports every module of the port and runs new then match on two
    synthetic WAVs; the query matches its song at rank 0."""
    rng = np.random.default_rng(41)
    np.save(tmp_path / "songs.npy",
            np.stack([synth_audio(rng, dur_sec=6.0, n_tones=40)
                      for _ in range(2)]))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSING_DRIVE, str(tmp_path)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STANDALONE_OK" in proc.stdout
    assert any("Matched" in ln and "s1.wav" in ln and "at rank 0" in ln
               for ln in proc.stdout.splitlines()), proc.stdout


# ---- the copies against their originals ----------------------------------

def _filled(cls, seed: int, **kw):
    rng = np.random.default_rng(seed)
    ht = cls(hashbits=12, depth=8, maxtime=1 << 12, **kw)
    for i in range(6):
        pairs = np.stack([rng.integers(0, 3000, 200),       # 64 hashes:
                          rng.integers(0, 64, 200)], axis=1)  # past depth
        ht.store_vectorized(f"track{i}.wav", pairs.astype(np.int64))
    return ht


@pytest.mark.parametrize("writer, reader", [(HTj, HTt), (HTt, HTj)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_pklz_loads_in_the_other_package(writer, reader, tmp_path):
    """A .pklz written by one package's HashTable loads in the other with
    equal arrays, names and hashesperid."""
    path = str(tmp_path / "db.pklz")
    src = _filled(writer, 5)
    src.save(path)
    got = reader(path)
    assert np.array_equal(got.table, src.table)
    assert np.array_equal(got.counts, src.counts)
    assert np.array_equal(got.hashesperid, src.hashesperid)
    assert got.names == src.names
    assert (got.hashbits, got.depth, got.maxtimebits) == (
        src.hashbits, src.depth, src.maxtimebits)


def test_store_and_reservoir_equal_the_original():
    """The same insertion stream, past depth (reservoir sampling), gives
    bit-identical tables in both packages."""
    a, b = _filled(HTj, 9), _filled(HTt, 9)
    assert int(a.counts.max()) > a.depth
    assert np.array_equal(a.table, b.table)
    assert np.array_equal(a.counts, b.counts)


def test_upstream_pickle_loads(tmp_path):
    """save_upstream writes a class-instance .pklz that both packages read
    back through the upstream unpickler."""
    path = str(tmp_path / "up.pklz")
    src = _filled(HTt, 6)
    src.save_upstream(path)
    with gzip.open(path, "rb") as f:
        assert b"HashTable" in f.read(4096)
    for cls in (HTt, HTj):
        got = cls(path)
        assert np.array_equal(got.table, src.table)
        assert got.names == src.names


def test_params_and_pipeline_config_equal():
    """Every constant, dataclass default and the gaussian template agree;
    PipelineConfig.from_params gives the same fields."""
    names = [n for n in dir(Pj) if n.isupper()]
    assert names and all(getattr(Pt, n) == getattr(Pj, n) for n in names)
    for cls in ("AnalyzerParams", "MatcherParams"):
        assert vars(getattr(Pt, cls)()) == vars(getattr(Pj, cls)())
    assert np.array_equal(Pt.gaussian_template(), Pj.gaussian_template())
    ap = Pt.AnalyzerParams(density=40.0, shifts=4)
    apj = Pj.AnalyzerParams(density=40.0, shifts=4)
    assert tuple(PCt.from_params(ap)) == tuple(PCj.from_params(apj))
    assert PCt._fields == PCj._fields


def test_formats_round_trip(tmp_path):
    """Hashes and peaks written by one package read back equal in both."""
    rng = np.random.default_rng(2)
    h = np.stack([rng.integers(0, 5000, 300),
                  rng.integers(0, 1 << 20, 300)], axis=1).astype(np.int32)
    pk = [(int(t), int(f)) for t, f in zip(rng.integers(0, 900, 50),
                                            rng.integers(0, 256, 50))]
    for w, r in ((Ft, Fj), (Fj, Ft)):
        hp, pp = str(tmp_path / "h.afpt"), str(tmp_path / "p.afpk")
        w.hashes_save(hp, h)
        w.peaks_save(pp, pk)
        assert np.array_equal(r.hashes_load(hp), h)
        assert np.array_equal(np.asarray(r.peaks_load(pp)), np.asarray(pk))


def test_mix32_and_reservoir_slot_above_2_31():
    """mix32 and reservoir_slot on uint32 values >= 2^31."""
    x = np.arange(2**31 - 8, 2**31 + 4096, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([x, np.array([2**32 - 1, 0], np.uint32)])
    assert np.array_equal(PRt.mix32(x), PRj.mix32(x))
    pos = np.arange(len(x), dtype=np.int64) + 100
    assert np.array_equal(PRt.reservoir_slot(x, pos, seed=3),
                          PRj.reservoir_slot(x, pos, seed=3))


def test_bwd_prune_sparse_equal():
    """bwd_prune_sparse on a seeded forward-peak stream keeps the same
    peaks in both oracles, and agrees with the dense bwd_prune."""
    rng = np.random.default_rng(13)
    sg = (rng.standard_normal((300, 256)) * 2.0).astype(np.float32)
    params = Pt.AnalyzerParams()
    fwd = OAt.fwd_prune(sg, params)
    t, p = np.nonzero(fwd)
    args = (sg.shape[0], t, p, sg[t, p], sg[-1])
    keep = OAt.bwd_prune_sparse(*args, params)
    assert np.array_equal(keep, OAj.bwd_prune_sparse(*args,
                                                     Pj.AnalyzerParams()))
    dense = OAt.bwd_prune(sg, fwd, params)
    assert np.array_equal(keep, dense[t, p])


def test_oracle_hashes_equal():
    """The copied oracle's full analysis equals the original's."""
    x = synth_audio(np.random.default_rng(4), dur_sec=3.0, n_tones=30)
    assert np.array_equal(OAt.samples_to_hashes(x),
                          OAj.samples_to_hashes(x))
    lm = OAt.peaks2landmarks(OAt.find_peaks(x))
    h = OAt.landmarks2hashes(lm)
    assert np.array_equal(h, OAj.landmarks2hashes(lm))
    assert np.array_equal(OAt.hashes2landmarks(h), OAj.hashes2landmarks(h))


@pytest.mark.parametrize("kw", [
    {}, {"exact_count": True, "max_returns": 3},
    {"find_time_range": True, "max_returns": 2},
    {"exact_count": True, "find_time_range": True, "sort_by_time": True,
     "max_returns": 3, "threshcount": 2}],
    ids=["approx", "exact", "time-range", "exact+range+by-time"])
def test_oracle_match_equal(kw):
    """The copied oracle matcher (find_modes, best_count_ids,
    match_hashes) equals the original on a duplicate-heavy table, in every
    mode."""
    rng = np.random.default_rng(22)
    ht = HTt(hashbits=12, depth=8, maxtime=1 << 12)
    tracks = []
    for i in range(6):                      # 64 hashes: buckets past depth
        tracks.append(np.stack([rng.integers(0, 3000, 200),
                                rng.integers(0, 64, 200)], axis=1))
        ht.store_vectorized(f"track{i}.wav", tracks[-1].astype(np.int64))
    for i in range(3):
        q = np.unique(tracks[i][:150] + [40 * i, 0], axis=0)
        got = OMt.match_hashes(ht, q, Pt.MatcherParams(**kw))
        want = OMj.match_hashes(ht, q, Pj.MatcherParams(**kw))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert len(want)
    data = rng.integers(-40, 40, 500)
    for a, b in zip(OMt.find_modes(data, 3, 2), OMj.find_modes(data, 3, 2)):
        assert np.array_equal(a, b)
    hits = ht.get_hits(q)
    for a, b in zip(OMt.best_count_ids(hits, ht),
                    OMj.best_count_ids(hits, ht)):
        assert np.array_equal(a, b)
    assert OMt.match_hashes(ht, np.zeros((0, 2), np.int64)).shape == (0, 6)


@pytest.mark.parametrize("idbits", [0, 22], ids=["packed", "wide"])
def test_entry_streams_equal(idbits):
    """parallel.sharded.entry_streams gives the original's replay streams:
    the same hashes and validity, and each entry as one int64 word that
    holds the original's uint32 entry (or its (lo, hi) planes joined)."""
    from audfprint_tpu.index import device_table as DTj

    kw = {"idbits": idbits} if idbits else {}
    hs, es, vs = SHt.entry_streams(_filled(HTt, 31, **kw), id_offset=9)
    hj, ej, vj = SHj.entry_streams(_filled(HTj, 31, **kw), id_offset=9)
    assert np.array_equal(hs, hj) and hs.dtype == hj.dtype
    assert np.array_equal(vs, vj) and len(hs) > 300
    assert np.array_equal(es.astype(np.uint64),
                          DTj.join_wide(ej) if idbits else ej)
    assert int(es.max() >> 12) >= 9


def _stages_out(cls):
    st = cls()
    st.totals.update({"analyze": 1.25, "match": 0.5})
    st.counts.update({"analyze": 3, "match": 1})
    st.add_meta(files=4)
    lines = []
    st.report(lines.append)
    return st.summary(), lines


def test_stages_output_equal(tmp_path):
    """Stages gives the same summary, report lines and JSON dump."""
    assert _stages_out(St) == _stages_out(Sj)
    for cls, name in ((St, "t.json"), (Sj, "j.json")):
        st = cls()
        with st.time("decode"):
            pass
        st.totals["decode"] = 0.125
        st.dump_json(str(tmp_path / name))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def test_audio_readers_equal(tmp_path):
    """audio_read, audio_read_staged, read_wav_batch and buf_to_float give
    the same arrays in both packages, resampled files included."""
    rng = np.random.default_rng(8)
    paths = []
    for i, sr in enumerate((11025, 22050, 8000)):
        p = str(tmp_path / f"a{i}.wav")
        Aj.audio_write_wav(p, synth_audio(rng, dur_sec=1.5, sr=sr), sr)
        paths.append(p)
    for p in paths:
        for sr in (None, 11025):
            a, sa = At.audio_read(p, sr=sr)
            b, sb = Aj.audio_read(p, sr=sr)
            assert sa == sb and np.array_equal(a, b)
        a, _ = At.audio_read_staged(p, 11025)
        b, _ = Aj.audio_read_staged(p, 11025)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert At.wav_is_target_mono16(p, 11025) == \
            Aj.wav_is_target_mono16(p, 11025)
    ra, rb = At.read_wav_batch(paths, 11025), Aj.read_wav_batch(paths, 11025)
    assert (ra is None) == (rb is None)
    if ra is not None:
        assert all(np.array_equal(u, v) for u, v in zip(ra, rb))
    raw = rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
    for w in (1, 2, 3, 4):
        assert np.array_equal(At.buf_to_float(raw, w), Aj.buf_to_float(raw, w))
    with pytest.raises(At.DecodeError):
        At.audio_read(str(tmp_path / "missing.wav"))


def test_native_loader_builds_under_build_dir(tmp_path):
    """The host decode library builds from the port's own source into
    build/audfprint_torch/, never next to the source, and decodes a WAV
    batch as the original does; without g++ the numpy path stands in."""
    lib = Nt.get_lib()
    src_dir = os.path.join(ROOT, "audfprint_torch", "native")
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]
    paths = []
    for i in range(2):
        x = synth_audio(np.random.default_rng(20 + i), dur_sec=1.0)
        paths.append(str(tmp_path / f"w{i}.wav"))
        Aj.audio_write_wav(paths[-1], x, 11025)
    if lib is None:
        assert Nt.load_wav_batch(paths, 20000) is None
        return
    assert os.path.dirname(lib._name) == os.path.join(ROOT, "build",
                                                      "audfprint_torch")
    got, want = Nt.load_wav_batch(paths, 20000), Nj.load_wav_batch(
        paths, 20000)
    assert want is not None
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
