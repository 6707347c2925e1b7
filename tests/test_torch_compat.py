"""audfprint_torch.compat, the upstream module-name surface of the port,
against audfprint_tpu.compat on the CPU: the counterparts of
tests/test_compat_surface.py.  Every public name of each JAX compat module
exists in the port's (computed, not listed), the names are the port's own
objects, an in-process `new` then `match` through compat.audfprint.main
prints the JAX CLI's lines (timings masked), glob2hashtable builds the JAX
table, and compat.stft gives the same array."""

import importlib
import os
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)
SR = 11025
MODULES = ["audfprint", "audfprint_analyze", "audfprint_match", "audio_read",
           "hash_table", "stft"]


def _public(mod) -> list:
    return sorted(k for k in vars(mod) if not k.startswith("_"))


@pytest.mark.parametrize("name", MODULES)
def test_compat_module_has_every_jax_name(name):
    """Each public name of audfprint_tpu.compat.<name> exists in
    audfprint_torch.compat.<name>, of the same kind, and is the port's
    object, never the JAX package's."""
    jm = importlib.import_module(f"audfprint_tpu.compat.{name}")
    tm = importlib.import_module(f"audfprint_torch.compat.{name}")
    names = _public(jm)
    assert names
    for k in names:
        assert hasattr(tm, k), f"compat.{name}.{k} missing"
        j, t = getattr(jm, k), getattr(tm, k)
        assert callable(t) == callable(j), k
        if callable(t):
            assert t.__module__.startswith("audfprint_torch."), (k, t)
        else:
            assert t == j, k                       # the constants


def test_compat_modules_import():
    """tests/test_compat_surface.py::test_compat_modules_import through
    the port's compat."""
    from audfprint_torch.compat import (  # noqa: F401
        audfprint,
        audfprint_analyze,
        audfprint_match,
        audio_read,
        hash_table,
        stft,
    )
    from audfprint_torch.index.hash_table import HashTable

    assert callable(audfprint.main)
    assert callable(audfprint_analyze.landmarks2hashes)
    assert callable(audfprint_match.find_modes)
    assert callable(audio_read.audio_read)
    assert callable(stft.stft)
    assert hash_table.HashTable is HashTable
    ht = hash_table.HashTable(hashbits=8, depth=2, maxtime=64)
    ht.store("x", np.array([[1, 2]]))
    assert ht.totalhashes() == 1


def _mask(out: str, d) -> str:
    out = out.replace(str(d) + os.sep, "<DIR>/")
    out = re.sub(r"\d+\.\d+ s", "<T> s", out)
    return re.sub(r"\d+\.\d+ x RT", "<R> x RT", out)


def test_compat_cli_session_matches_jax(tmp_path, capsys):
    """compat.audfprint.main(["new", ...], device="cpu") then `match`
    prints the JAX compat CLI's lines, and writes an equal database."""
    from audfprint_torch.compat import audfprint as ct
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.utils.audio import audio_write_wav
    from audfprint_tpu.compat import audfprint as cj

    rng = np.random.default_rng(5)
    songs = [synth_audio(rng, dur_sec=5.0, n_tones=40) for _ in range(2)]
    for i, x in enumerate(songs):
        audio_write_wav(str(tmp_path / f"t{i}.wav"), x, SR)
    audio_write_wav(str(tmp_path / "q.wav"), songs[1][SR: 4 * SR], SR)
    wavs = [str(tmp_path / f"t{i}.wav") for i in range(2)]
    outs = {}
    for tag, main, kw in (("jax", cj.main, {}),
                          ("port", ct.main, {"device": "cpu"})):
        db = str(tmp_path / f"{tag}.pklz")
        capsys.readouterr()
        assert main(["new", "-d", db, "-h", "14", *wavs], **kw) == 0
        assert main(["match", "-d", db, "-h", "14",
                     str(tmp_path / "q.wav")], **kw) == 0
        outs[tag] = _mask(capsys.readouterr().out, tmp_path).replace(
            f"{tag}.pklz", "<DB>")
    assert outs["port"] == outs["jax"]
    assert "Matched <DIR>/q.wav" in outs["port"]
    assert "as <DIR>/t1.wav" in outs["port"]
    a, b = (HashTable(str(tmp_path / f"{t}.pklz")) for t in ("port", "jax"))
    assert np.array_equal(a.table, b.table) and a.names == b.names


def test_compat_glob2hashtable_matches_jax(tmp_path):
    """compat.audfprint_analyze.glob2hashtable on the CPU equals the JAX
    compat's table; with no device it asks for CUDA, which is missing
    here."""
    from audfprint_torch.compat import audfprint_analyze as at
    from audfprint_torch.utils.audio import audio_write_wav
    from audfprint_tpu.compat import audfprint_analyze as aj
    from audfprint_tpu.index.hash_table import HashTable as HTj

    rng = np.random.default_rng(6)
    for i in range(2):
        audio_write_wav(str(tmp_path / f"g{i}.wav"),
                        synth_audio(rng, dur_sec=4.0, n_tones=30), SR)
    pattern = str(tmp_path / "g*.wav")
    got = at.glob2hashtable(pattern, device="cpu")
    want = aj.glob2hashtable(pattern, HTj())
    assert got.names == want.names and len(got.names) == 2
    assert np.array_equal(got.table, want.table)
    assert np.array_equal(got.hashesperid, want.hashesperid)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            at.glob2hashtable(pattern)


def test_compat_stft_matches_jax():
    from audfprint_torch.compat import stft as st
    from audfprint_tpu.compat import stft as sj

    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    s = st.stft(x, n_fft=512, hop_length=256)
    assert s.shape == (257, 15)
    assert np.array_equal(s, sj.stft(x, n_fft=512, hop_length=256))
    assert np.array_equal(st.frame(x, 512, 256), sj.frame(x, 512, 256))
