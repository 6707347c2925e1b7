"""ctypes binding for the port's native host library (native/audfp_host.cpp).

The port's own copy of audfprint_tpu/utils/native.py, plus the streamed
route's backward prune (bwd_prune_sparse).  Builds the shared library with
g++ on first use into build/audfprint_torch/ under the checkout (named by
a hash of the source, never next to it); every entry point has a fallback,
so the package works without a compiler: the original's NumPy host decode
for the loader, oracle.analyze.bwd_prune_sparse for the prune.  See
native/audfp_host.cpp for the role of this layer (the reference's
audio_read.py decode path, made batch + multithreaded).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "audfp_host.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "audfprint_torch")
_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libaudfp_host-{h}.so")


def _build(so: str) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [gxx, "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def get_lib():
    """The loaded library, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.s16_to_f32_mono.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.load_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.bwd_prune_sparse.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.bwd_prune_sparse.restype = ctypes.c_int
        _lib = lib
        return _lib


def s16_to_f32_mono(raw: np.ndarray, n_ch: int) -> np.ndarray | None:
    """Interleaved int16 -> mono float32; None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    n_frames = len(raw) // n_ch
    out = np.empty(n_frames, np.float32)
    lib.s16_to_f32_mono(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(n_frames), ctypes.c_int(n_ch),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def load_wav_batch(paths: list, max_samples: int, n_threads: int = 8):
    """Decode PCM WAVs into a zero-padded (n, max_samples) f32 batch.

    Returns (batch, lens, srs, errs) or None if the lib is unavailable.
    errs[i] != 0 marks failure (caller falls back / reports); non-PCM or
    resample-needed files must be handled by the Python path.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    batch = np.zeros((n, max_samples), np.float32)
    lens = np.zeros(n, np.int32)
    srs = np.zeros(n, np.int32)
    errs = np.zeros(n, np.int32)
    cpaths = (ctypes.c_char_p * n)(
        *[os.fsencode(p) for p in paths])
    lib.load_wav_batch(
        cpaths, ctypes.c_int(n),
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(max_samples),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        errs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(n_threads))
    return batch, lens, srs, errs


def bwd_prune_sparse(n_frames: int, pk_t: np.ndarray, pk_pos: np.ndarray,
                     pk_val: np.ndarray, sthresh: np.ndarray,
                     gvec: np.ndarray, a_dec: np.float32) -> np.ndarray | None:
    """The backward prune over sparse forward peaks -> bool keep mask,
    bit for bit with oracle.analyze.bwd_prune_sparse given its envelope
    seed `sthresh` (float32 (F,), updated in place), its float32 `gvec`
    and `a_dec`.  None if the lib is unavailable or the input is not one
    the native loop takes (pk_t not ascending, a bin outside [0, F), a
    NaN value)."""
    lib = get_lib()
    if lib is None:
        return None
    if sthresh.dtype != np.float32 or not sthresh.flags.c_contiguous:
        raise ValueError("sthresh must be a contiguous float32 array")
    if not len(pk_t) == len(pk_pos) == len(pk_val):
        raise ValueError("pk_t, pk_pos and pk_val differ in length")
    pk_t = np.ascontiguousarray(pk_t, dtype=np.int64)
    pk_pos = np.ascontiguousarray(pk_pos, dtype=np.int64)
    pk_val = np.ascontiguousarray(pk_val, dtype=np.float32)
    gvec = np.ascontiguousarray(gvec, dtype=np.float32)
    keep = np.empty(len(pk_t), np.uint8)
    rc = lib.bwd_prune_sparse(
        ctypes.c_int64(n_frames), ctypes.c_int64(len(pk_t)),
        pk_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pk_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pk_val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(sthresh)),
        sthresh.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        gvec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64((len(gvec) - 1) // 2), ctypes.c_float(a_dec),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.view(bool) if rc == 0 else None
