"""Build the port's CUDA kernels at first use and bind them with ctypes.

The sources (audfprint_torch/csrc/*.cu) have a plain C interface, so nvcc
compiles them in seconds, without PyTorch's headers, one process a source
started together, and links one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <source>.o audfprint_torch/csrc/<source>.cu
    nvcc -shared -o build/audfprint_torch/libaudfprint_kernels-<hash>.so *.o

The library lands in build/audfprint_torch/ under the checkout, named by a
hash of the sources and flags, so an edited kernel never loads a stale
build.  ptxas's register and shared-memory report is kept beside it
(`.log`).  Nothing here runs at import time: the CPU tests import every
module on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("hpf.cu", "pair.cu", "prune.cu", "scan.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "audfprint_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # x, y, x0, y0, xT, yT, B, T, F, pole, then the launch plan of
    # spectro.k2_plan (frames, stages), stream (carry pointers may be 0)
    "hpf_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    # m0, n_frames, env0f, env0b, gvec, lpos, lval, kept, B, T, F, k,
    # a_dec, stream
    "prune_fwd_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # m0, env_in, gvec, lpos, lval, env_out, B, T, F, k, a_dec, stream
    "prune_fwd_carry": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # bins, valid, hashes, lvalid, B, T, K, fanout, mindt, targetdt,
    # targetdf, stream
    "pair_scan": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, y, workspace (may be 0), B, H, tile, op, reverse, stream
    "seg_scan": [_P, _P, _P, _L, _L, _I, _I, _I, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of audfprint_torch "
                           "build from source at first use")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libaudfprint_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this exact build exists; returns its path.
    Each source compiles in its own nvcc process, all started together,
    then one link makes the library."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{tmp}.{s}.o" for s in SOURCES]
    cmds = [[_nvcc(), *compile_flags, "-c", "-o", o, os.path.join(CSRC, s)]
            for o, s in zip(objs, SOURCES)]
    link = [_nvcc(), "-shared", "-o", f"{tmp}.tmp", *objs]
    procs = []
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        logs = [p.communicate(timeout=900)[1] for p in procs]
        for cmd, p, err in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
        proc = subprocess.run(link, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stderr}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    with open(so[:-3] + ".log", "w") as f:
        f.write("".join(logs) + proc.stderr)
    os.replace(f"{tmp}.tmp", so)
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.audfp_cuda_error_string.argtypes = [ctypes.c_int]
            lib.audfp_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (cudaGetLastError)."""
    if err:
        msg = load().audfp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
