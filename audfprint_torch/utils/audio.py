"""Host audio decode layer (L0).

Reference parity: audio_read.py (SURVEY §2.3.1) — `audio_read(filename, sr,
channels)` -> (float32 mono array, sr).  The reference shells out to ffmpeg
for everything; this environment has no ffmpeg/soundfile baked in, so:

  * `.wav` PCM files decode natively (stdlib `wave` + NumPy, incl. 24-bit),
  * anything else uses ffmpeg via subprocess when present (same command
    shape as the reference: `ffmpeg -i f -f s16le -ar sr -ac ch -`, with a
    stderr drain thread standing in for the reference's QueueReaderThread),
  * resampling to the analysis rate is polyphase (scipy.signal.resample_poly)
    instead of ffmpeg's -ar,
  * typed exceptions mirror the reference's error surface.

Decode is host I/O and intentionally not a device target (SURVEY §2.1
item 1); the device pipeline consumes fixed-size float32 batches from here.
The port's own copy of audfprint_tpu/utils/audio.py.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import threading
import wave

import numpy as np


class DecodeError(Exception):
    """The file could not be decoded."""


class NotInstalledError(DecodeError):
    """ffmpeg is required for this format but is not installed."""


class CommunicationError(DecodeError):
    """ffmpeg produced no usable output."""


def buf_to_float(raw: bytes, sampwidth: int) -> np.ndarray:
    """Interleaved PCM bytes -> float32 in [-1, 1) (reference buf_to_float).

    A truncated final sample (corrupt/odd-length data chunk) is dropped,
    matching ffmpeg's decode-what-is-there tolerance."""
    if len(raw) % sampwidth:
        raw = raw[: len(raw) - (len(raw) % sampwidth)]
    if sampwidth == 1:  # unsigned 8-bit
        x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        return (x - 128.0) / 128.0
    if sampwidth == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        return x / float(1 << 15)
    if sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32)
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= (1 << 23), x - (1 << 24), x).astype(np.float32)
        return x / float(1 << 23)
    if sampwidth == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32)
        return x / float(1 << 31)
    raise DecodeError(f"unsupported PCM sample width {sampwidth}")


def _resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def _read_wav(filename: str):
    with wave.open(filename, "rb") as w:
        nch = w.getnchannels()
        sw = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
    x = buf_to_float(raw, sw)
    if nch > 1:
        x = x.reshape(-1, nch).mean(axis=1)
    return x.astype(np.float32), sr


def _read_ffmpeg(filename: str, sr: int | None, channels: int):
    if shutil.which("ffmpeg") is None:
        raise NotInstalledError(
            "ffmpeg not found; only PCM .wav is decodable natively")
    cmd = ["ffmpeg", "-i", filename, "-f", "s16le"]
    if sr is not None:
        cmd += ["-ar", str(sr)]
    cmd += ["-ac", str(channels), "-"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    stderr_chunks: list[bytes] = []

    def _drain(pipe):  # keep stderr flowing to avoid pipe deadlock
        for line in pipe:
            stderr_chunks.append(line)

    t = threading.Thread(target=_drain, args=(proc.stderr,), daemon=True)
    t.start()
    raw = proc.stdout.read()
    proc.wait()
    t.join(timeout=5)
    if proc.returncode != 0 or not raw:
        raise CommunicationError(
            f"ffmpeg failed on {filename}: "
            + b"".join(stderr_chunks[-5:]).decode(errors="replace"))
    x = buf_to_float(raw, 2)
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x.astype(np.float32), (sr if sr is not None else 0)


def audio_read(filename: str, sr: int | None = None, channels: int = 1):
    """Decode any supported file to (float32 mono-or-N array, sample rate).

    Reference contract (audio_read.py:~150-220): mono float32 at the target
    rate regardless of source format.
    """
    if filename.lower().endswith(".wav"):
        try:
            x, in_sr = _read_wav(filename)
        except (wave.Error, EOFError, OSError, ValueError) as e:
            # non-PCM/corrupt wav -> try ffmpeg; missing file stays a
            # DecodeError so --continue-on-error keeps its contract
            if shutil.which("ffmpeg") and os.path.exists(filename):
                return _read_ffmpeg(filename, sr, channels)
            raise DecodeError(f"cannot decode {filename}: {e}") from e
        if sr is not None:
            x = _resample(x, in_sr, sr)
            in_sr = sr
        return x, in_sr
    return _read_ffmpeg(filename, sr, channels)


def wav_is_target_mono16(filename: str, sr: int) -> bool:
    """Header-only check: 16-bit PCM, mono, already at the analysis rate —
    the case where samples can ship to the device as raw int16 (the
    device-side x * 2**-15 conversion is bit-exact in float32)."""
    try:
        with wave.open(filename, "rb") as w:
            return (w.getnchannels() == 1 and w.getsampwidth() == 2
                    and w.getframerate() == sr)
    except (wave.Error, EOFError, OSError):
        return False


def audio_read_staged(filename: str, sr: int | None = None):
    """audio_read variant for device staging: returns (array, sr) where the
    array is UNCONVERTED int16 when the source is 16-bit PCM mono already at
    `sr` (half the host->device bytes; converted losslessly on device), and
    the usual float32 otherwise.  Single open: eligibility is checked on
    the same handle that reads the frames."""
    if sr is not None and filename.lower().endswith(".wav"):
        try:
            with wave.open(filename, "rb") as w:
                if (w.getnchannels() == 1 and w.getsampwidth() == 2
                        and w.getframerate() == sr):
                    raw = w.readframes(w.getnframes())
                    if len(raw) % 2:          # truncated final sample
                        raw = raw[:-1]
                    return np.frombuffer(raw, dtype="<i2"), sr
        except (wave.Error, EOFError, OSError, ValueError):
            pass
    return audio_read(filename, sr=sr, channels=1)


def read_wav_batch(paths: list, sr: int | None = None,
                   n_threads: int = 8) -> list | None:
    """Bulk decode of PCM WAVs via the native C++ loader (threaded).

    Returns a list of float32 mono arrays aligned with `paths` (None entries
    for files the native path can't handle — caller falls back to
    audio_read), or None when the native lib is unavailable.
    """
    from audfprint_torch.utils import native

    if native.get_lib() is None or not paths:
        return None

    def _frames(p):
        # header-derived mono frame count (cheap: 44-byte read), CLAMPED
        # to the byte-size bound: sizing by raw bytes alone over-allocated
        # up to 8x for stereo 16-bit, while a header alone trusts a
        # declared length (streaming encoders write 0xFFFFFFFF) that
        # would drive a multi-GB allocation
        size_bound = os.path.getsize(p) + 8
        try:
            with wave.open(p, "rb") as w:
                return min(w.getnframes() + 8, size_bound)
        except (wave.Error, EOFError, OSError):
            return size_bound

    max_samples = max(_frames(p) for p in paths)
    res = native.load_wav_batch(paths, max_samples, n_threads)
    if res is None:
        return None
    batch, lens, srs, errs = res
    out: list = []
    for i in range(len(paths)):
        if errs[i] != 0:
            out.append(None)
            continue
        x = batch[i, : lens[i]]
        if sr is not None and srs[i] != sr:
            x = _resample(x, int(srs[i]), sr)
        out.append(np.ascontiguousarray(x))
    return out


def audio_write_wav(filename: str, x: np.ndarray, sr: int) -> None:
    """Write float32 [-1,1] mono to 16-bit PCM wav (test fixtures, sonify)."""
    xi = np.clip(np.asarray(x) * (1 << 15), -(1 << 15), (1 << 15) - 1)
    with wave.open(filename, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(xi.astype("<i2").tobytes())
