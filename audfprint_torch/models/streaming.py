"""Streaming (chunked) ingest (port of audfprint_tpu/models/streaming.py).

Analyses a WAV of any length with O(chunk) host and device memory: two
ranged read passes over the file, one device dispatch per chunk and pass,
all shifts batched into one (S, Nc) row block:

  stats pass  ops/streaming.chunk_stats gives the per-shift |STFT| max and
          min and exact integer level sums of the log magnitudes; the host
          keeps Python-int totals, so the whitening mean is the correctly
          rounded mean of the same f32 values at any chunk size.  Chunks
          holding entries below the final floor gmax/1e6 get one
          chunk_stats_below correction, still integer-exact.
  peaks pass  chunk_fwd_peaks: whiten -> HPF (kernel K2) with the carried
          (xprev, yprev) -> forward prune (kernel K1f) with the carried
          envelope -> per-frame peak slots.  Every recurrence crosses the
          chunk boundary through its exact float32 carry.

The backward prune runs on the host over the sparse forward peaks, as
one native call (utils/native.bwd_prune_sparse, the C++ loop in
native/audfp_host.cpp, bit for bit with oracle.analyze.bwd_prune_sparse,
which it falls back to without a compiler); pair_kept_slots pairs the
kept peaks on the device, its frames and anchors padded to powers of two
so that one shape serves many files.  Results are fetched two chunks
behind the dispatch: each chunk's results are copied into pinned host
memory without blocking and the host waits on that chunk's own event, so
disk reads and host work overlap the card.

On a CUDA device the stats pass, the peaks pass and the pairing replay
captured CUDA graphs (StreamGraphs, one set per device, so a run over
many long files captures each key once).  A file has at most four keys:
the stats chunk, the first peaks chunk (it seeds the envelope from its
head), the other peaks chunks (the last, partial one is padded with
zeros and differs only in its frame counts) and its pairing bucket.
chunk_stats_below and the f64 mean fallback run eagerly.

Wrong-rate PCM WAVs stream through ResampledWavSource (chunked polyphase
resampling, bit-identical to resampling the whole file).  Other inputs
raise StreamUnsupported and callers take the in-memory path.

Tracing (utils/timing), recorded while the tracer or a profiler is on:
spans stream.read (a chunk's ranged read, staging and upload when the
device cache does not serve it), stream.stats and stream.peaks (each
whole pass), stream.fetch (_Fetch.get: the wait for a copy's event),
stream.bwd_prune (one backward prune, one per active shift) and
stream.pair (_pair_on_device with its host slot staging); counters
stream.chunks (chunk dispatches of both passes), stream.cache_hits (chunks
served from the device cache after their first read: the floor
corrections' and the peaks pass's), stream.below (chunk_stats_below
corrections), stream.fallback (f64 mean fallbacks), stream.fwd_peaks and
stream.kept_peaks (the backward prune's input and output), and
stream.bwd_native (the backward prunes the native loop served).
"""

from __future__ import annotations

import math
import wave
from collections import deque
from fractions import Fraction

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.oracle import analyze as oa
from audfprint_torch.ops.config import PipelineConfig
from audfprint_torch.utils import audio as audio_io
from audfprint_torch.ops import cuda_peaks as CP
from audfprint_torch.ops import pipeline as pipe
from audfprint_torch.ops import streaming as ST
from audfprint_torch.utils import graphs, native, timing


class StreamUnsupported(Exception):
    """Input cannot be streamed (not a decodable PCM WAV)."""


class _RawWav:
    """Ranged float32 mono sample reads from a PCM WAV at its native rate.

    Per-sample conversion (buf_to_float + float32 channel mean) is local,
    so chunked reads are bit-identical to utils.audio._read_wav's
    whole-file decode of the same ranges."""

    def __init__(self, filename: str):
        try:
            self._w = wave.open(filename, "rb")
        except (wave.Error, EOFError, OSError) as e:
            raise StreamUnsupported(f"not a PCM WAV: {filename}: {e}") from e
        self.rate = self._w.getframerate()
        self.nch = self._w.getnchannels()
        self.sampwidth = self._w.getsampwidth()
        self.n_samples = self._w.getnframes()

    def read(self, start: int, n: int) -> np.ndarray:
        """float32 mono samples [start, start+n) (short read at EOF)."""
        if start >= self.n_samples:
            return np.zeros(0, np.float32)
        self._w.setpos(start)
        raw = self._w.readframes(min(n, self.n_samples - start))
        x = audio_io.buf_to_float(raw, self.sampwidth)
        if self.nch > 1:
            x = x.reshape(-1, self.nch).mean(axis=1)
        return x.astype(np.float32)

    def read_i16(self, start: int, n: int) -> np.ndarray:
        """Raw int16 mono samples [start, start+n); only valid when
        sampwidth == 2 and nch == 1.  The chunk reader stages these at half
        the bytes; ops/streaming._to_f32 makes buf_to_float's exact f32 on
        the device."""
        if start >= self.n_samples:
            return np.zeros(0, np.int16)
        self._w.setpos(start)
        raw = self._w.readframes(min(n, self.n_samples - start))
        return np.frombuffer(raw, dtype="<i2")

    def close(self):
        self._w.close()


class WavPCMSource(_RawWav):
    """Ranged reads from a PCM WAV already at the analysis sample rate
    (raises StreamUnsupported otherwise; open_stream_source resamples
    wrong-rate WAVs chunk by chunk)."""

    def __init__(self, filename: str, sr: int):
        super().__init__(filename)
        if self.rate != sr:
            rate = self.rate
            self.close()
            raise StreamUnsupported(
                f"{filename}: sample rate {rate} != analysis rate {sr}; "
                "use open_stream_source for chunked resampling")


class ResampledWavSource:
    """Ranged reads from a PCM WAV at any rate, chunk-resampled to the
    analysis rate with scipy.signal.resample_poly.

    Each read resamples an FIR-phase-aligned input window: the window
    start is clamped to a multiple of `down` (so the polyphase phase
    matches the whole-file call) and extended by a halo covering the
    kaiser-windowed FIR's half length, so every returned sample is
    bit-identical to slicing utils.audio._resample of the whole file."""

    def __init__(self, filename: str, sr: int):
        self._raw = _RawWav(filename)
        g = math.gcd(self._raw.rate, sr)
        self.up = sr // g
        self.down = self._raw.rate // g
        self.n_samples = -(-self._raw.n_samples * self.up // self.down)
        # scipy's default half-length is 10*max(up,down) output-domain taps
        # (window=('kaiser', 5.0)); +4 input samples of slack for rounding
        self._halo = -(-(10 * max(self.up, self.down)) // self.up) + 4

    def read(self, start: int, n: int) -> np.ndarray:
        """float32 analysis-rate samples [start, start+n) (short at EOF)."""
        from scipy.signal import resample_poly

        if start >= self.n_samples:
            return np.zeros(0, np.float32)
        n = min(n, self.n_samples - start)
        up, down = self.up, self.down
        i0 = max(0, (start * down) // up - self._halo)
        i0 -= i0 % down                       # polyphase phase alignment
        i1 = min(self._raw.n_samples,
                 -(-((start + n) * down) // up) + self._halo)
        y = resample_poly(self._raw.read(i0, i1 - i0), up,
                          down).astype(np.float32)
        j0 = i0 * up // down                  # exact: i0 % down == 0
        seg = y[start - j0: start - j0 + n]
        if len(seg) < n:                      # defensive (EOF rounding)
            seg = np.pad(seg, (0, n - len(seg)))
        return seg

    def close(self):
        self._raw.close()


def open_stream_source(filename: str, sr: int):
    """PCM WAV -> ranged analysis-rate sample source (resampling when the
    native rate differs); raises StreamUnsupported for non-WAV inputs."""
    raw = _RawWav(filename)
    rate = raw.rate
    raw.close()
    if rate == sr:
        return WavPCMSource(filename, sr)
    return ResampledWavSource(filename, sr)


# depth of the dispatch-ahead window: chunk c + _LAG is dispatched before
# chunk c's results are read
_LAG = 2


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without stalling the stream: staged in
    pinned memory and copied asynchronously on CUDA (a pageable copy
    synchronises with all queued work)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _Fetch:
    """Device tensors copied to pinned host memory without blocking;
    `get()` waits for this copy alone and returns numpy arrays."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self._host = [t.to("cpu", non_blocking=True) for t in tensors]
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def get(self) -> list:
        with timing.span("stream.fetch"):
            if self._event is not None:
                self._event.synchronize()
            return [t.numpy() for t in self._host]


class _ChunkReader:
    """The chunk grid both passes share: one ranged read per chunk feeds
    every shift's (S, Nc) row block.

    16-bit mono WAVs at the analysis rate stage raw int16 rows (half the
    bytes; the device makes buf_to_float's exact f32).  Uploaded chunks are
    cached on the device between the two passes while their total stays
    under `cache_bytes` (2 GiB, about 14 h of int16 mono at 11025 Hz), so
    each chunk is read and shipped once; past the budget the second pass
    reads and uploads again and device memory stays O(chunk)."""

    def __init__(self, src, cfg: PipelineConfig, chunk_frames: int,
                 device: torch.device, cache_bytes: int = 2 << 30):
        self.src, self.cfg, self.device = src, cfg, device
        S = max(1, cfg.shifts)
        self.offs = np.array([s * cfg.n_hop // S for s in range(S)])
        navail = np.maximum(0, src.n_samples - self.offs)
        self.T_s = np.where(
            navail >= cfg.n_fft, 1 + (navail - cfg.n_fft) // cfg.n_hop,
            0).astype(np.int64)
        self.Tc = int(chunk_frames)
        self.Nc = ST.chunk_samples(self.Tc, cfg)
        self.nchunks = int(-(-self.T_s.max() // self.Tc))
        self._span = self.Nc + int(self.offs.max())
        self._i16 = (isinstance(src, _RawWav) and src.sampwidth == 2
                     and src.nch == 1)
        itemsize = 2 if self._i16 else 4
        self._cache_ok = (self.nchunks * S * self.Nc * itemsize
                          <= cache_bytes)
        self._dev: dict[int, tuple] = {}

    def n_frames(self, c: int) -> np.ndarray:
        """(S,) int32 valid frame counts of chunk c."""
        return np.clip(self.T_s - c * self.Tc, 0, self.Tc).astype(np.int32)

    def chunk(self, c: int) -> np.ndarray:
        """(S, Nc) f32/int16 audio rows of chunk c."""
        base = c * self.Tc * self.cfg.n_hop
        if self._i16:
            x = self.src.read_i16(base, self._span)
            buf = np.zeros((len(self.offs), self.Nc), np.int16)
        else:
            x = self.src.read(base, self._span)
            buf = np.zeros((len(self.offs), self.Nc), np.float32)
        for s in range(len(self.offs)):
            row = x[self.offs[s]: self.offs[s] + self.Nc]
            buf[s, : len(row)] = row
        return buf

    def chunk_dev(self, c: int):
        """(device (S, Nc) rows, device (S,) int32 n_frames, host n_frames),
        cached across the passes under the budget."""
        nf = self.n_frames(c)
        dev = self._dev.get(c)
        if dev is None:
            with timing.span("stream.read"):
                dev = (_to_device(self.chunk(c), self.device),
                       _to_device(nf, self.device))
            if self._cache_ok:
                self._dev[c] = dev
        else:
            timing.count("stream.cache_hits", 1)
        return dev[0], dev[1], nf


class StreamGraphs:
    """The streamed route's graph caches on one device: the stats pass
    (chunk_stats), the peaks pass (chunk_fwd_peaks_step, with the bump
    template as its state and (cfg, first chunk) as its static key) and
    the pairing (pair_kept_slots)."""

    def __init__(self, device):
        self.stats = graphs.GraphCache(ST.chunk_stats, device)
        self.peaks = graphs.GraphCache(ST.chunk_fwd_peaks_step, device)
        self.pair = graphs.GraphCache(ST.pair_kept_slots, device)

    def keys(self) -> list:
        return self.stats.keys() + self.peaks.keys() + self.pair.keys()


_GRAPHS: dict = {}


def stream_graphs(device) -> StreamGraphs:
    """The streamed route's graph caches of `device`, made on first use
    and kept for the process's life."""
    dev = torch.device(device)
    if dev not in _GRAPHS:
        _GRAPHS[dev] = StreamGraphs(dev)
    return _GRAPHS[dev]


def _chunk_bytes(rd: _ChunkReader, cfg: PipelineConfig) -> int:
    """An estimate of a chunk pass's device bytes: the fingerprint's
    for its (S, Nc) rows."""
    return pipe.fingerprint_bytes(1, rd.Nc, cfg)


def _stats_pass(rd: _ChunkReader, cfg: PipelineConfig):
    """Chunked whitening stats: per shift (gmax f32, mean f32).  The
    integer level sums make the mean chunking-invariant by construction;
    Fraction -> float is the correctly rounded total."""
    S = len(rd.offs)
    F = cfg.n_fft // 2 + 1
    cmax = np.zeros(S, np.float32)
    cmin = np.full((rd.nchunks, S), np.inf, np.float32)
    totals = [0] * S
    resmax = 0.0
    pend: deque = deque()

    def drain():
        nonlocal resmax
        c, fetch = pend.popleft()
        cm, cn, sums, rm = fetch.get()
        np.maximum(cmax, cm, out=cmax)
        cmin[c] = cn
        for s in range(S):
            totals[s] += ST.levels_to_int(sums[s])
        resmax = max(resmax, float(rm))

    cache = stream_graphs(rd.device).stats
    for c in range(rd.nchunks):
        dev, nf_dev, _nf = rd.chunk_dev(c)
        timing.count("stream.chunks", 1)
        pend.append((c, _Fetch(*cache(
            (dev, nf_dev), (), (cfg,), _chunk_bytes(rd, cfg)))))
        if len(pend) > _LAG:
            drain()
    while pend:
        drain()

    gmax = cmax
    active = (rd.T_s > 0) & (gmax > 0)
    if resmax > 0 or np.any(active & (gmax < 1e-30)):
        # a log output below 2^-34, or a floor below the provisional tiny
        # floor, breaks the split's exactness: take the f64 logm path
        return gmax, _exact_mean_fallback(rd, cfg, gmax)

    # floor correction: a chunk whose min |STFT| can fall below the final
    # whitening floor gets one chunk_stats_below pass.  The host floor only
    # flags chunks (the 1e-6 slack over-flags, never under-flags); the
    # device recomputes its own f32 floor exactly.
    floor = np.where(active, (np.maximum(gmax, np.float32(1e-37))
                              / np.float32(1e6)) * (1 + 1e-6), 0.0)
    flagged = np.nonzero((cmin < floor[None, :]).any(axis=1))[0]
    gmax_dev = _to_device(gmax, rd.device)
    for c in flagged:
        dev, nf_dev, _nf = rd.chunk_dev(int(c))
        timing.count("stream.below", 1)
        cnt, bsums, lfs, rm = _Fetch(*ST.chunk_stats_below(
            dev, nf_dev, gmax_dev, cfg)).get()
        if float(rm) > 0:
            return gmax, _exact_mean_fallback(rd, cfg, gmax)
        for s in range(S):
            if cnt[s]:
                totals[s] += (int(cnt[s]) * ST.levels_to_int(lfs[s])
                              - ST.levels_to_int(bsums[s]))

    mean = np.zeros(S, np.float32)
    for s in range(S):
        if rd.T_s[s] > 0:
            mean[s] = np.float32(
                float(Fraction(totals[s], 1 << 58)) / (int(rd.T_s[s]) * F))
    return gmax, mean


def _exact_mean_fallback(rd: _ChunkReader, cfg: PipelineConfig,
                         gmax: np.ndarray) -> np.ndarray:
    """Per-shift whitening mean from the fetched (S, T, 257) f32 log
    magnitudes, accumulated in f64 on the host (exact at these magnitudes
    and counts).  The stats pass takes it when its integer split cannot be
    exact; the tests hold the integer mean against it."""
    timing.count("stream.fallback", 1)
    S = len(rd.offs)
    totals = np.zeros(S, np.float64)
    gmax_dev = _to_device(np.asarray(gmax, np.float32), rd.device)
    for c in range(rd.nchunks):
        dev, _nf_dev, nf = rd.chunk_dev(c)
        (logm,) = _Fetch(ST.chunk_logm(dev, gmax_dev, cfg)).get()
        for s in range(S):
            if nf[s]:
                totals[s] += float(np.sum(logm[s, : nf[s]].astype(np.float64)))
    F = cfg.n_fft // 2 + 1
    mean = (totals / (np.maximum(rd.T_s, 1) * F)).astype(np.float32)
    return np.where(rd.T_s > 0, mean, 0.0).astype(np.float32)


def _peaks_pass(rd: _ChunkReader, cfg: PipelineConfig, gmax: np.ndarray,
                mean: np.ndarray):
    """Chunked whiten -> HPF -> forward prune for all shifts at once; the
    carries stay on the device between chunks.  Returns per shift
    (pk_t int64, pk_pos int64, pk_val f32, last_row f32 (F,))."""
    S = len(rd.offs)
    F = cfg.n_bins
    dev = rd.device
    # the HPF's (xprev, yprev) and the envelope start from zeros
    carry = tuple(torch.zeros((S, F), dtype=torch.float32, device=dev)
                  for _ in range(3))
    gmax_dev = _to_device(np.asarray(gmax, np.float32), dev)
    mean_dev = _to_device(np.asarray(mean, np.float32), dev)
    # the bump template, made once per (cfg, device): the graphs' state
    gvec = CP.gauss_vector_on(cfg, dev)
    cache = stream_graphs(dev).peaks

    ts = [[] for _ in range(S)]
    poss = [[] for _ in range(S)]
    vals = [[] for _ in range(S)]
    last_row = np.zeros((S, F), np.float32)
    pend: deque = deque()

    def drain():
        c, nf, fetch = pend.popleft()
        bins_h, valid_h, vals_h, lrow = fetch.get()
        for s in range(S):
            n = int(nf[s])
            if not n:
                continue
            tloc, slot = np.nonzero(valid_h[s, :n])
            ts[s].append(tloc.astype(np.int64) + c * rd.Tc)
            poss[s].append(bins_h[s, :n][tloc, slot].astype(np.int64))
            vals[s].append(vals_h[s, :n][tloc, slot])
            last_row[s] = lrow[s]

    for c in range(rd.nchunks):
        audio, nf_dev, nf = rd.chunk_dev(c)
        timing.count("stream.chunks", 1)
        xprev, yprev, env = carry
        out = cache(
            (audio, nf_dev, gmax_dev, mean_dev, xprev, yprev, env), (gvec,),
            (cfg, c == 0), _chunk_bytes(rd, cfg))
        carry = (out[5], out[6], out[4])
        pend.append((c, nf, _Fetch(*out[:4])))
        if len(pend) > _LAG:
            drain()
    while pend:
        drain()

    def cat(parts, dt):
        return np.concatenate(parts) if parts else np.zeros(0, dt)

    return [(cat(ts[s], np.int64), cat(poss[s], np.int64),
             cat(vals[s], np.float32), last_row[s]) for s in range(S)]


def _pow2(n: int, lo: int = 128) -> int:
    return max(lo, 1 << (max(1, int(n)) - 1).bit_length())


def _pair_on_device(kept: list, Tmax: int, cfg: PipelineConfig,
                    device: torch.device) -> list:
    """Pair the final kept peak streams: one pair_kept_slots dispatch for
    all shifts, one fetch (the anchor times are already on the host).
    Content-identical to the oracle peaks2landmarks/landmarks2hashes
    pairing (tests/test_torch_streaming.py holds the two equal).  The
    frames and the anchors are padded to powers of two (at least 128), as
    the JAX package pads them, so that one captured shape serves many
    files: frames past the file are empty, and the host slices off the
    padded anchors.

    kept: per shift (t ascending, bin ascending within a frame) kept-peak
    arrays, or None for an inactive shift.  Returns per active shift an
    (n, 2) int32 (t, hash) row array, in shift order."""
    K = cfg.maxpksperframe
    act = [x for x in kept if x is not None and len(x[0])]
    if not act:
        return []
    Tp = _pow2(Tmax)
    A = _pow2(max(len(x[0]) for x in act))
    S = len(kept)
    slots = np.zeros((S, Tp, K), np.int16)
    anchors = np.zeros((S, A), np.int64)
    n_a = [0] * S
    for s, x in enumerate(kept):
        if x is None or len(x[0]) == 0:
            continue
        t, p = x
        slot = np.arange(len(t)) - np.searchsorted(t, t)   # rank in frame
        slots[s, t, slot] = p.astype(np.int16) + 1
        anchors[s, : len(t)] = t * K + slot
        n_a[s] = len(t)
    nbytes = 16 * S * Tp * K * cfg.maxpairsperpeak
    (g,) = _Fetch(stream_graphs(device).pair(
        (slots, anchors), (), (cfg,), nbytes)).get()
    out = []
    for s in range(S):
        n = n_a[s]
        if not n:
            continue
        gs = g[s, :n]                                   # (n, fanout)
        lv = (gs >> 20) > 0
        tt = np.broadcast_to(kept[s][0][:, None], gs.shape)[lv]
        out.append(np.stack([tt, (gs & 0xFFFFF)[lv]],
                            axis=1).astype(np.int32))
    return out


def analyzer_params(cfg: PipelineConfig) -> P.AnalyzerParams:
    """The oracle's parameter record for a pipeline config."""
    return P.AnalyzerParams(
        density=cfg.density, n_fft=cfg.n_fft, n_hop=cfg.n_hop,
        shifts=cfg.shifts, maxpksperframe=cfg.maxpksperframe,
        maxpairsperpeak=cfg.maxpairsperpeak, f_sd=cfg.f_sd,
        targetdf=cfg.targetdf, mindt=cfg.mindt, targetdt=cfg.targetdt,
        hpf_pole=cfg.hpf_pole)


def _bwd_prune(n_frames: int, pk_t: np.ndarray, pk_pos: np.ndarray,
               pk_val: np.ndarray, last_row: np.ndarray,
               ap: P.AnalyzerParams) -> np.ndarray:
    """One shift's backward prune -> keep mask over its forward peaks:
    the native loop (utils/native.bwd_prune_sparse) on the envelope seed
    the oracle computes, or the oracle itself where the library is
    unavailable or does not take the input."""
    last_row = np.asarray(last_row, np.float32)
    gvec = P.gaussian_template(ap.f_sd, len(last_row) - 1).astype(np.float32)
    sthresh = oa.spreadpeaksinvector(last_row, ap.f_sd, gvec=gvec
                                     ).astype(np.float32)
    keep = native.bwd_prune_sparse(n_frames, pk_t, pk_pos, pk_val, sthresh,
                                   gvec, np.float32(ap.a_dec))
    if keep is None:
        return oa.bwd_prune_sparse(n_frames, pk_t, pk_pos, pk_val, last_row,
                                   ap)
    timing.count("stream.bwd_native", 1)
    return keep


def kept_peaks(filename: str, cfg: PipelineConfig, target_sr: int,
               chunk_frames: int, device: torch.device, stats=None):
    """The streamed analysis up to the pairing: -> (per shift (t, bin)
    kept-peak arrays or None for an inactive shift, frames of the longest
    shift, duration_sec).  `stats` as in wavfile2hashes_streaming."""
    src = open_stream_source(filename, target_sr)
    try:
        dur = src.n_samples / float(target_sr)
        rd = _ChunkReader(src, cfg, chunk_frames, device)
        if rd.nchunks == 0:
            return [], 0, dur
        if stats is None:
            with timing.span("stream.stats"):
                gmax, mean = _stats_pass(rd, cfg)
        else:
            gmax = np.asarray([s[0] for s in stats], np.float32)
            mean = np.asarray([s[1] for s in stats], np.float32)
        ap = analyzer_params(cfg)
        with timing.span("stream.peaks"):
            peaks = _peaks_pass(rd, cfg, gmax, mean)
        kept: list = []
        for s, (pk_t, pk_pos, pk_val, lrow) in enumerate(peaks):
            if not (rd.T_s[s] > 0 and gmax[s] > 0):
                kept.append(None)   # an empty or all-zero shift has no peaks
                continue
            with timing.span("stream.bwd_prune"):
                sel = _bwd_prune(int(rd.T_s[s]), pk_t, pk_pos, pk_val, lrow,
                                 ap)
            timing.count("stream.fwd_peaks", len(pk_t))
            timing.count("stream.kept_peaks", int(np.count_nonzero(sel)))
            kept.append((pk_t[sel], pk_pos[sel]))
        return kept, int(rd.T_s.max()), dur
    finally:
        src.close()


def wavfile2hashes_streaming(filename: str, cfg: PipelineConfig,
                             target_sr: int, device: torch.device,
                             chunk_frames: int = 8192,
                             stats=None) -> tuple[np.ndarray, float]:
    """File -> (sorted unique (N, 2) int32 (t, hash) rows, duration_sec).

    `stats`: optional per-shift list of (gmax, mean) whitening-stat
    overrides (a testing hook that pins the one scalar whose reduction
    order differs from the in-memory path)."""
    kept, tmax, dur = kept_peaks(filename, cfg, target_sr, chunk_frames,
                                 device, stats)
    with timing.span("stream.pair"):
        all_h = _pair_on_device(kept, tmax, cfg, device)
    if not all_h:
        return np.zeros((0, 2), np.int32), dur
    h = np.concatenate(all_h, axis=0)
    if h.size == 0:
        return np.zeros((0, 2), np.int32), dur
    return np.unique(h, axis=0).astype(np.int32), dur
