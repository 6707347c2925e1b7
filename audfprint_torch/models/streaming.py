"""Streaming (chunked) ingest (port of audfprint_tpu/models/streaming.py).

Analyses WAVs of any length with O(chunk) host and device memory: two
ranged read passes over the files, one device dispatch per chunk and pass
for a whole group of files, all their shifts batched into one (R, Nc) row
block, R = files x shifts (wavfiles2hashes_streaming; one file is a group
of one, and a row reads only its own file):

  stats pass  ops/streaming.chunk_stats gives the per-row |STFT| max and
          min and exact integer level sums of the log magnitudes; the host
          keeps Python-int totals, so the whitening mean is the correctly
          rounded mean of the same f32 values at any chunk size.  Chunks
          holding entries below the final floor gmax/1e6 get one
          chunk_stats_below correction, still integer-exact.
  peaks pass  chunk_fwd_peaks: whiten -> HPF (kernel K2) with the carried
          (xprev, yprev) -> forward prune (kernel K1f) with the carried
          envelope -> per-frame peak slots.  Every recurrence crosses the
          chunk boundary through its exact float32 carry.

The backward prune runs on the host over each file's sparse forward
peaks, as one native call (utils/native.bwd_prune_sparse, the C++ loop in
native/audfp_host.cpp, bit for bit with oracle.analyze.bwd_prune_sparse,
which it falls back to without a compiler); pair_kept_slots pairs the
kept peaks of one file on the device, its frames and anchors padded to
powers of two so that one shape serves many files.  Results are fetched
two chunks behind the dispatch: each chunk's results are copied into
pinned host memory without blocking and the host waits on that chunk's
own event, so disk reads and host work overlap the card.

On a CUDA device the stats pass, the peaks pass and the pairing replay
captured CUDA graphs (StreamGraphs, one set per device, so a run over
many long files captures each key once).  A group's rows are its files
padded to a power of two (empty rows have no frames), times the shifts,
so groups of 3 and 4 share their keys.  A group has three pass keys at
most: the stats chunk, the first peaks chunk (it seeds the envelope from
its head) and the other peaks chunks (the last, partial one is padded
with zeros and differs only in its frame counts); each file has its
pairing bucket.  chunk_stats_below and the f64 mean fallback run eagerly.

Wrong-rate PCM WAVs stream through ResampledWavSource (chunked polyphase
resampling, bit-identical to resampling the whole file).  Other inputs
raise StreamUnsupported and callers take the in-memory path.

Tracing (utils/timing), recorded while the tracer or a profiler is on:
spans stream.read (a chunk's ranged read, staging and upload when the
device cache does not serve it), stream.stats and stream.peaks (each
whole pass of a group), stream.fetch (_Fetch.get: the wait for a copy's event),
stream.bwd_prune (one backward prune, one per active shift) and
stream.pair (_pair_on_device with its host slot staging); counters
stream.chunks (chunk dispatches of both passes), stream.cache_hits (chunks
served from the device cache after their first read: the floor
corrections' and the peaks pass's), stream.below (chunk_stats_below
corrections), stream.fallback (f64 mean fallbacks), stream.fwd_peaks and
stream.kept_peaks (the backward prune's input and output), and
stream.bwd_native (the backward prunes the native loop served),
stream.groups and stream.group_files (the groups run through the passes
and the files in them: their ratio is the files a group).
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
    """The chunk grid both passes share, over a group of sources: row
    f * S + s is shift s of source f, with its own offset and frame count
    T_s, and one ranged read of a source a chunk feeds its S rows of the
    (R, Nc) block.  A None source pads the group with S empty rows, and a
    row whose source has ended has 0 frames in the later chunks, as a
    shift row does past its own end; `nchunks` is the longest row's.

    A group whose sources are all 16-bit mono WAVs at the analysis rate
    stages raw int16 rows (half the bytes; the device makes buf_to_float's
    exact f32), any other group float32.  Uploaded chunks are cached on
    the device between the two passes while the group's total stays under
    `cache_bytes` (2 GiB, about 14 h of int16 mono at 11025 Hz), so each
    chunk is read and shipped once; past the budget the second pass reads
    and uploads again and device memory stays O(chunk)."""

    def __init__(self, srcs: list, cfg: PipelineConfig, chunk_frames: int,
                 device: torch.device, cache_bytes: int = 2 << 30):
        self.srcs, self.cfg, self.device = list(srcs), cfg, device
        self.S = S = max(1, cfg.shifts)
        shift_offs = np.array([s * cfg.n_hop // S for s in range(S)])
        self.offs = np.tile(shift_offs, len(self.srcs))
        n = np.repeat([0 if x is None else x.n_samples for x in self.srcs], S)
        navail = np.maximum(0, n - self.offs)
        self.T_s = np.where(
            navail >= cfg.n_fft, 1 + (navail - cfg.n_fft) // cfg.n_hop,
            0).astype(np.int64)
        self.Tc = int(chunk_frames)
        self.Nc = ST.chunk_samples(self.Tc, cfg)
        self.nchunks = int(-(-self.T_s.max(initial=0) // self.Tc))
        self._span = self.Nc + int(shift_offs.max())
        self._i16 = all(isinstance(x, _RawWav) and x.sampwidth == 2
                        and x.nch == 1 for x in self.srcs if x is not None)
        itemsize = 2 if self._i16 else 4
        self._cache_ok = (self.nchunks * len(self.offs) * self.Nc * itemsize
                          <= cache_bytes)
        self._dev: dict[int, tuple] = {}

    def rows(self, f: int) -> slice:
        """Source f's shift rows."""
        return slice(f * self.S, (f + 1) * self.S)

    def n_frames(self, c: int) -> np.ndarray:
        """(R,) int32 valid frame counts of chunk c."""
        return np.clip(self.T_s - c * self.Tc, 0, self.Tc).astype(np.int32)

    def chunk(self, c: int) -> np.ndarray:
        """(R, Nc) f32/int16 audio rows of chunk c; a source with no frame
        left is not read."""
        base = c * self.Tc * self.cfg.n_hop
        buf = np.zeros((len(self.offs), self.Nc),
                       np.int16 if self._i16 else np.float32)
        live = self.n_frames(c) > 0
        for f, src in enumerate(self.srcs):
            if not live[self.rows(f)].any():
                continue
            x = (src.read_i16 if self._i16 else src.read)(base, self._span)
            for r in range(f * self.S, (f + 1) * self.S):
                row = x[self.offs[r]: self.offs[r] + self.Nc]
                buf[r, : len(row)] = row
        return buf

    def chunk_dev(self, c: int):
        """(device (R, Nc) rows, device (R,) int32 n_frames, host n_frames),
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


def _chunk_bytes(n_sources: int, Nc: int, cfg: PipelineConfig) -> int:
    """An estimate of a chunk pass's device bytes: the fingerprint's for
    the (n_sources * S, Nc) rows of a group."""
    return pipe.fingerprint_bytes(n_sources, Nc, cfg)


def _stats_pass(rd: _ChunkReader, cfg: PipelineConfig):
    """Chunked whitening stats: per row (gmax f32, mean f32).  The integer
    level sums make the mean chunking-invariant by construction;
    Fraction -> float is the correctly rounded total.  Where a source's
    integer split cannot be exact (a split residual in one of its rows, a
    floor below the provisional tiny floor, or a residual in the floor
    correction of a chunk its own rows flag), its rows take the f64 mean
    of _exact_mean_fallback: each source decides from its own rows alone,
    as it would in a group of one."""
    R, S = len(rd.offs), rd.S
    F = cfg.n_fft // 2 + 1
    cmax = np.zeros(R, np.float32)
    cmin = np.full((rd.nchunks, R), np.inf, np.float32)
    totals = [0] * R
    resmax = np.zeros(R, np.float32)
    pend: deque = deque()

    def drain():
        c, fetch = pend.popleft()
        cm, cn, sums, rm = fetch.get()
        np.maximum(cmax, cm, out=cmax)
        np.maximum(resmax, rm, out=resmax)
        cmin[c] = cn
        for r in range(R):
            totals[r] += ST.levels_to_int(sums[r])

    cache = stream_graphs(rd.device).stats
    nbytes = _chunk_bytes(len(rd.srcs), rd.Nc, cfg)
    for c in range(rd.nchunks):
        dev, nf_dev, _nf = rd.chunk_dev(c)
        timing.count("stream.chunks", 1)
        pend.append((c, _Fetch(*cache((dev, nf_dev), (), (cfg,), nbytes))))
        if len(pend) > _LAG:
            drain()
    while pend:
        drain()

    gmax = cmax
    active = (rd.T_s > 0) & (gmax > 0)
    # a log output below 2^-34, or a floor below the provisional tiny
    # floor, breaks the split's exactness: that source takes the f64 path
    fall = ((resmax > 0) | (active & (gmax < 1e-30))).reshape(-1, S).any(1)

    # floor correction: a chunk whose min |STFT| can fall below the final
    # whitening floor gets one chunk_stats_below pass over the group.  The
    # host floor only flags chunks (the 1e-6 slack over-flags, never
    # under-flags); the device recomputes its own f32 floor exactly.  A
    # source takes the correction only in the chunks its own rows flag.
    floor = np.where(active, (np.maximum(gmax, np.float32(1e-37))
                              / np.float32(1e6)) * (1 + 1e-6), 0.0)
    flag = (cmin < floor[None, :]).reshape(rd.nchunks, -1, S).any(2)
    gmax_dev = _to_device(gmax, rd.device)
    for c in range(rd.nchunks):
        todo = np.nonzero(flag[c] & ~fall)[0]
        if not len(todo):
            continue
        dev, nf_dev, _nf = rd.chunk_dev(c)
        timing.count("stream.below", 1)
        cnt, bsums, lfs, rm = _Fetch(*ST.chunk_stats_below(
            dev, nf_dev, gmax_dev, cfg)).get()
        for f in todo:
            if rm[rd.rows(f)].max() > 0:
                fall[f] = True
                continue
            for r in range(f * S, (f + 1) * S):
                if cnt[r]:
                    totals[r] += (int(cnt[r]) * ST.levels_to_int(lfs[r])
                                  - ST.levels_to_int(bsums[r]))

    mean = np.zeros(R, np.float32)
    for r in range(R):
        if rd.T_s[r] > 0:
            mean[r] = np.float32(
                float(Fraction(totals[r], 1 << 58)) / (int(rd.T_s[r]) * F))
    if fall.any():
        timing.count("stream.fallback", int(fall.sum()))
        mean = np.where(np.repeat(fall, S),
                        _exact_mean_fallback(rd, cfg, gmax), mean)
    return gmax, mean


def _exact_mean_fallback(rd: _ChunkReader, cfg: PipelineConfig,
                         gmax: np.ndarray) -> np.ndarray:
    """Per-row whitening mean from the fetched (R, T, 257) f32 log
    magnitudes, accumulated in f64 on the host (exact at these magnitudes
    and counts).  The stats pass takes it for a source whose integer split
    cannot be exact; the tests hold the integer mean against it."""
    totals = np.zeros(len(rd.offs), np.float64)
    gmax_dev = _to_device(np.asarray(gmax, np.float32), rd.device)
    for c in range(rd.nchunks):
        dev, _nf_dev, nf = rd.chunk_dev(c)
        (logm,) = _Fetch(ST.chunk_logm(dev, gmax_dev, cfg)).get()
        for r in np.nonzero(nf)[0]:
            totals[r] += float(np.sum(logm[r, : nf[r]].astype(np.float64)))
    F = cfg.n_fft // 2 + 1
    mean = (totals / (np.maximum(rd.T_s, 1) * F)).astype(np.float32)
    return np.where(rd.T_s > 0, mean, 0.0).astype(np.float32)


def _peaks_pass(rd: _ChunkReader, cfg: PipelineConfig, gmax: np.ndarray,
                mean: np.ndarray):
    """Chunked whiten -> HPF -> forward prune for all rows at once (K1f
    takes the group's rows as one launch); the carries stay on the device
    between chunks.  Returns per row (pk_t int64, pk_pos int64, pk_val
    f32, last_row f32 (F,))."""
    R = len(rd.offs)
    F = cfg.n_bins
    dev = rd.device
    # the HPF's (xprev, yprev) and the envelope start from zeros
    carry = tuple(torch.zeros((R, F), dtype=torch.float32, device=dev)
                  for _ in range(3))
    gmax_dev = _to_device(np.asarray(gmax, np.float32), dev)
    mean_dev = _to_device(np.asarray(mean, np.float32), dev)
    # the bump template, made once per (cfg, device): the graphs' state
    gvec = CP.gauss_vector_on(cfg, dev)
    cache = stream_graphs(dev).peaks
    nbytes = _chunk_bytes(len(rd.srcs), rd.Nc, cfg)

    ts = [[] for _ in range(R)]
    poss = [[] for _ in range(R)]
    vals = [[] for _ in range(R)]
    last_row = np.zeros((R, F), np.float32)
    pend: deque = deque()

    def drain():
        c, nf, fetch = pend.popleft()
        bins_h, valid_h, vals_h, lrow = fetch.get()
        for r in range(R):
            n = int(nf[r])
            if not n:
                continue
            tloc, slot = np.nonzero(valid_h[r, :n])
            ts[r].append(tloc.astype(np.int64) + c * rd.Tc)
            poss[r].append(bins_h[r, :n][tloc, slot].astype(np.int64))
            vals[r].append(vals_h[r, :n][tloc, slot])
            last_row[r] = lrow[r]

    for c in range(rd.nchunks):
        audio, nf_dev, nf = rd.chunk_dev(c)
        timing.count("stream.chunks", 1)
        xprev, yprev, env = carry
        out = cache(
            (audio, nf_dev, gmax_dev, mean_dev, xprev, yprev, env), (gvec,),
            (cfg, c == 0), nbytes)
        carry = (out[5], out[6], out[4])
        pend.append((c, nf, _Fetch(*out[:4])))
        if len(pend) > _LAG:
            drain()
    while pend:
        drain()

    def cat(parts, dt):
        return np.concatenate(parts) if parts else np.zeros(0, dt)

    return [(cat(ts[r], np.int64), cat(poss[r], np.int64),
             cat(vals[r], np.float32), last_row[r]) for r in range(R)]


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


def _group_kept(srcs: list, cfg: PipelineConfig, chunk_frames: int,
                device: torch.device, stats=None) -> list:
    """The streamed analysis of a group of sources up to the pairing, one
    stats pass and one peaks pass over all their rows -> per source (per
    shift (t, bin) kept-peak arrays or None for an inactive shift, frames
    of its longest shift).  `stats`: None, or per source a per-shift list
    of (gmax, mean) overrides (None for a padding source)."""
    rd = _ChunkReader(srcs, cfg, chunk_frames, device)
    S = rd.S
    timing.count("stream.groups", 1)
    timing.count("stream.group_files",
                 sum(x is not None for x in rd.srcs))
    if rd.nchunks == 0:
        return [([None] * S, 0) for _ in rd.srcs]
    if stats is None:
        with timing.span("stream.stats"):
            gmax, mean = _stats_pass(rd, cfg)
    else:
        pinned = np.asarray([st for per in stats
                             for st in (per or [(0.0, 0.0)] * S)],
                            np.float32)
        gmax, mean = pinned[:, 0], pinned[:, 1]
    ap = analyzer_params(cfg)
    with timing.span("stream.peaks"):
        peaks = _peaks_pass(rd, cfg, gmax, mean)
    out = []
    for f in range(len(rd.srcs)):
        kept: list = []
        for r in range(f * S, (f + 1) * S):
            if not (rd.T_s[r] > 0 and gmax[r] > 0):
                kept.append(None)   # an empty or all-zero shift has no peaks
                continue
            pk_t, pk_pos, pk_val, lrow = peaks[r]
            with timing.span("stream.bwd_prune"):
                sel = _bwd_prune(int(rd.T_s[r]), pk_t, pk_pos, pk_val, lrow,
                                 ap)
            timing.count("stream.fwd_peaks", len(pk_t))
            timing.count("stream.kept_peaks", int(np.count_nonzero(sel)))
            kept.append((pk_t[sel], pk_pos[sel]))
        out.append((kept, int(rd.T_s[rd.rows(f)].max())))
    return out


def _hashes(kept: list, tmax: int, cfg: PipelineConfig,
            device: torch.device) -> np.ndarray:
    """One source's kept peaks -> its sorted unique (N, 2) int32 rows."""
    with timing.span("stream.pair"):
        all_h = _pair_on_device(kept, tmax, cfg, device)
    if not all_h:
        return np.zeros((0, 2), np.int32)
    h = np.concatenate(all_h, axis=0)
    if h.size == 0:
        return np.zeros((0, 2), np.int32)
    return np.unique(h, axis=0).astype(np.int32)


def kept_peaks(filename: str, cfg: PipelineConfig, target_sr: int,
               chunk_frames: int, device: torch.device, stats=None):
    """The streamed analysis of one file up to the pairing: -> (per shift
    (t, bin) kept-peak arrays or None for an inactive shift, frames of the
    longest shift, duration_sec).  `stats` as in wavfile2hashes_streaming."""
    src = open_stream_source(filename, target_sr)
    try:
        ((kept, tmax),) = _group_kept(
            [src], cfg, chunk_frames, device,
            None if stats is None else [stats])
        return kept, tmax, src.n_samples / float(target_sr)
    finally:
        src.close()


# what reading a file can raise: the file is reported and left out
_READ_ERRORS = (StreamUnsupported, OSError, ValueError, audio_io.DecodeError)


def _groups(srcs: dict, cfg: PipelineConfig, chunk_frames: int,
            device: torch.device) -> list:
    """The sources' indices cut into groups in input order.  A group's
    rows are its sources padded to a power of two, so that groups of 3
    and 4 share one key; a source joins the group before it while the
    group's pass bytes fit the graphs' budget (graphs.budget_bytes) and
    its uploaded chunks the device cache's 2 GiB: a group past the cache
    would read and upload every chunk twice, which its files alone
    would not."""
    Nc = ST.chunk_samples(int(chunk_frames), cfg)
    budget = graphs.budget_bytes(torch.device(device))
    out: list = []
    for i in srcs:
        if out:
            g = out[-1] + [i]
            n = P.next_pow2(len(g))
            rd = _ChunkReader([srcs[j] for j in g] + [None] * (n - len(g)),
                              cfg, chunk_frames, device)
            if _chunk_bytes(n, Nc, cfg) <= budget and rd._cache_ok:
                out[-1] = g
                continue
        out.append([i])
    return out


def wavfiles2hashes_streaming(filenames: list, cfg: PipelineConfig,
                              target_sr: int, device: torch.device,
                              chunk_frames: int = 8192,
                              stats=None) -> list:
    """Files -> per file (sorted unique (N, 2) int32 (t, hash) rows,
    duration_sec), or the exception reading it raised (_READ_ERRORS).

    The files run as groups (_groups): each group's stats and peaks passes
    take all its files' shift rows at once, and the backward prune and the
    pairing run a file at a time, so every file's rows are what it gives
    alone.  A file that does not open is left out of the groups; where a
    group's passes raise, its files run again one at a time.  `stats`:
    optional per-file list of per-shift (gmax, mean) whitening-stat
    overrides (a testing hook that pins the one scalar whose reduction
    order differs from the in-memory path)."""
    out: list = [None] * len(filenames)
    srcs: dict = {}
    for i, name in enumerate(filenames):
        try:
            srcs[i] = open_stream_source(name, target_sr)
        except _READ_ERRORS as e:
            out[i] = e

    def run(group: list) -> None:
        pad = P.next_pow2(len(group)) - len(group)
        try:
            kept = _group_kept(
                [srcs[i] for i in group] + [None] * pad, cfg, chunk_frames,
                device, None if stats is None
                else [stats[i] for i in group] + [None] * pad)
        except _READ_ERRORS as e:
            if len(group) == 1:
                out[group[0]] = e
                return
            for i in group:
                run([i])
            return
        for i, (k, tmax) in zip(group, kept):
            out[i] = (_hashes(k, tmax, cfg, device),
                      srcs[i].n_samples / float(target_sr))

    try:
        for group in _groups(srcs, cfg, chunk_frames, device):
            run(group)
    finally:
        for src in srcs.values():
            src.close()
    return out


def wavfile2hashes_streaming(filename: str, cfg: PipelineConfig,
                             target_sr: int, device: torch.device,
                             chunk_frames: int = 8192,
                             stats=None) -> tuple[np.ndarray, float]:
    """File -> (sorted unique (N, 2) int32 (t, hash) rows, duration_sec):
    a group of one.  `stats`: optional per-shift list of (gmax, mean)
    overrides, as in wavfiles2hashes_streaming."""
    (got,) = wavfiles2hashes_streaming(
        [filename], cfg, target_sr, device, chunk_frames,
        None if stats is None else [stats])
    if isinstance(got, Exception):
        raise got
    return got
