"""Analyzer: the user-facing analysis model (port of audfprint_tpu/models/analyzer.py).

Mirrors the reference class surface (wavfile2hashes / wavfile2peaks /
ingest) plus the batched entry points.  All DSP runs through
ops.pipeline on `device`; decode stays on the host.  Audio lengths are
padded into geometric buckets so batches share a few shapes.  On one
CUDA device the batched fingerprint (fingerprint_batch_compact_k) and
the batched peaks of `precompute -K` (peaks_batch), the JAX package's
jitted functions of those names, are captured as CUDA graphs per shape
key and replayed (utils/graphs.GraphCache).  WAVs longer than
`stream_above_sec` take the chunked streamed route (models/streaming.py)
with O(chunk) host and device memory, whose passes replay graphs too.
"""

from __future__ import annotations

import os

import numpy as np

from audfprint_torch import params as P
from audfprint_torch.ops.config import PipelineConfig
from audfprint_torch.utils import audio as audio_io
from audfprint_torch.utils import formats
from audfprint_torch.models import streaming as STM
from audfprint_torch.ops import pipeline as pipe
from audfprint_torch.utils import graphs
from audfprint_torch.utils.device import resolve_device


def _bucket_len(n: int, minimum: int = 1 << 16) -> int:
    """Pad length to the next {1, 1.5} x power-of-two bucket."""
    b = minimum
    while b < n:
        if (b * 3) // 2 >= n and b >= minimum * 2:
            return (b * 3) // 2
        b *= 2
    return b


class Analyzer:
    def __init__(self,
                 density: float = P.DENSITY,
                 target_sr: int = P.TARGET_SR,
                 n_fft: int = P.N_FFT,
                 n_hop: int = P.N_HOP,
                 shifts: int = P.SHIFTS,
                 maxpksperframe: int = P.MAX_PKS_PER_FRAME,
                 maxpairsperpeak: int = P.MAX_PAIRS_PER_PEAK,
                 f_sd: float = P.F_SD,
                 fail_on_error: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.density = density
        self.target_sr = target_sr
        self.n_fft = n_fft
        self.n_hop = n_hop
        self.shifts = max(1, shifts)
        self.maxpksperframe = maxpksperframe
        self.maxpairsperpeak = maxpairsperpeak
        self.f_sd = f_sd
        self.fail_on_error = fail_on_error
        self.soundfiledur = 0.0   # duration of last-analyzed file (reference)
        # rows per device dispatch: bounds device memory for huge ingest
        # lists; the peak prune is bound by its serial time chain, so wide
        # batches are what fill the card
        self.max_batch_rows = 256
        # streamed (chunked) ingest for very long inputs: PCM WAVs longer
        # than stream_above_sec analyse chunk by chunk with O(chunk) host
        # and device memory (models/streaming.py).  0 disables streaming.
        self.stream_above_sec = 3600.0
        self.stream_chunk_frames = 8192
        # the batched fingerprint's captured graphs, one per shape key
        self._graphs = graphs.GraphCache(pipe.fingerprint_batch_compact_k,
                                         self.device)
        # and the batched peaks' (precompute -K)
        self._peaks = graphs.GraphCache(pipe.peaks_batch, self.device)

    # -- config ---------------------------------------------------------

    @property
    def config(self) -> PipelineConfig:
        return PipelineConfig(
            density=self.density, n_fft=self.n_fft, n_hop=self.n_hop,
            shifts=self.shifts, maxpksperframe=self.maxpksperframe,
            maxpairsperpeak=self.maxpairsperpeak, f_sd=self.f_sd)

    def params_dict(self) -> dict:
        """Analyzer params persisted into the DB for compat checks."""
        return {"density": self.density, "samplerate": self.target_sr,
                "n_fft": self.n_fft, "n_hop": self.n_hop,
                "shifts": self.shifts, "fanout": self.maxpairsperpeak}

    # -- decode ---------------------------------------------------------

    def read_audio(self, filename: str) -> np.ndarray:
        d, _sr = audio_io.audio_read(filename, sr=self.target_sr, channels=1)
        self.soundfiledur = float(len(d)) / self.target_sr
        return d

    # -- single-file API (reference parity) ------------------------------

    def wavfile2hashes(self, filename: str) -> np.ndarray:
        """File -> (N, 2) int32 sorted unique (t, hash) rows.

        `.afpt` inputs short-circuit to hashes_load; `.afpk` peak files are
        re-paired into landmarks and hashed by the numpy oracle."""
        ext = os.path.splitext(filename)[1]
        if ext == formats.PRECOMPEXT:
            hashes = formats.hashes_load(filename)
        elif ext == formats.PRECOMPPKEXT:
            from audfprint_torch.oracle import analyze as oa

            params = P.AnalyzerParams(
                density=self.density, n_fft=self.n_fft, n_hop=self.n_hop,
                maxpairsperpeak=self.maxpairsperpeak, f_sd=self.f_sd)
            peaks = formats.peaks_load(filename)
            h = oa.landmarks2hashes(oa.peaks2landmarks(peaks, params))
            hashes = (np.unique(h, axis=0) if len(h)
                      else np.zeros((0, 2), np.int32))
        elif self._should_stream(filename):
            return self.wavfile2hashes_streaming(filename)
        else:
            return self.samples2hashes(self.read_audio(filename))
        # the reference reports duration from the hash extent here
        self.soundfiledur = (
            float(hashes[:, 0].max()) * self.n_hop / self.target_sr
            if len(hashes) else 0.0)
        return hashes

    def samples2hashes(self, d: np.ndarray) -> np.ndarray:
        return self.samples_batch2hashes([d])[0]

    def wavfile2peaks(self, filename: str):
        """File -> list of (frame, bin) peaks (sorted, unique across
        shifts).  `.afpk` inputs short-circuit to peaks_load."""
        if os.path.splitext(filename)[1] == formats.PRECOMPPKEXT:
            return formats.peaks_load(filename)
        return self.samples_batch2peaks([self.read_audio(filename)])[0]

    def samples_batch2peaks(self, signals: list) -> list:
        """Batched peak extraction (the `precompute -K` path): list of
        sample arrays -> list of sorted unique (frame, bin) peak tuples per
        file, the union across shifts.  Each group replays the captured
        graph of its key (rows, bucket length, int16 or float32, config),
        its inputs staged through pinned memory."""
        out: list = [None] * len(signals)
        cfg = self.config
        for idxs, batch, lens in self.stage_groups(signals):
            bins, valid = self._peaks(
                (batch, lens), (), (cfg,),
                pipe.fingerprint_bytes(*batch.shape, cfg))
            bins = bins.cpu().numpy()
            valid = valid.cpu().numpy()
            for row, i in enumerate(idxs):
                pairs = []
                for s in range(cfg.shifts):
                    tt, pp = np.nonzero(valid[row, s])
                    pairs.append(np.stack([tt, bins[row, s][tt, pp]], axis=1))
                pk = np.unique(np.concatenate(pairs, axis=0), axis=0)
                out[i] = [(int(a), int(b)) for a, b in pk]
        return out

    def ingest(self, ht, filename: str):
        """Analyze one file and store it (reference ingest) -> (dur, nhash)."""
        hashes = self.wavfile2hashes(filename)
        ht.store_vectorized(filename, hashes)
        return self.soundfiledur, len(hashes)

    # -- streamed (chunked) ingest for very long inputs -------------------

    def _should_stream(self, filename: str) -> bool:
        """True when this file is longer than stream_above_sec and can
        stream (a PCM WAV at any rate; wrong rates stream through chunked
        polyphase resampling).  Header probe only, no decode."""
        if not self.stream_above_sec or not filename.lower().endswith(".wav"):
            return False
        try:
            src = STM.open_stream_source(filename, self.target_sr)
        except STM.StreamUnsupported:
            return False
        dur = src.n_samples / float(self.target_sr)
        src.close()
        return dur > self.stream_above_sec

    def wavfile2hashes_streaming(self, filename: str,
                                 chunk_frames: int | None = None
                                 ) -> np.ndarray:
        """Chunked analysis of a WAV of any length: host and device memory
        O(chunk) instead of O(file) (models/streaming.py)."""
        h, dur = STM.wavfile2hashes_streaming(
            filename, self.config, self.target_sr, self.device,
            chunk_frames or self.stream_chunk_frames)
        self.soundfiledur = dur
        return h

    def wavfiles2hashes_streaming(self, filenames: list,
                                  chunk_frames: int | None = None) -> list:
        """Chunked analysis of many WAVs, their passes run as groups
        (models/streaming.wavfiles2hashes_streaming): per file (hashes,
        duration), or the exception reading it raised."""
        return STM.wavfiles2hashes_streaming(
            filenames, self.config, self.target_sr, self.device,
            chunk_frames or self.stream_chunk_frames)

    # -- batched API --------------------------------------------------------

    def stage_groups(self, signals: list):
        """Stage sample arrays into padded (rows, bucket_len) host batches.

        Returns [(idxs, batch, lens)] groups: signals grouped by length
        bucket, at most max_batch_rows rows per group, row count padded to
        a power of two.  All-int16 inputs stay raw PCM (converted exactly
        on the device at half the transfer bytes)."""
        order = sorted(range(len(signals)), key=lambda i: len(signals[i]))
        groups: dict[int, list[int]] = {}
        for i in order:
            groups.setdefault(_bucket_len(len(signals[i])), []).append(i)
        rows_cap = max(1, int(self.max_batch_rows))
        all_i16 = bool(signals) and all(
            s.dtype == np.int16 for s in signals if len(s))
        out = []
        for blen, g_idxs in groups.items():
            for i0 in range(0, len(g_idxs), rows_cap):
                idxs = g_idxs[i0: i0 + rows_cap]
                nrows = min(P.next_pow2(len(idxs)), rows_cap)
                batch = np.zeros((nrows, blen),
                                 np.int16 if all_i16 else np.float32)
                lens = np.zeros(nrows, np.int32)
                for row, i in enumerate(idxs):
                    s = signals[i]
                    if not all_i16 and s.dtype == np.int16:
                        s = s.astype(np.float32) / float(1 << 15)
                    batch[row, : len(s)] = s
                    lens[row] = len(s)
                out.append((idxs, batch, lens))
        return out

    def _hash_cap_estimate(self, dur_sec: float) -> int:
        """Per-file unique-hash estimate for the single-fetch buffer: about
        density hashes/s, +50% per extra shift, 1.5x + 64 headroom.  An
        underestimate only costs a per-row fetch of the full buffer."""
        factor = 1.0 + 0.5 * (self.shifts - 1)
        return P.next_pow2(
            int(dur_sec * self.density * factor * 1.5) + 64, 128)

    def fingerprint_async(self, signals: list):
        """Queue fingerprinting of sample arrays on the device without
        waiting; returns a handle for fingerprint_resolve.  Each group
        replays the captured graph of its key (rows, bucket length, int16
        or float32 input, config, k), captured on the key's first call
        after the budget rule (GraphCache.reserve), which never refuses
        the batch."""
        cfg = self.config
        groups = self.stage_groups(signals)
        calls = []
        for _idxs, batch, lens in groups:
            k = self._hash_cap_estimate(batch.shape[1] / self.target_sr)
            calls.append(((batch, lens), (), (cfg, k),
                          pipe.fingerprint_bytes(*batch.shape, cfg)))
        self._graphs.reserve(calls)
        handle = [(idxs, self._graphs(*call[:3]))
                  for (idxs, _b, _l), call in zip(groups, calls)]
        return (len(signals), handle)

    def fingerprint_resolve(self, handle) -> list:
        """Materialise fingerprint_async results as (n, 2) int32 arrays:
        one device-to-host copy per dispatch group (rows and counts in one
        buffer); rows past the buffer's k read the full on-device buffer."""
        n, groups = handle
        out: list = [None] * n
        for idxs, (buf_dev, th_dev) in groups:
            buf = buf_dev.cpu().numpy()
            k = buf.shape[1] - 1
            counts = buf[:, k, 0]
            for row, i in enumerate(idxs):
                c = int(counts[row])
                if c <= k:
                    out[i] = buf[row, :c].astype(np.int32)
                else:
                    out[i] = th_dev[row, :c].cpu().numpy().astype(np.int32)
        return out

    def samples_batch2hashes(self, signals: list) -> list:
        """Fingerprint a list of sample arrays in shared-bucket batches."""
        return self.fingerprint_resolve(self.fingerprint_async(signals))

    def wavfiles2hashes(self, filenames: list) -> list:
        """Batched fingerprinting of many files -> list of (N, 2) arrays
        (None for failed decodes when fail_on_error is False).  Files past
        stream_above_sec analyse chunk-wise, as one group, instead of
        joining the in-memory batch."""
        long = [i for i, f in enumerate(filenames) if self._should_stream(f)]
        streamed = dict(zip(long, self.wavfiles2hashes_streaming(
            [filenames[i] for i in long])))
        signals, durs, oks = [], [], []
        for i, f in enumerate(filenames):
            try:
                if i in streamed:
                    got = streamed[i]
                    if isinstance(got, Exception):
                        raise got
                    self.soundfiledur = got[1]
                    signals.append(np.zeros(0, np.float32))
                else:
                    signals.append(self.read_audio(f))
                durs.append(self.soundfiledur)
                oks.append(True)
            except audio_io.DecodeError:
                if self.fail_on_error:
                    raise
                signals.append(np.zeros(0, np.float32))
                durs.append(0.0)
                oks.append(False)
        hashes = self.samples_batch2hashes(signals)
        for i, got in streamed.items():
            if oks[i]:
                hashes[i] = got[0]
        self.durations = durs
        return [h if ok else None for h, ok in zip(hashes, oks)]

    def glob2hashtable(self, pattern: str, ht=None):
        """Build (or extend) a HashTable from a glob pattern: audio batched
        on the device, precomputed .afpt/.afpk loaded directly; store order
        is input order."""
        import glob as _glob

        from audfprint_torch.index.hash_table import HashTable
        if ht is None:
            ht = HashTable()
        names = sorted(_glob.glob(pattern))
        pre = {n for n in names
               if os.path.splitext(n)[1] in (formats.PRECOMPEXT,
                                             formats.PRECOMPPKEXT)}
        wav_hashes = iter(self.wavfiles2hashes(
            [n for n in names if n not in pre]))
        for name in names:
            h = (self.wavfile2hashes(name) if name in pre
                 else next(wav_hashes))
            if h is not None:
                ht.store_vectorized(name, h)
        return ht
