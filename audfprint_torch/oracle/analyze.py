"""Oracle analyzer: audio samples -> masked spectral peaks -> landmarks -> hashes.

Faithful, readable NumPy implementation of the reference pipeline
(SURVEY.md §2.3.3, audfprint_analyze.py):

  spectrogram:   |STFT| -> log floor -> scalar-mean whitening -> onset HPF
                 -> drop nyquist row (256 bins so f1 fits 8 bits)
  find_peaks:    forward decaying-threshold prune (audfprint_analyze.py:~200-250)
                 + backward prune (:~252-278)
  peaks2landmarks: fanout pairing within (mindt <= dt < targetdt, |df| < targetdf)
                 (:~370-410)
  landmarks2hashes: 20-bit pack (f1:8 | df:6 | dt:6)  (:~100-130)

The port's own copy of audfprint_tpu/oracle/analyze.py: the bit-compat
gold standard for `audfprint_torch.ops` and its CUDA kernels.  Everything
runs in float32 by default so the kernels can match exactly.
"""

from __future__ import annotations

import numpy as np

from audfprint_torch import params as P
from audfprint_torch.oracle import stft as _stft


# ---------------------------------------------------------------------------
# Spectrogram front end
# ---------------------------------------------------------------------------

def spectrogram(d: np.ndarray, params: P.AnalyzerParams | None = None,
                dtype=np.float32, hpf: bool = True) -> np.ndarray:
    """Audio samples -> whitened, HPF'd log-magnitude spectrogram (T, n_bins).

    hpf=False skips the onset high-pass and returns the whitened
    log-magnitude directly — the reference's `--illustrate` (-I) display
    draws that, while `--illustrate-hpf` (-J) applies the HPF first
    (audfprint_match.py:~300-380).  The analysis path always uses hpf=True.

    NOTE: time-major orientation (T, F) — internal choice of this rebuild; the
    reference keeps librosa (F, T).  All downstream oracle/device code uses (T, F).
    """
    params = params or P.AnalyzerParams()
    d = np.asarray(d, dtype=dtype)
    win = P.hann_window(params.n_fft).astype(dtype)
    sgram = np.abs(_stft.stft(d, n_fft=params.n_fft, hop_length=params.n_hop,
                              window=win)).T.astype(dtype)   # (T, 257)
    if sgram.size == 0:
        return np.zeros((0, params.n_bins), dtype=dtype)
    sgrammax = np.max(sgram)
    if sgrammax > 0.0:
        sgram = np.log(np.maximum(sgram, sgrammax / 1e6))
        sgram = sgram - np.mean(sgram, dtype=dtype)
    # else: identically-zero signal passes through as zeros (reference prints a
    # warning and continues — audfprint_analyze.py find_peaks).
    sgram = sgram.astype(dtype)
    if not hpf:
        return sgram[:, : params.n_bins]
    # Onset high-pass along time, per freq row: y[t] = x[t] - x[t-1] + pole*y[t-1]
    # == lfilter([1, -1], [1, -HPF_POLE**(1/OVERSAMP)], row).  Explicit f32
    # recurrence so the device scan can match bit-for-bit.
    pole = dtype(params.hpf_pole ** (1.0 / P.OVERSAMP))
    out = np.empty_like(sgram)
    xprev = np.zeros(sgram.shape[1], dtype=dtype)
    yprev = np.zeros(sgram.shape[1], dtype=dtype)
    for t in range(sgram.shape[0]):
        y = (sgram[t] - xprev) + pole * yprev
        out[t] = y
        xprev = sgram[t]
        yprev = y
    # Discard the nyquist row so bins fit in F1_BITS (reference "[:-1,]").
    return out[:, : params.n_bins]


# ---------------------------------------------------------------------------
# Peak picking
# ---------------------------------------------------------------------------

def locmax(vec: np.ndarray, indices: bool = False):
    """Boolean mask of local maxima; endpoints per the reference convention.

    Reference audfprint_analyze.py locmax: point i is a max iff
    (i == 0 or v[i] >= v[i-1]) and not (v[i+1] >= v[i]); the last point is a
    max iff v[-1] >= v[-2].
    """
    vec = np.asarray(vec)
    n = len(vec)
    nbr = np.zeros(n + 1, dtype=bool)
    nbr[0] = True
    nbr[1:-1] = np.greater_equal(vec[1:], vec[:-1])
    maxmask = nbr[:-1] & ~nbr[1:]
    if indices:
        return np.nonzero(maxmask)[0]
    return maxmask


def spreadpeaks(peaks, npoints=None, width: float = P.F_SD, base=None,
                gvec: np.ndarray | None = None) -> np.ndarray:
    """Max of gaussian bumps at (pos, val) peaks over a length-npoints vector.

    Reference audfprint_analyze.py spreadpeaks: the bump spans the FULL
    vector (no truncation; upstream evaluates the exponential over all
    bins).  Tabulated once in gaussian_template so the kernels index
    the identical values.
    """
    if base is None:
        vec = np.zeros(npoints, dtype=np.float32)
    else:
        vec = np.array(base, copy=True)
        npoints = len(vec)
    if gvec is None:
        # full support over THIS vector's length (a bump anywhere reaches
        # every bin), regardless of n_fft
        gvec = P.gaussian_template(width, npoints - 1).astype(vec.dtype)
    gsize = (len(gvec) - 1) // 2
    for pos, val in peaks:
        lo = max(0, pos - gsize)
        hi = min(npoints, pos + gsize + 1)
        vec[lo:hi] = np.maximum(
            vec[lo:hi], val * gvec[lo - pos + gsize : hi - pos + gsize])
    return vec


def spreadpeaksinvector(vector: np.ndarray, width: float = P.F_SD,
                        gvec: np.ndarray | None = None) -> np.ndarray:
    """Spread the local maxima of `vector` by gaussians of SD `width`."""
    vector = np.asarray(vector)
    pks = locmax(vector, indices=True)
    return spreadpeaks(list(zip(pks, vector[pks])), npoints=len(vector),
                       width=width, gvec=gvec)


def _frame_topk(s_col: np.ndarray, cand_mask: np.ndarray, k: int):
    """Candidate (val, pos) pairs sorted by val desc then pos desc, first k.

    Mirrors reference `sorted(zip(vals, poss), reverse=True)[:k]`.
    """
    poss = np.nonzero(cand_mask)[0]
    order = sorted(zip(s_col[poss], poss), reverse=True)
    return order[:k]


def fwd_prune(sgram: np.ndarray, params: P.AnalyzerParams) -> np.ndarray:
    """Forward decaying-threshold prune -> boolean peak mask (T, F).

    Reference _decaying_threshold_fwd_prune (audfprint_analyze.py:~200-250):
    threshold envelope seeded from the gaussian-spread max of the first <=10
    frames; per frame accept the top `maxpksperframe` above-threshold local
    maxima (candidates evaluated against the envelope *at frame start*), each
    accepted peak raises the envelope, then the envelope decays by a_dec.
    """
    dtype = sgram.dtype
    T, F = sgram.shape
    gvec = P.gaussian_template(params.f_sd, F - 1).astype(dtype)
    gsize = (len(gvec) - 1) // 2
    a_dec = dtype.type(params.a_dec)
    peaks = np.zeros((T, F), dtype=bool)
    if T == 0:
        return peaks
    sthresh = spreadpeaksinvector(
        np.max(sgram[: min(10, T)], axis=0), params.f_sd, gvec=gvec
    ).astype(dtype)
    for t in range(T):
        s_col = sgram[t]
        cand = locmax(s_col) & (s_col > sthresh)
        for val, pos in _frame_topk(s_col, cand, params.maxpksperframe):
            lo = max(0, pos - gsize)
            hi = min(F, pos + gsize + 1)
            sthresh[lo:hi] = np.maximum(
                sthresh[lo:hi], val * gvec[lo - pos + gsize : hi - pos + gsize])
            peaks[t, pos] = True
        sthresh *= a_dec
    return peaks


def bwd_prune(sgram: np.ndarray, peaks: np.ndarray,
              params: P.AnalyzerParams) -> np.ndarray:
    """Backward prune of fwd-pass peaks (audfprint_analyze.py:~252-278).

    Runs the same masking envelope time-reversed over only the surviving
    peaks: a peak is kept iff its value >= the (backward) envelope; kept peaks
    raise the envelope AND delete any peak at the same freq bin in the
    following (t+1) frame.  Within a frame, peaks are processed in descending
    (val, pos) order with sequential envelope updates.
    """
    dtype = sgram.dtype
    T, F = sgram.shape
    out = peaks.copy()
    if T == 0:
        return out
    gvec = P.gaussian_template(params.f_sd, F - 1).astype(dtype)
    gsize = (len(gvec) - 1) // 2
    a_dec = dtype.type(params.a_dec)
    sthresh = spreadpeaksinvector(sgram[T - 1], params.f_sd, gvec=gvec).astype(dtype)
    for t in range(T - 1, -1, -1):
        poss = np.nonzero(peaks[t])[0]   # fwd mask: later deletions never
        # touch not-yet-processed (earlier-time) frames, so reading the fwd
        # mask is equivalent to the reference's in-place update.
        for val, pos in sorted(zip(sgram[t, poss], poss), reverse=True):
            if val >= sthresh[pos]:
                lo = max(0, pos - gsize)
                hi = min(F, pos + gsize + 1)
                sthresh[lo:hi] = np.maximum(
                    sthresh[lo:hi], val * gvec[lo - pos + gsize : hi - pos + gsize])
                if t + 1 < T:
                    out[t + 1, pos] = False
            else:
                out[t, pos] = False
        sthresh *= a_dec
    return out


def bwd_prune_sparse(n_frames: int, pk_t: np.ndarray, pk_pos: np.ndarray,
                     pk_val: np.ndarray, last_row: np.ndarray,
                     params: P.AnalyzerParams | None = None) -> np.ndarray:
    """Exact backward prune over a SPARSE forward-peak stream.

    Identical decision sequence to `bwd_prune` (reference
    audfprint_analyze.py:~252-278) without ever materializing the dense
    (T, F) spectrogram: the backward pass only reads spectrogram values at
    forward-surviving peaks plus the final frame's full row (its envelope
    seed), so a streamed ingest (ops/streaming.py) can hand those in and
    keep memory O(#peaks).

    pk_t ascending frame indices, pk_pos bins, pk_val whitened-HPF values
    at the peaks, last_row = whitened row at frame n_frames-1.  Returns a
    bool keep-mask over the peaks.
    """
    params = params or P.AnalyzerParams()
    last_row = np.asarray(last_row, dtype=np.float32)
    F = len(last_row)
    gvec = P.gaussian_template(params.f_sd, F - 1).astype(last_row.dtype)
    gsize = (len(gvec) - 1) // 2
    a_dec = last_row.dtype.type(params.a_dec)
    n = len(pk_t)
    keep = np.ones(n, dtype=bool)
    if n_frames <= 0:
        return keep
    by_frame: dict[int, list[int]] = {}
    idx_of: dict[tuple[int, int], int] = {}
    for i in range(n):
        t = int(pk_t[i])
        by_frame.setdefault(t, []).append(i)
        idx_of[(t, int(pk_pos[i]))] = i
    sthresh = spreadpeaksinvector(last_row, params.f_sd, gvec=gvec
                                  ).astype(last_row.dtype)
    for t in range(n_frames - 1, -1, -1):
        idxs = by_frame.get(t)
        if idxs:
            # within-frame (val desc, pos desc) order; (val, pos) is unique
            # per frame so the trailing index never decides a tie
            order = sorted(((pk_val[i], int(pk_pos[i]), i) for i in idxs),
                           reverse=True)
            for val, pos, i in order:
                if val >= sthresh[pos]:
                    lo = max(0, pos - gsize)
                    hi = min(F, pos + gsize + 1)
                    sthresh[lo:hi] = np.maximum(
                        sthresh[lo:hi],
                        val * gvec[lo - pos + gsize: hi - pos + gsize])
                    j = idx_of.get((t + 1, pos))
                    if j is not None:
                        keep[j] = False
                else:
                    keep[i] = False
        sthresh *= a_dec
    return keep


def find_peaks_mask(sgram: np.ndarray, params: P.AnalyzerParams | None = None
                    ) -> np.ndarray:
    """Whitened spectrogram (T, F) -> boolean peak mask (T, F)."""
    params = params or P.AnalyzerParams()
    return bwd_prune(sgram, fwd_prune(sgram, params), params)


def find_peaks(d: np.ndarray, sr: int = P.TARGET_SR,
               params: P.AnalyzerParams | None = None) -> list:
    """Audio samples -> column-sorted list of (frame, bin) peaks.

    Mirrors the reference find_peaks() public contract
    (audfprint_analyze.py:~280-360).
    """
    params = params or P.AnalyzerParams()
    d = np.asarray(d)
    if d.size == 0:
        return []
    sgram = spectrogram(d, params)
    mask = find_peaks_mask(sgram, params)
    cols, bins = np.nonzero(mask)
    return list(zip(cols.tolist(), bins.tolist()))


# ---------------------------------------------------------------------------
# Landmarks & hashes
# ---------------------------------------------------------------------------

def peaks2landmarks(pklist, params: P.AnalyzerParams | None = None) -> list:
    """Pair peaks into landmarks (t1, f1, f2, dt).

    Reference peaks2landmarks (audfprint_analyze.py:~370-410): anchors in
    (t asc, bin asc) order; candidate partners scanned t2 in
    [t1+mindt, t1+targetdt) then bin asc; accept while |f2-f1| < targetdf and
    fewer than maxpairsperpeak pairs emitted for this anchor.
    """
    params = params or P.AnalyzerParams()
    landmarks = []
    if not pklist:
        return landmarks
    scols = pklist[-1][0] + 1
    peaks_at = [[] for _ in range(scols)]
    for col, bin_ in pklist:
        peaks_at[col].append(bin_)
    for col in range(scols):
        for peak in peaks_at[col]:
            pairsthispeak = 0
            for col2 in range(col + params.mindt, min(scols, col + params.targetdt)):
                if pairsthispeak >= params.maxpairsperpeak:
                    break
                for peak2 in peaks_at[col2]:
                    if abs(peak2 - peak) < params.targetdf:
                        if pairsthispeak < params.maxpairsperpeak:
                            landmarks.append((col, peak, peak2, col2 - col))
                            pairsthispeak += 1
    return landmarks


def landmarks2hashes(landmarks) -> np.ndarray:
    """Landmarks (t1, f1, f2, dt) -> (N, 2) int32 rows of (t1, 20-bit hash).

    Bit layout (audfprint_analyze.py:~100-130, SURVEY Appendix C) [H]:
      hash = ((f1 & 0xFF) << 12) | (((f2 - f1) & 0x3F) << 6) | (dt & 0x3F)
    """
    landmarks = np.asarray(landmarks, dtype=np.int64)
    if landmarks.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    hashes = np.zeros((len(landmarks), 2), dtype=np.int32)
    hashes[:, 0] = landmarks[:, 0]
    hashes[:, 1] = (
        ((landmarks[:, 1] & P.F1_MASK) << P.F1_SHIFT)
        | (((landmarks[:, 2] - landmarks[:, 1]) & P.DF_MASK) << P.DF_SHIFT)
        | (landmarks[:, 3] & P.DT_MASK)
    )
    return hashes


def hashes2landmarks(hashes) -> np.ndarray:
    """Invert landmarks2hashes; df is sign-extended from 6 bits."""
    hashes = np.asarray(hashes)
    lmks = np.zeros((len(hashes), 4), dtype=np.int32)
    lmks[:, 0] = hashes[:, 0]
    h = hashes[:, 1].astype(np.int64)
    f1 = (h >> P.F1_SHIFT) & P.F1_MASK
    df = (h >> P.DF_SHIFT) & P.DF_MASK
    df = np.where(df > (1 << (P.DF_BITS - 1)) - 1, df - (1 << P.DF_BITS), df)
    lmks[:, 1] = f1
    lmks[:, 2] = f1 + df
    lmks[:, 3] = h & P.DT_MASK
    return lmks


def samples_to_hashes(d: np.ndarray, params: P.AnalyzerParams | None = None
                      ) -> np.ndarray:
    """Full analysis of decoded samples: the core of wavfile2hashes
    (audfprint_analyze.py:~430-520): per-shift find_peaks -> pairing ->
    hashing, concatenated over shifts, then row-unique (sorted, deduped).
    """
    params = params or P.AnalyzerParams()
    d = np.asarray(d)
    all_hashes = []
    for shift in range(max(1, params.shifts)):
        shiftsamps = shift * params.n_hop // max(1, params.shifts)
        pks = find_peaks(d[shiftsamps:], params.target_sr, params)
        all_hashes.append(landmarks2hashes(peaks2landmarks(pks, params)))
    hashes = np.concatenate(all_hashes, axis=0)
    if hashes.size == 0:
        return np.zeros((0, 2), dtype=np.int32)
    return np.unique(hashes, axis=0)
