"""Plain PyTorch reference of the landmark analyzer, batched over tracks.

The semantics of dpwe/audfprint's analyzer as its documentation and the
repository's SURVEY.md set them out: |STFT| of 512-sample Hann frames at a
256-sample hop (no centring), a log floor at max/1e6, whitening by the
scalar mean, the onset high-pass y[t] = x[t] - x[t-1] + 0.98 y[t-1], the
Nyquist row dropped; a forward decaying-threshold prune (top 5 local maxima
a frame above a Gaussian-spread envelope) and a backward prune over the
survivors; landmark pairs within 2 <= dt < 63 and |df| < 31, three per
anchor; 20-bit hashes (f1:8 | df:6 | dt:6); sub-hop shifts unioned.

Everything runs in whole-batch tensor operations: a loop over frames, each
step over every track at once, so 1,000 tracks of 30 s take about as many
steps as one.  It imports nothing of the measured program.  `dtype` is the
precision of everything after the FFT's magnitude: float32 as the
configuration states it, or bfloat16 for the control (the nearest precision
below it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SR = 11025
N_FFT = 512
N_HOP = 256
N_BINS = 256
HPF_POLE = 0.98
F_SD = 30.0
MAX_PKS = 5
TARGET_DF = 31
MIN_DT = 2
TARGET_DT = 63
TIME_BITS = 20            # a key is (t << 20) | hash
_TINY = 1.1754943508222875e-38     # below it an HPF output flushes to 0


def a_dec(density: float) -> float:
    """The envelope's decay a frame (audfprint_analyze.py's a_dec)."""
    return 1 - 0.01 * (density * math.sqrt(N_HOP / 352.8) / 35.0)


def hann(device) -> torch.Tensor:
    """The analyzer's window: np.hanning(n_fft + 2)[1:-1]."""
    return torch.as_tensor(np.hanning(N_FFT + 2)[1:-1].astype(np.float32),
                           device=device)


def gauss_rows(dtype, device) -> torch.Tensor:
    """(F, F): row p is the Gaussian bump of SD F_SD centred on bin p,
    over every bin (the spreading has full support)."""
    off = np.arange(N_BINS)[None, :] - np.arange(N_BINS)[:, None]
    g = np.exp(-0.5 * (off / F_SD) ** 2).astype(np.float32)
    return torch.as_tensor(g, device=device).to(dtype)


def spectrogram(audio: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, N) float32 samples of one length -> (B, T, 256) whitened, high-
    passed log magnitude."""
    B, N = audio.shape
    if N < N_FFT:
        return audio.new_zeros((B, 0, N_BINS), dtype=dtype)
    frames = audio.unfold(1, N_FFT, N_HOP) * hann(audio.device)
    mag = torch.fft.rfft(frames, dim=-1).abs().to(dtype)       # (B, T, 257)
    mx = mag.amax(dim=(1, 2), keepdim=True)
    logm = torch.log(torch.maximum(mag, mx / 1e6))
    white = torch.where(mx > 0, logm - logm.mean(dim=(1, 2), keepdim=True),
                        mag)
    pole = torch.tensor(float(np.float32(HPF_POLE)), dtype=torch.float64,
                        device=audio.device)       # the float32 pole
    out = torch.empty_like(white)
    xprev = torch.zeros_like(white[:, 0])
    yprev = torch.zeros_like(white[:, 0])
    for t in range(white.shape[1]):
        x = white[:, t]
        # one rounding of (x - xprev) + pole * yprev, as a fused multiply-add
        y = ((x - xprev).double() + pole * yprev.double()).to(dtype)
        y = torch.where(y.abs() < _TINY, y * 0, y)
        out[:, t] = y
        xprev, yprev = x, y
    return out[:, :, :N_BINS]


def locmax(v: torch.Tensor) -> torch.Tensor:
    """(..., F) -> bool local maxima: v[i] >= v[i-1] (or i = 0) and not
    v[i+1] >= v[i] (or i = F-1)."""
    ge = v[..., 1:] >= v[..., :-1]
    true = torch.ones_like(ge[..., :1])
    left = torch.cat([true, ge], dim=-1)
    right = torch.cat([ge, ~true], dim=-1)
    return left & ~right


def spread(v: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """(B, F) -> the max of Gaussian bumps at v's local maxima (and 0)."""
    bumps = torch.where(locmax(v)[:, :, None], v[:, :, None] * G[None],
                        torch.zeros((), dtype=v.dtype, device=v.device))
    return torch.clamp(bumps.amax(dim=1), min=0)


def prune(s: torch.Tensor, density: float):
    """Forward then backward prune of (B, T, F) -> peaks as per-frame slots
    (bins (B, T, k) ascending, valid (B, T, k))."""
    B, T, F = s.shape
    dev, dt = s.device, s.dtype
    k = MAX_PKS
    G = gauss_rows(dt, dev)
    dec = torch.tensor(a_dec(density), dtype=torch.float32).to(dt).to(dev)
    ninf = torch.tensor(-math.inf, dtype=dt, device=dev)
    rows = torch.arange(B, device=dev)
    # forward: per frame the top k candidates by (value desc, bin desc)
    th = spread(s[:, : min(10, T)].amax(dim=1), G)
    pos = torch.zeros((T, B, k), dtype=torch.long, device=dev)
    val = torch.zeros((T, B, k), dtype=dt, device=dev)
    ok = torch.zeros((T, B, k), dtype=torch.bool, device=dev)
    for t in range(T):
        col = s[:, t]
        cand = locmax(col) & (col > th)
        key = torch.where(cand, col, ninf).flip(-1)
        v, i = torch.sort(key, dim=-1, descending=True, stable=True)
        p = F - 1 - i[:, :k]
        o = torch.gather(cand, 1, p)
        v = v[:, :k]
        th = torch.maximum(th, torch.where(o[:, :, None], v[:, :, None] * G[p],
                                           ninf).amax(dim=1))
        th = th * dec
        pos[t], val[t], ok[t] = p, v, o
    # backward over the survivors, in the same order, one at a time
    keep = torch.zeros_like(ok)
    th = spread(s[:, T - 1], G)
    for t in range(T - 1, -1, -1):
        for j in range(k):
            p, v = pos[t, :, j], val[t, :, j]
            kj = ok[t, :, j] & (v >= th[rows, p])
            th = torch.where(kj[:, None], torch.maximum(th, v[:, None] * G[p]),
                             th)
            keep[t, :, j] = kj
        th = th * dec
    mask = torch.zeros((B, T + 1, F), dtype=torch.bool, device=dev)
    gone = torch.zeros_like(mask)
    tt = torch.arange(T, device=dev)[None, :, None].expand(B, T, k)
    bb = rows[:, None, None].expand(B, T, k)
    pp = pos.permute(1, 0, 2)
    kk = keep.permute(1, 0, 2)
    mask[bb[kk], tt[kk], pp[kk]] = True
    gone[bb[kk], tt[kk] + 1, pp[kk]] = True     # a kept peak deletes its
    mask = (mask & ~gone)[:, :T]                # successor in the next frame
    bins = torch.where(mask, torch.arange(F, device=dev), F)
    bins = torch.sort(bins, dim=-1).values[:, :, :k]
    return bins, bins < F


def landmark_keys(bins: torch.Tensor, valid: torch.Tensor, fanout: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame peak slots (B, T, k) -> (keys (B, T*k*fanout) int64
    (t << 20) | hash, kept (same shape) bool): each anchor pairs with the
    first `fanout` peaks in (frame, bin) order within MIN_DT <= dt <
    TARGET_DT and |df| < TARGET_DF."""
    B, T, k = bins.shape
    dev = bins.device
    far = 1 << 12
    b = torch.where(valid, bins, far).to(torch.int64)
    padded = torch.cat([b, b.new_full((B, TARGET_DT, k), far)], dim=1)
    win = padded.unfold(1, TARGET_DT, 1)[:, :T]                # (B,T,k,63)
    cand = win.permute(0, 1, 3, 2)[:, :, MIN_DT:].reshape(B, T, 1, -1)
    f1 = b[:, :, :, None]
    ok = (cand < far) & (f1 < far) & ((cand - f1).abs() < TARGET_DF)
    rank = torch.cumsum(ok.to(torch.int16), dim=-1)
    dt = torch.arange(cand.shape[-1], device=dev) // k + MIN_DT
    head = (torch.arange(T, device=dev)[None, :, None] << TIME_BITS) \
        | ((b & 0xFF) << 12)
    keys, kept = [], []
    for r in range(1, fanout + 1):
        m = ok & (rank == r)                   # the r-th partner, if any
        j = torch.argmax(m.to(torch.int8), dim=-1, keepdim=True)
        f2 = torch.gather(cand.expand(B, T, k, -1), -1, j)[..., 0]
        keys.append(head | (((f2 - b) & 0x3F) << 6) | (dt[j[..., 0]] & 0x3F))
        kept.append(m.any(dim=-1))
    return (torch.stack(keys, -1).reshape(B, -1),
            torch.stack(kept, -1).reshape(B, -1))


def track_keys(audio: torch.Tensor, analyzer: dict, dtype=torch.float32,
               rows_per_block: int = 256) -> list:
    """(B, N) int16 or float32 tracks of one length -> per track the sorted
    unique landmark keys (t << 20) | hash, as int64 tensors on the
    audio's device."""
    shifts = int(analyzer.get("shifts", 1))
    density = float(analyzer.get("density", 20.0))
    fanout = int(analyzer.get("fanout", 3))
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) / 32768.0
    out = []
    for r0 in range(0, audio.shape[0], rows_per_block):
        blk = audio[r0: r0 + rows_per_block]
        B = blk.shape[0]
        flat = []
        for s in range(shifts):
            sp = spectrogram(blk[:, s * N_HOP // shifts:], dtype)
            if sp.shape[1] == 0:
                continue
            bins, valid = prune(sp, density)
            del sp
            step = max(1, (1 << 24) // max(1, bins.shape[1] * MAX_PKS * 305))
            for q0 in range(0, B, step):
                keys, kept = landmark_keys(bins[q0: q0 + step],
                                           valid[q0: q0 + step], fanout)
                row = torch.arange(q0, q0 + keys.shape[0],
                                   device=keys.device)[:, None]
                flat.append(((row << 40) | keys)[kept])
        u = (torch.unique(torch.cat(flat)) if flat else
             torch.zeros(0, dtype=torch.int64, device=audio.device))
        n = torch.bincount(u >> 40, minlength=B).tolist()
        out.extend(x & ((1 << 40) - 1) for x in torch.split(u, n))
    return out


def keys_of(signals: list, analyzer: dict, device, dtype=torch.float32,
            rows_per_block: int = 256) -> list:
    """Host arrays of any lengths -> their keys, one length group at a
    time."""
    out: list = [None] * len(signals)
    groups: dict = {}
    for i, s in enumerate(signals):
        groups.setdefault((len(s), s.dtype.str), []).append(i)
    for idxs in groups.values():
        batch = torch.as_tensor(np.stack([signals[i] for i in idxs]),
                                device=device)
        for i, k in zip(idxs, track_keys(batch, analyzer, dtype,
                                         rows_per_block)):
            out[i] = k
    return out
