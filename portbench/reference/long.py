"""The plain reference's analyzer for long recordings: reference/analyze.py's
semantics, whole file, with its three frame loops recast so that a batch of
2 h files (310,077 frames) takes seconds on the card.

analyze.py walks frames in Python, some twenty to forty small torch ops a
frame: written for 30 s tracks (1,292 frames), it would take minutes on a
2 h file.  Here each loop is one step function over a (B, F) state:

  HPF        y[t] = (x[t] - x[t-1]) + pole * y[t-1], one rounding from
             float64, values below float32's smallest normal flushed to 0;
  forward    the top 5 candidates a frame (local maxima above the
             envelope) by (value, bin) descending, as one int64 key a bin
             (the value's bits over the bin) and topk; the envelope raised
             to their Gaussian bumps, then decayed;
  backward   over the kept slots of a frame in that order: slot j is kept
             when its value reaches the envelope raised by the slots kept
             before it in the frame.  The 32 keep patterns of 5 slots are
             tried at once and the one pattern that reproduces itself is
             the sequential answer; the bumps of a frame's slots on each
             other are worked out ahead, a block of frames at a time.

Every step does the same float operations in the same order as
analyze.py's loops (products, maxima and comparisons only, each exactly
rounded), so the results are equal bit for bit on one device
(tests/test_torch_stream_reference.py holds it on the CPU).  On a CUDA
device the steps of each block of BLOCK frames are one torch.cuda.CUDAGraph
replay; elsewhere they run eagerly.  Like every file of the reference it
imports only numpy and torch, so the constants and helpers it shares with
analyze.py (the window, the Gaussian rows, locmax, spread and the pairing,
landmark_keys) are analyze.py's, copied unchanged.

Where it departs from the streamed route's arithmetic
(audfprint_torch/models/streaming.py), which it is the yardstick of:
  - the whitening mean is logm.mean() over the whole file, a float32
    reduction in the device's order; the route's is exactly rounded from
    integer level sums, chunk by chunk;
  - the FFT is one batched rfft of the whole file; the route's, a chunk's
    frames at a time (cuFFT may round the two differently);
  - the backward prune runs over the dense slots of every frame; the route
    prunes its sparse forward peaks on the host, and a kept peak deletes
    its successor in the next frame in both.
On the card either of the first two can move a near-tie peak (PERF.md §2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# analyze.py's constants and helpers
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


BLOCK = 1024                  # frame steps a captured graph replays
K = MAX_PKS
NONKEY = -(1 << 63) + N_BINS   # a non-candidate: bin N_BINS, below all
# the 2**K keep patterns of a frame's slots: PATTERNS[c, j] = bit j of c
PATTERNS = ((torch.arange(1 << K)[:, None] >> torch.arange(K)) & 1).bool()


def _loop(step, state: list, n: int, block_inputs, out_specs: list,
          device) -> list:
    """step(state, ins, outs) for i in [0, n): ins are row i of the tensors
    block_inputs(i0, i1) returns for rows [i0, i1), outs row i of the
    outputs ((shape, dtype) a row each).  Returns the outputs (n, ...)."""
    outs = [torch.empty((n, *shape), dtype=dt, device=device)
            for shape, dt in out_specs]
    nb = n // BLOCK if torch.device(device).type == "cuda" else 0
    if nb:
        bins = [x.clone() for x in block_inputs(0, BLOCK)]   # static
        bouts = [torch.empty_like(o[:BLOCK]) for o in outs]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):          # warm-up, state kept
            saved = [x.clone() for x in state]
            step(state, [b[0] for b in bins], [o[0] for o in bouts])
            for x, y in zip(state, saved):
                x.copy_(y)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(BLOCK):
                step(state, [b[i] for b in bins], [o[i] for o in bouts])
        for blk in range(nb):
            i0 = blk * BLOCK
            if blk:
                for b, x in zip(bins, block_inputs(i0, i0 + BLOCK)):
                    b.copy_(x)
            graph.replay()
            for o, y in zip(outs, bouts):
                o[i0: i0 + BLOCK].copy_(y)
        del graph
    i0 = nb * BLOCK
    if i0 < n:
        ins = block_inputs(i0, n)
        for i in range(n - i0):
            step(state, [x[i] for x in ins], [o[i0 + i] for o in outs])
    return outs


def spectrogram(audio: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """analyze.spectrogram, time first: (B, N) float32 samples of one
    length -> (T, B, 256) whitened, high-passed log magnitude."""
    B, N = audio.shape
    dev = audio.device
    if N < N_FFT:
        return audio.new_zeros((0, B, N_BINS), dtype=dtype)
    frames = audio.unfold(1, N_FFT, N_HOP) * hann(dev)
    mag = torch.fft.rfft(frames, dim=-1).abs().to(dtype)       # (B, T, 257)
    del frames
    mx = mag.amax(dim=(1, 2), keepdim=True)
    logm = torch.log(torch.maximum(mag, mx / 1e6))
    white = torch.where(mx > 0, logm - logm.mean(dim=(1, 2), keepdim=True),
                        mag)
    del mag, logm
    # the Nyquist row is dropped after the HPF, whose bins are independent
    x = white[:, :, :N_BINS].permute(1, 0, 2).contiguous()   # (T, B, F)
    del white
    pole = torch.tensor(float(np.float32(HPF_POLE)), dtype=torch.float64,
                        device=dev)                # the float32 pole

    def inputs(i0, i1):
        prev = (x[i0 - 1: i1 - 1] if i0 else torch.cat(
            [torch.zeros_like(x[:1]), x[: i1 - 1]]))
        return [(x[i0:i1] - prev).double()]

    def step(state, ins, outs):
        (yprev,), (d,), (out,) = state, ins, outs
        # one rounding of (x - xprev) + pole * yprev; a value below the
        # smallest normal flushes to 0 (times 0: its sign stays)
        y = (d + pole * yprev).to(dtype)
        torch.mul(y, y.abs() >= _TINY, out=out)
        yprev.copy_(out)

    state = [torch.zeros((B, N_BINS), dtype=torch.float64, device=dev)]
    (s,) = _loop(step, state, x.shape[0], inputs,
                 [((B, N_BINS), dtype)], dev)
    return s


def _sort_keys(s: torch.Tensor) -> torch.Tensor:
    """(n, B, F) -> int64 keys of the local maxima, ordered as analyze.prune
    ranks its candidates (value descending, then bin descending): the
    value's float32 bits over the bin (a candidate's value is positive, so
    its bits order as it does); NONKEY elsewhere."""
    bins = torch.arange(s.shape[-1], device=s.device)
    key = (s.float().view(torch.int32).to(torch.int64) << 9) | bins
    return torch.where(locmax(s), key, NONKEY)


def prune(s: torch.Tensor, density: float):
    """analyze.prune of (T, B, F) -> (bins (B, T, k) ascending,
    valid (B, T, k))."""
    T, B, F = s.shape
    dev, dt = s.device, s.dtype
    G = gauss_rows(dt, dev)
    dec = torch.tensor(a_dec(density), dtype=torch.float32).to(dt).to(dev)
    # a non-candidate's bin F reads -inf and a row of ones: no bump
    G1 = torch.cat([G, torch.ones_like(G[:1])])
    ninf_col = torch.full((B, 1), -torch.inf, dtype=dt, device=dev)

    def fwd_inputs(i0, i1):
        blk = s[i0:i1]
        return [blk, torch.cat([blk, ninf_col.expand(i1 - i0, B, 1)], -1),
                _sort_keys(blk)]

    def fwd_step(state, ins, outs):
        (th,), (col, colx, keys), (out,) = state, ins, outs
        top = torch.topk(torch.where(col > th, keys, NONKEY), K, dim=-1,
                         sorted=False).values
        out.copy_(top)
        p = top & 511
        bump = colx.gather(1, p)[:, :, None] * G1[p]
        torch.maximum(th, bump.amax(dim=1), out=th)
        th.mul_(dec)

    th = spread(s[: min(10, T)].amax(dim=0), G)
    (top,) = _loop(fwd_step, [th], T, fwd_inputs, [((B, K), torch.int64)],
                   dev)
    top = torch.sort(top, dim=-1, descending=True).values   # the ranking
    pos = top & 511
    ok = pos < F
    pc = torch.clamp(pos, max=F - 1)
    val = torch.where(ok, s.gather(2, pc), -torch.inf)
    del top

    # backward, frames last to first: slot j is kept when val[j] reaches
    # the envelope raised by the slots kept before it in the frame
    pcr, valr = pc.flip(0), val.flip(0)
    pats = PATTERNS.to(dev)
    earlier = pats[:, :, None] & torch.ones(K, K, dtype=torch.bool,
                                            device=dev).triu(1)

    def bwd_inputs(i0, i1):
        p, v = pcr[i0:i1], valr[i0:i1]
        # on[..., i, j]: slot i's bump at slot j's bin; by pattern, the
        # largest over the earlier slots the pattern keeps
        on = v[..., :, None] * G[p[..., :, None], p[..., None, :]]
        by_pat = torch.where(earlier, on[:, :, None], -torch.inf).amax(-2)
        return [p, v, by_pat, v[..., None] * G[p]]

    def bwd_step(state, ins, outs):
        (th,), (p, v, by_pat, bumps), (out,) = state, ins, outs
        thr = torch.maximum(th.gather(1, p)[:, None, :], by_pat)
        same = ((v[:, None, :] >= thr) == pats).all(-1)         # (B, 32)
        keep = (same[:, :, None] & pats).any(1)
        out.copy_(keep)
        torch.maximum(th, torch.where(keep[:, :, None], bumps,
                                      -torch.inf).amax(dim=1), out=th)
        th.mul_(dec)

    th = spread(s[T - 1], G)
    (keep,) = _loop(bwd_step, [th], T, bwd_inputs, [((B, K), torch.bool)],
                    dev)
    keep = keep.flip(0)
    # analyze.prune's ending: kept peaks, each deleting its successor
    mask = torch.zeros((B, T + 1, F), dtype=torch.bool, device=dev)
    gone = torch.zeros_like(mask)
    tt = torch.arange(T, device=dev)[None, :, None].expand(B, T, K)
    bb = torch.arange(B, device=dev)[:, None, None].expand(B, T, K)
    pp = pos.permute(1, 0, 2)
    kk = keep.permute(1, 0, 2)
    mask[bb[kk], tt[kk], pp[kk]] = True
    gone[bb[kk], tt[kk] + 1, pp[kk]] = True
    mask = (mask & ~gone)[:, :T]
    bins = torch.where(mask, torch.arange(F, device=dev), F)
    bins = torch.sort(bins, dim=-1).values[:, :, :K]
    return bins, bins < F


def track_keys(audio: torch.Tensor, analyzer: dict, dtype=torch.float32,
               rows_per_block: int = 256) -> list:
    """analyze.track_keys with this module's spectrogram and prune: (B, N)
    int16 or float32 tracks of one length -> per track the sorted unique
    landmark keys (t << 20) | hash, int64 on the audio's device."""
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
            if sp.shape[0] == 0:
                continue
            bins, valid = prune(sp, density)
            del sp
            step = max(1, (1 << 24) // max(1, bins.shape[1] * K * 305))
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


def keys_of(signals: list, analyzer: dict, device, dtype=torch.float32
            ) -> list:
    """Host arrays of any lengths -> their keys, one length group at a
    time (analyze.keys_of with this module's track_keys)."""
    out: list = [None] * len(signals)
    groups: dict = {}
    for i, s in enumerate(signals):
        groups.setdefault((len(s), s.dtype.str), []).append(i)
    for idxs in groups.values():
        batch = torch.as_tensor(np.stack([signals[i] for i in idxs]),
                                device=device)
        for i, k in zip(idxs, track_keys(batch, analyzer, dtype)):
            out[i] = k
    return out
