"""Decaying-threshold spectral peak picking in plain PyTorch (port of
audfprint_tpu/ops/peaks.py).

Forward + backward masking-envelope prunes over a batch of spectrograms,
vectorised over (batch, freq) and sequential in time (a Python loop over
T).  This is the plain version of kernel K1 (ops/cuda_peaks.py): the
peak stage on CPU tensors, and the reference the kernel is held against on
the card.  Given the same float32 spectrogram it gives bit-identical masks
to the JAX package:

  * within-frame order (value desc, bin desc) comes from a stable
    descending sort of the bin-reversed frame (torch.topk documents no tie
    order);
  * the gaussian bump is read from the same tabulated full-support
    template (params.gaussian_template) and formed as one f32 product;
  * envelopes are nonnegative, so "no update outside the bump support"
    equals "max with 0";
  * the envelopes' compares, products and decays flush subnormal inputs
    and results as the reference does (ops/ftz.py): over minutes of
    digital silence an envelope decays into that range.
"""

from __future__ import annotations

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.ops import ftz as FTZ
from audfprint_torch.ops.config import PipelineConfig

_NEG = float("-inf")


def gauss_vector(cfg: PipelineConfig) -> np.ndarray:
    """(2*gsize + 1,) f32 template: g[i + gsize] = bump value at offset i."""
    return P.gaussian_template(cfg.f_sd, cfg.gsize).astype(np.float32)


def _gauss_table(cfg: PipelineConfig) -> np.ndarray:
    """(F, F) table: gtab[p, j] = template value of a bump at p evaluated
    at j (full support), shared with the oracle."""
    gvec = gauss_vector(cfg)
    gsize = cfg.gsize
    F = cfg.n_bins
    off = np.arange(F)[None, :] - np.arange(F)[:, None]   # j - p
    inside = np.abs(off) <= gsize
    return np.where(inside, gvec[np.clip(off + gsize, 0, 2 * gsize)], 0.0
                    ).astype(np.float32)


def _a_dec(cfg: PipelineConfig, device) -> torch.Tensor:
    return torch.tensor(np.float32(cfg.a_dec), device=device)


def locmax2(s: torch.Tensor) -> torch.Tensor:
    """Vectorised reference locmax over the last axis (oracle `locmax`)."""
    ge = s[..., 1:] >= s[..., :-1]
    tr = torch.ones(s.shape[:-1] + (1,), dtype=torch.bool, device=s.device)
    fa = torch.zeros(s.shape[:-1] + (1,), dtype=torch.bool, device=s.device)
    nbr = torch.cat([tr, ge], dim=-1)          # nbr[i] = rise into i
    nbr_next = torch.cat([ge, fa], dim=-1)     # nbr[i+1]
    return nbr & ~nbr_next


def _spread_vector(v: torch.Tensor, gtab: torch.Tensor) -> torch.Tensor:
    """Oracle spreadpeaksinvector: max of bumps at local maxima of v, (B,F).
    v reads subnormals as zeros, in the compares too; the (B, F, F)
    products flush once, after the maximum (FTZ.amax_mul)."""
    v = FTZ.flush(v)
    vl = torch.where(locmax2(v), v, v.new_zeros(()))
    return FTZ.amax_mul(vl[:, :, None], gtab[None], dim=1)


def head_envelope(y: torch.Tensor, n_frames: torch.Tensor,
                  gtab: torch.Tensor) -> torch.Tensor:
    """Forward initial envelope: spread of the per-bin max over the first
    min(10, max(1, n_frames)) frames."""
    T = y.shape[1]
    head = torch.clamp(n_frames, min=1).clamp(max=10)
    sel = torch.arange(T, device=y.device)[None, :] < head[:, None]
    vmax = torch.where(sel[:, :, None], y, _NEG).amax(dim=1)
    vmax = torch.where(torch.isfinite(vmax), vmax, vmax.new_zeros(()))
    return _spread_vector(vmax, gtab)


def tail_envelope(y: torch.Tensor, n_frames: torch.Tensor,
                  gtab: torch.Tensor) -> torch.Tensor:
    """Backward initial envelope: spread of the last valid frame."""
    last_idx = torch.clamp(n_frames.long() - 1, min=0)
    last = y[torch.arange(y.shape[0], device=y.device), last_idx]
    return _spread_vector(last, gtab)


def _topk_valdesc_posdesc(m: torch.Tensor, k: int):
    """Top-k of masked values (mask -> -inf) ordered by (val desc, pos desc).

    Returns (vals (..., k), pos (..., k) int64, valid (..., k) bool)."""
    F = m.shape[-1]
    vals, ridx = torch.sort(m.flip(-1), dim=-1, descending=True, stable=True)
    vals = vals[..., :k]
    return vals, (F - 1) - ridx[..., :k], vals > _NEG


def fwd_lists(m0: torch.Tensor, env0: torch.Tensor, gtab: torch.Tensor,
              a_dec: torch.Tensor, k: int):
    """Forward pass over a candidate map m0 (B, T, F): values of local
    maxima in valid frames, anything else below every envelope (-inf or
    -3e38).  Returns the per-frame accepted lists in extraction order,
    (vals (B,T,k) f32, pos (B,T,k) int64, valid (B,T,k) bool), and the
    envelope after the last frame (B, F), which continues the pass over
    the next chunk of frames (the decay follows every frame, valid or
    not)."""
    B, T, _F = m0.shape
    vals = m0.new_empty((B, T, k))
    pos = torch.empty((B, T, k), dtype=torch.long, device=m0.device)
    ok = torch.empty((B, T, k), dtype=torch.bool, device=m0.device)
    sthresh = FTZ.flush(env0)
    zero = m0.new_zeros(())
    for t in range(T):
        m = m0[:, t]
        v, p, pv = _topk_valdesc_posdesc(
            torch.where(FTZ.flush(m) > sthresh, m, _NEG), k)
        contrib = torch.where(pv[:, :, None], FTZ.mul(v[:, :, None], gtab[p]),
                              zero)
        sthresh = FTZ.mul(torch.maximum(sthresh, contrib.amax(dim=1)), a_dec)
        vals[:, t], pos[:, t], ok[:, t] = v, p, pv
    return vals, pos, ok, sthresh


def bwd_lists(vals: torch.Tensor, pos: torch.Tensor, ok: torch.Tensor,
              n_frames: torch.Tensor, env0: torch.Tensor, gtab: torch.Tensor,
              a_dec: torch.Tensor) -> torch.Tensor:
    """Backward pass over per-frame lists in extraction order -> kept
    positions (B, T, k) int64, -1 = not kept (before the delete-next rule).
    Acceptance within a frame is sequential: a kept peak raises the
    envelope before the next, weaker peak of its frame is tested."""
    B, T, k = pos.shape
    bidx = torch.arange(B, device=pos.device)
    kept = torch.full((B, T, k), -1, dtype=torch.long, device=pos.device)
    env0 = FTZ.flush(env0)
    sthresh = env0
    zero = env0.new_zeros(())
    for t in range(T - 1, -1, -1):
        sthresh = torch.where((n_frames == t + 1)[:, None], env0, sthresh)
        valid_t = t < n_frames
        for i in range(k):
            v, p, pv = vals[:, t, i], pos[:, t, i], ok[:, t, i]
            pc = torch.clamp(p, min=0)
            keep = pv & valid_t & (FTZ.flush(v) >= sthresh[bidx, pc])
            contrib = torch.where(keep[:, None],
                                  FTZ.mul(v[:, None], gtab[pc]), zero)
            sthresh = torch.maximum(sthresh, contrib)
            kept[:, t, i] = torch.where(keep, p, -1)
        sthresh = FTZ.mul(sthresh, a_dec)
    return kept


def _lists_to_mask(pos: torch.Tensor, ok: torch.Tensor, F: int):
    B, T, _k = pos.shape
    mask = torch.zeros((B, T, F + 1), dtype=torch.bool, device=pos.device)
    mask.scatter_(2, torch.where(ok, pos, F), True)
    return mask[..., :F]


def fwd_prune(sgram: torch.Tensor, n_frames: torch.Tensor,
              cfg: PipelineConfig) -> torch.Tensor:
    """(B, T, F) f32, (B,) int -> (B, T, F) bool forward-pass peak mask."""
    B, T, F = sgram.shape
    gtab = torch.as_tensor(_gauss_table(cfg), device=sgram.device)
    active = (torch.arange(T, device=sgram.device)[None, :]
              < n_frames[:, None])
    m0 = torch.where(locmax2(sgram) & active[:, :, None], sgram, _NEG)
    _v, pos, ok, _env = fwd_lists(m0, head_envelope(sgram, n_frames, gtab),
                                  gtab, _a_dec(cfg, sgram.device),
                                  cfg.maxpksperframe)
    return _lists_to_mask(pos, ok, F)


def fwd_prune_carry(sgram: torch.Tensor, n_frames: torch.Tensor,
                    env_in: torch.Tensor, cfg: PipelineConfig,
                    use_env_in: bool):
    """fwd_prune with an explicit threshold-envelope carry: kernel K1f
    (ops/cuda_peaks.prune_fwd_carry) on a CUDA tensor, its plain version
    on a CPU tensor.  use_env_in=False seeds the envelope from the first
    <= 10 valid frames as fwd_prune does; True continues from env_in (1, F)
    or (B, F).  Returns (peak mask (B, T, F), envelope after the last
    frame (B, F)); the decay follows every frame, valid or not."""
    from audfprint_torch.ops import cuda_peaks as CP

    B, T, F = sgram.shape
    gvec = torch.as_tensor(gauss_vector(cfg), device=sgram.device)
    if use_env_in:
        env0 = env_in.to(sgram.device, torch.float32).expand(B, F)
    else:
        env0 = head_envelope(sgram, n_frames,
                             torch.as_tensor(_gauss_table(cfg),
                                             device=sgram.device))
    lpos, _lval, env = CP.prune_fwd_carry(
        CP.candidate_map(sgram, n_frames), env0.contiguous(), gvec,
        cfg.a_dec, cfg.maxpksperframe)
    return _lists_to_mask(lpos.long(), lpos >= 0, F), env


def bwd_prune(sgram: torch.Tensor, peaks: torch.Tensor,
              n_frames: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """Backward prune of fwd-pass peaks -> final (B, T, F) bool mask."""
    B, T, F = sgram.shape
    gtab = torch.as_tensor(_gauss_table(cfg), device=sgram.device)
    active = (torch.arange(T, device=sgram.device)[None, :]
              < n_frames[:, None])
    vals, pos, ok = _topk_valdesc_posdesc(
        torch.where(peaks & active[:, :, None], sgram, _NEG),
        cfg.maxpksperframe)
    kept = bwd_lists(vals, pos, ok, n_frames,
                     tail_envelope(sgram, n_frames, gtab), gtab,
                     _a_dec(cfg, sgram.device))
    kmask = _lists_to_mask(kept, kept >= 0, F)
    # a kept peak at (t, p) deletes any kept peak at (t+1, p)
    # (oracle bwd_prune "delete any following peak")
    kept_prev = torch.cat([torch.zeros_like(kmask[:, :1]), kmask[:, :-1]],
                          dim=1)
    return kmask & ~kept_prev


def find_peaks_mask(sgram: torch.Tensor, n_frames: torch.Tensor,
                    cfg: PipelineConfig) -> torch.Tensor:
    return bwd_prune(sgram, fwd_prune(sgram, n_frames, cfg), n_frames, cfg)


def mask_to_slots(mask: torch.Tensor, cfg: PipelineConfig):
    """(B, T, F) bool -> (bins (B,T,k) int32 ascending, valid (B,T,k) bool):
    dense per-frame peak lists in ascending-bin order."""
    F = mask.shape[-1]
    key = torch.where(mask, F - torch.arange(F, device=mask.device), 0)
    tops = []
    for _ in range(cfg.maxpksperframe):   # unique keys: k extractions
        v = key.amax(dim=-1, keepdim=True)
        tops.append(v)
        key = torch.where(key == v, 0, key)
    topv = torch.cat(tops, dim=-1)
    valid = topv > 0
    return torch.where(valid, F - topv, 0).to(torch.int32), valid
