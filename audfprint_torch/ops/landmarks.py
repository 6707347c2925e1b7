"""Landmark pairing + 20-bit hash packing (port of audfprint_tpu/ops/landmarks.py).

Every anchor peak gets exactly `maxpairsperpeak` landmark slots with a
validity mask; partner selection order (dt asc, partner-bin asc) and the
|df| < targetdf window replicate the oracle, so packed hashes are
bit-identical given the same peak slots.
"""

from __future__ import annotations

import torch

from audfprint_torch import params as P
from audfprint_torch.ops.config import PipelineConfig


def pack_hashes(f1: torch.Tensor, f2: torch.Tensor,
                dt) -> torch.Tensor:
    """20-bit hash: ((f1 & 0xFF) << 12) | ((f2-f1 & 0x3F) << 6) | (dt & 0x3F)."""
    f1 = f1.to(torch.int32)
    return (((f1 & P.F1_MASK) << P.F1_SHIFT)
            | (((f2.to(torch.int32) - f1) & P.DF_MASK) << P.DF_SHIFT)
            | (dt.to(torch.int32) & P.DT_MASK))


def slots_to_hashes(bins: torch.Tensor, valid: torch.Tensor,
                    cfg: PipelineConfig):
    """Per-frame peak slots -> per-anchor landmark hashes.

    A loop over the (targetdt - mindt) dt offsets with a small carry (per
    anchor fill count + fanout partner slots): each step examines the K
    partner slots of frame t+dt in bin-ascending order and appends the
    qualifying ones, the reference's (dt asc, partner-bin asc) order.

    Args:
      bins:  (B, T, K) int32 peak bins, ascending per frame
      valid: (B, T, K) bool

    Returns (times, hashes, lvalid), each (B, T, K, fanout): int32 anchor
    frame, int32 packed 20-bit hash (0 where invalid), bool.
    """
    B, T, K = bins.shape
    fanout = cfg.maxpairsperpeak
    dev = bins.device
    bins = bins.to(torch.int32)
    bins_p = torch.cat([bins, bins.new_zeros((B, cfg.targetdt, K))], dim=1)
    valid_p = torch.cat(
        [valid, valid.new_zeros((B, cfg.targetdt, K))], dim=1)
    foid = torch.arange(fanout, dtype=torch.int32, device=dev)
    count = torch.zeros((B, T, K), dtype=torch.int32, device=dev)
    f2s = torch.zeros((B, T, K, fanout), dtype=torch.int32, device=dev)
    dts = torch.zeros((B, T, K, fanout), dtype=torch.int32, device=dev)
    for d in range(cfg.mindt, cfg.targetdt):
        pbin = bins_p[:, d: d + T]
        pval = valid_p[:, d: d + T]
        for j in range(K):                 # partner slots, bin ascending
            f2j = pbin[:, :, j, None]                          # (B, T, 1)
            okj = (valid & pval[:, :, j, None]
                   & ((f2j - bins).abs() < cfg.targetdf)
                   & (count < fanout))                         # (B, T, K)
            write = okj[..., None] & (count[..., None] == foid)
            f2s = torch.where(write, f2j[..., None], f2s)
            dts = torch.where(write, d, dts)
            count = count + okj.to(torch.int32)
    lvalid = foid < count[..., None]
    hashes = pack_hashes(bins[..., None], f2s, dts)
    times = torch.arange(T, dtype=torch.int32, device=dev)[
        None, :, None, None].expand(hashes.shape)
    return times, torch.where(lvalid, hashes, 0), lvalid
