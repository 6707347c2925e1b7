"""Landmark pairing + 20-bit hash packing (port of audfprint_tpu/ops/landmarks.py).

Every anchor peak gets exactly `maxpairsperpeak` landmark slots with a
validity mask; partner selection order (dt asc, partner-bin asc) and the
|df| < targetdf window replicate the oracle, so packed hashes are
bit-identical given the same peak slots.  The pairing scan is kernel K3
(csrc/pair.cu) on CUDA tensors and `slots_to_hashes_plain` on CPU
tensors.
"""

from __future__ import annotations

import torch

from audfprint_torch import params as P
from audfprint_torch.ops.config import PipelineConfig

# kernel launches made by slots_to_hashes (read by the on-card smoke run)
launches = {"pair_scan": 0}


def pack_hashes(f1: torch.Tensor, f2: torch.Tensor,
                dt) -> torch.Tensor:
    """20-bit hash: ((f1 & 0xFF) << 12) | ((f2-f1 & 0x3F) << 6) | (dt & 0x3F)."""
    f1 = f1.to(torch.int32)
    return (((f1 & P.F1_MASK) << P.F1_SHIFT)
            | (((f2.to(torch.int32) - f1) & P.DF_MASK) << P.DF_SHIFT)
            | (dt.to(torch.int32) & P.DT_MASK))


def slice_start(d: int, T: int, targetdt: int) -> int:
    """The first padded frame the scan's step d reads (jax.lax.dynamic_slice
    of T frames out of T + targetdt): d itself for the d >= 0 of every
    real configuration; a negative d (mindt < 0) wraps by the padded
    length and is clamped to [0, targetdt]."""
    s = d + T + targetdt if d < 0 else d
    return min(max(s, 0), targetdt)


def slots_to_hashes_plain(bins: torch.Tensor, valid: torch.Tensor,
                          cfg: PipelineConfig):
    """Plain version of K3: a loop over the (targetdt - mindt) dt offsets
    with a small carry (per anchor fill count + fanout partner slots), the
    lax.scan of audfprint_tpu/ops/landmarks.py written out.  Each step
    examines the K partner slots of frame t+dt in bin-ascending order and
    appends the qualifying ones, the reference's (dt asc, partner-bin asc)
    order.

    Args and returns: as slots_to_hashes.
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
        s = slice_start(d, T, cfg.targetdt)
        pbin = bins_p[:, s: s + T]
        pval = valid_p[:, s: s + T]
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
    return _times(T, hashes), torch.where(lvalid, hashes, 0), lvalid


def _times(T: int, hashes: torch.Tensor) -> torch.Tensor:
    """Each landmark's anchor frame: an expanded view of arange(T)."""
    return torch.arange(T, dtype=torch.int32, device=hashes.device)[
        None, :, None, None].expand(hashes.shape)


def slots_to_hashes(bins: torch.Tensor, valid: torch.Tensor,
                    cfg: PipelineConfig):
    """Per-frame peak slots -> per-anchor landmark hashes: kernel K3
    (csrc/pair.cu) on a CUDA tensor, slots_to_hashes_plain on a CPU
    tensor.

    Args:
      bins:  (B, T, K) int32 peak bins, ascending per frame
      valid: (B, T, K) bool

    Returns (times, hashes, lvalid), each (B, T, K, fanout): int32 anchor
    frame, int32 packed 20-bit hash (0 where invalid), bool.
    """
    if bins.device.type == "cpu":
        return slots_to_hashes_plain(bins, valid, cfg)
    if bins.device.type != "cuda":
        raise RuntimeError(f"pair_scan: no kernel for device {bins.device}")
    B, T, K = bins.shape
    if valid.shape != bins.shape:
        raise ValueError(f"pair_scan: valid {tuple(valid.shape)} and bins "
                         f"{tuple(bins.shape)} differ")
    fanout = cfg.maxpairsperpeak
    dev = bins.device
    hashes = torch.empty((B, T, K, fanout), dtype=torch.int32, device=dev)
    lvalid = torch.empty((B, T, K, fanout), dtype=torch.bool, device=dev)
    if hashes.numel() == 0:
        return _times(T, hashes), hashes, lvalid
    from audfprint_torch.ops import _build

    b32 = bins.to(torch.int32).contiguous()
    v8 = valid.to(device=dev, dtype=torch.bool).contiguous()
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.pair_scan(
            b32.data_ptr(), v8.data_ptr(), hashes.data_ptr(),
            lvalid.data_ptr(), B, T, K, fanout, cfg.mindt, cfg.targetdt,
            cfg.targetdf, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pair_scan")
    launches["pair_scan"] += 1
    return _times(T, hashes), hashes, lvalid
