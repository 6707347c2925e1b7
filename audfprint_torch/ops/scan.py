"""Inclusive max / min / add scans along the last axis of int64 tensors:
kernel K4 (csrc/scan.cu) on a CUDA tensor, seg_scan_plain on a CPU
tensor.

The JAX package's segmented scans (the vote's run starts and ends, its
segmented copy and lexicographic max, the run starts of the device store
and of the routed ingest) and its prefix sums over hit rows go through
here.  Every one is integer arithmetic, so K4 and the plain version agree
bit for bit.  A reverse scan (`reverse=True`) runs from the row's end,
where the plain version flips, scans and flips back.
"""

from __future__ import annotations

import torch

# int64 elements a block of K4 scans (csrc/scan.cu kTile)
TILE = 4096
_OPS = {"max": 0, "min": 1, "add": 2}

# kernel launches made by seg_scan (read by the on-card smoke run)
launches = {"seg_scan": 0}


def seg_scan_plain(x: torch.Tensor, op: str,
                   reverse: bool = False) -> torch.Tensor:
    """Plain version of K4: torch's cummax, cummin or cumsum along the
    last axis, between two flips for a reverse scan."""
    if op not in _OPS:
        raise ValueError(f"seg_scan: op {op!r} is not one of {list(_OPS)}")
    if reverse:
        x = x.flip(-1)
    if op == "max":
        y = torch.cummax(x, dim=-1).values
    elif op == "min":
        y = torch.cummin(x, dim=-1).values
    else:
        y = torch.cumsum(x, dim=-1)
    return y.flip(-1) if reverse else y


def seg_scan(x: torch.Tensor, op: str, reverse: bool = False
             ) -> torch.Tensor:
    """y[..., i] = x[..., 0] op ... op x[..., i] (reverse: x[..., i] op
    ... op x[..., -1]) for op in "max", "min", "add" (wrapping modulo
    2^64): K4 on a CUDA tensor, seg_scan_plain on a CPU tensor.

    Args:
      x: int64, at least one dimension; the scan runs along the last.
    Returns an int64 tensor of x's shape.
    """
    if x.device.type == "cpu":
        return seg_scan_plain(x, op, reverse)
    if x.device.type != "cuda":
        raise RuntimeError(f"seg_scan: no kernel for device {x.device}")
    if op not in _OPS:
        raise ValueError(f"seg_scan: op {op!r} is not one of {list(_OPS)}")
    if x.dtype != torch.int64 or x.dim() == 0:
        raise ValueError(f"seg_scan: takes int64 with a last axis, not "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    H = x.shape[-1]
    B = x.numel() // H
    ntiles = -(-H // TILE)
    ws = (torch.empty((B, ntiles), dtype=torch.int64, device=x.device)
          if ntiles > 1 else None)
    from audfprint_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.seg_scan(x.data_ptr(), y.data_ptr(),
                           ws.data_ptr() if ws is not None else None, B, H,
                           _OPS[op], int(reverse),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(err, "seg_scan")
    launches["seg_scan"] += 1
    return y


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Running max along the last axis (K4 on the card)."""
    return seg_scan(x, "max")


def cummin(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Running min along the last axis, from the row's end when reverse
    (K4 on the card)."""
    return seg_scan(x, "min", reverse)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Running sum along the last axis, int64 (K4 on the card)."""
    return seg_scan(x, "add")
