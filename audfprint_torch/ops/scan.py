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

# int64 elements a block of K4 scans (csrc/scan.cu kTileSmall,
# kTileMedium, kTileLarge)
TILES = (1024, 2048, 4096)
# the blocks a call should give: about 100 spread it over most of an
# H100's 132 SMs; past that, more tiles in one row lengthen its look-back
# chain more than the spread saves (PERF.md)
SPREAD = 100
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


def plan(B: int, H: int) -> int:
    """K4's tile for a (B, H) call: the largest tile that gives SPREAD
    blocks or more, else the smallest (a one-tile row of a short call
    takes it too)."""
    for tile in reversed(TILES):
        if B * -(-H // tile) >= SPREAD:
            return tile
    return TILES[0]


def workspace_words(B: int, H: int, tile: int) -> int:
    """int64 words of K4's workspace at this tile: the tile counter, a
    word unused (16-byte alignment) and a 16-byte slot a tile, status and
    value (csrc/scan.cu); none when a row is one tile."""
    ntiles = -(-H // tile)
    return 2 + 2 * B * ntiles if ntiles > 1 else 0


def seg_scan(x: torch.Tensor, op: str, reverse: bool = False, *,
             tile: int | None = None) -> torch.Tensor:
    """y[..., i] = x[..., 0] op ... op x[..., i] (reverse: x[..., i] op
    ... op x[..., -1]) for op in "max", "min", "add" (wrapping modulo
    2^64): K4 on a CUDA tensor, seg_scan_plain on a CPU tensor.

    Args:
      x: int64, at least one dimension; the scan runs along the last.
      tile: K4's tile, one of TILES; None takes `plan`'s.  The result
        does not depend on it; the CPU ignores it.
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
    tile = plan(B, H) if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"seg_scan: tile {tile} is not one of {TILES}")
    words = workspace_words(B, H, tile)
    ws = (torch.empty((words,), dtype=torch.int64, device=x.device)
          if words else None)
    from audfprint_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.seg_scan(x.data_ptr(), y.data_ptr(),
                           ws.data_ptr() if ws is not None else None, B, H,
                           tile, _OPS[op], int(reverse),
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
