"""Batched spectrogram front end (PyTorch port of audfprint_tpu/ops/spectro.py).

Audio batch (B, N) -> whitened log-magnitude spectrogram (B, T, n_bins)
with per-file valid-frame masking, then the causal onset HPF along time.
The FFT is torch.fft.rfft (cuFFT on the card), so the spectrogram agrees
with the JAX package within the front end's tolerance, not bit for bit;
the HPF is bit-exact given the same input, subnormals flushed as the
reference flushes them (ops/ftz.py).

`hpf` is kernel K2 (csrc/hpf.cu) on CUDA tensors and its plain version,
a loop over T, on CPU tensors; both take and return the recurrence's
carry, so streamed ingest continues it across chunks of frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.ops import ftz as FTZ
from audfprint_torch.ops.config import PipelineConfig

# kernel launches made by hpf (read by the on-card smoke run)
launches = {"hpf_scan": 0}


def n_frames_padded(n_samples_padded: int, cfg: PipelineConfig) -> int:
    if n_samples_padded < cfg.n_fft:
        return 0
    return 1 + (n_samples_padded - cfg.n_fft) // cfg.n_hop


def frame_batch(audio: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """(B, N) -> (B, T, n_fft) overlapping frames, frame t starts at t*n_hop."""
    B, N = audio.shape
    if n_frames_padded(N, cfg) <= 0:
        return audio.new_zeros((B, 0, cfg.n_fft))
    return audio.unfold(1, cfg.n_fft, cfg.n_hop)


@functools.lru_cache(maxsize=None)
def hann_window(n_fft: int, device: torch.device) -> torch.Tensor:
    """The analysis window, made once per device: an upload per call would
    wait for the work queued on the stream.  Kept for the life of the
    process: a captured graph reads it by address (utils/graphs.py)."""
    return torch.as_tensor(P.hann_window(n_fft).astype(np.float32),
                           device=device)


def whitened_logmag(audio: torch.Tensor, n_frames: torch.Tensor,
                    cfg: PipelineConfig) -> torch.Tensor:
    """(B, N) float32, (B,) int -> pre-HPF whitened log-mag (B, T, n_bins).

    Rows t >= n_frames[b] carry arbitrary values; the peak picker masks
    them."""
    frames = frame_batch(audio.to(torch.float32), cfg)
    B, T, _ = frames.shape
    mag = torch.fft.rfft(frames * hann_window(cfg.n_fft, audio.device),
                         dim=-1).abs()                           # (B,T,257)
    valid = (torch.arange(T, device=audio.device)[None, :]
             < n_frames.to(audio.device)[:, None])
    vmask = valid[:, :, None]
    zero = mag.new_zeros(())
    mx = torch.where(vmask, mag, zero).amax(dim=(1, 2), keepdim=True)
    logm = torch.log(torch.maximum(mag, torch.clamp(mx, min=1e-37) / 1e6))
    nvalid = torch.clamp(n_frames.to(audio.device), min=1)[:, None, None]
    mean = (torch.where(vmask, logm, zero).sum(dim=(1, 2), keepdim=True)
            / (nvalid.to(torch.float32) * mag.shape[-1]))
    white = torch.where(mx > 0.0, logm - mean, mag)   # zero signal passes raw
    return white[:, :, : cfg.n_bins].contiguous()


def _pole(cfg: PipelineConfig) -> float:
    return float(np.float32(cfg.hpf_pole ** (1.0 / P.OVERSAMP)))


def hpf_plain(white: torch.Tensor, cfg: PipelineConfig, carry=None):
    """Plain version of K2: y[t] = fma(pole, y[t-1], x[t] - x[t-1]).

    `carry` is (x[-1], y[-1]), each (B, F), or None for zeros; returns
    (y, (x[T-1], y[T-1])), the carry that continues the recurrence into
    the next chunk of frames.  The reference (XLA on the CPU) contracts
    the recurrence into a fused multiply-add with the difference rounded
    first, and flushes subnormal inputs and results (ops/ftz.py); this
    forms the same single rounding under the same rule, so the result is
    bit-exact against it.  x[T-1] leaves unflushed, as the reference's
    scan carries it."""
    pole = torch.tensor(_pole(cfg), dtype=torch.float32, device=white.device)
    out = torch.empty_like(white)
    if carry is None:
        xprev = white.new_zeros(white.shape[0], white.shape[2])
        yprev = xprev
    else:
        xprev, yprev = carry
    for t in range(white.shape[1]):
        x = white[:, t]
        yprev = FTZ.fma(pole, yprev, FTZ.sub(x, xprev))
        out[:, t] = yprev
        xprev = x
    return out, (xprev, yprev)


# K2's launch plan (csrc/hpf.cu).  A block scans a strip of K2_STRIP
# consecutive bins of one row, walking t; the grid covers B x ceil(Fp /
# K2_STRIP) strips.  Frames reach shared memory as TMA boxes of `frames` x
# K2_STRIP floats, `stages` of them in flight, and y leaves through
# K2_Y_STAGES output boxes.  K2_STRIP, K2_Y_STAGES and K2_MAX_SMEM mirror
# kStrip, kYStages and kMaxSmem in hpf.cu.
K2_SMS = 132                  # SMs of an H100 SXM
K2_STRIP = 32                 # bins a block owns (128 B a frame)
K2_Y_STAGES = 3
K2_MAX_SMEM = 232448          # a block's shared memory on sm_90


class K2Plan(NamedTuple):
    Fp: int          # bins the kernel scans: F padded to a multiple of 4
    frames: int      # frames of one box (one ring stage)
    stages: int      # input boxes in flight per strip
    n_strips: int    # blocks
    smem: int        # dynamic shared memory bytes of a block


def k2_plan(B: int, T: int, F: int, sms: int = K2_SMS) -> K2Plan:
    """K2's launch for a (B, T, F) scan.  With at most one strip per SM (a
    streamed chunk, a query) each strip gets 256-frame boxes and 96 KB of
    input in flight: a box's fixed cost in the scanning warp (two barrier
    waits and two arrivals) is paid once per 256 frames, and the loads run
    ahead of the chain of T dependent FMAs.  A batch has strips to spare:
    8 KB boxes, four in flight, three blocks an SM.  The plan does not
    depend on T: the last box of a row is cut at T."""
    Fp = -(-F // 4) * 4
    n = B * -(-Fp // K2_STRIP)
    frames = 256 if n <= sms else 64
    stages = 3 if n <= sms else 4
    smem = ((stages + K2_Y_STAGES) * frames * K2_STRIP * 4
            + 2 * (stages + K2_Y_STAGES) * 8)
    return K2Plan(Fp, frames, stages, n, smem)


def k2_operands(x: torch.Tensor, carry, Fp: int):
    """K2's operands: the bins padded with zeros to Fp (16-byte rows for
    the TMA boxes), x 16-byte aligned.  The pad bins scan zeros and are cut
    off by k2_results before anything is returned."""
    F = x.shape[-1]
    if Fp != F:
        x = torch.nn.functional.pad(x, (0, Fp - F))
        if carry is not None:
            carry = tuple(torch.nn.functional.pad(c, (0, Fp - F))
                          for c in carry)
    if x.data_ptr() % 16:
        x = x.clone()
    return x, carry


def k2_results(y: torch.Tensor, x_out: torch.Tensor, y_out: torch.Tensor,
               F: int):
    """(y, carry out) on the real F bins of K2's padded results."""
    if y.shape[-1] == F:
        return y, (x_out, y_out)
    return (y[..., :F].contiguous(),
            (x_out[:, :F].contiguous(), y_out[:, :F].contiguous()))


def hpf(white: torch.Tensor, cfg: PipelineConfig, carry=None):
    """Causal onset HPF along time of a (B, T, F) float32 spectrogram:
    kernel K2 on a CUDA tensor, the plain loop on a CPU tensor.

    `carry` is (x[-1], y[-1]), each (B, F) float32, or None for zeros;
    returns (y, carry out) as hpf_plain does."""
    if white.device.type == "cpu":
        return hpf_plain(white, cfg, carry)
    if white.device.type != "cuda":
        raise RuntimeError(f"hpf: no kernel for device {white.device}")
    if white.dtype != torch.float32 or white.dim() != 3:
        raise ValueError("hpf: expects a (B, T, F) float32 tensor")
    from audfprint_torch.ops import _build

    x = white.contiguous()
    B, T, F = x.shape
    if carry is not None:
        carry = tuple(c.to(device=x.device, dtype=torch.float32).contiguous()
                      for c in carry)
        if any(c.shape != (B, F) for c in carry):
            raise ValueError(f"hpf: the carry must be two ({B}, {F}) tensors")
    if x.numel() == 0:
        if carry is None:
            carry = (x.new_zeros(B, F), x.new_zeros(B, F))
        return torch.empty_like(x), carry
    plan = k2_plan(B, T, F, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    if plan.smem > K2_MAX_SMEM:
        raise ValueError(f"hpf: needs {plan.smem} bytes of shared memory")
    xk, carry = k2_operands(x, carry, plan.Fp)
    y = torch.empty_like(xk)
    x_out = xk.new_empty(B, plan.Fp)
    y_out = xk.new_empty(B, plan.Fp)
    x0, y0 = (None, None) if carry is None else (carry[0].data_ptr(),
                                                 carry[1].data_ptr())
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.hpf_scan(xk.data_ptr(), y.data_ptr(), x0, y0,
                           x_out.data_ptr(), y_out.data_ptr(), B, T,
                           plan.Fp, _pole(cfg), plan.frames, plan.stages,
                           torch.cuda.current_stream().cuda_stream)
    _build.check(err, "hpf_scan")
    launches["hpf_scan"] += 1
    return k2_results(y, x_out, y_out, F)


def whitened_spectrogram(audio: torch.Tensor, n_frames: torch.Tensor,
                         cfg: PipelineConfig) -> torch.Tensor:
    """(B, N) float32, (B,) int -> HPF'd whitened log-mag (B, T, n_bins):
    whitened_logmag then hpf (K2 on a CUDA tensor) from a zero carry."""
    return hpf(whitened_logmag(audio, n_frames, cfg), cfg)[0]
