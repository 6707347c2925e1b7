"""Batched spectrogram front end (PyTorch port of audfprint_tpu/ops/spectro.py).

Audio batch (B, N) -> whitened log-magnitude spectrogram (B, T, n_bins)
with per-file valid-frame masking, then the causal onset HPF along time.
The FFT is torch.fft.rfft (cuFFT on the card), so the spectrogram agrees
with the JAX package within the front end's tolerance, not bit for bit;
the HPF is bit-exact given the same input.

`hpf` is kernel K2 (csrc/hpf.cu) on CUDA tensors and its plain version,
a loop over T, on CPU tensors; both take and return the recurrence's
carry, so streamed ingest continues it across chunks of frames.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audfprint_torch import params as P
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


@functools.lru_cache(maxsize=8)
def hann_window(n_fft: int, device: torch.device) -> torch.Tensor:
    """The analysis window, made once per device: an upload per call would
    wait for the work queued on the stream."""
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


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 a * b + c (one rounding, as a hardware
    FMA).  The f64 product of two f32 values is exact; the f64 sum is made
    round-to-odd (TwoSum error term), so the final cast to f32 rounds once
    correctly instead of twice."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def hpf_plain(white: torch.Tensor, cfg: PipelineConfig, carry=None):
    """Plain version of K2: y[t] = fma(pole, y[t-1], x[t] - x[t-1]).

    `carry` is (x[-1], y[-1]), each (B, F), or None for zeros; returns
    (y, (x[T-1], y[T-1])), the carry that continues the recurrence into
    the next chunk of frames.  The reference (XLA on the CPU) contracts
    the recurrence into a fused multiply-add with the difference rounded
    first; this forms the same single rounding, so the result is
    bit-exact against it."""
    pole = torch.tensor(_pole(cfg), dtype=torch.float32, device=white.device)
    out = torch.empty_like(white)
    if carry is None:
        xprev = white.new_zeros(white.shape[0], white.shape[2])
        yprev = xprev
    else:
        xprev, yprev = carry
    for t in range(white.shape[1]):
        x = white[:, t]
        yprev = fma_f32(pole, yprev, x - xprev)
        out[:, t] = yprev
        xprev = x
    return out, (xprev, yprev)


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
    y = torch.empty_like(x)
    if x.numel() == 0:
        if carry is None:
            carry = (x.new_zeros(B, F), x.new_zeros(B, F))
        return y, carry
    x_out = x.new_empty(B, F)
    y_out = x.new_empty(B, F)
    x0, y0 = (None, None) if carry is None else (carry[0].data_ptr(),
                                                 carry[1].data_ptr())
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.hpf_scan(x.data_ptr(), y.data_ptr(), x0, y0,
                           x_out.data_ptr(), y_out.data_ptr(), B, T, F,
                           _pole(cfg), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "hpf_scan")
    launches["hpf_scan"] += 1
    return y, (x_out, y_out)
