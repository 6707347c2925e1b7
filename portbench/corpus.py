"""The benchmark's inputs, made from the seed inside the run's process.

Tracks follow the music-like recipe of the repository's smoke run
(`synth_track`: noise at 0.01 plus eight Hann-windowed tone bursts a
second, 80-4000 Hz, 0.1-0.8 s, amplitude 0.1-0.5, peak-normalised to
0.7), here drawn on the device with a seeded `torch.Generator` in whole
batches and quantised to int16 PCM as a 16-bit WAV at 11,025 Hz holds it.
Degradations follow the config-3 recipe (`_degrade`: rational resampling
for a speed change, a 6th-order Butterworth low-pass, white noise at a
set SNR of the clip's own power), in NumPy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SR = 11025
HOP = 256


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g


def tracks(n: int, dur_s: float, gen: torch.Generator, device,
           tones_per_sec: float = 8.0, noise: float = 0.01) -> torch.Tensor:
    """(n, dur_s * SR) int16 tracks on `device`."""
    N = int(dur_s * SR)
    m = int(dur_s * tones_per_sec)
    lmax = int(0.8 * SR) + 1

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((n, m), generator=gen,
                                           device=device)

    f, start, length = u(80, 4000), u(0, dur_s - 0.3), u(0.1, 0.8)
    amp, phase = u(0.1, 0.5), u(0, 2 * math.pi)
    i0 = torch.ceil(start * SR).long()
    mlen = torch.clamp(i0 + (length * SR).long(), max=N) - i0
    # tones past the end write into the padding, which is cut off
    x = torch.zeros((n, N + lmax), device=device)
    x[:, :N] = noise * torch.randn((n, N), generator=gen, device=device)
    seg = torch.arange(lmax, device=device)
    rows = torch.arange(n, device=device)[:, None]
    for j in range(m):
        ml = mlen[:, j: j + 1]
        idx = i0[:, j: j + 1] + seg
        win = 0.5 - 0.5 * torch.cos(2 * math.pi * seg
                                    / torch.clamp(ml - 1, min=1))
        tone = amp[:, j: j + 1] * win * torch.sin(
            2 * math.pi * f[:, j: j + 1] * (idx / SR) + phase[:, j: j + 1])
        x[rows, idx] = x[rows, idx] + torch.where(seg < ml, tone, 0.0)
    x = x[:, :N]
    peak = torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-9)
    pcm = torch.round(x / peak * 0.7 * 32768.0)
    return torch.clamp(pcm, -32768, 32767).to(torch.int16)


def excerpts(host_tracks: np.ndarray, n: int, dur_s: float,
             rng: np.random.Generator) -> tuple[list, np.ndarray, np.ndarray]:
    """n hop-aligned excerpts of dur_s seconds from distinct tracks where
    there are enough of them: (clips, track ids, start samples)."""
    n_tracks, N = host_tracks.shape
    L = int(dur_s * SR)
    ids = (rng.permutation(n_tracks)[:n] if n <= n_tracks
           else rng.integers(0, n_tracks, n))
    starts = HOP * rng.integers(0, (N - L) // HOP + 1, n)
    clips = [host_tracks[i, s: s + L].copy() for i, s in zip(ids, starts)]
    return clips, ids, starts


def degrade(clip: np.ndarray, rng: np.random.Generator, snr_db=None,
            speed=None, lowpass_hz=None) -> np.ndarray:
    """One query degradation of int16 or float samples -> float32."""
    from scipy.signal import butter, resample_poly, sosfilt
    x = clip.astype(np.float64)
    if clip.dtype == np.int16:
        x = x / 32768.0
    if speed and speed != 1.0:
        x = resample_poly(x, max(1, round(1000 / speed)), 1000)
    if lowpass_hz:
        x = sosfilt(butter(6, lowpass_hz / (SR / 2), output="sos"), x)
    if snr_db is not None:
        noise_pow = float(np.mean(x ** 2)) / (10 ** (snr_db / 10))
        x = x + np.sqrt(noise_pow) * rng.standard_normal(len(x))
    return x.astype(np.float32)
