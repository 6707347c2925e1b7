"""End-to-end fingerprint pipeline: audio batch -> sorted unique hashes
(port of audfprint_tpu/ops/pipeline.py).

Framing, |rfft|, whitening, HPF (kernel K2), fwd+bwd peak pruning (kernel
K1), landmark pairing, 20-bit packing, and a per-file sort + dedup of the
(t, hash) rows (the reference's np.unique).  Shifts (`--shifts S`) become
extra batch rows, re-merged per file before the dedup.

The sort uses one int64 key (t << 20) | hash at every T.  On CUDA tensors
the peak stage is always K1, on CPU tensors always its plain version
(ops/cuda_peaks.prune_fwd_bwd decides by the tensor's device).
"""

from __future__ import annotations

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.ops.config import PipelineConfig
from audfprint_torch.ops import cuda_peaks as CP
from audfprint_torch.ops import landmarks as L
from audfprint_torch.ops import scan as SC
from audfprint_torch.ops import spectro as SP

T_SENTINEL = 2**31 - 1
_KEY_SENTINEL = 2**63 - 1


def frame_count_device(lengths: torch.Tensor,
                       cfg: PipelineConfig) -> torch.Tensor:
    return torch.where(lengths >= cfg.n_fft,
                       1 + (lengths - cfg.n_fft) // cfg.n_hop,
                       0).to(torch.int32)


def launch_counters() -> tuple:
    """The kernel wrappers' launch counts: K2 (spectro), K1 and K1f
    (cuda_peaks), K3 (landmarks), K4 (scan)."""
    return SP.launches, CP.launches, L.launches, SC.launches


# frames of an n-sample row, under the JAX package's name
n_frames_padded_static = SP.n_frames_padded


def _expand_shifts(audio: torch.Tensor, lengths: torch.Tensor,
                   cfg: PipelineConfig):
    """(B, N) -> (B*S, N) sub-hop-shifted copies; rows grouped per file."""
    S = cfg.shifts
    if S <= 1:
        return audio, lengths
    B, N = audio.shape
    padded = torch.cat([audio, audio.new_zeros((B, cfg.n_hop))], dim=1)
    offs = [s * cfg.n_hop // S for s in range(S)]
    audio_s = torch.stack([padded[:, o: o + N] for o in offs],
                          dim=1).reshape(B * S, N)
    lengths_s = torch.stack([torch.clamp(lengths - o, min=0) for o in offs],
                            dim=1).reshape(B * S)
    return audio_s, lengths_s


def _peak_slots(audio: torch.Tensor, lengths: torch.Tensor,
                cfg: PipelineConfig):
    """Shared front half of fingerprint_batch and peaks_batch: shift
    expansion, |rfft|, whitening, fwd+bwd peak pruning -> per-frame peak
    slots (bins, valid), each (B*shifts, T, maxpks), and T."""
    if audio.dtype == torch.int16:
        # raw PCM staging: x * 2**-15 is an exponent shift — bit-identical
        # to the host buf_to_float conversion, at half the H2D bytes
        audio = audio.to(torch.float32) * (1.0 / 32768.0)
    audio_s, lengths_s = _expand_shifts(
        audio.to(torch.float32), lengths.to(torch.int32), cfg)
    n_frames = frame_count_device(lengths_s, cfg)
    T = SP.n_frames_padded(audio_s.shape[1], cfg)
    if T == 0:
        z = torch.zeros((audio_s.shape[0], 0, cfg.maxpksperframe),
                        dtype=torch.int32, device=audio.device)
        return z, z.bool(), T
    white = SP.whitened_logmag(audio_s, n_frames, cfg)
    bins, valid = CP.find_peaks_slots_fused(white, n_frames, cfg)
    return bins, valid, T


def peaks_batch(audio: torch.Tensor, lengths: torch.Tensor,
                cfg: PipelineConfig):
    """Batched peak extraction (the `precompute -K` path): audio batch ->
    (bins, valid) shaped (B, shifts, T, maxpks) int32/bool."""
    B = audio.shape[0]
    bins, valid, T = _peak_slots(audio, lengths, cfg)
    k = bins.shape[-1]
    return (bins.reshape(B, cfg.shifts, T, k),
            valid.reshape(B, cfg.shifts, T, k))


def fingerprint_batch(audio: torch.Tensor, lengths: torch.Tensor,
                      cfg: PipelineConfig):
    """Fingerprint a padded batch of audio.

    Args:
      audio:   (B, N) float32 or int16, zero-padded past per-file lengths
      lengths: (B,) int true sample counts

    Returns:
      times:  (B, L) int32 sorted unique (t, hash) rows' times
      hashes: (B, L) int32
      uniq:   (B, L) bool   validity mask (True rows are the output set)
      counts: (B,) int32    number of unique hashes per file
    """
    B = audio.shape[0]
    bins, valid, _T = _peak_slots(audio, lengths, cfg)
    times, hashes, lvalid = L.slots_to_hashes(bins, valid, cfg)
    # all shift rows of one file together, one packed sort key per row
    flat_t = times.reshape(B, -1).to(torch.int64)
    flat_h = hashes.reshape(B, -1).to(torch.int64)
    packed = torch.where(lvalid.reshape(B, -1), (flat_t << 20) | flat_h,
                         _KEY_SENTINEL)
    p_s = torch.sort(packed, dim=1).values
    valid_s = p_s != _KEY_SENTINEL
    t_s = torch.where(valid_s, p_s >> 20, T_SENTINEL).to(torch.int32)
    h_s = torch.where(valid_s, p_s & 0xFFFFF, T_SENTINEL).to(torch.int32)
    neq = torch.cat([torch.ones_like(valid_s[:, :1]),
                     p_s[:, 1:] != p_s[:, :-1]], dim=1)
    uniq = valid_s & neq
    counts = uniq.sum(dim=1, dtype=torch.int32)
    return t_s, h_s, uniq, counts


def fingerprint_batch_compact(audio: torch.Tensor, lengths: torch.Tensor,
                              cfg: PipelineConfig):
    """fingerprint_batch with the unique rows front-compacted into one
    buffer: returns (th (B, L, 2) int32 [t, hash], counts (B,)).  Row b's
    unique hashes occupy th[b, :counts[b]]; the tail is zeroed."""
    t_s, h_s, uniq, counts = fingerprint_batch(audio, lengths, cfg)
    L_ = t_s.shape[1]
    iota = torch.arange(L_, device=t_s.device)[None]
    order = torch.argsort(torch.where(uniq, iota, L_ + iota), dim=1)
    keepm = iota < counts[:, None]
    th = torch.stack([torch.where(keepm, t_s.gather(1, order), 0),
                      torch.where(keepm, h_s.gather(1, order), 0)], dim=-1)
    return th, counts


def fingerprint_batch_compact_k(audio: torch.Tensor, lengths: torch.Tensor,
                                cfg: PipelineConfig, k: int):
    """fingerprint_batch_compact plus a single-fetch result buffer.

    Returns (buf, th): buf is (B, min(k, L) + 1, 2) int32 whose columns
    [:k'] are the front-compacted (t, hash) rows and whose column [k', 0]
    is the per-file unique count; `th` is the full-capacity buffer, kept on
    the device for the rare row with more than k unique hashes."""
    th, counts = fingerprint_batch_compact(audio, lengths, cfg)
    kk = min(k, th.shape[1])
    extra = torch.stack([counts, torch.zeros_like(counts)], dim=-1)[:, None]
    return torch.cat([th[:, :kk], extra], dim=1), th


def fingerprint_bytes(rows: int, n: int, cfg: PipelineConfig) -> int:
    """An estimate of the device bytes fingerprint_batch_compact_k keeps
    live for a (rows, n) batch, which its captured graph holds in the
    graphs' shared pool: per row and shift the audio twice, the framed
    signal, eight spectrogram-sized float32 arrays (the rfft's complex
    output counts two) and 64 bytes per landmark slot for the pairing,
    its sort and the compaction."""
    T = SP.n_frames_padded(n, cfg)
    slots = T * cfg.maxpksperframe * cfg.maxpairsperpeak
    per = (8 * n + 4 * T * cfg.n_fft + 32 * T * (cfg.n_fft // 2 + 1)
           + 64 * slots)
    return rows * cfg.shifts * per


def resolve_compact(th: torch.Tensor, counts) -> list:
    """Materialise fingerprint_batch_compact outputs as (n, 2) int32
    arrays, fetching only a power-of-two column slice covering max(counts)."""
    counts = np.asarray(counts.cpu() if torch.is_tensor(counts) else counts)
    L_ = th.shape[1]
    kmax = int(counts.max()) if counts.size else 0
    k = min(L_, P.next_pow2(max(1, kmax), 512))
    th_np = th[:, :k].cpu().numpy()
    return [th_np[b, : counts[b]].astype(np.int32)
            for b in range(th_np.shape[0])]


def fingerprint_numpy(audio_batch, lengths, cfg: PipelineConfig, device):
    """Host convenience: run the pipeline on `device`, return a list of
    (n, 2) int32 (t, hash) arrays, matching oracle samples_to_hashes."""
    th, counts = fingerprint_batch_compact(
        torch.as_tensor(np.asarray(audio_batch), device=device),
        torch.as_tensor(np.asarray(lengths, np.int32), device=device), cfg)
    return resolve_compact(th, counts)
