"""Fused forward/backward peak prune (port of audfprint_tpu/ops/pallas_peaks.py).

Everything with no data dependence on the masking envelope runs as plain
tensor code over all frames at once: the onset HPF (kernel K2), locmax,
the length mask into the candidate map m0, and both initial envelopes.
The irreducibly sequential part is kernel K1 (csrc/prune.cu) on CUDA
tensors and `prune_fwd_bwd_plain` on CPU tensors; both return the kept
positions per frame in extraction order, -1 where nothing was kept.  The
delete-next rule and the ascending slot order follow in plain torch.

Streamed ingest (ops/streaming.py) runs the forward half alone, chunk by
chunk: kernel K1f, `prune_fwd_carry` (plain version
`prune_fwd_carry_plain`), takes the envelope in and hands it back, the
port of audfprint_tpu/ops/peaks.py fwd_prune_carry.

The TPU kernel split the (F, F) bump table into three bf16 planes to reach
the MXU; K1 reads the 2F-1 float template directly and forms the same
single f32 product v * g, so results stay bit-identical to
ops.peaks.find_peaks_mask(hpf(sgram)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audfprint_torch.ops.config import PipelineConfig
from audfprint_torch.ops import peaks as PK
from audfprint_torch.ops import spectro as SP

_NEG = -3.0e38     # "not a candidate" in m0: below every envelope
MAX_BINS = 1024    # K1/K1f: one warp per row, at most 32 bins per lane
MAX_K = 16         # a frame's slots are lanes 0..k-1

# The kernels' shared memory (csrc/prune.cu Layout): a ring of kStages
# stages of about kStageBytes of m0, one mbarrier per stage, the 2F - 1
# template and, for K1 when they fit with two rows per SM, the T * k
# (pos, val) lists.
_STAGES = 4
_STAGE_BYTES = 8192
_MAX_SMEM = 232448            # a block's shared memory on sm_90
_LIST_SMEM_MAX = 113 * 1024


def _smem_bytes(T: int, F: int, k: int, lists: bool) -> int:
    sf = max(1, _STAGE_BYTES // (F * 4))
    tmpl = _STAGES * sf * F * 4 + _STAGES * 8
    return (((tmpl + (2 * F - 1) * 4 + 15) & ~15)
            + (T * k * 8 if lists else 0))


def _kernel_inputs(what: str, m0: torch.Tensor, envs: list,
                   gvec: torch.Tensor, T: int, k: int, lists: bool):
    """The kernels' f32 operands with the bins padded to a multiple of 4
    (16-byte bulk copies): m0 with _NEG, which is never a candidate, the
    envelopes with 0, and the template re-centred on the padded width, so
    every real bin sees the same bump values.  Checks the padding and the
    shared memory the launch needs; returns (m0, envs, gvec, Fp)."""
    F = m0.shape[-1]
    Fp = -(-F // 4) * 4
    if Fp % 4 or not 0 < Fp <= MAX_BINS:
        raise ValueError(f"{what}: padded bins {Fp} must be a multiple of 4 "
                         f"and at most {MAX_BINS}")
    need = _smem_bytes(T, Fp, k, False)
    if lists and _smem_bytes(T, Fp, k, True) <= _LIST_SMEM_MAX:
        need = _smem_bytes(T, Fp, k, True)
    if need > _MAX_SMEM:
        raise ValueError(f"{what}: needs {need} bytes of shared memory, more "
                         f"than the {_MAX_SMEM} a block has on sm_90")
    f32 = torch.float32
    dev = m0.device
    m0c = m0.to(f32)
    g = gvec.to(device=dev, dtype=f32)
    envs = [e.to(device=dev, dtype=f32) for e in envs]
    if Fp != F:
        m0c = torch.nn.functional.pad(m0c, (0, Fp - F), value=_NEG)
        envs = [torch.nn.functional.pad(e, (0, Fp - F)) for e in envs]
        g2 = g.new_zeros(2 * Fp - 1)
        g2[Fp - F: Fp + F - 1] = g
        g = g2
    m0c = m0c.contiguous()
    if m0c.data_ptr() % 16:           # bulk copies read 16-byte rows
        m0c = m0c.clone()
    return m0c, [e.contiguous() for e in envs], g.contiguous(), Fp

# kernel launches made by prune_fwd_bwd and prune_fwd_carry (read by the
# on-card smoke run)
launches = {"prune_fwd_bwd": 0, "prune_fwd_carry": 0}


def _bump_table(gvec: torch.Tensor, F: int) -> torch.Tensor:
    """(F, F) rows gtab[p, j] = gvec[j - p + F - 1] (full support)."""
    j = torch.arange(F, device=gvec.device)
    return gvec[(j[None, :] - j[:, None]) + (F - 1)]


def prune_fwd_bwd_plain(m0: torch.Tensor, n_frames: torch.Tensor,
                        env0f: torch.Tensor, env0b: torch.Tensor,
                        gvec: torch.Tensor, a_dec: float,
                        k: int) -> torch.Tensor:
    """Plain version of K1 -> kept (B, T, k) int32, -1 = not kept."""
    gtab = _bump_table(gvec, m0.shape[-1])
    a = torch.tensor(np.float32(a_dec), device=m0.device)
    vals, pos, ok, _env = PK.fwd_lists(m0, env0f, gtab, a, k)
    kept = PK.bwd_lists(vals, pos, ok, n_frames, env0b, gtab, a)
    return kept.to(torch.int32)


def prune_fwd_bwd(m0: torch.Tensor, n_frames: torch.Tensor,
                  env0f: torch.Tensor, env0b: torch.Tensor,
                  gvec: torch.Tensor, a_dec: float, k: int) -> torch.Tensor:
    """Kernel K1 on a CUDA tensor, its plain version on a CPU tensor.

    m0 (B, T, F) f32 candidate map, n_frames (B,), env0f/env0b (B, F) f32,
    gvec (2F-1,) f32 -> kept (B, T, k) int32."""
    if m0.device.type == "cpu":
        return prune_fwd_bwd_plain(m0, n_frames, env0f, env0b, gvec, a_dec, k)
    if m0.device.type != "cuda":
        raise RuntimeError(f"prune_fwd_bwd: no kernel for device {m0.device}")
    B, T, F = m0.shape
    if not (0 < F <= MAX_BINS and 0 < k <= MAX_K):
        raise ValueError(f"prune_fwd_bwd: needs 0 < F <= {MAX_BINS} and "
                         f"0 < k <= {MAX_K}, got F={F}, k={k}")
    if gvec.shape != (2 * F - 1,) or env0f.shape != (B, F) \
            or env0b.shape != (B, F) or n_frames.shape != (B,):
        raise ValueError("prune_fwd_bwd: inconsistent shapes")
    kept = torch.empty((B, T, k), dtype=torch.int32, device=m0.device)
    if m0.numel() == 0:
        return kept
    from audfprint_torch.ops import _build

    m0c, (e0f, e0b), g, Fp = _kernel_inputs(
        "prune_fwd_bwd", m0, [env0f, env0b], gvec, T, k, lists=True)
    nf = n_frames.to(device=m0.device, dtype=torch.int32).contiguous()
    # the forward lists' global scratch, used when they do not fit in
    # shared memory (csrc/prune.cu)
    lpos = torch.empty((B, T, k), dtype=torch.int32, device=m0.device)
    lval = torch.empty((B, T, k), dtype=torch.float32, device=m0.device)
    lib = _build.load()
    with torch.cuda.device(m0.device):
        err = lib.prune_fwd_bwd(
            m0c.data_ptr(), nf.data_ptr(), e0f.data_ptr(), e0b.data_ptr(),
            g.data_ptr(), lpos.data_ptr(), lval.data_ptr(), kept.data_ptr(),
            B, T, Fp, k, float(a_dec), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "prune_fwd_bwd")
    launches["prune_fwd_bwd"] += 1
    return kept


def prune_fwd_carry_plain(m0: torch.Tensor, env_in: torch.Tensor,
                          gvec: torch.Tensor, a_dec: float, k: int):
    """Plain version of K1f -> (lpos (B, T, k) int32 in extraction order,
    -1 = empty slot; lval (B, T, k) f32, -inf = empty; env_out (B, F))."""
    gtab = _bump_table(gvec, m0.shape[-1])
    a = torch.tensor(np.float32(a_dec), device=m0.device)
    vals, pos, ok, env = PK.fwd_lists(m0, env_in, gtab, a, k)
    return torch.where(ok, pos, -1).to(torch.int32), vals, env


def prune_fwd_carry(m0: torch.Tensor, env_in: torch.Tensor,
                    gvec: torch.Tensor, a_dec: float, k: int):
    """Kernel K1f on a CUDA tensor, its plain version on a CPU tensor: the
    forward prune of a chunk of frames, continuing from the envelope
    env_in and handing back the envelope after its last frame.

    m0 (B, T, F) f32 candidate map, env_in (B, F) f32, gvec (2F-1,) f32 ->
    (lpos (B, T, k) int32, lval (B, T, k) f32, env_out (B, F) f32)."""
    if m0.device.type == "cpu":
        return prune_fwd_carry_plain(m0, env_in, gvec, a_dec, k)
    if m0.device.type != "cuda":
        raise RuntimeError(f"prune_fwd_carry: no kernel for device {m0.device}")
    B, T, F = m0.shape
    if not (0 < F <= MAX_BINS and 0 < k <= MAX_K):
        raise ValueError(f"prune_fwd_carry: needs 0 < F <= {MAX_BINS} and "
                         f"0 < k <= {MAX_K}, got F={F}, k={k}")
    if gvec.shape != (2 * F - 1,) or env_in.shape != (B, F):
        raise ValueError("prune_fwd_carry: inconsistent shapes")
    lpos = torch.empty((B, T, k), dtype=torch.int32, device=m0.device)
    lval = torch.empty((B, T, k), dtype=torch.float32, device=m0.device)
    if B == 0:
        return lpos, lval, torch.empty((B, F), dtype=torch.float32,
                                       device=m0.device)
    from audfprint_torch.ops import _build

    m0c, (e_in,), g, Fp = _kernel_inputs(
        "prune_fwd_carry", m0, [env_in], gvec, T, k, lists=False)
    env_out = torch.empty((B, Fp), dtype=torch.float32, device=m0.device)
    lib = _build.load()
    with torch.cuda.device(m0.device):
        err = lib.prune_fwd_carry(
            m0c.data_ptr(), e_in.data_ptr(), g.data_ptr(), lpos.data_ptr(),
            lval.data_ptr(), env_out.data_ptr(), B, T, Fp, k, float(a_dec),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "prune_fwd_carry")
    launches["prune_fwd_carry"] += 1
    return lpos, lval, env_out[:, :F]


def candidate_map(y: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
    """The prune's candidate map m0: y at local maxima of frames t <
    n_frames, _NEG everywhere else."""
    T = y.shape[1]
    active = (torch.arange(T, device=y.device)[None, :]
              < n_frames.to(y.device)[:, None])
    return torch.where(PK.locmax2(y) & active[:, :, None], y, _NEG)


@functools.lru_cache(maxsize=None)
def gauss_vector_on(cfg: PipelineConfig, device: torch.device) -> torch.Tensor:
    """The bump template on `device`, made once per configuration and
    device: an upload from pageable memory waits for the stream, and a
    CUDA graph cannot capture it.  Callers must not write to it.  Kept
    for the life of the process: a captured graph reads it by address,
    so an evicted template's block, reused, would feed its replays."""
    return torch.as_tensor(PK.gauss_vector(cfg), device=device)


def prune_inputs(sgram: torch.Tensor, n_frames: torch.Tensor,
                 cfg: PipelineConfig):
    """The envelope-independent prologue, vectorised over all frames: the
    HPF (K2), locmax and the length mask into the candidate map m0, and
    both initial envelopes.  Returns (y, m0, env0f, env0b, gvec)."""
    F = sgram.shape[2]
    gvec = gauss_vector_on(cfg, sgram.device)
    gtab = _bump_table(gvec, F)
    y, _ = SP.hpf(sgram, cfg)
    m0 = candidate_map(y, n_frames)
    return (y, m0, PK.head_envelope(y, n_frames, gtab),
            PK.tail_envelope(y, n_frames, gtab), gvec)


def fused_prune(sgram: torch.Tensor, n_frames: torch.Tensor,
                cfg: PipelineConfig) -> torch.Tensor:
    """(B, T, F) pre-HPF whitened sgram -> kept (B, T, k) int32 positions
    the backward pass kept, extraction order, -1 = not kept (before the
    delete-next rule, which the caller applies)."""
    _y, m0, env0f, env0b, gvec = prune_inputs(sgram, n_frames, cfg)
    return prune_fwd_bwd(m0, n_frames, env0f, env0b, gvec, cfg.a_dec,
                         cfg.maxpksperframe)


def _delete_next_compact(kept: torch.Tensor) -> torch.Tensor:
    """The reference's delete-next rule in the compact domain: a kept peak
    at (t, p) kills a kept peak at (t+1, p); kills test the pre-rule frame
    t.  kept (B, T, k) int -> (B, T, k) bool survivors."""
    prev = torch.cat([torch.full_like(kept[:, :1], -1), kept[:, :-1]], dim=1)
    dup = (kept[..., :, None] == prev[..., None, :]).any(dim=-1)
    return (kept >= 0) & ~dup


def find_peaks_slots_fused(sgram_prehpf: torch.Tensor,
                           n_frames: torch.Tensor, cfg: PipelineConfig):
    """Pre-HPF whitened sgram -> per-frame peak slots (bins (B, T, k) int32
    ascending, valid (B, T, k) bool); equal to
    mask_to_slots(find_peaks_mask(hpf(sgram)))."""
    B, T, F = sgram_prehpf.shape
    k = cfg.maxpksperframe
    if T == 0:
        z = torch.zeros((B, 0, k), dtype=torch.int32,
                        device=sgram_prehpf.device)
        return z, z.bool()
    kept = fused_prune(sgram_prehpf, n_frames, cfg)
    surv = _delete_next_compact(kept)
    s = torch.sort(torch.where(surv, kept, F), dim=-1).values
    valid = s < F
    return torch.where(valid, s, 0).to(torch.int32), valid
