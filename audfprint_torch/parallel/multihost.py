"""One mesh over several processes (port of
audfprint_tpu/parallel/multihost.py).

Every process runs the same program; `initialize` joins them into one
torch.distributed group, and every mesh made afterwards
(global_table_mesh, sharded.make_mesh) spans all of them: the bucket-
sharded table covers processes x local shards, queries replicate, and the
collectives of parallel/mesh.py cross the process boundary.

The backend is the caller's choice, never a fallback: "nccl" when every
process has a card of its own, "gloo" otherwise (several processes on one
card, or on the CPU), for which the collectives stage their tensors
through the host.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from audfprint_torch.index import device_table as DT
from audfprint_torch.parallel import mesh as M
from audfprint_torch.parallel import sharded


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str = "gloo",
               timeout_s: float = 300.0) -> None:
    """Join this process to the job: `coordinator_address` is host:port of
    process 0.  A collective that waits longer than timeout_s fails
    instead of hanging."""
    import torch.distributed as dist

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the job (the counterpart of initialize)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    world = M.current_world()
    return world.nproc if world else 1


def process_index() -> int:
    world = M.current_world()
    return world.rank if world else 0


def global_table_mesh(devices=None) -> M.Mesh:
    """One flat mesh over every process's local shards (`devices`: this
    process's, one entry per local shard; None = its CUDA devices): the
    bucket-sharded table spans the whole job."""
    return sharded.make_mesh(None, devices)


def process_local_batch_slice(global_batch: int) -> slice:
    """Each process decodes and feeds its own slice of a data-parallel
    batch.  Remainder rows go to the first `global_batch % n` processes,
    so every row belongs to exactly one."""
    n, i = process_count(), process_index()
    per, rem = divmod(global_batch, n)
    start = i * per + min(i, rem)
    return slice(start, start + per + (1 if i < rem else 0))


def allgather_host_batch(local_rows: np.ndarray,
                         global_batch: int | None = None) -> np.ndarray:
    """Assemble the replicated global batch from the processes' local
    slices (process_local_batch_slice): the sharded store and match take
    replicated streams, so this is the only data that crosses processes on
    the input side.  One process: the identity.  Pass `global_batch` when
    the process count does not divide it: the slices are padded to a
    common size for the collective and the padding dropped."""
    local = np.asarray(local_rows)
    n = process_count()
    if n == 1:
        return local
    import torch.distributed as dist

    per, rem = divmod(global_batch if global_batch is not None
                      else len(local) * n, n)
    perc = per + (1 if rem else 0)               # the common slice size
    send = np.zeros((perc,) + local.shape[1:], local.dtype)
    send[: len(local)] = local
    send = torch.from_numpy(send)
    if M.current_world().backend == "nccl":
        send = send.cuda()
    recv = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(recv, send)
    sizes = [per + (1 if j < rem else 0) for j in range(n)]
    return np.concatenate([r.cpu().numpy()[:sizes[j]]
                           for j, r in enumerate(recv)], axis=0)


def empty_sharded_table(mesh: M.Mesh, cfg: DT.TableConfig):
    """The bucket-sharded table of a mesh that spans processes: each
    process allocates its own shards (sharded.empty_sharded_table does so
    for any mesh)."""
    return sharded.empty_sharded_table(mesh, cfg)
