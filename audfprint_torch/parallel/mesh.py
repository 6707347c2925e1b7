"""A mesh of table shards and the four collectives the sharded paths use.

The JAX package is one controller over N devices (a `Mesh` and
`shard_map`), and across hosts the same program in several processes over
one global mesh.  This port keeps that shape.  A mesh is (processes) x
(local shards per process); a sharded array is, in each process, a Python
list of its local shards' tensors, each on its shard's device.  A device
may appear more than once in a mesh: that is a logical shard, the
counterpart of XLA's forced host devices, and it is how one card or the
CPU runs a real N-shard mesh.  Global shard g = rank * n_local + l.

The collectives work on such lists (one entry per local shard, in shard
order) and return lists:

  all_to_all(xs, split_axis, concat_axis)   tiled: shard d receives piece d
      of every shard's split, concatenated source-major
  all_gather(xs, axis)                      tiled, the result on every shard
  all_reduce(xs, "sum" | "min")             the result on every shard

With one process they are slices, copies and torch.cat (`.to()` between
devices).  With several, the part that crosses processes goes through
torch.distributed (all_to_all_single, all_gather, all_reduce) on the
backend the caller initialised: "nccl" moves device tensors, "gloo" is
given host copies (bool as uint8), staged here explicitly.

`spmd` runs a per-shard body that calls its collectives from inside (the
histogram vote's combiners): one thread per local shard, meeting at each
collective.  Each thread launches on the stream that is current for its
device in the calling thread, so a CUDA graph captured around `spmd`
records every shard's work (torch's current stream is per thread: a
thread left on its default stream would launch outside the capture,
which the global capture mode refuses).

With one process and every shard on one device, the collectives are
slices, same-device `.to()` and torch.cat, and nothing in them reads
back to the host: a mesh of logical shards of one card can be captured
as a whole (one_device; utils/graphs.GraphCache.replays).  Across devices or
processes it runs eagerly: a capture lives on one device's streams, and
gloo stages its collectives through the host.
"""

from __future__ import annotations

import contextlib
import threading

import torch

class World:
    """The processes of one job (torch.distributed's default group):
    their count, this one's rank, and the backend."""

    def __init__(self, nproc: int, rank: int, backend: str):
        self.nproc, self.rank, self.backend = nproc, rank, backend


def current_world() -> World | None:
    """The job this process has joined (parallel.multihost.initialize),
    which every new mesh spans; None = this process alone."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return World(dist.get_world_size(), dist.get_rank(),
                 str(dist.get_backend()))


def local_devices() -> list:
    """This process's CUDA devices (the port's entry points run on the
    card; a caller that wants the CPU passes its devices)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device: pass devices=['cpu', ...] to run shards on "
            "the CPU")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """`devices`: one device per local shard (repeats allowed); `world`:
    the process group it spans (None = one process)."""

    def __init__(self, devices, world: World | None = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.world = world
        self.nproc = world.nproc if world else 1
        self.rank = world.rank if world else 0
        self.n_local = len(self.devices)
        self.size = self.nproc * self.n_local
        self.first = self.rank * self.n_local     # global index of shard 0

    def __repr__(self):
        return (f"Mesh({self.nproc} x {[str(d) for d in self.devices]}, "
                f"rank {self.rank})")

    @property
    def one_device(self):
        """The device every shard sits on, where this is one process whose
        local shards all share one device, else None.  Only such a mesh
        can be captured as a whole: a capture records one device's
        streams, and a mesh that spans processes stages its collectives
        through torch.distributed (gloo through the host)."""
        if self.nproc == 1 and len(set(self.devices)) == 1:
            return self.devices[0]
        return None

    # -- placement ----------------------------------------------------------

    def replicate(self, x) -> list:
        """One copy of x per local shard; shards on one device share it."""
        x = torch.as_tensor(x)
        by_dev = {}
        for d in self.devices:
            if d not in by_dev:
                by_dev[d] = x.to(d)
        return [by_dev[d] for d in self.devices]

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor this mesh's backend is given: a host copy for gloo,
        one on the first local device for nccl; bool as uint8."""
        t = t.cpu() if self.world.backend == "gloo" else t.to(self.devices[0])
        return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()

    # -- collectives on lists of local shards -------------------------------

    def all_to_all(self, xs: list, split_axis: int, concat_axis: int) -> list:
        n, L = self.size, self.n_local
        if xs[0].shape[split_axis] % n:
            raise ValueError(f"axis {split_axis} of {tuple(xs[0].shape)} "
                             f"does not split over {n} shards")
        pieces = [x.chunk(n, dim=split_axis) for x in xs]     # [source][dest]
        if self.nproc == 1:
            return [torch.cat([pieces[s][d].to(dev) for s in range(n)],
                              dim=concat_axis)
                    for d, dev in enumerate(self.devices)]
        import torch.distributed as dist
        send = self._stage(torch.stack([
            torch.stack([torch.stack([self._stage(pieces[s][p * L + m])
                                      for m in range(L)]) for s in range(L)])
            for p in range(self.nproc)]))           # [process, source, dest]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        # recv[q, s, m]: from process q's local source s for local dest m;
        # (q, s) ascending is the global source order
        return [torch.cat([recv[q, s, m] for q in range(self.nproc)
                           for s in range(L)], dim=concat_axis)
                .to(device=dev, dtype=xs[0].dtype)
                for m, dev in enumerate(self.devices)]

    def all_gather(self, xs: list, axis: int) -> list:
        if self.size == 1:
            return [xs[0]]
        if self.nproc == 1:
            return self.replicate(torch.cat(
                [x.to(self.devices[0]) for x in xs], dim=axis))
        import torch.distributed as dist
        send = torch.stack([self._stage(x) for x in xs])
        recv = [torch.empty_like(send) for _ in range(self.nproc)]
        dist.all_gather(recv, send)
        return self.replicate(torch.cat(
            [x for r in recv for x in r.unbind(0)], dim=axis)
            .to(xs[0].dtype))

    def all_reduce(self, xs: list, op: str) -> list:
        if op not in ("sum", "min"):
            raise ValueError(f"unknown reduction {op!r}")
        if self.size == 1:
            return [xs[0]]
        stack = torch.stack([x.to(self.devices[0]) for x in xs])
        local = stack.sum(dim=0, dtype=xs[0].dtype) if op == "sum" \
            else stack.amin(dim=0)
        del stack
        if self.nproc > 1:
            import torch.distributed as dist
            local = self._stage(local)
            dist.all_reduce(local, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MIN)
        return self.replicate(local)

    # -- per-shard bodies that call their collectives from inside -----------

    def spmd(self, body, *shard_args) -> list:
        """body(cx, *[a[l] for a in shard_args]) for every local shard l,
        one thread each (inline for a single shard); `cx` is that shard's
        ShardContext, whose collectives meet the other shards'.  Returns
        the bodies' results in shard order; the first failure is raised.

        A shard's thread runs under the caller's current stream of its
        device, so under a capture every shard's launches and blocks join
        the graph (the caching allocator files a block by its stream's
        capture).  Between two meetings the threads' launches interleave
        in any order on that stream; the shards' work there is
        independent, and the stream orders each block's reuse."""
        meet = _Meeting(self)
        ctxs = [ShardContext(self, meet, l) for l in range(self.n_local)]
        if self.n_local == 1:
            return [body(ctxs[0], *[a[0] for a in shard_args])]
        results = [None] * self.n_local
        errors = [None] * self.n_local
        streams = {d: torch.cuda.current_stream(d)
                   for d in set(self.devices) if d.type == "cuda"}

        def run(l):
            s = streams.get(self.devices[l])
            try:
                with (torch.cuda.stream(s) if s is not None
                      else contextlib.nullcontext()):
                    results[l] = body(ctxs[l], *[a[l] for a in shard_args])
            except BaseException as e:   # the others must not wait for us
                errors[l] = e
                meet.barrier.abort()

        threads = [threading.Thread(target=run, args=(l,), daemon=True)
                   for l in range(self.n_local)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            raise next((e for e in failed if not isinstance(
                e, threading.BrokenBarrierError)), failed[0])
        return results


class _Meeting:
    """Where the local shards' threads meet for a collective: each leaves
    its tensor, one of them runs the list collective, all pick up theirs."""

    TIMEOUT_S = 600.0

    def __init__(self, mesh: Mesh):
        self.barrier = threading.Barrier(mesh.n_local, timeout=self.TIMEOUT_S)
        self.slots = [None] * mesh.n_local
        self.out = None

    def run(self, l: int, x, fn):
        if len(self.slots) == 1:
            return fn([x])[0]
        self.slots[l] = x
        if self.barrier.wait() == 0:
            try:
                self.out = fn(list(self.slots))
            except BaseException:
                self.barrier.abort()
                raise
        # nobody overwrites `out` before every shard has passed the next
        # collective's first wait, by when all have read it
        self.barrier.wait()
        return self.out[l]


class ShardContext:
    """One local shard's view of its mesh inside `Mesh.spmd`: its index and
    device, and collectives on its own tensor."""

    def __init__(self, mesh: Mesh, meet: _Meeting, l: int):
        self.mesh, self._meet, self.local = mesh, meet, l
        self.index = mesh.first + l               # global shard index
        self.device = mesh.devices[l]

    def sum_all(self, x):
        return self._meet.run(self.local, x,
                              lambda xs: self.mesh.all_reduce(xs, "sum"))

    def min_all(self, x):
        return self._meet.run(self.local, x,
                              lambda xs: self.mesh.all_reduce(xs, "min"))

    def gather_all(self, x, axis: int = 1):
        return self._meet.run(self.local, x,
                              lambda xs: self.mesh.all_gather(xs, axis))
