"""Captured CUDA graphs, one per shape key: the port's counterpart of the
executable cache of jax.jit.

The JAX package compiles its functions once per static shape and
replays the executable: the fused fingerprint + match, the two halves of
the two-stage path (`fingerprint_batch_compact_k` and
`match_batch_packed`), the fused ingest and store (with the table
donated), the streamed route's chunk passes and pairing, and
`peaks_batch`.  PyTorch runs eagerly, so each call dispatches its
hundreds of ops from Python again.  GraphCache captures a function into
a torch.cuda.CUDAGraph on the first call of a key, as jax.jit compiles
on its first call, and replays the graph on every later call: the input
copies, one graph launch and a clone of the output.

Key: each input's (shape, dtype) (rows, bucket length, int16 PCM or
float32), which entries of the device state are None (the hpi plane) and
the static arguments.  A graph reads the device state it was captured
with by address, so the cache holds that state and drops every graph
when a call passes another: no graph replays against a table that was
freed or replaced.  A function may write its device state in place (the
device store's table and counts, the counterpart of donate_argnums):
each replay writes it once.

An entry holds the static input buffers, the graph and its static output
(a tensor, a tuple of tensors, or None).  Host numpy inputs are staged
through pinned host memory and copied without blocking; the caching host
allocator keeps a pinned block until the copy that reads it has run, so
the next call's staging cannot overwrite it.  A host tensor input is
copied from as it is: the caller's own pinned staging, which it keeps
until the copy has run (models/ingest's slots).  Device tensor inputs
(the streamed route's chunk rows and carries) are copied device to
device on the stream.

The first call of a key runs the function once eagerly on a side stream
(the warm-up), captures it, and returns the warm-up run's own output: a
capture runs nothing, so a function that writes its state writes it
once on that call too.  Later calls replay.

Two calls may share a key before the caller reads either result (the
Matcher and the Analyzer queue every group of a batch before they
resolve any), so each replay is followed by a clone of every static
output on the same stream: the next replay overwrites them only after
the clones have read them.

Memory: every cache on one device draws on one shared private pool.
The graphs replay one at a time on one stream, and what one replay
leaves for later lies outside the pool (the static inputs, filled
before the replay; the clones of the outputs, taken right after it), so
a graph may reuse any other graph's intermediates in any replay order.
held_bytes(device) counts the pool's growth over its captures and the
static inputs of every cache on the device.  The budget rule: a new key
whose capture would not fit beside what the caches hold clears every
cache on the device, pool included, before it is captured;
`counts["budget_clears"]` counts those clears.  A cache applies it
itself: to one call's new key (the call's `nbytes`, against the
device's budget_bytes), or to a batch of calls queued before any
resolves (admit, which may refuse the batch, and reserve, which never
does), against the caller's budget.

Placement: a cache is made for a device or a parallel/mesh.Mesh, and
decides from it whether its calls replay (`replays`).  A CUDA device
replays.  So does a mesh of logical shards on one device in one process,
captured like one device, its shards' tables and counts (lists of
tensors) being the state: the counterpart of the JAX package's jitted
shard_map functions.  A CPU device, which a caller asks for by name,
runs the function directly on its inputs placed there; a mesh over
several devices or processes runs it directly on the inputs as given,
which its function places itself.  Such a cache holds nothing, so its
budget rule clears nothing; admit budgets the sum of its batch's calls,
whose buffers can be live together.

No fallback: on a CUDA device a failed capture or replay raises.

Tracing (utils/timing): a replay is the span "graph.pin" (every host
array made contiguous and pinned; the counter "graph.h2d_bytes" adds the
bytes of every host input), then "graph.launch" (the copies into the
static inputs queued, the replay, the output clones); a key's warm-up
run and capture add their seconds to the process-wide one-time event
"graph.capture".  The kernel library is loaded (built, in a fresh
checkout) before that clock starts, so the event holds no compiler time.
"""

from __future__ import annotations

import functools
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

from audfprint_torch.ops import _build
from audfprint_torch.ops import pipeline as pipe
from audfprint_torch.utils import timing

# process-wide: keys captured, graph replays, and clears made by the
# budget rule (the CLI's --json-metrics records them); a capture's seconds
# are the one-time event "graph.capture" (utils/timing)
counts = {"captures": 0, "replays": 0, "budget_clears": 0}


def captures(device: torch.device) -> bool:
    """Whether calls on `device` replay captured graphs: every CUDA device
    does; a CPU device runs the function directly."""
    return device.type == "cuda"


def budget_bytes(device: torch.device) -> int:
    """The default device-memory budget of one call and of the graphs:
    a third of the device's memory, between 256 MiB and 8 GiB (4 GiB on
    the CPU)."""
    if device.type != "cuda":
        return 4 << 30
    _free, total = torch.cuda.mem_get_info(device)
    return min(max(1 << 28, total // 3), 8 << 30)


class _Shared:
    """What the caches on one device share: the private pool their graphs
    draw on and the bytes its captures added."""

    def __init__(self):
        self.pool = None
        self.pool_bytes = 0
        self.caches = weakref.WeakSet()

    def live(self) -> bool:
        return any(c.keys() for c in self.caches)


_SHARED: dict = {}


def _shared(device: torch.device) -> _Shared:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _SHARED.setdefault(dev, _Shared())


def held_bytes(device: torch.device) -> int:
    """Bytes the graph caches on `device` hold: their shared pool's growth
    over its captures and every cache's static inputs."""
    sh = _shared(device)
    if not sh.live():
        return 0
    return sh.pool_bytes + sum(c.input_bytes for c in sh.caches)


def clear(device: torch.device) -> None:
    """Drop every graph of every cache on `device`; the pool goes with
    them."""
    for cache in list(_shared(device).caches):
        cache.clear()


def _tensors(out) -> tuple:
    if out is None:
        return ()
    return out if isinstance(out, tuple) else (out,)


def _warm(fn, device: torch.device):
    """fn() once on a side stream before a capture (PyTorch's recipe):
    cuFFT plans, the kernel library, cached constants and the allocator
    are set up outside the graph.  Returns its output, which the key's
    first call hands back, marked as used on the current stream so that
    the allocator does not hand its blocks to the side stream early."""
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(cur)
    return out


def _record(fn, device: torch.device, pool):
    """fn() captured in the default (global) capture mode into a new
    CUDAGraph that draws on `pool` (made when None).  Returns (graph,
    static output, pool, bytes the capture added to the reserved
    memory)."""
    with torch.cuda.device(device):
        # torch.cuda.graph empties the cache before it captures; doing so
        # here first makes the reserved bytes before and after comparable
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
        grown = torch.cuda.memory_reserved() - reserved
    return graph, out, pool, max(0, grown)


def _staged(a, device: torch.device) -> torch.Tensor:
    """An input ready to copy into its static buffer: a tensor as it is
    (a host tensor is the caller's own, pinned, staging: its bytes are
    counted), a host numpy array in pinned memory."""
    if isinstance(a, torch.Tensor):
        if a.device.type == "cpu":
            timing.count("graph.h2d_bytes", a.numel() * a.element_size())
        return a
    timing.count("graph.h2d_bytes", a.nbytes)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


def _clone(out):
    if out is None:
        return None
    if isinstance(out, tuple):
        return tuple(o.clone() for o in out)
    return out.clone()


class _Entry(NamedTuple):
    """One captured key."""
    inputs: tuple         # static input buffers
    graph: object
    out: object           # static output: a tensor or a tuple of them
    launches: dict        # kernel launches one replay makes
    capture_s: float      # wall seconds of the warm-up run and the capture
    pool_bytes: int       # what its capture added to the shared pool
    input_bytes: int      # its static input buffers


class GraphCache:
    """Captured graphs of fn(*inputs, *state, *static), one per key.

    inputs: host numpy arrays or device tensors, copied into the graph's
    static buffers on each call; state: device tensors (or None) the
    graphs read, and may write, in place; static: hashable arguments
    that shape the graph.  place: the torch device or the
    parallel/mesh.Mesh the calls run on (`replays` says whether they
    replay graphs there).  A replay adds the launches its capture queued
    to the kernel wrappers' launch counts (ops/pipeline.launch_counters)."""

    def __init__(self, fn, place):
        self.fn = fn
        # a mesh has `devices`; anything else names a torch device
        self.mesh = place if hasattr(place, "devices") else None
        self.device = (place.devices[0] if self.mesh is not None
                       else torch.device(place))
        self.counters = pipe.launch_counters()
        self._entries: dict = {}
        self._state: tuple = ()
        _shared(self.device).caches.add(self)

    @property
    def replays(self) -> bool:
        """Whether calls replay captured graphs: on a device that captures,
        or on a mesh that can be captured as a whole (Mesh.one_device)
        on such a device.  A mesh over several devices or processes runs
        its function directly."""
        return captures(self.device) and (
            self.mesh is None or self.mesh.one_device is not None)

    @staticmethod
    def key(inputs, state, static) -> tuple:
        return (tuple((tuple(a.shape), str(a.dtype))
                      if isinstance(a, torch.Tensor) else
                      (a.shape, a.dtype.str) for a in inputs),
                tuple(s is None for s in state), tuple(static))

    def keys(self) -> list:
        """The captured keys, in capture order."""
        return list(self._entries)

    def _need(self, calls) -> int:
        """Bytes the captures of a batch of calls need: the estimate of
        each (inputs, state, static, nbytes) call whose key is neither
        captured nor met earlier in `calls`."""
        seen, total = set(), 0
        for inputs, state, static, nbytes in calls:
            key = self.key(inputs, state, static)
            if key in seen or (self._same_state(state)
                               and key in self._entries):
                continue
            seen.add(key)
            total += nbytes
        return total

    def reserve(self, calls, budget: int | None = None) -> None:
        """The budget rule before a batch of (inputs, state, static,
        nbytes) calls: where this cache replays and the captures of their
        new keys would not fit in `budget` (None: budget_bytes of the
        device) beside what the caches on the device hold, every cache
        there is cleared first (counted in counts["budget_clears"])."""
        if not self.replays:
            return
        need = self._need(calls)
        if need <= 0:
            return
        if budget is None:
            budget = budget_bytes(self.device)
        held = held_bytes(self.device)
        if held == 0 or held + need <= budget:
            return
        clear(self.device)
        counts["budget_clears"] += 1

    def admit(self, calls, budget: int) -> bool:
        """Whether a batch of (inputs, state, static, nbytes) calls, queued
        before any resolves, fits `budget`; when it does, after the budget
        rule (reserve).  Where this cache replays, each key's graph keeps
        its buffers in the shared pool, which every call of that key
        reuses: the distinct keys' estimates must fit.  Where it runs
        directly, every call's buffers can be live together: their sum
        must fit."""
        if not self.replays:
            return sum(c[3] for c in calls) <= budget
        if sum({self.key(*c[:3]): c[3] for c in calls}.values()) > budget:
            return False
        self.reserve(calls, budget)
        return True

    @property
    def input_bytes(self) -> int:
        return sum(e.input_bytes for e in self._entries.values())

    @property
    def held_bytes(self) -> int:
        """What this cache's captures added to the shared pool, and its
        static inputs."""
        return sum(e.pool_bytes + e.input_bytes
                   for e in self._entries.values())

    def held_by_key(self) -> dict:
        return {k: e.pool_bytes + e.input_bytes
                for k, e in self._entries.items()}

    def capture_seconds(self) -> dict:
        return {k: e.capture_s for k, e in self._entries.items()}

    def clear(self) -> None:
        """Drop every graph and the device state it reads, once the
        replays already queued have run."""
        if self._entries and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._entries = {}
        self._state = ()

    def _same_state(self, state) -> bool:
        return len(state) == len(self._state) and all(
            a is b for a, b in zip(state, self._state))

    def __call__(self, inputs, state, static, nbytes: int = 0):
        """fn on these arguments: where the cache replays, the graph of
        their key, captured on the key's first call after the budget rule
        (reserve) with `nbytes`, its capture's estimate; elsewhere fn
        itself, on a device with the inputs placed there, on a mesh with
        the inputs as given."""
        dev = self.device
        if not self.replays:
            if self.mesh is None:
                inputs = [torch.as_tensor(a, device=dev) for a in inputs]
            return self.fn(*inputs, *state, *static)
        if nbytes:
            self.reserve([(inputs, state, static, nbytes)])
        if not self._same_state(state):
            self.clear()
            self._state = tuple(state)
        key = self.key(inputs, state, static)
        entry = self._entries.get(key)
        if entry is None:
            return self._capture(key, inputs, state, static)
        with timing.span("graph.pin"):
            srcs = [_staged(a, dev) for a in inputs]
        with timing.span("graph.launch"):
            for buf, src in zip(entry.inputs, srcs):
                buf.copy_(src, non_blocking=True)
            entry.graph.replay()
            counts["replays"] += 1
            self._add_launches(entry.launches)
            return _clone(entry.out)

    def _launch_snapshot(self) -> dict:
        return {(i, k): n for i, d in enumerate(self.counters)
                for k, n in d.items()}

    def _add_launches(self, delta: dict) -> None:
        for (i, k), n in delta.items():
            self.counters[i][k] += n

    def _capture(self, key, inputs, state, static):
        """Warm-up run, capture and a new entry for `key`; returns the
        warm-up run's output."""
        dev = self.device
        sh = _shared(dev)
        if not sh.live():
            # no graph is left in the pool: start a new one
            sh.pool, sh.pool_bytes = None, 0
        if dev.type == "cuda":
            _build.load()
        t0 = time.perf_counter()
        bufs = []
        for a in inputs:
            src = _staged(a, dev)
            bufs.append(torch.empty_like(src, device=dev))
            bufs[-1].copy_(src, non_blocking=True)
        bufs = tuple(bufs)

        run = functools.partial(self.fn, *bufs, *state, *static)
        out = _warm(run, dev)
        # the wrappers count a launch as they queue it; during the capture
        # nothing is launched, so those counts become the graph's own,
        # added back at each replay
        before = self._launch_snapshot()
        graph, static_out, sh.pool, grown = _record(run, dev, sh.pool)
        after = self._launch_snapshot()
        launches = {k: n - before.get(k, 0) for k, n in after.items()
                    if n != before.get(k, 0)}
        self._add_launches({k: -n for k, n in launches.items()})
        capture_s = time.perf_counter() - t0
        timing.event("graph.capture", capture_s)
        self._entries[key] = _Entry(
            bufs, graph, static_out, launches, capture_s,
            grown, sum(b.numel() * b.element_size() for b in bufs))
        sh.pool_bytes += grown
        counts["captures"] += 1
        return out
