"""Captured CUDA graphs, one per shape key: the port's counterpart of the
executable cache of jax.jit.

The JAX package compiles its fused fingerprint + match once per static
shape and replays the executable.  PyTorch runs eagerly, so each query
dispatches its hundreds of ops from Python again.  GraphCache captures a function into a torch.cuda.CUDAGraph on
the first call of a key, as jax.jit compiles on its first call, and
replays the graph on every later call: the input copies, one graph launch
and a clone of the output.

Key: each host input's (shape, dtype) (rows, bucket length, int16 PCM or
float32), which entries of the device state are None (the hpi plane) and
the static arguments (qcap, pcfg, tcfg, mcfg).  A graph reads the device
state it was captured with by address, so the cache holds that state and
drops every graph when a call passes another: no graph replays against a
table that was freed or replaced.

An entry holds the static input buffers, the graph and its static output.
The inputs are staged through pinned host memory and copied without
blocking; the caching host allocator keeps a pinned block until the copy
that reads it has run, so the next call's staging cannot overwrite it.

Two calls may share a key before the caller reads either result (the
Matcher queues every group of a batch before it resolves any), so each
replay is followed by a clone of the static output on the same stream:
the next replay overwrites the static output only after the clone has
read it.

Memory: the graphs of one cache draw on one shared private pool.  They
replay one at a time on one stream, and what one replay leaves for later
lies outside the pool (the static inputs, filled before the replay; the
clone of the output, taken right after it), so a graph may reuse another
graph's intermediates in any replay order.  The pool's bytes and the
static inputs are counted in `held_bytes`, which the Matcher adds to its
memory budget.

No fallback: on a CUDA device a failed capture or replay raises.  A CPU
device, which a caller asks for by name, captures nothing and runs the
function directly.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch


def captures(device: torch.device) -> bool:
    """Whether calls on `device` replay captured graphs: every CUDA device
    does; a CPU device runs the function directly."""
    return device.type == "cuda"


def _warm(fn, device: torch.device) -> None:
    """fn() once on a side stream before a capture (PyTorch's recipe):
    cuFFT plans, the kernel library, cached constants and the allocator
    are set up outside the graph."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)


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


def _staged(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if device.type == "cuda" else t


class _Entry(NamedTuple):
    """One captured key."""
    inputs: tuple         # static input buffers
    graph: object
    out: torch.Tensor     # static output
    launches: dict        # kernel launches one replay makes
    capture_s: float      # wall seconds of the warm-up run and the capture


class GraphCache:
    """Captured graphs of fn(*inputs, *state, *static), one per key.

    inputs: host numpy arrays, copied into the graph's static buffers on
    each call; state: device tensors (or None) the graphs read in place;
    static: hashable arguments that shape the graph.  counters: the
    kernel wrappers' launch-count dicts; a replay adds to them the
    launches its capture queued."""

    def __init__(self, fn, device, counters: tuple = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.counters = counters
        self._entries: dict = {}
        self._state: tuple = ()
        self._pool = None
        self.held_bytes = 0

    @staticmethod
    def key(inputs, state, static) -> tuple:
        return (tuple((a.shape, a.dtype.str) for a in inputs),
                tuple(s is None for s in state), tuple(static))

    def keys(self) -> list:
        """The captured keys, in capture order."""
        return list(self._entries)

    def holds(self, inputs, state, static) -> bool:
        """Whether a call with these arguments replays a captured graph."""
        return self._same_state(state) and \
            self.key(inputs, state, static) in self._entries

    def capture_seconds(self) -> dict:
        return {k: e.capture_s for k, e in self._entries.items()}

    def clear(self) -> None:
        """Drop every graph, its pool and the device state it reads."""
        self._entries = {}
        self._state = ()
        self._pool = None
        self.held_bytes = 0

    def _same_state(self, state) -> bool:
        return len(state) == len(self._state) and all(
            a is b for a, b in zip(state, self._state))

    def __call__(self, inputs, state, static) -> torch.Tensor:
        dev = self.device
        if not captures(dev):
            return self.fn(*(torch.as_tensor(a, device=dev) for a in inputs),
                           *state, *static)
        if not self._same_state(state):
            self.clear()
            self._state = tuple(state)
        key = self.key(inputs, state, static)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._capture(key, inputs, state, static)
        for buf, a in zip(entry.inputs, inputs):
            buf.copy_(_staged(a, dev), non_blocking=True)
        entry.graph.replay()
        self._add_launches(entry.launches)
        return entry.out.clone()

    def _launch_snapshot(self) -> dict:
        return {(i, k): n for i, d in enumerate(self.counters)
                for k, n in d.items()}

    def _add_launches(self, delta: dict) -> None:
        for (i, k), n in delta.items():
            self.counters[i][k] += n

    def _capture(self, key, inputs, state, static) -> _Entry:
        dev = self.device
        t0 = time.perf_counter()
        bufs = []
        for a in inputs:
            host = _staged(a, dev)
            bufs.append(torch.empty_like(host, device=dev))
            bufs[-1].copy_(host, non_blocking=True)
        bufs = tuple(bufs)

        def run():
            return self.fn(*bufs, *state, *static)

        _warm(run, dev)
        # the wrappers count a launch as they queue it; during the capture
        # nothing is launched, so those counts become the graph's own,
        # added back at each replay
        before = self._launch_snapshot()
        graph, out, self._pool, grown = _record(run, dev, self._pool)
        after = self._launch_snapshot()
        launches = {k: n - before.get(k, 0) for k, n in after.items()
                    if n != before.get(k, 0)}
        self._add_launches({k: -n for k, n in launches.items()})
        entry = _Entry(bufs, graph, out, launches, time.perf_counter() - t0)
        self._entries[key] = entry
        self.held_bytes += grown + sum(b.numel() * b.element_size()
                                       for b in bufs)
        return entry
