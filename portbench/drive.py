"""What the drivers of every kind of traffic share: the cell a driver is
handed, the inputs made from the seed, the program's store driven chunk
by chunk, and the table it leaves, as the reference reads it.

Each kind of traffic is one module, portbench/kinds/<kind>.py, which a
mix (portbench/mixes/<traffic>.json) names by its "kind" and which
portbench.run.kind() loads.  Such a module has
  drive(cell) -> rec   make the inputs from the seed, build the table
                       through the program, warm what the window will run,
                       measure for `cell.seconds`, and return the window's
                       record: the counts and spans the metric readers
                       take, `outputs()` (the program's outputs for the
                       comparison), `inputs`, and `release()`, which frees
                       the program's state before the reference runs;
  judge(outputs, inputs, device) -> readings
                       the numbers compared with the cell's limits, from
                       the reference (judge.py's shared comparisons);
  control(cell, dtype) -> (outputs, inputs)
                       the reference computed in `dtype` in the program's
                       place (portbench/control.py).
A new kind is a new file there and data files beside it; no file of the
harness names a kind.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import corpus


class Cell:
    """What a driver is handed: the run's arguments and files."""

    def __init__(self, cfg, mix, seed, seconds, traced, device, tmp, spans):
        self.cfg, self.mix = cfg, mix
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device, self.tmp, self.spans = device, tmp, spans
        self.t_open = None

    def open_window(self) -> float:
        """Mark the window's start (the end of set-up); returns its
        perf_counter time."""
        sync(self.device)
        self.t_open = time.time()
        return time.perf_counter()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def analyzer(preset: dict, device):
    from audfprint_torch.models.analyzer import Analyzer
    return Analyzer(density=float(preset["density"]),
                    shifts=int(preset["shifts"]),
                    maxpairsperpeak=int(preset["fanout"]), device=device)


def empty_table(cfg: dict):
    from audfprint_torch.index.hash_table import HashTable
    t = cfg["table"]
    return HashTable(hashbits=t["hashbits"], depth=t["depth"],
                     maxtime=1 << t["maxtimebits"])


def make_tracks(cell: Cell, n: int) -> np.ndarray:
    c = cell.cfg["corpus"]
    gen = corpus.generator(cell.seed, cell.device)
    x = corpus.tracks(n, float(c["track_s"]), gen, cell.device)
    host = x.cpu().numpy()
    del x
    return host


def ingest_chunks(di, chunks: list, on_consumed=None, deadline=None,
                  spans=None, reset=None) -> tuple[int, int]:
    """Dispatch chunk i, then consume chunk i-1 (cli._run_pipelined's
    order), cycling over `chunks` until `deadline` (once through without
    one).  Returns (chunks dispatched, index of the last)."""
    def span(name):
        return spans(name) if spans is not None else _null()

    inflight, i = None, 0
    while True:
        if deadline is None and i == len(chunks):
            break
        if deadline is not None and time.perf_counter() >= deadline:
            break
        c = i % len(chunks)
        if c == 0 and reset is not None:
            with span("table_reset"):
                reset()
        with span("ingest_dispatch"):
            h = di.dispatch_chunk(chunks[c], _no_report)
        if inflight is not None:
            with span("ingest_consume_wait"):
                rows = di.consume_chunk(inflight[1])
            if on_consumed:
                on_consumed(inflight[0], rows)
        inflight = (i, h)
        i += 1
    if inflight is not None:
        with span("ingest_consume_wait"):
            rows = di.consume_chunk(inflight[1])
        if on_consumed:
            on_consumed(inflight[0], rows)
    return i, i - 1


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _no_report(msg: str) -> None:
    raise RuntimeError(f"ingest reported: {msg}")


def chunked(names_tracks: list, size: int) -> list:
    return [[(n, "wav", x) for n, x in names_tracks[i: i + size]]
            for i in range(0, len(names_tracks), size)]


def build_table(cell: Cell, tracks: np.ndarray):
    """The cell's table through the program's device store: the host
    table holding the result as `new --device-store` leaves it."""
    from audfprint_torch.models.ingest import DeviceIngest
    an = analyzer(cell.cfg["db_analyzer"], cell.device)
    ht = empty_table(cell.cfg)
    di = DeviceIngest(ht, an, ndev=1)
    ingest_chunks(di, chunked([(f"track{i}", x) for i, x in
                               enumerate(tracks)], 256))
    di.finalize()
    return ht


def port_table(table, counts, hashes_per_id, cfg):
    from portbench.reference import table as RT
    return RT.from_dense(table, counts, np.asarray(hashes_per_id),
                         cfg["table"]["maxtimebits"])


def k1_bytes_of(batch: list, pcfg) -> float:
    """The least bytes of K1's work on a batch: each valid frame of each
    row (every shift a row) read once, its envelopes and template read,
    its kept peaks written (portbench/roofline.py)."""
    from portbench import roofline
    frames = []
    for x in batch:
        for s in range(pcfg.shifts):
            n = len(x) - s * pcfg.n_hop // pcfg.shifts
            frames.append(max(0, 1 + (n - pcfg.n_fft) // pcfg.n_hop))
    return roofline.k1_bytes(frames, pcfg.n_bins, pcfg.maxpksperframe)
