"""The general load generator: one driver per kind of traffic, each set by
the parameters of a mix file (portbench/mixes/<traffic>.json) and the
configuration (portbench/configs/<config>.json).

  backlog  batches of queries through Matcher.match_samples_fused_async and
           match_fused_resolve, one batch in flight while the one before
           resolves (cli.do_match under --batchsize)
  ingest   chunks of tracks through DeviceIngest.dispatch_chunk and
           consume_chunk, one chunk ahead (cli._run_pipelined under
           new --device-store), each pass into the emptied table

Every driver makes its inputs from the seed, builds the table through the
program, warms what its window will run, measures for `seconds`, and
returns the window's record: the counts and spans the metric readers
take, the program's outputs for the comparison (judge.py), and a way to
free the program's state before the reference runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import corpus, trace


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


# ---------------------------------------------------------------- backlog

def queries(cell: Cell, tracks: np.ndarray, n: int) -> list:
    """n excerpts of the mix's length; where the configuration lists
    query conditions, each condition on an equal share of them, in an
    order drawn from the seed, so every seed has the same set of sizes."""
    rng = np.random.default_rng(cell.seed)
    clips, _ids, _starts = corpus.excerpts(tracks, n,
                                           float(cell.mix["query_s"]), rng)
    conds = cell.cfg.get("query_conditions")
    if conds:
        kinds = [conds[i % len(conds)] for i in range(n)]
        kinds = [kinds[j] for j in rng.permutation(n)]
        clips = [corpus.degrade(c, rng, **kw) for c, kw in zip(clips, kinds)]
    return clips


def backlog(cell: Cell) -> dict:
    from audfprint_torch.match.matcher import Matcher
    from audfprint_torch.utils import graphs

    mix, dev, spans = cell.mix, cell.device, cell.spans
    n_tracks = int(cell.cfg["corpus"]["tracks"])
    tracks = make_tracks(cell, n_tracks)
    ht = build_table(cell, tracks)
    B = int(mix["batch"])
    clips = queries(cell, tracks, B * int(mix["pool_batches"]))
    batches = [clips[i: i + B] for i in range(0, len(clips), B)]
    an = analyzer(cell.cfg["query_analyzer"], dev)
    matcher = Matcher(ndev=1, verbose=0, device=dev)
    got: list = []

    def loop(n_batches=None, deadline=None, keep=False):
        inflight, i = None, 0
        while True:
            if n_batches is not None and i == n_batches:
                break
            if deadline is not None and time.perf_counter() >= deadline:
                break
            b = i % len(batches)
            with spans("match_dispatch"):
                h = matcher.match_samples_fused_async(an, ht, batches[b])
            if h is None:
                raise RuntimeError("the fused path refused a batch")
            if inflight is not None:
                resolve(*inflight, keep)
            inflight = (b, h)
            i += 1
        if inflight is not None:
            resolve(*inflight, keep)

    def resolve(b, h, keep):
        with spans("match_resolve_wait"):
            res, nh = matcher.match_fused_resolve(an, ht, h)
        if keep:
            for j, (r, n) in enumerate(zip(res, nh)):
                top = (r[0, :4].tolist() if r is not None and len(r)
                       else [-1, -1, -1, -1])
                got.append([b * B + j] + top + [int(n)])

    spans.on = False
    loop(n_batches=2 * len(batches))                 # every key, warm
    spans.on = True
    cap0 = graphs.counts["captures"]
    t0 = cell.open_window()
    loop(deadline=t0 + cell.seconds, keep=True)
    window = time.perf_counter() - t0
    rec = {"window_s": window, "queries": len(got),
           "graph_captures": graphs.counts["captures"] - cap0,
           "batch_rows": B}
    if cell.traced:
        spans.on = False
        nb = int(mix.get("traced_batches", 16))
        rec["trace"] = trace.profile(lambda: loop(n_batches=nb), spans,
                                     cell.tmp)
        rec["k1_bytes"] = nb * k1_bytes_of(batches[0], an.config)
    answers = np.array(got, dtype=np.int64).reshape(-1, 6)
    state = {"ht": ht, "matcher": matcher, "an": an}

    def outputs():
        table, counts = matcher._device_state(ht)[:2]
        return {"table": port_table(table, counts, ht.hashesperid, cell.cfg),
                "answers": answers}

    rec.update(attempted=len(got), failed=0, outputs=outputs,
               release=state.clear,
               inputs={"cfg": cell.cfg, "tracks": tracks, "clips": clips})
    return rec


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


# ----------------------------------------------------------------- ingest

def ingest(cell: Cell) -> dict:
    from audfprint_torch.models.ingest import DeviceIngest
    from audfprint_torch.utils import graphs

    mix, dev, spans = cell.mix, cell.device, cell.spans
    n = int(mix["tracks"])
    tracks = make_tracks(cell, n)
    an = analyzer(cell.cfg["db_analyzer"], dev)
    ht = empty_table(cell.cfg)
    di = DeviceIngest(ht, an, ndev=1)
    chunks = chunked([(f"track{i}", x) for i, x in enumerate(tracks)],
                     int(mix["chunk"]))
    size = int(mix["chunk"])

    def reset():
        di.table.zero_()
        di.counts.zero_()

    spans.on = False
    ingest_chunks(di, chunks, reset=reset)           # the key, warm
    spans.on = True
    stored: list = []
    done = {"audio_s": 0.0, "last": 0}

    def consumed(i, rows):
        c = i % len(chunks)
        for j, (_name, nh, d) in enumerate(rows):
            stored.append([c * size + j, int(nh)])
            done["audio_s"] += d
        done["last"] = i

    cap0 = graphs.counts["captures"]
    t0 = cell.open_window()
    ingest_chunks(di, chunks, on_consumed=consumed,
                  deadline=t0 + cell.seconds, spans=spans, reset=reset)
    window = time.perf_counter() - t0
    last = done["last"] % len(chunks)
    n_table = min(n, (last + 1) * size)
    rec = {"window_s": window, "audio_s": done["audio_s"],
           "graph_captures": graphs.counts["captures"] - cap0}
    snap = port_table(di.table, di.counts, np.zeros(n_table), cell.cfg)
    if cell.traced:
        spans.on = False
        nc = int(mix.get("traced_chunks", 8))
        rec["trace"] = trace.profile(
            lambda: ingest_chunks(di, chunks[:nc], spans=spans, reset=reset),
            spans, cell.tmp)
        rec["k1_bytes"] = sum(k1_bytes_of([x for _n, _k, x in c], an.config)
                              for c in chunks[:nc])
    state = [ht, di, an]
    del ht, di, an
    rec.update(attempted=len(stored), failed=0,
               outputs=lambda: {"table": snap, "n_table": n_table,
                                "stored": np.array(stored, np.int64)},
               release=state.clear, inputs={"cfg": cell.cfg,
                                            "tracks": tracks})
    return rec


DRIVERS = {"backlog": backlog, "ingest": ingest}
