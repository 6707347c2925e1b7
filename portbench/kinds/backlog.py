"""The backlog kind: batches of queries through
Matcher.match_samples_fused_async and match_fused_resolve, one batch in
flight while the one before resolves (cli.do_match under --batchsize).

Its mix names `batch`, `query_s`, `pool_batches` and, for the traced span,
`traced_batches`.  The program's outputs, as judge() takes them:
  table    the table the window read, as reference.table.Table
  answers  (n, 6) int64 [pool index, id, filtered, mode dt, raw, hashes]
           for every query resolved in the window (id -1: no match)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import corpus, trace
from portbench.drive import (Cell, analyzer, build_table, k1_bytes_of,
                             make_tracks, port_table)
from portbench.judge import (answer_readings, reference_rows,
                             reference_tables, table_readings)


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


def drive(cell: Cell) -> dict:
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


def judge(out: dict, inp: dict, device, dtype=torch.float32) -> dict:
    cfg = inp["cfg"]
    n = len(inp["tracks"])
    _keys, tb = reference_tables(inp["tracks"], n, cfg, device, dtype)
    readings = table_readings(out["table"], tb, n)
    rows, nq = reference_rows(tb, inp["clips"], cfg, device, dtype)
    readings.update(answer_readings(out["answers"], rows, nq))
    return readings


def control(cell: Cell, dtype) -> tuple[dict, dict]:
    """(outputs, inputs) of the reference computed in `dtype` in the
    program's place: every pool query answered once, over the whole
    collection's table."""
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    n = int(cfg["corpus"]["tracks"])
    tracks = make_tracks(cell, n)
    _keys, tb = reference_tables(tracks, n, cfg, dev, dtype)
    pool = int(mix["batch"]) * int(mix["pool_batches"])
    clips = queries(cell, tracks, pool)
    rows, nq = reference_rows(tb, clips, cfg, dev, dtype)
    answers = np.concatenate([np.arange(pool)[:, None], rows, nq[:, None]],
                             axis=1)
    return ({"table": tb, "answers": answers},
            {"cfg": cfg, "tracks": tracks, "clips": clips})
