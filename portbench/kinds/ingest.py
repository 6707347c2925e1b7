"""The ingest kind: chunks of tracks through DeviceIngest.dispatch_chunk
and consume_chunk, one chunk ahead (cli._run_pipelined under
new --device-store), each pass into the emptied table.

Its mix names `tracks`, `chunk` and, for the traced span, `traced_chunks`.
The program's outputs, as judge() takes them:
  table    the table of the window's last pass, as reference.table.Table
  n_table  the tracks that table holds (the first n_table of the mix's)
  stored   (n, 2) int64 [track index, hashes] for every track ingested
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import trace
from portbench.drive import (Cell, analyzer, chunked, empty_table,
                             ingest_chunks, k1_bytes_of, make_tracks,
                             port_table)
from portbench.judge import floor, reference_tables, table_readings


def drive(cell: Cell) -> dict:
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


def judge(out: dict, inp: dict, device, dtype=torch.float32) -> dict:
    cfg = inp["cfg"]
    keys, tb = reference_tables(inp["tracks"], out["n_table"], cfg, device,
                                dtype)
    readings = table_readings(out["table"], tb, out["n_table"])
    nref = np.array([len(k) for k in keys], dtype=np.int64)
    st = out["stored"]
    readings["track_hashes_gap"] = float(
        np.max(np.abs(st[:, 1] - nref[st[:, 0]]) / floor(nref[st[:, 0]]))
    ) if len(st) else 0.0
    return readings


def control(cell: Cell, dtype) -> tuple[dict, dict]:
    """(outputs, inputs) of the reference computed in `dtype` in the
    program's place: the whole collection stored once."""
    cfg = cell.cfg
    n = int(cell.mix["tracks"])
    tracks = make_tracks(cell, n)
    keys, tb = reference_tables(tracks, n, cfg, cell.device, dtype)
    stored = np.array([[i, len(k)] for i, k in enumerate(keys)], np.int64)
    return ({"table": tb, "n_table": n, "stored": stored},
            {"cfg": cfg, "tracks": tracks})
