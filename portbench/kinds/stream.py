"""The stream kind: long recordings stored through new --device-store's
streamed route, in the CLI's own order (cli._run_pipelined): for a chunk
of file names, cli._decode_chunk classifies each file past --stream-above
as "stream", cli._stream_chunk analyses it chunk by chunk
(Analyzer.wavfile2hashes_streaming), then DeviceIngest.dispatch_chunk
stores its host hashes; consume_chunk runs one chunk of files behind.
Each pass of the pool goes into the emptied table.  The route reads files,
so set-up writes the recordings, made on the card from the seed, as 16-bit
WAVs into the run's temporary directory and flushes them to disk before
the window opens (the page cache holds them: disk speed is not measured).

Its mix names `files`, `batch` (files a chunk) and, for the traced span,
`traced_chunks`; the configuration's corpus gives a recording's length
(`track_s`), and its `stream` the route's `above_s` and `chunk_frames`.
The program's outputs, as judge() takes them:
  table    the table of the window's last pass, as reference.table.Table
  n_table  the files that table holds (the first n_table of the mix's)
  stored   (n, 2) int64 [file index, hashes] for every file consumed
"""

from __future__ import annotations

import os
import time
import wave
from types import SimpleNamespace

import numpy as np
import torch

from portbench import corpus, roofline_k1f, trace
from portbench.drive import (Cell, analyzer, empty_table, ingest_chunks,
                             make_tracks, port_table)
from portbench.judge import floor, table_readings
from portbench.reference import long as RL
from portbench.reference import table as RT


def write_wavs(tracks: np.ndarray, folder: str) -> list:
    names = []
    for i, x in enumerate(tracks):
        path = os.path.join(folder, f"rec{i}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(corpus.SR)
            w.writeframes(np.ascontiguousarray(x, "<i2").tobytes())
        # written back now, in set-up: the window reads the page cache and
        # shares no CPU or disk with the writeback of 1.27 GB
        with open(path, "rb") as f:
            os.fsync(f.fileno())
        names.append(path)
    return names


class _Streamed:
    """DeviceIngest behind the CLI's decode and stream stages: a chunk of
    file names in, the store's handle out."""

    def __init__(self, di, an):
        self.di, self.an = di, an
        self.args = SimpleNamespace(ncores=None)

    def dispatch_chunk(self, names: list, report):
        from audfprint_torch import cli
        ordered = cli._decode_chunk(self.an, self.args, report, names)
        if any(kind != "stream" for _n, kind, _d in ordered):
            raise RuntimeError("a recording did not take the streamed route")
        ordered = cli._stream_chunk(self.an, report, ordered)
        return self.di.dispatch_chunk(ordered, report)

    def consume_chunk(self, handle) -> list:
        return self.di.consume_chunk(handle)


def drive(cell: Cell) -> dict:
    from audfprint_torch.models.ingest import DeviceIngest
    from audfprint_torch.utils import graphs

    mix, cfg, spans = cell.mix, cell.cfg, cell.spans
    tracks = make_tracks(cell, int(mix["files"]))
    names = write_wavs(tracks, cell.tmp)
    an = analyzer(cfg["db_analyzer"], cell.device)
    an.stream_above_sec = float(cfg["stream"]["above_s"])
    an.stream_chunk_frames = int(cfg["stream"]["chunk_frames"])
    ht = empty_table(cfg)
    di = DeviceIngest(ht, an, ndev=1)
    st = _Streamed(di, an)
    size = int(mix["batch"])
    chunks = [names[i: i + size] for i in range(0, len(names), size)]

    def reset():
        di.table.zero_()
        di.counts.zero_()

    spans.on = False
    ingest_chunks(st, chunks, reset=reset)           # every key, warm
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
    ingest_chunks(st, chunks, on_consumed=consumed,
                  deadline=t0 + cell.seconds, spans=spans, reset=reset)
    window = time.perf_counter() - t0
    n_table = min(len(names), (done["last"] % len(chunks) + 1) * size)
    rec = {"window_s": window, "audio_s": done["audio_s"],
           "graph_captures": graphs.counts["captures"] - cap0}
    snap = port_table(di.table, di.counts, np.zeros(n_table), cfg)
    if cell.traced:
        spans.on = False
        nc = int(mix.get("traced_chunks", 1))
        rec["trace"] = trace.profile(
            lambda: ingest_chunks(st, chunks[:nc], spans=spans, reset=reset),
            spans, cell.tmp)
        rec["k1f_bytes"] = sum(len(c) for c in chunks[:nc]) * \
            roofline_k1f.file_bytes(tracks.shape[1], an.config,
                                    an.stream_chunk_frames)
    state = [ht, di, an, st]
    del ht, di, an, st
    rec.update(attempted=len(stored), failed=0,
               outputs=lambda: {"table": snap, "n_table": n_table,
                                "stored": np.array(stored, np.int64)},
               release=state.clear, inputs={"cfg": cfg, "tracks": tracks})
    return rec


def _table(keys: list, cfg: dict) -> RT.Table:
    t = cfg["table"]
    return RT.build(keys, hashbits=t["hashbits"], depth=t["depth"],
                    maxtimebits=t["maxtimebits"])


def judge(out: dict, inp: dict, device, dtype=torch.float32) -> dict:
    cfg = inp["cfg"]
    n = out["n_table"]
    keys = RL.keys_of(list(inp["tracks"]), cfg["db_analyzer"], device, dtype)
    readings = table_readings(out["table"], _table(keys[:n], cfg), n)
    nref = np.array([len(k) for k in keys], dtype=np.int64)
    st = out["stored"]
    readings["track_hashes_gap"] = float(
        np.max(np.abs(st[:, 1] - nref[st[:, 0]]) / floor(nref[st[:, 0]]))
    ) if len(st) else 0.0
    return readings


def control(cell: Cell, dtype) -> tuple[dict, dict]:
    """(outputs, inputs) of the reference computed in `dtype` in the
    program's place: every recording stored once."""
    cfg = cell.cfg
    tracks = make_tracks(cell, int(cell.mix["files"]))
    keys = RL.keys_of(list(tracks), cfg["db_analyzer"], cell.device, dtype)
    stored = np.array([[i, len(k)] for i, k in enumerate(keys)], np.int64)
    return ({"table": _table(keys, cfg), "n_table": len(keys),
             "stored": stored}, {"cfg": cfg, "tracks": tracks})
