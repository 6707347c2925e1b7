"""The comparisons that decide `correct`, shared by the kinds' judges
(portbench/kinds/<kind>.py): what the timed path produced against the
plain reference (portbench/reference), which works the fingerprints, the
table and the votes out again from the same inputs.  Each reading has a
limit in portbench/limits/<cell>.json.  The program's outputs come in as
plain data, a table as reference.table.Table.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import analyze as RA
from portbench.reference import table as RT


def _table_cfg(cfg: dict) -> dict:
    t = cfg["table"]
    return {"hashbits": t["hashbits"], "depth": t["depth"],
            "maxtimebits": t["maxtimebits"]}


def reference_tables(tracks: np.ndarray, n_table: int, cfg: dict, device,
                     dtype=torch.float32, rows: int = 1024):
    """(keys of every track, the table of the first n_table of them)."""
    keys = RA.keys_of(list(tracks), cfg["db_analyzer"], device, dtype, rows)
    return keys, RT.build(keys[:n_table], **_table_cfg(cfg))


def table_readings(got: RT.Table, want: RT.Table, n_ids: int) -> dict:
    r = RT.compare(got, want, n_ids)
    return {"table_entries_gap": r["entries_gap"],
            "table_counts_gap": r["counts_gap"]}


def floor(counts: np.ndarray) -> np.ndarray:
    """Each count, or the median count where that is larger: a gap is
    measured against it, so that one hash more or less on a small count
    reads as the small change it is."""
    c = np.asarray(counts, dtype=np.float64)
    return np.maximum(c, max(1.0, float(np.median(c)) if len(c) else 1.0))


def answer_readings(answers: np.ndarray, want_rows: np.ndarray,
                    want_n: np.ndarray) -> dict:
    """answers (n, 6) against the reference's row and hash count of each
    pool query: the hash counts' widest gap, the share of the pool queries
    answered with an answer whose track or time offset differs, and the
    widest gap of the filtered and raw counts where they agree."""
    q = answers[:, 0]
    got, ref = answers[:, 1:5], want_rows[q]
    same = (got[:, 0] == ref[:, 0]) & ((got[:, 0] < 0) | (got[:, 2] == ref[:, 2]))
    both = same & (got[:, 0] >= 0)
    gap = 0.0
    if both.any():
        g, r = got[both], ref[both]
        gap = max(float(np.max(np.abs(g[:, c] - r[:, c]) / floor(r[:, c])))
                  for c in (1, 3))
    return {"query_hashes_gap": float(np.max(np.abs(answers[:, 5] - want_n[q])
                                             / floor(want_n[q])))
            if len(q) else 0.0,
            "vote_rows_differing_share": float(len(np.unique(q[~same]))
                                               / max(1, len(np.unique(q)))),
            "vote_counts_gap": gap}


def reference_rows(tb: RT.Table, clips: list, cfg: dict, device,
                   dtype=torch.float32):
    qkeys = RA.keys_of(clips, cfg["query_analyzer"], device, dtype)
    m = cfg.get("matcher", {})
    rows = RT.vote(tb, qkeys, window=m.get("window", 2),
                   thresh=m.get("min_count", 5),
                   search_depth=m.get("search_depth", 100))
    return (rows.cpu().numpy(),
            np.array([len(k) for k in qkeys], dtype=np.int64))
