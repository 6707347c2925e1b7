"""Oracle matcher: time-offset histogram voting over hash-table hits.

Behavioral spec: SURVEY.md §2.3.5 (reference audfprint_match.py:~150-260).
Given query (time, hash) rows and a HashTable:

  1. hits = ht.get_hits(hashes)
  2. candidate ids ranked by raw hit count weighted by 1/hashesperid
     (_best_count_ids, audfprint_match.py:~180); ties -> HIGHER id, the
     upstream np.argsort(wcounts)[::-1] rule (ADVICE r1)
  3. per candidate:
       approx (default): delta-t histogram smeared over +/-window; mode =
         argmax (ties -> smallest dt); filtered count = smeared count at
         mode (_approx_match_counts — can overcount duplicate hashes);
         ONE row per candidate.
       exact (--exact-count): find_modes() = every local-maximum bin of the
         RAW histogram (maximal within +/-window, count >= threshcount);
         ONE ROW PER MODE, each counted as #unique (qtime, hash) among its
         aligned hits (_exact_match_counts / _unique_match_hashes) — so one
         track matching a query at two offsets yields two rows under -x 2.
  4. optional [q, 1-q] quantile time range of aligned query times
  5. rank all rows by filtered count desc (stable: candidate rank, then
     mode bin asc), drop < threshcount, return <= max_returns rows
     (id, filtcount, mode_dt, rawcount, min_t, max_t)

This module is the gold standard for the batched on-device matcher in
`audfprint_torch.match`.
"""

from __future__ import annotations

import numpy as np

from audfprint_torch import params as P


def find_modes(data, threshold: int = 5, window: int = 0):
    """Local-maximum modes of an integer sample set (audfprint_match.py:~120).

    Returns (modes, counts) for every bin whose count is maximal within
    +/-window and >= threshold.
    """
    data = np.asarray(data, dtype=np.int64)
    if data.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    datamin = int(np.min(data))
    fullvector = np.bincount(data - datamin)
    # windowed max via shifted vector maxes — identical to the per-bin
    # np.max(fullvector[i-window : i+window+1]) loop, vectorized so the
    # oracle-vs-device fuzz tests can afford larger shapes (VERDICT r3
    # weak #6)
    wmax = fullvector.copy()
    for o in range(1, window + 1):
        if o < len(fullvector):
            np.maximum(wmax[o:], fullvector[:-o], out=wmax[o:])
            np.maximum(wmax[:-o], fullvector[o:], out=wmax[:-o])
    ismax = (fullvector == wmax) & (fullvector >= threshold)
    modes = np.nonzero(ismax)[0]
    return modes + datamin, fullvector[modes]


def _smeared_hist(dts: np.ndarray, window: int):
    """(offset, smeared histogram): smeared[d] = sum_{|d'-d|<=window} hist[d']."""
    dtmin = int(np.min(dts))
    hist = np.bincount(dts - dtmin)
    # pad so the window sum is defined at the edges
    padded = np.r_[np.zeros(window, np.int64), hist, np.zeros(window, np.int64)]
    csum = np.r_[0, np.cumsum(padded)]
    smeared = csum[2 * window + 1:] - csum[: len(hist)]
    return dtmin, smeared


def best_count_ids(hits: np.ndarray, ht):
    """Candidate ids by descending (rawcount / hashesperid); ties -> higher
    id, matching upstream's np.argsort(wcounts)[::-1] (_best_count_ids,
    audfprint_match.py:~180; reversing a stable ascending sort puts the
    higher index first among equals)."""
    allids = hits[:, 0]
    ids = np.unique(allids)
    rawcounts = np.bincount(allids)[ids]
    wcounts = rawcounts.astype(np.float64) / np.maximum(
        1, ht.hashesperid[ids].astype(np.float64))
    order = np.argsort(wcounts, kind="stable")[::-1]
    return rawcounts[order], ids[order]


def match_hashes(ht, hashes, mparams: P.MatcherParams | None = None) -> np.ndarray:
    """Query hashes -> (k, 6) int64 rows [id, filtcount, mode_dt, rawcount,
    min_t, max_t], sorted per the matcher params."""
    mparams = mparams or P.MatcherParams()
    hits = ht.get_hits(hashes)
    if hits.size == 0:
        return np.zeros((0, 6), dtype=np.int64)
    rawcounts, ids = best_count_ids(hits, ht)
    ids = ids[: mparams.search_depth]
    rawcounts = rawcounts[: mparams.search_depth]

    allids = hits[:, 0].astype(np.int64)
    alldts = hits[:, 1].astype(np.int64)
    allhashes = hits[:, 2].astype(np.int64)
    allqtimes = hits[:, 3].astype(np.int64)

    rows = []
    for id_, rawcount in zip(ids, rawcounts):
        sel = allids == id_
        dts = alldts[sel]
        if mparams.exact_count:
            # one row per local-maximum mode of the raw histogram
            # (_exact_match_counts + find_modes, audfprint_match.py:~120/~200)
            modes, _ = find_modes(dts, threshold=max(1, mparams.threshcount),
                                  window=mparams.window)
            mode_list = [int(m) for m in modes]
        else:
            dtmin, smeared = _smeared_hist(dts, mparams.window)
            mode_list = [int(np.argmax(smeared)) + dtmin]
        for mode in mode_list:
            aligned = sel & (np.abs(alldts - mode) <= mparams.window)
            if mparams.exact_count:
                # unique (qtime, hash) pairs among aligned hits
                # (_unique_match_hashes, audfprint_match.py:~200)
                packed = (allhashes[aligned] << 32) + allqtimes[aligned]
                filtcount = len(np.unique(packed))
            else:
                filtcount = int(np.max(smeared))
            if mparams.find_time_range:
                sq = np.sort(allqtimes[aligned])
                nq = len(sq)
                min_t = int(sq[int(mparams.time_quantile * nq)])
                max_t = int(sq[max(0, int((1 - mparams.time_quantile) * nq)
                                  - 1)])
            else:
                min_t, max_t = 0, 0
            rows.append([int(id_), filtcount, mode, int(rawcount),
                         min_t, max_t])

    results = np.array(rows, dtype=np.int64).reshape(-1, 6)
    # stable sort by filtered count desc (preserves candidate rank on ties)
    results = results[np.argsort(-results[:, 1], kind="stable")]
    results = results[results[:, 1] >= mparams.threshcount]
    if mparams.sort_by_time:
        results = results[np.argsort(results[:, 2], kind="stable")]
    return results[: mparams.max_returns]
