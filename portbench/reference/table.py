"""Plain PyTorch reference of the hash table and of the vote.

The table is dpwe/audfprint's: 2^hashbits buckets of `depth` entries, an
entry (id << maxtimebits) | (t mod maxtime), files stored one after the
other, each in its (t, hash) order; past the depth an insertion takes a
reservoir slot, here the deterministic one the repository's store
documents (murmur3's fmix32 of the bucket times the golden ratio, xor
fmix32 of the position plus the seed, modulo the position + 1).

It is kept compact: the written slots as one sorted key bucket * depth +
slot with its entry, and every bucket's count of insertions.  The vote is
audfprint_match's default: candidates ranked by hits over the id's stored
hashes (ties to the higher id), the first `search_depth` of them; for each
the time-offset histogram smeared over +/- window, its first maximum; the
best filtered count (ties to the better candidate), reported at `thresh`
or more.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

M32 = 0xFFFFFFFF
_C1, _C2, _GOLDEN = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1


class Table(NamedTuple):
    slot_key: torch.Tensor      # (E,) bucket * depth + slot, ascending
    entry: torch.Tensor         # (E,) (id << maxtimebits) | t
    counts: torch.Tensor        # (n_buckets,) insertions, int64
    hashes_per_id: torch.Tensor  # (n_ids,) int64
    depth: int
    maxtimebits: int


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (((x & 0xFFFF) * c) + (((((x >> 16) * c) & 0xFFFF)) << 16)) & M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x & M32
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def reservoir_slot(bucket: torch.Tensor, pos: torch.Tensor, seed: int
                   ) -> torch.Tensor:
    h = _fmix32(_mul32(bucket & M32, _GOLDEN) ^ _fmix32((pos + seed) & M32))
    return h % (pos + 1)


def build(keys: list, hashbits: int = 20, depth: int = 100,
          maxtimebits: int = 14, seed: int = 0) -> Table:
    """Store track keys[i] under id i, in that order."""
    dev = keys[0].device if keys else torch.device("cpu")
    n = torch.tensor([len(k) for k in keys], device=dev, dtype=torch.int64)
    allk = (torch.cat(keys) if keys else
            torch.zeros(0, dtype=torch.int64, device=dev))
    ids = torch.repeat_interleave(
        torch.arange(len(keys), device=dev), n)
    h = allk & ((1 << hashbits) - 1)
    t = (allk >> 20) & ((1 << maxtimebits) - 1)
    entry = (ids << maxtimebits) | t
    hs, order = torch.sort(h, stable=True)
    es = entry[order]
    idx = torch.arange(len(hs), device=dev)
    first = torch.ones_like(hs, dtype=torch.bool)
    first[1:] = hs[1:] != hs[:-1]
    start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    pos = idx - start
    slot = torch.where(pos < depth, pos,
                       reservoir_slot(hs, torch.clamp(pos, min=depth), seed))
    w = slot < depth
    sk, es = hs[w] * depth + slot[w], es[w]
    # the last insertion into a slot stays: order by (slot key, arrival)
    sk, o = torch.sort(sk, stable=True)
    es = es[o]
    last = torch.ones_like(sk, dtype=torch.bool)
    last[:-1] = sk[1:] != sk[:-1]
    counts = torch.bincount(h, minlength=1 << hashbits)
    return Table(sk[last], es[last], counts, n, depth, maxtimebits)


def from_dense(table: torch.Tensor, counts: torch.Tensor,
               hashes_per_id, maxtimebits: int = 14) -> Table:
    """A (n_buckets, depth) table of uint32 entries (in any integer dtype)
    and its counts, as a Table."""
    nb, depth = table.shape
    occ = torch.clamp(counts.to(torch.int64), max=depth)
    mask = torch.arange(depth, device=table.device)[None, :] < occ[:, None]
    b, s = torch.nonzero(mask, as_tuple=True)
    entry = table[b, s].to(torch.int64) & M32
    return Table(b * depth + s, entry, counts.to(torch.int64),
                 torch.as_tensor(hashes_per_id, dtype=torch.int64,
                                 device=table.device), depth, maxtimebits)


def compare(got: Table, want: Table, n_ids: int) -> dict:
    """Per-id gap between the entries two tables hold (entries in one
    but not the other, over the id's entries in `want` or the median
    id's, whichever is larger), the worst of them, and the gap of the
    bucket counts (over their sum)."""
    def keyed(tb):
        bucket = tb.slot_key // tb.depth
        return (tb.entry << 24) | bucket, tb.entry >> tb.maxtimebits

    gk, gid = keyed(got)
    wk, wid = keyed(want)
    common = torch.isin(gk, wk)
    ng = torch.bincount(gid, minlength=n_ids)[:n_ids]
    nw = torch.bincount(wid, minlength=n_ids)[:n_ids]
    nc = torch.bincount(gid[common], minlength=n_ids)[:n_ids]
    # against the id's entries, or the median id's where that is larger
    med = nw[nw > 0].double().median().item() if bool((nw > 0).any()) else 1
    per_id = (ng + nw - 2 * nc).double() / torch.clamp(nw.double(), min=med)
    stray = int((gid >= n_ids).sum().item())    # entries of no stored id
    cg = (got.counts - want.counts).abs().sum().item()
    worst = per_id.max().item() if n_ids else 0.0
    return {"entries_gap": max(worst, stray / max(1, len(wk))),
            "ids_differing": int((per_id > 0).sum().item()),
            "counts_gap": cg / max(1, want.counts.sum().item())}


def _first_per_run(sorted_keys: torch.Tensor, shift: int) -> torch.Tensor:
    """Mask of the first element of each run of equal sorted_keys >> shift."""
    g = sorted_keys >> shift
    m = torch.ones_like(g, dtype=torch.bool)
    m[1:] = g[1:] != g[:-1]
    return m


def vote(tb: Table, qkeys: list, window: int = 2, thresh: int = 5,
         search_depth: int = 100) -> torch.Tensor:
    """Query keys (one tensor per query) -> (Q, 4) int64 rows [id,
    filtered count, mode dt, raw count]; id -1 where no match."""
    dev = tb.entry.device
    Q = len(qkeys)
    out = torch.full((Q, 4), -1, dtype=torch.int64, device=dev)
    nq = torch.tensor([len(k) for k in qkeys], device=dev)
    if Q == 0 or int(nq.sum()) == 0:
        return out
    qk = torch.cat(qkeys)
    qi = torch.repeat_interleave(torch.arange(Q, device=dev), nq)
    qh, qt = qk & (len(tb.counts) - 1), qk >> 20      # bucket, time
    # every query hash's stored entries (its bucket's written slots)
    lo = torch.searchsorted(tb.slot_key, qh * tb.depth)
    hi = torch.searchsorted(tb.slot_key, qh * tb.depth + tb.depth)
    ne = hi - lo
    hq = torch.repeat_interleave(qi, ne)
    start = torch.repeat_interleave(lo - (torch.cumsum(ne, 0) - ne), ne)
    e = tb.entry[start + torch.arange(len(hq), device=dev)]
    hid = e >> tb.maxtimebits
    hdt = (e & ((1 << tb.maxtimebits) - 1)) - torch.repeat_interleave(qt, ne)
    # candidates: raw hits per (query, id), ranked by raw / hashes per id
    pair, pinv, raw = torch.unique((hq << 32) | hid, return_inverse=True,
                                   return_counts=True)
    pq, pid = pair >> 32, pair & M32
    hpi = tb.hashes_per_id
    w = raw.double() / torch.clamp(hpi[pid], min=1).double()
    order = torch.argsort(pid, descending=True, stable=True)
    order = order[torch.argsort(w[order], descending=True, stable=True)]
    order = order[torch.argsort(pq[order], stable=True)]
    rank = torch.empty_like(order)
    pos = torch.arange(len(order), device=dev)
    firsts = _first_per_run(pq[order], 0)
    rank[order] = pos - torch.cummax(torch.where(firsts, pos, 0), 0).values
    # each candidate's smeared histogram of dt: its first maximum
    off, wid = 1 << 15, 1 << 17
    keep = rank[pinv] < search_depth
    ud, cnt = torch.unique(pinv[keep] * wid + hdt[keep] + off,
                           return_counts=True)
    csum = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])
    upair = ud // wid
    dmin = torch.full((len(pair),), wid, device=dev, dtype=torch.int64)
    dmax = torch.full((len(pair),), -1, device=dev, dtype=torch.int64)
    dmin.scatter_reduce_(0, upair, ud % wid, "amin")
    dmax.scatter_reduce_(0, upair, ud % wid, "amax")
    o = torch.arange(-window, window + 1, device=dev)
    cd = ((ud % wid)[:, None] + o).reshape(-1)
    cp = upair[:, None].expand(-1, len(o)).reshape(-1)
    inside = (cd >= dmin[cp]) & (cd <= dmax[cp])
    cd, cp = cd[inside], cp[inside]
    base = cp * wid
    sm = (csum[torch.searchsorted(ud, base + cd + window, right=True)]
          - csum[torch.searchsorted(ud, base + cd - window)])
    best = torch.sort((cp << 40) | (((1 << 20) - 1 - sm) << 17) | cd).values
    best = best[_first_per_run(best, 40)]
    bp = best >> 40
    filt = (1 << 20) - 1 - ((best >> 17) & ((1 << 20) - 1))
    mode = (best & (wid - 1)) - off
    # per query the best filtered count, ties to the better rank
    sel = torch.sort((pq[bp] << 40) | (((1 << 20) - 1 - filt) << 8)
                     | rank[bp]).values
    sel = sel[_first_per_run(sel, 40)]
    sq = sel >> 40
    sfilt = (1 << 20) - 1 - ((sel >> 8) & ((1 << 20) - 1))
    srank = sel & 0xFF
    # back from (query, rank) to the candidate
    cand = torch.full((Q, search_depth), -1, dtype=torch.int64, device=dev)
    kp = rank < search_depth
    cand[pq[kp], rank[kp]] = torch.arange(len(pair), device=dev)[kp]
    c = cand[sq, srank]
    bm = torch.full((len(pair),), 0, dtype=torch.int64, device=dev)
    bm[bp] = mode
    ok = sfilt >= thresh
    out[sq[ok], 0] = pid[c[ok]]
    out[sq[ok], 1] = sfilt[ok]
    out[sq[ok], 2] = bm[c[ok]]
    out[sq[ok], 3] = raw[c[ok]]
    return out
