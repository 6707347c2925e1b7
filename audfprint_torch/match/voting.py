"""Batched time-offset voting (port of audfprint_tpu/match/voting.py):
the compacted run-length core (MatchConfig, _rank_rows, _Runs, _seg_spread,
_shifted, match_core_sorted, _vote_rle) and the histogram core
(_select_candidates*, match_core with its sum_all / min_all / gather_all
combiners, match_batch_hist), both behind match_batch_packed.

Bit-compat contract (shared with the JAX package and its numpy oracle,
audfprint_tpu.oracle.match.match_hashes):
  * candidate ranking: raw count / hashesperid, ties -> higher id;
  * approx (default): mode = first argmax of the +/-window smeared dt
    histogram over the candidate's own dt domain, count = smear at mode;
  * exact (--exact-count): modes = local maxima of the raw histogram
    within +/-window with count >= threshcount, one row per mode, counted
    as distinct query rows with an aligned hit;
  * time range: integer-index quantiles over the aligned-hit qtimes.

Where the JAX core runs multi-key `lax.sort`s and `associative_scan`s,
this port uses `torch.sort` on packed int64 keys, gathers at `cummax`
indices (the segmented copy), and a `cummax` over a packed key that
carries the segment's rank in its high bits (the segmented lexicographic
max).  Every packing checks that its fields fit.  Everything here runs on
int64 internally; results are packed to int32.

The histogram core is written against combiner callables, so the same
code runs on one device (identity combiners) and on one shard of a
bucket-sharded table (sums, minima and gathers over the mesh; see
audfprint_torch.parallel.sharded), with bit-identical results.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from audfprint_torch import params as P
from audfprint_torch.index import device_table as DT

_I32MAX = 2**31 - 1
_F32_INF_BITS = 0x7F800000


def _ident(x):
    """The combiner of an unsharded call (compared by identity)."""
    return x


class MatchConfig(NamedTuple):
    window: int = P.MATCH_WIN
    threshcount: int = P.MIN_COUNT
    max_returns: int = P.MAX_MATCHES
    search_depth: int = P.SEARCH_DEPTH
    exact_count: bool = False
    find_time_range: bool = False
    time_quantile: float = P.TIME_QUANTILE
    sort_by_time: bool = False
    qt_cap: int = 2048          # max query frame index + 1
    n_ids_cap: int = 4096       # id-space capacity (>= #tracks)
    modes_cap: int = 4          # exact-count: result rows kept per
                                # candidate (exact whenever
                                # modes_cap >= max_returns)

    @classmethod
    def from_params(cls, mp: P.MatcherParams, qt_cap: int = 2048,
                    n_ids_cap: int = 4096) -> "MatchConfig":
        return cls(window=mp.window, threshcount=mp.threshcount,
                   max_returns=mp.max_returns, search_depth=mp.search_depth,
                   exact_count=mp.exact_count,
                   find_time_range=mp.find_time_range,
                   time_quantile=mp.time_quantile,
                   sort_by_time=mp.sort_by_time,
                   qt_cap=qt_cap, n_ids_cap=n_ids_cap,
                   modes_cap=max(1, mp.max_returns))


def _lexsort(keys: list) -> torch.Tensor:
    """Row-wise lexicographic order of (B, R) keys (first key most
    significant) as a permutation; ties keep index order.  A chain of
    stable sorts, least significant key first."""
    B, R = keys[0].shape
    perm = torch.arange(R, device=keys[0].device).expand(B, R)
    for key in reversed(keys):
        perm = perm.gather(1, torch.argsort(key.gather(1, perm), dim=1,
                                            stable=True))
    return perm


def _rank_rows(cand_ids, cand_raw, cand_valid, mode_bin, mode_ok, filt,
               min_t, max_t, mcfg: MatchConfig):
    """Rank (candidate, mode) rows: count desc, then (candidate rank, mode
    bin asc) — the oracle's append order — filter, optional sort-by-time,
    truncate to max_returns.  All inputs (B, SD, Mc)."""
    B, SD, Mc = filt.shape
    R = SD * Mc

    def flat(a):
        return a.expand(B, SD, Mc).reshape(B, R)

    keep = flat(cand_valid[:, :, None] & mode_ok
                & (filt >= mcfg.threshcount))
    filt_r, mode_r = flat(filt), flat(mode_bin)
    min_r, max_r = flat(min_t), flat(max_t)
    ids_r, raw_r = flat(cand_ids[:, :, None]), flat(cand_raw[:, :, None])
    rank_r = flat(torch.arange(SD, device=filt.device)[None, :, None])
    k_first = (~keep).long()
    if mcfg.sort_by_time:
        keys = [k_first, torch.where(keep, mode_r, _I32MAX), -filt_r,
                rank_r, mode_r]
    else:
        keys = [k_first, -filt_r, rank_r, mode_r]
    sel = _lexsort(keys)[:, : mcfg.max_returns]

    def take(a):
        return a.gather(1, sel)

    kb = take(keep)

    def z(a):            # rows past n_results are zeroed
        return torch.where(kb, take(a), 0)

    return {
        "ids": z(ids_r),
        "filtcount": z(filt_r),
        "mode_dt": z(mode_r - mcfg.qt_cap),
        "rawcount": z(raw_r),
        "min_t": z(min_r),
        "max_t": z(max_r),
        "rvalid": kb,
        "n_results": torch.clamp(keep.sum(dim=1), max=mcfg.max_returns),
    }


class _Runs(NamedTuple):
    """Run structure of a sorted (B, H) key array: for every position the
    index of its run's first element (`start`) and one past its last
    (`end`)."""
    start: torch.Tensor
    end: torch.Tensor

    @classmethod
    def of(cls, keys_sorted: torch.Tensor) -> "_Runs":
        return cls.from_first(_first_of(keys_sorted))

    @classmethod
    def from_first(cls, first: torch.Tensor) -> "_Runs":
        B, H = first.shape
        iota = torch.arange(H, device=first.device).expand(B, H)
        a = torch.where(first, iota, H)
        nxt_incl = torch.cummin(a.flip(1), dim=1).values.flip(1)
        end = torch.cat([nxt_incl[:, 1:],
                         torch.full_like(nxt_incl[:, :1], H)], dim=1)
        start = torch.cummax(torch.where(first, iota, 0), dim=1).values
        return cls(start=start, end=end)


def _first_of(keys_sorted: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(keys_sorted[:, :1], dtype=torch.bool),
                      keys_sorted[:, 1:] != keys_sorted[:, :-1]], dim=1)


def _seg_spread(first: torch.Tensor, *vals: torch.Tensor) -> tuple:
    """Segmented forward copy: every position receives its segment's first
    value (first[:, 0] must be True) — a gather at the running max of the
    segment-start indices."""
    B, H = first.shape
    iota = torch.arange(H, device=first.device).expand(B, H)
    idx = torch.cummax(torch.where(first, iota, 0), dim=1).values
    return tuple(v.gather(1, idx) for v in vals)


def _shifted(a: torch.Tensor, o: int, fill) -> torch.Tensor:
    """s[:, i] = a[:, i + o] with `fill` outside."""
    if o == 0:
        return a
    pad = torch.full_like(a[:, : abs(o)], fill)
    if o > 0:
        return torch.cat([a[:, o:], pad], dim=1)
    return torch.cat([pad, a[:, :o]], dim=1)


def _pad_cols(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    if n <= 0:
        return a
    return torch.cat([a, torch.full_like(a[:, :1], fill).expand(
        a.shape[0], n)], dim=1)


def _pack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi << 32) | lo for 0 <= hi < 2^31, 0 <= lo < 2^32: sorts as the
    lexicographic pair (hi, lo)."""
    return (hi << 32) | lo


def match_core_sorted(table: torch.Tensor, counts: torch.Tensor,
                      hashesperid: torch.Tensor, qtimes: torch.Tensor,
                      qhashes: torch.Tensor, qvalid: torch.Tensor,
                      tcfg: DT.TableConfig, mcfg: MatchConfig,
                      hpi_plane: torch.Tensor | None = None):
    """Single-device voting on the hit domain: gather the hits, then the
    compacted-RLE vote (_vote_rle).  O(B * H log H) with H = Q * depth,
    independent of maxtime, query length and track count.  With an
    hpi_plane (DT.build_hpi_plane) each hit's hashesperid is gathered with
    its bucket row instead of by its id.

    Memory: only the packed (id, bin) key of each hit, and its query frame
    for the time range, stay referenced here while the vote runs; every
    other hit-domain array is dropped (`del`) as soon as it is dead, so the
    peak is what Matcher._sorted_bytes_per_row budgets."""
    B, Q = qhashes.shape
    N = mcfg.n_ids_cap
    nbins = tcfg.maxtime + mcfg.qt_cap
    if N + 1 >= 2**31 or nbins >= 2**29:
        raise ValueError("n_ids_cap or the dt-bin domain is out of range")
    ids3, dts3, hv3 = DT.get_hits_local(
        table, counts, qtimes, qhashes, qvalid, tcfg, 0)
    H = Q * tcfg.depth
    idk = torch.where(hv3.reshape(B, H),
                      torch.clamp(ids3.reshape(B, H).long(), max=N - 1), N)
    del ids3, hv3
    dtbin = torch.clamp(dts3.reshape(B, H).long() + mcfg.qt_cap, 0, nbins - 1)
    del dts3
    key = _pack2(idk, dtbin)
    del idk, dtbin
    qt_f = None
    if mcfg.find_time_range:
        qt_f = torch.clamp(
            qtimes.long()[:, :, None].expand(B, Q, tcfg.depth).reshape(B, H),
            0, mcfg.qt_cap - 1)
    hpi_f = None
    if hpi_plane is not None:
        hpi_f = DT.gather_plane(hpi_plane, qhashes, tcfg, 0).reshape(B, H)
    return _vote_rle(key, qt_f, hpi_f, hashesperid, Q, tcfg, mcfg)


def _rank_id_runs(s_id: torch.Tensor, c_h: torch.Tensor,
                  first_ok: torch.Tensor, hpi_h: torch.Tensor, SD: int,
                  N: int):
    """The top-SD ids of a row of id-sorted hits by (wc desc, id desc), the
    upstream np.argsort(wcounts)[::-1] rule, wc = raw count / hashesperid
    in float32.  s_id: sorted ids; c_h: each hit's id-run length; first_ok:
    the run starts of real ids; hpi_h: each hit's hashesperid (float32,
    >= 1).  wc > 0, so its f32 bits order like its value; the other
    positions get a key past every start.  Returns (cand_valid, cand_ids,
    cand_pos, cand_raw), each (B, SD); cand_pos is the run start's
    position, 0 where invalid."""
    H = s_id.shape[1]
    wc = c_h.to(torch.float32) / hpi_h
    ckey = _pack2(torch.where(first_ok, _F32_INF_BITS - wc.view(torch.int32)
                              .long(), _F32_INF_BITS + 1), N - s_id)
    del wc
    k1s, pos_s = torch.sort(ckey, dim=1, stable=True)
    del ckey
    S = min(SD, H)
    cand_valid = _pad_cols((k1s[:, :S] >> 32) <= _F32_INF_BITS, SD - S,
                           False)
    del k1s
    pos_s = _pad_cols(pos_s[:, :S], SD - S, 0)
    cand_ids = torch.where(cand_valid, s_id.gather(1, pos_s), N - 1)
    cand_pos = torch.where(cand_valid, pos_s, 0)
    cand_raw = torch.where(cand_valid, c_h.gather(1, cand_pos), 0)
    return cand_valid, cand_ids, cand_pos, cand_raw


def _vote_rle(key: torch.Tensor, qt_f: torch.Tensor | None,
              hpi_f: torch.Tensor | None, hashesperid: torch.Tensor | None,
              qrows: int, tcfg: DT.TableConfig, mcfg: MatchConfig):
    """The compacted-RLE vote on flat hit arrays.

    key:     (B, H) packed hit keys _pack2(id, dt bin): track ids with the
             invalid slots at n_ids_cap (sort last), dt bins = dt + qt_cap
             clipped to [0, nbins)
    qt_f:    (B, H) hit query frame (clipped to qt_cap), iff find_time_range
    hpi_f:   (B, H) per-hit hashesperid (DT.gather_plane of a
             DT.build_hpi_plane), or None to gather hashesperid[id]
    qrows:   query-hash rows; each row's depth hits are contiguous: Q on
             one device, ndev * Q after the mesh's hit exchange

    Results are invariant to the order of hits within a (row, id, bin)
    group (same-id hpi_f values are equal by construction), so no sort
    here needs a tie rule beyond its keys, and the exchanged layout of
    parallel.sharded gives the single-device rows.  Each
    hit-domain intermediate is deleted when it is dead (see
    match_core_sorted)."""
    B, H = key.shape
    SD = mcfg.search_depth
    W = mcfg.window
    Mc = max(1, mcfg.modes_cap) if mcfg.exact_count else 1
    N = mcfg.n_ids_cap
    nbins = tcfg.maxtime + mcfg.qt_cap
    if qrows * tcfg.depth != H:
        raise ValueError("hit arrays must hold qrows * depth columns")
    dev = key.device
    iota_h = torch.arange(H, device=dev).expand(B, H)

    # F1: all hits sorted by (id, bin)
    f1, perm = torch.sort(key, dim=1, stable=True)
    s_id, s_db = f1 >> 32, f1 & 0xFFFFFFFF
    del f1
    s_qt = qt_f.gather(1, perm) if mcfg.find_time_range else None
    s_hpi = hpi_f.gather(1, perm) if hpi_f is not None else None
    del perm

    # candidate selection on the id-run starts
    idruns = _Runs.of(s_id)
    c_h = idruns.end - idruns.start                 # raw count per hit
    first_ok = (iota_h == idruns.start) & (s_id < N)
    del idruns
    if s_hpi is not None:
        hpi_h = torch.clamp(s_hpi, min=1).to(torch.float32)
        del s_hpi
    else:
        hpi_h = torch.clamp(hashesperid, min=1).to(torch.float32)[
            torch.clamp(s_id, max=N - 1)]
    cand_valid, cand_ids, cand_start, cand_raw = _rank_id_runs(
        s_id, c_h, first_ok, hpi_h, SD, N)
    del first_ok, hpi_h, c_h
    cand_last = torch.clamp(cand_start + cand_raw - 1, min=0)

    # compact the (id, bin) runs to the row front (distinct keys)
    run_first = torch.cat(
        [torch.ones_like(s_id[:, :1], dtype=torch.bool),
         (s_id[:, 1:] != s_id[:, :-1]) | (s_db[:, 1:] != s_db[:, :-1])],
        dim=1)
    rruns = _Runs.from_first(run_first)
    c_run = rruns.end - rruns.start
    del rruns
    cend_c = (torch.cumsum(run_first.long(), dim=1) - 1).gather(1, cand_last)
    keep_r = run_first & (s_id < N)
    del run_first
    corder = torch.argsort(torch.where(keep_r, iota_h, H + iota_h), dim=1)
    cid_c = torch.where(keep_r, s_id, N + 1).gather(1, corder)
    db_c = torch.where(keep_r, s_db, -(1 << 28)).gather(1, corder)
    cnt_c = torch.where(keep_r, c_run, 0).gather(1, corder)
    del keep_r, c_run, corder
    if not mcfg.find_time_range:
        del s_id, s_db
    val_c = cid_c < N

    # id-segment structure on the compacted row
    seg_first = _first_of(cid_c)
    seg_last = torch.cat([seg_first[:, 1:], torch.ones_like(seg_first[:, :1])],
                         dim=1)

    offsets = range(-2 * W, W + 1) if not mcfg.exact_count \
        else range(-W, W + 1)

    def neighbours():
        """Each nonzero offset's shifted (id, bin, count) rows, made one
        offset at a time so that only one set is live."""
        for o in offsets:
            if o:
                yield (_shifted(cid_c, o, -1), _shifted(db_c, o, -(1 << 28)),
                       _shifted(cnt_c, o, 0))

    # segmented lexicographic max of (score, then min pos): one cummax over
    # (segment rank | score code | reversed pos); the segment rank in the
    # high bits restarts the max at every segment.  Valid scores are >= -1
    # and <= max(H, nbins); valid positions lie in [0, nbins).
    pbits = nbins.bit_length()
    sbits = (max(H, nbins) + 2).bit_length()
    if max(1, (H - 1).bit_length()) + sbits + pbits > 63:
        raise ValueError("segmented max key does not fit 63 bits")
    seg_hi = (torch.cumsum(seg_first.long(), dim=1) - 1) << (sbits + pbits)
    pmax = 1 << pbits

    def seg_best(score, pos, valid):
        key = (seg_hi | (torch.where(valid, score + 2, 0) << pbits)
               | torch.where(valid, pmax - 1 - pos, 0))
        run = torch.cummax(key, dim=1).values
        del key
        sc = (run >> pbits) & ((1 << sbits) - 1)
        best_s = torch.where(sc == 0, -(1 << 30), sc - 2)
        del sc
        pc = run & (pmax - 1)
        del run
        return best_s, torch.where(pc == 0, _I32MAX, pmax - 1 - pc)

    def seg_final(*vals):
        """Broadcast each segment's last value over the segment."""
        out = _seg_spread(seg_last.flip(1), *[v.flip(1) for v in vals])
        return tuple(o.flip(1) for o in out)

    def at_cands(a, fill):
        return torch.where(cand_valid, a.gather(1, cend_c), fill)

    if not mcfg.exact_count:
        # approx: the smear at every event point p = max(dtmin, d - W);
        # winner per id = (max count, then smallest p)
        (dtmin_c,) = _seg_spread(seg_first, db_c)
        p_c = torch.maximum(dtmin_c, db_c - W)
        del dtmin_c
        s_c = cnt_c.clone()
        for cid_o, db_o, cn_o in neighbours():
            m = (cid_o == cid_c) & (db_o >= p_c - W) & (db_o <= p_c + W)
            s_c += torch.where(m, cn_o, 0)        # in place: s_c is ours
            del m, cid_o, db_o, cn_o
        bs, bp = seg_best(s_c, p_c, val_c)
        del s_c, p_c
        filt = at_cands(bs, -1)[:, :, None]
        mode_bin = at_cands(bp, 0)[:, :, None]
        del bs, bp
        mode_ok = torch.ones_like(filt, dtype=torch.bool)
    else:
        # a run is a mode candidate iff count >= every same-id neighbour
        # run count within +/-W bins
        nb_max = torch.zeros_like(cnt_c)
        c_cov = cnt_c.clone()
        for cid_o, db_o, cn_o in neighbours():
            m = (cid_o == cid_c) & ((db_o - db_c).abs() <= W)
            cm = torch.where(m, cn_o, 0)
            del m
            torch.maximum(nb_max, cm, out=nb_max)  # in place: ours
            c_cov += cm
            del cm, cid_o, db_o, cn_o
        ismode = (val_c & (cnt_c >= max(1, mcfg.threshcount))
                  & (cnt_c >= nb_max))
        del nb_max

        # D = #consecutive same-(query row, id) hit pairs whose windows
        # both cover a run's bin, via one merged event/run sort: +1 at
        # (id, dhi - W), -1 at (id, dlo + W + 1), runs at odd bins so they
        # never tie an event; the prefix sum read at each run is D there
        s3 = torch.sort(key.reshape(B, qrows, tcfg.depth), dim=-1).values
        i3s, d3s = s3 >> 32, s3 & 0xFFFFFFFF
        del s3
        pair_ok = ((i3s[..., :-1] == i3s[..., 1:]) & (i3s[..., 1:] < N)
                   & (d3s[..., 1:] - d3s[..., :-1] <= 2 * W))
        NP = qrows * (tcfg.depth - 1)
        pid = torch.where(pair_ok, i3s[..., 1:], N).reshape(B, NP) << 32
        del i3s
        off = 1 << 30
        key_m = torch.cat(
            [pid | ((d3s[..., 1:].reshape(B, NP) - W) * 2 + off),
             pid | ((d3s[..., :-1].reshape(B, NP) + W + 1) * 2 + off),
             _pack2(cid_c, db_c * 2 + 1 + off)], dim=1)
        del pid, d3s
        # the weights in int8: +1 / -1 / 0, summed in int64 below
        wplus = pair_ok.reshape(B, NP).to(torch.int8)
        del pair_ok
        w_m = torch.cat([wplus, -wplus, torch.zeros_like(cid_c,
                                                        dtype=torch.int8)],
                        dim=1)
        del wplus
        mperm = torch.argsort(key_m, dim=1, stable=True)
        del key_m
        csum = torch.cumsum(w_m.gather(1, mperm), dim=1, dtype=torch.long)
        del w_m
        u_c = c_cov - torch.empty_like(csum).scatter_(1, mperm, csum)[:, 2 * NP:]
        del csum, mperm, c_cov

        mode_bins, mode_oks, mode_filts = [], [], []
        if mcfg.sort_by_time:
            # time-sorted output truncates to the earliest rows: take the
            # Mc earliest modes that pass the keep filter
            avail = ismode & (u_c >= mcfg.threshcount)
            for _s in range(Mc):
                tscore = torch.where(avail, nbins - 1 - db_c, -1)
                bs, bp = seg_best(tscore, db_c, avail)
                del tscore
                (bp_full,) = seg_final(bp)
                chosen = avail & (db_c == bp_full)
                del bp_full
                us, _up = seg_best(torch.where(chosen, u_c, -1), db_c,
                                   chosen)
                del _up
                mode_bins.append(at_cands(bp, 0))
                mode_oks.append(at_cands(bs, -1) >= 0)
                mode_filts.append(at_cands(us, -1))
                del bs, bp, us
                avail = avail & ~chosen
                del chosen
        else:
            score = torch.where(ismode, u_c, -1)
            for _s in range(Mc):
                bs, bp = seg_best(score, db_c, score >= 0)
                mode_bins.append(at_cands(bp, 0))
                bv = at_cands(bs, -1)
                mode_oks.append(bv > 0)
                mode_filts.append(bv)
                bs_full, bp_full = seg_final(bs, bp)
                del bs, bp
                chosen = ((score >= 0) & (score == bs_full)
                          & (db_c == bp_full))
                del bs_full, bp_full
                score = torch.where(chosen, -1, score)
                del chosen
        mode_bin = torch.stack(mode_bins, dim=-1)
        mode_ok = torch.stack(mode_oks, dim=-1)
        filt = torch.stack(mode_filts, dim=-1)
    del cid_c, db_c, cnt_c, val_c, seg_first, seg_last, seg_hi

    # optional time range per (candidate, mode slot): one (id, qtime)
    # re-sort of the F1 row per slot puts each id segment's aligned qtimes
    # ascending at the segment front; the quantiles are gathers there
    if mcfg.find_time_range:
        s_valid = s_id < N
        id_first_f1 = _first_of(s_id)
        tq = torch.tensor(mcfg.time_quantile, dtype=torch.float32,
                          device=dev)
        tq1 = torch.tensor(1.0 - mcfg.time_quantile, dtype=torch.float32,
                           device=dev)
        seed_col = torch.where(cand_valid, cand_start, H)  # H: spare column
        min_ts, max_ts = [], []
        for s in range(Mc):
            mb_seed = torch.full((B, H + 1), -(1 << 28), dtype=torch.long,
                                 device=dev)
            mb_seed.scatter_(1, seed_col, mode_bin[:, :, s])
            (mb_h,) = _seg_spread(id_first_f1, mb_seed[:, :H])
            del mb_seed
            aligned = s_valid & ((s_db - mb_h).abs() <= W)
            del mb_h
            q_sorted = torch.sort(
                _pack2(s_id, torch.where(aligned, s_qt, 1 << 29)),
                dim=1).values & 0xFFFFFFFF
            ca = torch.cumsum(aligned.long(), dim=1)
            del aligned
            hi = ca.gather(1, cand_last)
            lo = torch.where(cand_start > 0,
                             ca.gather(1, torch.clamp(cand_start - 1, min=0)),
                             0)
            del ca
            nq = torch.where(cand_valid, hi - lo, 0)
            nqf = nq.to(torch.float32)
            k0 = (tq * nqf).long()
            k1 = torch.clamp((tq1 * nqf).long() - 1, min=0)
            gmin = q_sorted.gather(1, torch.clamp(cand_start + k0, max=H - 1))
            gmax = q_sorted.gather(1, torch.clamp(cand_start + k1, max=H - 1))
            del q_sorted
            min_ts.append(torch.where(nq > 0, gmin, 0))
            max_ts.append(torch.where(nq > 0, gmax, 0))
        min_t = torch.stack(min_ts, dim=-1)
        max_t = torch.stack(max_ts, dim=-1)
    else:
        min_t = torch.zeros_like(mode_bin)
        max_t = torch.zeros_like(mode_bin)

    return _rank_rows(cand_ids, cand_raw, cand_valid, mode_bin, mode_ok,
                      filt, min_t, max_t, mcfg)


# ---- the histogram core -------------------------------------------------

def _hit_ranks(cand_ids, cand_valid, id_safe, v_f, mcfg: MatchConfig):
    """Each hit's candidate rank (SD = not a candidate) through a
    (B, n_ids_cap + 1) rank map; invalid candidate slots write the spare
    last column, which no hit reads."""
    B, SD = cand_ids.shape
    N = mcfg.n_ids_cap
    rankmap = torch.full((B, N + 1), SD, dtype=torch.long,
                         device=cand_ids.device)
    rankmap.scatter_(1, torch.where(cand_valid, cand_ids, N),
                     torch.arange(SD, device=cand_ids.device).expand(B, SD))
    return torch.where(v_f, rankmap.gather(1, id_safe), SD)


def _raw_counts(id_safe, v_f, N: int) -> torch.Tensor:
    """Valid hits per id, (B, N) int32."""
    raw = torch.zeros((id_safe.shape[0], N), dtype=torch.int32,
                      device=id_safe.device)
    return raw.scatter_add_(1, id_safe, v_f.to(torch.int32))


def _select_candidates_hits(id_f, v_f, hashesperid, mcfg: MatchConfig):
    """Hit-domain candidate selection (one device): sort the hit ids, take
    the raw counts as run lengths, rank the run starts by (wc desc, id
    desc) (_rank_id_runs) and give every hit its candidate's rank.  Same
    wc values, order and validity as the id-domain path of
    _select_candidates."""
    N = mcfg.n_ids_cap
    id_safe = torch.where(v_f, torch.clamp(id_f, max=N - 1), 0)
    s = torch.sort(torch.where(v_f, id_safe, N), dim=1).values
    runs = _Runs.of(s)
    first_ok = (torch.arange(s.shape[1], device=s.device)[None]
                == runs.start) & (s < N)
    hpi_h = torch.clamp(hashesperid, min=1).to(torch.float32)[
        torch.clamp(s, max=N - 1)]
    cand_valid, cand_ids, _pos, cand_raw = _rank_id_runs(
        s, runs.end - runs.start, first_ok, hpi_h, mcfg.search_depth, N)
    return (cand_ids, cand_raw, cand_valid,
            _hit_ranks(cand_ids, cand_valid, id_safe, v_f, mcfg))


def _select_candidates_hits_sharded(id_f, v_f, hashesperid,
                                    mcfg: MatchConfig, sum_all: Callable,
                                    gather_all: Callable):
    """Hit-domain candidate selection on one shard of a mesh.  A query
    hash's hits all live on the shard that owns its bucket, so:

      1. the raw counts are summed over the shards in the id domain;
      2. each shard ranks its local id-run starts by the global (wc desc,
         id desc) key and keeps its top SD;
      3. the (B, SD) local keys are gathered, merged by one sort of
         (B, ndev * SD), and the duplicates of an id (equal keys, hence
         adjacent) dropped: the global top SD.

    A globally top-SD id has a hit on some shard, where its local rank is
    at most its global one, so it survives step 2; distinct ids never tie,
    so step 3 reproduces the global order."""
    B, H = id_f.shape
    SD, N = mcfg.search_depth, mcfg.n_ids_cap
    dev = id_f.device
    id_safe = torch.where(v_f, torch.clamp(id_f, max=N - 1), 0)
    raw = sum_all(_raw_counts(id_safe, v_f, N))
    s = torch.sort(torch.where(v_f, id_safe, N), dim=1).values
    s_safe = torch.clamp(s, max=N - 1)
    raw_h = raw.gather(1, s_safe).long()
    first_ok = _first_of(s) & (s < N) & (raw_h > 0)
    hpi_h = torch.clamp(hashesperid, min=1).to(torch.float32)[s_safe]
    wc = raw_h.to(torch.float32) / hpi_h
    none = _pack2(torch.tensor(_F32_INF_BITS + 1, device=dev),
                  torch.tensor(0, device=dev))
    ckey = torch.where(first_ok, _pack2(
        _F32_INF_BITS - wc.view(torch.int32).long(), N - s), none)
    S = min(SD, H)
    lkey = torch.sort(ckey, dim=1).values[:, :S]
    if SD > S:
        lkey = torch.cat([lkey, none.expand(B, SD - S)], dim=1)
    gkey = torch.sort(gather_all(lkey), dim=1).values     # (B, ndev * SD)
    G = gkey.shape[1]
    ids_m = N - (gkey & 0xFFFFFFFF)
    dup = ~_first_of(ids_m) | ((gkey >> 32) > _F32_INF_BITS)
    # kept keys first, in order: positions are distinct sort keys
    order = torch.argsort(dup.long() * G + torch.arange(G, device=dev)[None],
                          dim=1)[:, :SD]
    cand_valid = ~dup.gather(1, order)
    cand_ids = torch.where(cand_valid, ids_m.gather(1, order), N - 1)
    cand_raw = torch.where(cand_valid, raw.gather(1, cand_ids).long(), 0)
    return (cand_ids, cand_raw, cand_valid,
            _hit_ranks(cand_ids, cand_valid, id_safe, v_f, mcfg))


def _select_candidates(id_f, v_f, hashesperid, mcfg: MatchConfig,
                       sum_all: Callable = _ident,
                       gather_all: Callable | None = None):
    """Raw counts per id (combined over the shards) -> the weighted top-SD
    candidates and every hit's candidate rank.

    Ranking: raw count / hashesperid, ties to the higher id.  Unsharded
    calls take the hit-domain form (_select_candidates_hits), sharded
    calls with a gather_all combiner the per-shard hit-domain form and a
    merge (_select_candidates_hits_sharded).  The id-domain scatter and
    full (B, n_ids_cap) sort below is the equivalence reference, and
    serves sharded callers that pass no gather.  Returns (cand_ids,
    cand_raw, cand_valid (B, SD); rank_f (B, H), SD = not a candidate)."""
    if sum_all is _ident:
        return _select_candidates_hits(id_f, v_f, hashesperid, mcfg)
    if gather_all is not None:
        return _select_candidates_hits_sharded(
            id_f, v_f, hashesperid, mcfg, sum_all, gather_all)
    SD, N = mcfg.search_depth, mcfg.n_ids_cap
    dev = id_f.device
    id_safe = torch.where(v_f, torch.clamp(id_f, max=N - 1), 0)
    raw = sum_all(_raw_counts(id_safe, v_f, N)).long()
    hpi = torch.clamp(hashesperid, min=1).to(torch.float32)
    wc = raw.to(torch.float32) / hpi[None, :]
    key = _pack2(torch.where(raw > 0, _F32_INF_BITS
                             - wc.view(torch.int32).long(),
                             _F32_INF_BITS + 1),
                 N - 1 - torch.arange(N, device=dev)[None])
    if SD > N:
        raise ValueError("search_depth exceeds n_ids_cap")
    top = torch.sort(key, dim=1).values[:, :SD]
    cand_valid = (top >> 32) <= _F32_INF_BITS
    cand_ids = N - 1 - (top & 0xFFFFFFFF)
    cand_raw = raw.gather(1, cand_ids)
    # never-hit filler ids are distinct too: every slot may write its rank
    return (cand_ids, cand_raw, cand_valid,
            _hit_ranks(cand_ids, torch.ones_like(cand_valid), id_safe, v_f,
                       mcfg))


def _bin_scatter(B: int, rows: int, width: int, bidx, rank, col, val):
    """zeros((B, rows, width), int32) with val added at [bidx, rank, col]
    (repeated indices accumulate; integer adds are exact in any order)."""
    buf = torch.zeros(B * rows * width, dtype=torch.int32, device=val.device)
    buf.scatter_add_(0, ((bidx * rows + rank) * width + col).reshape(-1),
                     val.reshape(-1))
    return buf.view(B, rows, width)


def _window(histp: torch.Tensor, nbins: int, W: int, op) -> torch.Tensor:
    """op-reduce the 2W + 1 shifted views of the W-padded histogram: value
    at bin d covers hist[d - W .. d + W]."""
    acc = histp[..., :nbins].clone()
    for o in range(1, 2 * W + 1):
        op(acc, histp[..., o: o + nbins], out=acc)
    return acc


def _take_last(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return a.gather(-1, idx[..., None])[..., 0]


def match_core(table: torch.Tensor, counts: torch.Tensor,
               hashesperid: torch.Tensor, qtimes: torch.Tensor,
               qhashes: torch.Tensor, qvalid: torch.Tensor,
               tcfg: DT.TableConfig, mcfg: MatchConfig, bucket_lo: int = 0,
               sum_all: Callable = _ident, min_all: Callable = _ident,
               gather_all: Callable | None = None):
    """Voting over a (possibly shard-local) table through (B, SD, dt-bin)
    histograms: scatter-adds, a +/-window smear and masked argmax
    reductions.

    `sum_all` / `min_all` combine the shards' partials over the mesh
    (identity when unsharded); `gather_all` concatenates the shards' arrays
    along axis 1 and enables the sharded hit-domain candidate selection.
    The exact-count pair correction is shard-local: a query hash's hits all
    live on the shard that owns its bucket.  The histograms are int32:
    every count and windowed sum is at most H = Q * depth.  Returns the
    dict of _rank_rows."""
    B, Q = qhashes.shape
    SD, W = mcfg.search_depth, mcfg.window
    nbins = tcfg.maxtime + mcfg.qt_cap
    depth = tcfg.depth
    H = Q * depth
    dev = table.device
    ids3, dts3, hv3 = DT.get_hits_local(
        table, counts, qtimes, qhashes, qvalid, tcfg, bucket_lo)
    id_f = ids3.reshape(B, H).long()
    v_f = hv3.reshape(B, H)
    dtbin_f = torch.clamp(dts3.reshape(B, H).long() + mcfg.qt_cap, 0,
                          nbins - 1)
    del ids3, dts3, hv3
    bidx = torch.arange(B, device=dev)[:, None].expand(B, H)

    # 1 + 2. candidates and every hit's candidate rank
    cand_ids, cand_raw, cand_valid, rank_f = _select_candidates(
        id_f, v_f, hashesperid, mcfg, sum_all, gather_all)
    del id_f

    # 3. per-candidate dt histogram (combined) and its mode bins: approx,
    # the first argmax of the +/-W smear over the candidate's own dt
    # domain; exact, modes_cap local maxima of the raw histogram, chosen by
    # their exact count (or, time-sorted, the earliest that pass)
    one = v_f.to(torch.int32)
    hist = sum_all(_bin_scatter(B, SD + 1, nbins, bidx, rank_f, dtbin_f,
                                one)[:, :SD])
    binid = torch.arange(nbins, dtype=torch.int32, device=dev)
    zpad = torch.zeros((B, SD, W), dtype=torch.int32, device=dev)
    histp = torch.cat([zpad, hist, zpad], dim=-1)
    del zpad
    Mc = max(1, mcfg.modes_cap) if mcfg.exact_count else 1
    filt_approx = None

    if mcfg.exact_count:
        ismode = ((hist == _window(histp, nbins, W, torch.maximum))
                  & (hist >= max(1, mcfg.threshcount)))
        del hist, histp
        # exact unique-row coverage U(m) = #distinct query rows with a hit
        # in [m - W, m + W], for every bin, by interval difference arrays:
        # C(m) counts hits; D(m) counts consecutive same-(query row,
        # candidate) sorted hit pairs whose windows both cover m; U = C - D
        EXT = nbins + 2 * W + 2              # buffer index = bin + W
        idx0 = (bidx * (SD + 1) + rank_f) * EXT
        diff = torch.zeros(B * (SD + 1) * EXT, dtype=torch.int32, device=dev)
        diff.scatter_add_(0, (idx0 + dtbin_f).reshape(-1), one.reshape(-1))
        diff.scatter_add_(0, (idx0 + dtbin_f + 2 * W + 1).reshape(-1),
                          -one.reshape(-1))
        del idx0
        s3 = torch.sort(_pack2(rank_f, dtbin_f).reshape(B, Q, depth),
                        dim=-1).values
        r_s, d_s = s3 >> 32, s3 & 0xFFFFFFFF
        del s3
        pair_ok = ((r_s[..., :-1] == r_s[..., 1:]) & (r_s[..., 1:] < SD)
                   & (d_s[..., 1:] - d_s[..., :-1] <= 2 * W))
        pone = pair_ok.to(torch.int32).reshape(-1)
        idx3 = ((torch.arange(B, device=dev)[:, None, None] * (SD + 1)
                 + torch.where(pair_ok, r_s[..., 1:], SD)) * EXT)
        del r_s, pair_ok
        diff.scatter_add_(0, (idx3 + d_s[..., 1:]).reshape(-1), -pone)
        diff.scatter_add_(0, (idx3 + d_s[..., :-1] + 2 * W + 1).reshape(-1),
                          pone)
        del idx3, d_s, pone
        diff = sum_all(diff.view(B, SD + 1, EXT)[:, :SD])
        ucov = torch.cumsum(diff, dim=-1, dtype=torch.int32)[
            ..., W: W + nbins]
        del diff

        mode_bins, mode_oks, mode_filts = [], [], []
        if mcfg.sort_by_time:
            # time-sorted output truncates to the earliest rows: take the
            # Mc earliest modes that pass the keep filter
            sbin = torch.where(ismode & (ucov >= mcfg.threshcount), binid,
                               _I32MAX)
            for _s in range(Mc):
                mb = sbin.argmin(dim=-1)
                ok = _take_last(sbin, mb) < _I32MAX
                mode_bins.append(mb)
                mode_oks.append(ok)
                mode_filts.append(torch.where(ok, _take_last(ucov, mb).long(),
                                              -1))
                sbin.scatter_(-1, mb[..., None], _I32MAX)
        else:
            mscore = torch.where(ismode, ucov, -1)
            for _s in range(Mc):
                mb = mscore.argmax(dim=-1)             # ties -> low bin
                mv = _take_last(mscore, mb).long()
                mode_bins.append(mb)
                mode_oks.append(mv > 0)
                mode_filts.append(mv)
                mscore.scatter_(-1, mb[..., None], -1)
        del ismode, ucov
        mode_bin = torch.stack(mode_bins, dim=-1)          # (B, SD, Mc)
        mode_ok = torch.stack(mode_oks, dim=-1)
        filt = torch.stack(mode_filts, dim=-1)
    else:
        del hist
        smeared = _window(histp, nbins, W, torch.add)
        del histp
        dtmin = torch.full((B, SD + 1), _I32MAX, dtype=torch.long, device=dev)
        dtmin.scatter_reduce_(1, rank_f, torch.where(v_f, dtbin_f, _I32MAX),
                              "amin", include_self=True)
        dtmin = min_all(dtmin[:, :SD])
        sm = torch.where(binid >= dtmin[..., None], smeared, -1)
        del smeared
        mode_bin = sm.argmax(dim=-1)[..., None]            # first maximum
        mode_ok = torch.ones_like(mode_bin, dtype=torch.bool)
        filt = sm.amax(dim=-1).long()[..., None]
        del sm

    # 4 + 5. optional qtime quantile range per (candidate, mode slot)
    if mcfg.find_time_range:
        qt_f = torch.clamp(
            qtimes.long()[:, :, None].expand(B, Q, depth).reshape(B, H),
            0, mcfg.qt_cap - 1)
        tq = torch.tensor(mcfg.time_quantile, dtype=torch.float32, device=dev)
        tq1 = torch.tensor(1.0 - mcfg.time_quantile, dtype=torch.float32,
                           device=dev)
        rank_c = torch.clamp(rank_f, max=SD - 1)
        min_ts, max_ts = [], []
        for s in range(Mc):
            aligned = (v_f & (rank_f < SD)
                       & ((dtbin_f - mode_bin[:, :, s].gather(1, rank_c)).abs()
                          <= W))
            qthist = sum_all(_bin_scatter(
                B, SD + 1, mcfg.qt_cap, bidx, rank_f, qt_f,
                aligned.to(torch.int32))[:, :SD])
            qcsum = torch.cumsum(qthist, dim=-1, dtype=torch.int32)
            del qthist
            nq = qcsum[..., -1].long()
            nqf = nq.to(torch.float32)
            k0 = (tq * nqf).long()
            k1 = torch.clamp((tq1 * nqf).long() - 1, min=0)
            # first bin whose cumulative count reaches k + 1 (0 if none)
            for k, out in ((k0, min_ts), (k1, max_ts)):
                at = torch.searchsorted(
                    qcsum, (k + 1).to(torch.int32)[..., None])[..., 0]
                out.append(torch.where((nq > 0) & (at < mcfg.qt_cap), at, 0))
            del qcsum
        min_t = torch.stack(min_ts, dim=-1)
        max_t = torch.stack(max_ts, dim=-1)
    else:
        min_t = torch.zeros_like(mode_bin)
        max_t = torch.zeros_like(mode_bin)

    # 6. rank the (candidate, mode) rows
    return _rank_rows(cand_ids, cand_raw, cand_valid, mode_bin, mode_ok,
                      filt, min_t, max_t, mcfg)


def match_batch_sorted(table: torch.Tensor, counts: torch.Tensor,
                       hashesperid: torch.Tensor, qtimes: torch.Tensor,
                       qhashes: torch.Tensor, qvalid: torch.Tensor,
                       tcfg: DT.TableConfig, mcfg: MatchConfig,
                       hpi_plane: torch.Tensor | None = None) -> dict:
    """Single-device matching through the compacted run-length core, as
    the JAX package's result dict: ids, filtcount, mode_dt, rawcount,
    min_t and max_t (B, max_returns) int32, rvalid (B, max_returns) bool
    and n_results (B,) int32."""
    out = match_core_sorted(table, counts, hashesperid, qtimes, qhashes,
                            qvalid, tcfg, mcfg, hpi_plane)
    return {k: v if v.dtype == torch.bool else v.to(torch.int32)
            for k, v in out.items()}


# the default single-device entry, as in the JAX package
match_batch = match_batch_sorted


def match_batch_hist(table: torch.Tensor, counts: torch.Tensor,
                     hashesperid: torch.Tensor, qtimes: torch.Tensor,
                     qhashes: torch.Tensor, qvalid: torch.Tensor,
                     tcfg: DT.TableConfig, mcfg: MatchConfig):
    """Single-device matching through the histogram core (the computation
    a mesh runs with summing combiners)."""
    return match_core(table, counts, hashesperid, qtimes, qhashes, qvalid,
                      tcfg, mcfg)


def pack_rows(out: dict) -> torch.Tensor:
    """_rank_rows' dict -> (B, max_returns, 7) int32: [id, filtcount,
    mode_dt, rawcount, min_t, max_t, rvalid]."""
    return torch.stack(
        [out["ids"], out["filtcount"], out["mode_dt"], out["rawcount"],
         out["min_t"], out["max_t"], out["rvalid"].long()],
        dim=-1).to(torch.int32)


def match_batch_packed(table: torch.Tensor, counts: torch.Tensor,
                       hashesperid: torch.Tensor, qtimes: torch.Tensor,
                       qhashes: torch.Tensor, qvalid: torch.Tensor,
                       tcfg: DT.TableConfig, mcfg: MatchConfig,
                       core: str = "sorted",
                       hpi_plane: torch.Tensor | None = None) -> torch.Tensor:
    """Matching with the result packed into one (B, max_returns, 7) int32
    tensor: [id, filtcount, mode_dt, rawcount, min_t, max_t, rvalid].
    n_results is rvalid.sum() (invalid rows sort last and are zeroed).
    core: "sorted" (the compacted-RLE core, which alone takes an
    hpi_plane) or "hist"; both give the same rows."""
    if core == "sorted":
        out = match_core_sorted(table, counts, hashesperid, qtimes, qhashes,
                                qvalid, tcfg, mcfg, hpi_plane)
    elif core == "hist":
        out = match_core(table, counts, hashesperid, qtimes, qhashes, qvalid,
                         tcfg, mcfg)
    else:
        raise ValueError(f"unknown voting core {core!r}")
    return pack_rows(out)
