"""Batched time-offset voting, the compacted run-length core (port of
audfprint_tpu/match/voting.py: MatchConfig, _rank_rows, _Runs, _seg_spread,
_shifted, match_core_sorted, _vote_rle, match_batch_packed).

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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from audfprint_torch import params as P
from audfprint_torch.index import device_table as DT

_I32MAX = 2**31 - 1
_F32_INF_BITS = 0x7F800000


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
                      tcfg: DT.TableConfig, mcfg: MatchConfig):
    """Single-device voting on the hit domain: gather the hits, then the
    compacted-RLE vote (_vote_rle).  O(B * H log H) with H = Q * depth,
    independent of maxtime, query length and track count.

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
    return _vote_rle(key, qt_f, hashesperid, Q, tcfg, mcfg)


def _vote_rle(key: torch.Tensor, qt_f: torch.Tensor | None,
              hashesperid: torch.Tensor, qrows: int, tcfg: DT.TableConfig,
              mcfg: MatchConfig):
    """The compacted-RLE vote on flat hit arrays.

    key:     (B, H) packed hit keys _pack2(id, dt bin): track ids with the
             invalid slots at n_ids_cap (sort last), dt bins = dt + qt_cap
             clipped to [0, nbins)
    qt_f:    (B, H) hit query frame (clipped to qt_cap), iff find_time_range
    qrows:   query-hash rows; each row's depth hits are contiguous

    Results are invariant to the order of hits within a (row, id, bin)
    group, so no sort here needs a tie rule beyond its keys.  Each
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
    del perm

    # candidate selection on the id-run starts: (wc desc, id desc), the
    # upstream np.argsort(wcounts)[::-1] rule.  wc > 0, so its f32 bits
    # order like its value; non-starts get a key past every start.
    idruns = _Runs.of(s_id)
    c_h = idruns.end - idruns.start                 # raw count per hit
    first_ok = (iota_h == idruns.start) & (s_id < N)
    del idruns
    hpi = torch.clamp(hashesperid, min=1).to(torch.float32)
    wc = c_h.to(torch.float32) / hpi[torch.clamp(s_id, max=N - 1)]
    ckey = _pack2(torch.where(first_ok, _F32_INF_BITS - wc.view(torch.int32)
                              .long(), _F32_INF_BITS + 1), N - s_id)
    del first_ok, wc
    k1s, pos_s = torch.sort(ckey, dim=1, stable=True)
    del ckey
    S = min(SD, H)
    cand_valid = _pad_cols((k1s[:, :S] >> 32) <= _F32_INF_BITS, SD - S,
                           False)
    del k1s
    cand_ids = torch.where(
        cand_valid, _pad_cols(s_id.gather(1, pos_s[:, :S]), SD - S, 0),
        N - 1)
    cand_start = torch.where(cand_valid, _pad_cols(pos_s[:, :S], SD - S, 0),
                             0)
    del pos_s
    cand_raw = torch.where(cand_valid, c_h.gather(1, cand_start), 0)
    del c_h
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


def match_batch_packed(table: torch.Tensor, counts: torch.Tensor,
                       hashesperid: torch.Tensor, qtimes: torch.Tensor,
                       qhashes: torch.Tensor, qvalid: torch.Tensor,
                       tcfg: DT.TableConfig, mcfg: MatchConfig,
                       core: str = "sorted") -> torch.Tensor:
    """Matching with the result packed into one (B, max_returns, 7) int32
    tensor: [id, filtcount, mode_dt, rawcount, min_t, max_t, rvalid].
    n_results is rvalid.sum() (invalid rows sort last and are zeroed).
    Only the sorted (compacted-RLE) core is ported."""
    if core != "sorted":
        raise NotImplementedError(
            f"voting core {core!r} is not yet ported to audfprint_torch "
            "(ROADMAP.md); use core='sorted'")
    out = match_core_sorted(table, counts, hashesperid, qtimes, qhashes,
                            qvalid, tcfg, mcfg)
    return torch.stack(
        [out["ids"], out["filtcount"], out["mode_dt"], out["rawcount"],
         out["min_t"], out["max_t"], out["rvalid"].long()],
        dim=-1).to(torch.int32)
