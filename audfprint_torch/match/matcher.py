"""Matcher: user-facing retrieval (port of audfprint_tpu/match/matcher.py).

match_hashes / match_file / file_match_to_msgs run the compacted-RLE vote
(match.voting) on `device`, or with `ndev` > 1 on a mesh of that many
bucket-range shards of the table (parallel/sharded.py; bit-identical
rows).  The device table upload is cached per (HashTable, revision, ndev),
so repeated queries against one DB pay the transfer once.  The fused path
fingerprints and matches a batch of sample arrays in one call
(_fused_match_graph) and re-matches the rare row past its static caps
through the two-stage path, so it never changes results.  On one CUDA
device the fused function and the two-stage path's vote are each
captured as a CUDA graph per shape key and replayed (utils/graphs.
GraphCache, the counterpart of the JAX package's jitted executables
_fused_match_graph and match_batch_packed); so are their mesh
counterparts, whose caches are made for the mesh, on a mesh of logical
shards of one card in one process (JAX's jitted shard_map functions),
while a mesh over several devices or processes runs them eagerly.  The
serving modes ride the batched match: match_hashes_windowed (broadcast
monitoring) and match_samples_sweep (playback-speed corrections);
illustrate_match and sonify_match are host diagnostics on top of
match_hashes.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.utils import audio as audio_io
from audfprint_torch.index import device_table as DT
from audfprint_torch.match import voting
from audfprint_torch.ops import pipeline as pipe
from audfprint_torch.utils import graphs
from audfprint_torch.utils.device import resolve_device

_next_pow2 = P.next_pow2

# qt_cap floor shared by the two-stage path and the fused path: queries
# whose max frame fits under it (~47.5 s at the default hop) share one
# dt-bin domain, and the fused path's cap equals the two-stage path's
# derived qt_cap exactly (the bit-identity precondition)
_QT_FLOOR = 2048


def _fused_match_graph(audio, lengths, table, counts, hpi, hpi_plane, pcfg,
                       tcfg, mcfg, qcap: int) -> torch.Tensor:
    """Raw audio to packed match results on the device: the compacted
    fingerprint -> its first qcap (t, hash) columns -> the vote.

    Row [-1] of the returned (B, max_returns + 1, 7) tensor carries
    [n_unique_hashes, max_frame, effective_qcap, 0, ...]: a row whose hash
    count exceeds the cap, or whose max frame reaches mcfg.qt_cap, is
    re-matched by the caller through the two-stage path."""
    th, cnt = pipe.fingerprint_batch_compact(audio, lengths, pcfg)
    qce = min(qcap, th.shape[1])
    qt = th[:, :qce, 0]
    qh = th[:, :qce, 1]
    iota = torch.arange(qce, device=th.device)[None]
    qv = iota < torch.clamp(cnt, max=qce)[:, None]
    packed = voting.match_batch_packed(table, counts, hpi, qt, qh, qv,
                                       tcfg, mcfg, "sorted", hpi_plane)
    maxt = torch.where(qv, qt, 0).amax(dim=1) if qce else torch.zeros_like(cnt)
    zero = torch.zeros_like(cnt)
    extra = torch.stack([cnt, maxt.to(cnt.dtype), torch.full_like(cnt, qce),
                         zero, zero, zero, zero], dim=-1)
    return torch.cat([packed, extra[:, None, :].to(packed.dtype)], dim=1)


def _two_stage_vote(qt, qh, qv, table, counts, hpi, hpi_plane, tcfg, mcfg,
                    core: str) -> torch.Tensor:
    """The two-stage path's vote on one device, as its graphs capture it:
    (B, Q) query (t, hash, valid) columns -> match_batch_packed's
    (B, max_returns, 7) rows."""
    return voting.match_batch_packed(table, counts, hpi, qt, qh, qv, tcfg,
                                     mcfg, core, hpi_plane)


def _mesh_vote(qt, qh, qv, table, counts, hpi, hpi_plane, mesh, tcfg,
               mcfg, core: str) -> torch.Tensor:
    """The two-stage path's vote on a mesh, as its graphs capture it: the
    RLE hit exchange (core "sorted") or the histogram core with its
    partials summed over the shards ("hist") -> (B, max_returns, 7)
    rows.  table, counts and hpi_plane are the lists of the shards'
    tensors; B must be a multiple of the mesh size for "sorted"."""
    from audfprint_torch.parallel import sharded

    if core == "hist":
        return sharded.sharded_match_packed_cached(mesh, tcfg, mcfg)(
            table, counts, hpi, qt, qh, qv)
    fn = sharded.sharded_match_rle_packed_cached(mesh, tcfg, mcfg,
                                                 hpi_plane is not None)
    plane = (hpi_plane,) if hpi_plane is not None else ()
    return fn(table, counts, hpi, *plane, qt, qh, qv)


def _mesh_fused_match(audio, lengths, table, counts, hpi, hpi_plane, mesh,
                      pcfg, tcfg, mcfg, qcap: int) -> torch.Tensor:
    """The fused fingerprint + match on a mesh (sharded.
    sharded_fused_match_cached), as its graphs capture it; the rows and
    readback row of _fused_match_graph.  B must be a multiple of the mesh
    size."""
    from audfprint_torch.parallel import sharded

    fn = sharded.sharded_fused_match_cached(mesh, pcfg, tcfg, mcfg, qcap,
                                            hpi_plane is not None)
    plane = (hpi_plane,) if hpi_plane is not None else ()
    return fn(table, counts, hpi, *plane, audio, lengths)


def _pad_rows(arrays, n: int) -> tuple:
    """Host arrays with their first axis padded by zeros to a multiple of
    n (the mesh paths split the batch over the shards)."""
    pad = -arrays[0].shape[0] % n
    if not pad:
        return tuple(arrays)
    return tuple(np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                 for a in arrays)


def _shards_per_device(mesh) -> int:
    """The most local shards of the mesh that share one device."""
    return max(mesh.devices.count(d) for d in set(mesh.devices))


def sweep_factors(pct: float) -> list:
    """+/-pct% speed-correction factors in 1% steps, unity excluded."""
    k = min(10, int(round(abs(pct))))
    return [1.0 + i / 100.0 for i in range(-k, k + 1) if i]


def slice_hash_windows(hashes, dur: float, window_sec: float, fps: float,
                       hop_sec: float = 0.0) -> list:
    """Slice one query's (t, hash) rows into overlapping time windows in
    the hash domain.  Returns [(t0_sec, hashes_shifted, win_dur_sec)] per
    window; hop defaults to window/2, and the tail remainder gets its own
    window only when offset by at least hop/2 from the last grid window."""
    ww = max(1, int(round(window_sec * fps)))
    hh = max(1, int(round((hop_sec if hop_sec > 0 else window_sec / 2)
                          * fps)))
    nf = max(1, int(round(dur * fps)))
    starts = list(range(0, max(1, nf - ww + 1), hh))
    if nf - ww - starts[-1] >= max(1, hh // 2):
        starts.append(nf - ww)
    h = np.asarray(hashes).reshape(-1, 2)
    out = []
    for t0 in starts:
        sel = h[(h[:, 0] >= t0) & (h[:, 0] < t0 + ww)].copy()
        sel[:, 0] -= t0
        out.append((t0 / fps, sel, min(ww, nf - t0) / fps))
    return out


class Matcher:
    def __init__(self,
                 window: int = P.MATCH_WIN,
                 threshcount: int = P.MIN_COUNT,
                 max_returns: int = P.MAX_MATCHES,
                 search_depth: int = P.SEARCH_DEPTH,
                 exact_count: bool = False,
                 find_time_range: bool = False,
                 time_quantile: float = P.TIME_QUANTILE,
                 sort_by_time: bool = False,
                 verbose: int = 1,
                 illustrate: bool = False,
                 illustrate_hpf: bool = False,
                 sonify: bool = False,
                 ndev: int | None = 1,
                 device=None):
        self.device = resolve_device(device)
        self.window = window
        self.threshcount = threshcount
        self.max_returns = max_returns
        self.search_depth = search_depth
        self.exact_count = exact_count
        self.find_time_range = find_time_range
        self.time_quantile = time_quantile
        self.sort_by_time = sort_by_time
        self.verbose = verbose
        self.illustrate = illustrate
        self.illustrate_hpf = illustrate_hpf
        self.sonify = sonify
        # shards for table-sharded matching: 1 = the single-device cores;
        # None / 0 = one per local device; N = N shards placed round-robin
        # on the local devices (on `device` when it is the CPU).  The rows
        # are bit-identical at any ndev.
        self.ndev = ndev
        self._dev = None          # (weakref to ht, revision) -> device state
        self._fallback_dev = None
        # the captured graphs, one per shape key: the fused path's and the
        # two-stage path's vote on one device, and their mesh counterparts,
        # made with each staged mesh (_device_state), whose keys carry it:
        # None while no mesh is staged yet
        self._graphs = graphs.GraphCache(_fused_match_graph, self.device)
        self._votes = graphs.GraphCache(_two_stage_vote, self.device)
        self._mesh_graphs = self._mesh_votes = None

    # Device-memory budget for one voting call; None = derive from the
    # device on first use.  Set it to split batches on small devices.
    mem_budget_bytes: int | None = None

    # Per-entry hashesperid plane for the sorted core's candidate ranking
    # (DT.build_hpi_plane): one more table-shaped int32 buffer, built once
    # per staged table, replaces the per-batch hashesperid[id] gather of
    # every hit.  None = auto, which leaves it off; True builds it.
    use_hpi_plane: bool | None = None

    # Pin the voting core ("hist" | "sorted"); None = the sorted core.
    # Both give the same rows; the histogram core's buffers scale with
    # search_depth x (maxtime + qt_cap) per query row.
    force_core: str | None = None

    # Pin the fused path's static query-hash cap (None = estimate per
    # bucket from density); a low cap only re-routes rows two-stage.
    fused_qcap: int | None = None

    # -- device cache -----------------------------------------------------

    def _resolved_ndev(self, ht) -> int:
        from audfprint_torch.parallel import sharded
        n = sharded.resolve_ndev(self.ndev, self.device)
        if n > 1 and (1 << ht.hashbits) % n:
            if self.verbose and getattr(self, "_ndev_noted", None) != n:
                self._ndev_noted = n      # note once, not per batch
                print(f"Note: hashbits={ht.hashbits} table not divisible "
                      f"over {n} devices; matching single-device")
            return 1
        return n

    def _device_state(self, ht):
        """(table, counts, hpi, tcfg, ncap, mesh, plane) on the device(s),
        cached on a weak reference to the HashTable plus its mutation
        counter and the shard count.  With a mesh, table, counts and plane
        are lists of the local shards' tensors."""
        rev = getattr(ht, "rev", None)
        ndev = self._resolved_ndev(ht)
        if self._dev is None or self._dev[0]() is not ht \
                or self._dev[1] != (rev, ndev):
            # the graphs read the old tensors: drop them before re-staging
            self._clear_graphs()
            ncap = _next_pow2(max(1, len(ht.names)), 256)
            hpi = np.zeros(ncap, np.int32)
            hpi[: len(ht.hashesperid)] = np.minimum(ht.hashesperid,
                                                    2**31 - 1)
            if ndev > 1:
                from audfprint_torch.parallel import sharded
                mesh = sharded.make_mesh(
                    ndev, sharded.mesh_devices(self.device))
                table, counts, tcfg = sharded.upload_sharded(ht, mesh)
                self._mesh_graphs = graphs.GraphCache(_mesh_fused_match,
                                                      mesh)
                self._mesh_votes = graphs.GraphCache(_mesh_vote, mesh)
                hpi_dev = torch.as_tensor(hpi, device=mesh.devices[0])
                plane = None
                if self.use_hpi_plane:
                    plane = [DT.build_hpi_plane(t, h, tcfg) for t, h in
                             zip(table, mesh.replicate(hpi_dev))]
            else:
                mesh = None
                table, counts, tcfg = DT.table_to_device(ht, self.device)
                hpi_dev = torch.as_tensor(hpi, device=self.device)
                plane = self._maybe_hpi_plane(table, hpi_dev, tcfg)
            self._dev = (weakref.ref(ht), (rev, ndev), table, counts,
                         hpi_dev, tcfg, ncap, mesh, plane)
        return self._dev[2:]

    def _maybe_hpi_plane(self, table, hpi_dev, tcfg):
        return (DT.build_hpi_plane(table, hpi_dev, tcfg)
                if self.use_hpi_plane else None)

    def invalidate(self):
        """Drop the cached device tables and the graphs that read them;
        the next match stages anew."""
        self._dev = None
        self._fallback_dev = None
        self._clear_graphs()

    def _clear_graphs(self):
        for cache in (self._graphs, self._votes, self._mesh_graphs,
                      self._mesh_votes):
            if cache is not None:
                cache.clear()

    # -- core -------------------------------------------------------------

    def _budget_bytes(self) -> int:
        """Voting memory budget, which the captured graphs' bytes count
        against too: a third of the device's memory, between 256 MiB and
        8 GiB (4 GiB on the CPU; graphs.budget_bytes)."""
        if self.mem_budget_bytes is not None:
            return self.mem_budget_bytes
        return graphs.budget_bytes(self.device)

    def _sorted_bytes_per_row(self, tcfg, Q: int, mesh=None) -> int:
        """Footprint of the sorted core per query row, in int64 hit-domain
        arrays (Q * depth * 8 bytes each).  The arrays live at its peak,
        counted on the CPU by tests/test_torch_vote_memory.py, are at most
        12 for the approximate count, 17 with exact counting, and 4 more
        with the time range; each budget leaves 4 to spare for a sort's
        scratch on the card (the plane's int32 payload fits in them).  On a
        mesh every shard gathers its hits for all rows before the exchange
        and holds its exchanged slice after it, one array per operand each
        time, while the votes run one shard after another: shards that
        share a device add 2 arrays per operand each."""
        units = (16 + (5 if self.exact_count else 0)
                 + (4 if self.find_time_range else 0))
        if mesh is not None:
            units += (2 * _shards_per_device(mesh)
                      * (1 + self.find_time_range + bool(self.use_hpi_plane)))
        return units * Q * tcfg.depth * 8

    def _voting_bytes_per_row(self, tcfg, qt_cap: int, Q: int = 0,
                              mesh=None) -> int:
        """Footprint of the histogram core per query row: its (SD + 1) x
        (maxtime + qt_cap) int32 bin-domain buffers, of which at most 3
        are live at once for the approximate count and 4 with exact
        counting (counted on the CPU by tests/test_torch_vote_memory.py;
        one more is budgeted for scratch), the (SD + 1) x qt_cap pair of
        the time range, and 12 int64 hit-domain arrays.  Shards of a mesh
        that share a device hold their buffers at the same time."""
        SD = self.search_depth
        nbins = tcfg.maxtime + qt_cap
        per = (5 if self.exact_count else 4) * (SD + 1) * (nbins + 8) * 4
        if self.find_time_range:
            per += 2 * (SD + 1) * qt_cap * 4
        per += 12 * Q * tcfg.depth * 8
        return per * (_shards_per_device(mesh) if mesh is not None else 1)

    def sub_batch(self, B: int, tcfg, Q: int, per_row: int | None = None
                  ) -> int:
        """Rows per voting call for B query rows of Q hashes: the memory
        envelope only ever splits the batch (power-of-two sub-batches),
        never the query."""
        if per_row is None:
            per_row = self._sorted_bytes_per_row(tcfg, Q)
        cap = max(1, self._budget_bytes() // max(1, per_row))
        bsub = _next_pow2(B)
        if bsub > cap:
            bsub = 1 << max(0, cap.bit_length() - 1)
        return bsub

    def _mcfg(self, qt_cap: int, ncap: int) -> voting.MatchConfig:
        return voting.MatchConfig(
            window=self.window, threshcount=self.threshcount,
            max_returns=self.max_returns, search_depth=self.search_depth,
            exact_count=self.exact_count,
            find_time_range=self.find_time_range,
            time_quantile=self.time_quantile,
            sort_by_time=self.sort_by_time,
            qt_cap=qt_cap, n_ids_cap=ncap,
            modes_cap=max(1, self.max_returns))

    def match_hashes(self, ht, hashes) -> np.ndarray:
        """Query (t, hash) rows -> (k, 6) int64 result rows
        [id, filtcount, mode_dt, rawcount, min_t, max_t]."""
        return self.match_hashes_batch(ht, [np.asarray(hashes)])[0]

    def match_hashes_batch(self, ht, hash_lists) -> list:
        (table, counts, hpi, tcfg, ncap, mesh,
         hpi_plane) = self._device_state(ht)
        B = len(hash_lists)
        maxn = max([1] + [len(h) for h in hash_lists])
        Q = _next_pow2(maxn, 128)
        maxt = max([1] + [int(h[:, 0].max()) + 1 for h in hash_lists
                          if len(h)])
        qt_cap = _next_pow2(maxt, _QT_FLOOR)
        # the sorted core everywhere: its memory is independent of maxtime
        # and query length, so the envelope only ever splits the batch; on
        # a mesh the same vote runs after the hit exchange.  force_core
        # pins the histogram core (the equivalence reference).  The vote
        # replays its captured graphs on one device, on a mesh of logical
        # shards of one device and on the mesh's fallback below; a mesh
        # over several devices or processes runs it eagerly.
        core = self.force_core or "sorted"
        votes = self._votes if mesh is None else self._mesh_votes
        if core not in ("sorted", "hist"):
            raise ValueError(f"unknown voting core {core!r}")
        if mesh is not None and core == "hist" and self._voting_bytes_per_row(
                tcfg, qt_cap, Q, mesh) > self._budget_bytes():
            # a query too long for even one row's histogram buffers on the
            # mesh drops to one device (bit-identical); that device's
            # state is cached per table revision
            if self.verbose:
                print("Note: query exceeds the sharded voting memory "
                      "envelope; matching this batch single-device")
            rev = getattr(ht, "rev", None)
            fb = self._fallback_dev
            if fb is None or fb[0]() is not ht or fb[1] != rev:
                table, counts, tcfg = DT.table_to_device(ht, self.device)
                hpi = hpi.to(self.device)
                hpi_plane = self._maybe_hpi_plane(table, hpi, tcfg)
                self._fallback_dev = (weakref.ref(ht), rev, table, counts,
                                      tcfg, hpi, hpi_plane)
            else:
                table, counts, tcfg, hpi, hpi_plane = fb[2:]
            mesh = None
            core = "sorted"
            votes = self._votes
        if core == "hist":
            per_row = self._voting_bytes_per_row(tcfg, qt_cap, Q, mesh)
        else:
            per_row = self._sorted_bytes_per_row(tcfg, Q, mesh)
        bsub = self.sub_batch(B, tcfg, Q, per_row)
        if bsub < B and self.verbose:
            print(f"Note: using the {core} voting core, "
                  f"splitting {B} queries into sub-batches of {bsub} "
                  f"(voting buffers ~{per_row >> 20} MiB/query at "
                  f"qt_cap={qt_cap}, search_depth={self.search_depth})")
        results = []
        for i in range(0, B, bsub):
            chunk = list(hash_lists[i: i + bsub])
            pad = bsub - len(chunk)
            chunk += [np.zeros((0, 2), np.int32)] * pad
            rows = self._match_padded(table, counts, hpi, tcfg, ncap,
                                      chunk, Q, qt_cap, core, mesh,
                                      hpi_plane, votes, per_row * bsub)
            results.extend(rows[: len(rows) - pad] if pad else rows)
        return results

    def _match_padded(self, table, counts, hpi, tcfg, ncap,
                      hash_lists, Q: int, qt_cap: int, core: str = "sorted",
                      mesh=None, hpi_plane=None, votes=None,
                      need: int = 0) -> list:
        """One sub-batch of query (t, hash) lists -> its rows.  `votes`
        (a GraphCache of _two_stage_vote, or of _mesh_vote on a mesh)
        replays the graph of the vote's key, (rows, Q, qt_cap, [mesh,]
        tcfg, mcfg, core, plane present), where it captures, and runs the
        vote directly elsewhere; `need` is its capture's byte estimate
        for the budget rule (GraphCache.reserve) under the vote's
        budget."""
        B = len(hash_lists)
        mcfg = self._mcfg(qt_cap, ncap)
        inputs = DT.pad_hashes(
            [np.asarray(h).reshape(-1, 2) for h in hash_lists], B, Q)
        state = (table, counts, hpi, hpi_plane if core == "sorted" else None)
        if mesh is None:
            static = (tcfg, mcfg, core)
        else:
            static = (mesh, tcfg, mcfg, core)
            if core == "sorted":
                # the RLE exchange splits the batch axis over the mesh: pad
                # B to a multiple of ndev with empty rows, dropped below
                inputs = _pad_rows(inputs, mesh.size)
        votes.reserve([(inputs, state, static, need)], self._budget_bytes())
        out = votes(inputs, state, static)[:B].cpu().numpy()
        return [out[b, : int(out[b, :, 6].sum()), :6].astype(np.int64)
                for b in range(B)]

    def match_hashes_windowed(self, ht, hashes, dur: float,
                              window_sec: float, fps: float,
                              hop_sec: float = 0.0) -> list:
        """Broadcast monitoring over one long query: hash-domain window
        slicing (slice_hash_windows) and one batched match over all
        windows.  fps = analyzer.target_sr / analyzer.n_hop.  Returns
        [(t0_sec, rows, n_window_hashes, win_dur_sec)]."""
        wins = slice_hash_windows(hashes, dur, window_sec, fps, hop_sec)
        res = self.match_hashes_batch(ht, [h for _, h, _ in wins])
        return [(t0, rows, len(h), wdur)
                for (t0, h, wdur), rows in zip(wins, res)]

    def match_samples_sweep(self, analyzer, ht, samples: list, pct: float,
                            base_hashes: list | None = None) -> list:
        """Batched match with a query playback-speed correction sweep:
        each query is also fingerprinted at +/-pct% time-scale corrections
        in 1% steps, all variants are matched in one batch, and the best
        rank-0 aligned count wins, unity on ties.

        samples[i] = float32/int16 sample array, or None to match only
        base_hashes[i] (a precomputed input has no audio).  base_hashes:
        the (t, hash) arrays aligned with samples (computed when omitted).
        Returns [(rows, factor, nhash_of_winner)] per query."""
        factors = sweep_factors(pct)
        if base_hashes is None:
            it = iter(analyzer.samples_batch2hashes(
                [s for s in samples if s is not None]))
            base_hashes = [next(it) if s is not None
                           else np.zeros((0, 2), np.int32) for s in samples]
        sigs, meta = [], []
        for i, d in enumerate(samples):
            if d is None or not factors:
                continue
            if d.dtype == np.int16:
                d = d.astype(np.float32) / float(1 << 15)
            for f in factors:
                # the integer ratio 100 : 100 + pct, as in the JAX package
                sigs.append(audio_io._resample(
                    d, 100, 100 + round((f - 1) * 100)))
                meta.append((i, f))
        vlists = analyzer.samples_batch2hashes(sigs) if sigs else []
        results = self.match_hashes_batch(ht, list(base_hashes) + vlists)

        def score(rr):
            return int(rr[0][1]) if len(rr) else 0

        best = [(rr, 1.0, len(h)) for rr, h in zip(results, base_hashes)]
        for (i, f), rr, h in zip(meta, results[len(base_hashes):], vlists):
            if score(rr) > score(best[i][0]):      # unity wins ties
                best[i] = (rr, f, len(h))
        return best

    # -- fused fast path ---------------------------------------------------

    def match_samples_fused_async(self, analyzer, ht, signals: list):
        """Queue the fused fingerprint+match for a list of sample arrays.
        Returns a handle for match_fused_resolve, or None when the
        histogram core is pinned or the voting buffers pass the memory
        budget: every group's where the groups run eagerly, each key's
        once where they replay graphs (the caller then takes the
        two-stage path).
        On one device each group replays the captured graph of its key
        (rows, bucket length, int16 or float32 input, qcap, the configs,
        the hpi plane), capturing it on the key's first call after the
        budget rule (GraphCache.admit).  On a mesh each group, its rows
        padded to a multiple of the mesh size, goes through sharded.
        sharded_fused_match_cached (_mesh_fused_match): every shard
        fingerprints its slice of the batch, then the hit exchange and
        the vote; same readback row, same rows as the two-stage mesh
        path.  A mesh of logical shards of one device replays its graphs
        as one device does, the key carrying the mesh; a mesh over
        several devices or processes runs eagerly."""
        (table, counts, hpi, tcfg, ncap, mesh,
         hpi_plane) = self._device_state(ht)
        if self.force_core == "hist":
            return None
        mcfg = self._mcfg(_QT_FLOOR, ncap)
        budget = self._budget_bytes()
        groups = analyzer.stage_groups(signals)
        state = (table, counts, hpi, hpi_plane)
        cache = self._graphs if mesh is None else self._mesh_graphs
        idxs_of, calls = [], []
        for idxs, batch, lens in groups:
            # static query-hash cap per bucket: ~density unique hashes/s,
            # 1.5x + 64 headroom; an underestimate only costs a re-match
            dur = batch.shape[1] / float(analyzer.target_sr)
            qcap = self.fused_qcap or _next_pow2(
                int(dur * analyzer.density * 1.5) + 64, 128)
            static = (analyzer.config, tcfg, mcfg, qcap)
            if mesh is not None:
                batch, lens = _pad_rows((batch, lens), mesh.size)
                static = (mesh,) + static
            idxs_of.append(idxs)
            calls.append(((batch, lens), state, static,
                          self._sorted_bytes_per_row(tcfg, qcap, mesh)
                          * len(lens)))
        if not cache.admit(calls, budget):
            return None
        outs = [(idxs, cache(*call[:3])) for idxs, call in zip(idxs_of, calls)]
        return (len(signals), outs, signals)

    def match_fused_resolve(self, analyzer, ht, handle) -> tuple:
        """Materialise match_samples_fused_async results: one copy per
        dispatch group; rows flagged ineligible by the readback row
        re-match two-stage.  Returns (result rows list, n_hashes list)."""
        n, outs, signals = handle
        results: list = [None] * n
        nhash = [0] * n
        redo = []
        for idxs, dev_out in outs:
            out = dev_out.cpu().numpy()
            R = out.shape[1] - 1
            for row, i in enumerate(idxs):
                cnt_i, maxt_i, qce = (int(x) for x in out[row, R, :3])
                nhash[i] = cnt_i
                if cnt_i > qce or maxt_i + 1 > _QT_FLOOR:
                    redo.append(i)
                    continue
                nres = int(out[row, :R, 6].sum())
                results[i] = out[row, :nres, :6].astype(np.int64)
        if redo:
            hashes = analyzer.samples_batch2hashes(
                [signals[i] for i in redo])
            for i, h, r in zip(redo, hashes,
                               self.match_hashes_batch(ht, hashes)):
                results[i] = r
                nhash[i] = len(h)
        return results, nhash

    def match_samples_fused(self, analyzer, ht, signals: list):
        """Blocking form of the async/resolve pair; None when ineligible."""
        handle = self.match_samples_fused_async(analyzer, ht, signals)
        if handle is None:
            return None
        return self.match_fused_resolve(analyzer, ht, handle)

    # -- file-level API -----------------------------------------------------

    def match_file(self, analyzer, ht, filename: str, number=None):
        """Analyze one file and match it -> (rows, dur, nhash)."""
        hashes = analyzer.wavfile2hashes(filename)
        dur = analyzer.soundfiledur
        rows = self.match_hashes(ht, hashes)
        if self.verbose > 1:
            print(f"Analyzed {filename} of {dur:.3f} s "
                  f"to {len(hashes)} hashes")
        return rows, dur, len(hashes)

    def file_match_to_msgs(self, analyzer, ht, qry: str, number=None):
        """Match one file, return the canonical output message lines."""
        rslts, dur, nhash = self.match_file(analyzer, ht, qry, number)
        return self.results_to_msgs(rslts, dur, nhash, analyzer, ht, qry)

    def results_to_msgs(self, rslts, dur, nhash, analyzer, ht, qry):
        t_hop = analyzer.n_hop / float(analyzer.target_sr)
        qrymsg = f"{qry} {dur:.1f} sec {nhash} raw hashes" if self.verbose \
            else qry
        msgrslt = []
        if len(rslts) == 0:
            msgrslt.append("NOMATCH " + qrymsg if self.verbose
                           else qrymsg + "\t")
        for rank, row in enumerate(rslts):
            (tophitid, nhashaligned, aligntime, nhashraw,
             min_time, max_time) = (int(x) for x in row[:6])
            name = ht.names[tophitid]
            if not self.verbose:
                msgrslt.append(qrymsg + "\t" + name)
            elif self.find_time_range:
                msgrslt.append(
                    f"Matched {(max_time - min_time) * t_hop:6.1f} s "
                    f"starting at {min_time * t_hop:6.1f} s in {qry} "
                    f"to time {(min_time + aligntime) * t_hop:6.1f} s "
                    f"in {name} with {nhashaligned} of {nhashraw} "
                    f"common hashes at rank {rank}")
            else:
                msgrslt.append(f"Matched {qrymsg} as {name} "
                               f"at {aligntime * t_hop:.1f} s "
                               f"with {nhashaligned} of {nhashraw} "
                               f"common hashes at rank {rank}")
        if self.illustrate or self.illustrate_hpf:
            self.illustrate_match(analyzer, ht, qry)
        if self.sonify:
            self.sonify_match(analyzer, ht, qry)
        return msgrslt

    # -- diagnostics --------------------------------------------------------

    def _matched_rows(self, ht, hashes, rows) -> set:
        """(t, hash) query rows aligned with the rank-0 match: hits of its
        track within +/-window of its mode dt (host get_hits)."""
        if not len(rows):
            return set()
        mode, tid = int(rows[0][2]), int(rows[0][0])
        hits = ht.get_hits(hashes)
        alig = hits[(hits[:, 0] == tid)
                    & (np.abs(hits[:, 1] - mode) <= self.window)]
        return {(int(q), int(h)) for h, q in zip(alig[:, 2], alig[:, 3])}

    def illustrate_match(self, analyzer, ht, filename: str,
                         out_png: str | None = None,
                         show: bool | None = None,
                         hpf: bool | None = None):
        """Spectrogram + landmark overlay with the matched landmarks
        highlighted (the JAX package's illustrate_match).

        hpf=None follows the matcher's flags: `-I` draws the plain
        whitened log-magnitude spectrogram, `-J` the onset-high-passed
        one.  show=None displays when a display exists and no out_png was
        asked for, else saves <filename>.match.png."""
        import os
        if show is None:
            show = out_png is None and bool(
                os.environ.get("DISPLAY")
                or os.environ.get("MPLBACKEND", "").lower()
                not in ("", "agg"))
        try:
            import matplotlib
            if not show:
                matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("illustrate_match: matplotlib not available; skipping")
            return None
        from audfprint_torch.oracle import analyze as oa

        if hpf is None:
            hpf = bool(self.illustrate_hpf)
        d = analyzer.read_audio(filename)
        sg = oa.spectrogram(d, P.AnalyzerParams(
            density=analyzer.density, n_fft=analyzer.n_fft,
            n_hop=analyzer.n_hop, f_sd=analyzer.f_sd), hpf=hpf)
        hashes = analyzer.samples2hashes(d)
        rows = self.match_hashes(ht, hashes)
        fig, ax = plt.subplots(figsize=(12, 5))
        ax.imshow(sg.T, origin="lower", aspect="auto", cmap="magma")
        for t, f1, f2, dt in oa.hashes2landmarks(hashes):
            ax.plot([t, t + dt], [f1, f2], "-", color="c", lw=0.6)
        if len(rows):
            qmatch = self._matched_rows(ht, hashes, rows)
            matched = [(int(r[0]), int(r[1])) for r in hashes
                       if (int(r[0]), int(r[1])) in qmatch]
            for t, f1, f2, dt in oa.hashes2landmarks(
                    np.array(matched, dtype=np.int64).reshape(-1, 2)):
                ax.plot([t, t + dt], [f1, f2], "-", color="lime", lw=1.2)
            ax.set_title(f"{filename}: matched {ht.names[int(rows[0][0])]} "
                         f"dt={int(rows[0][2])} frames")
        else:
            ax.set_title(f"{filename}: NOMATCH")
        if show:
            plt.show()
            plt.close(fig)
            return None
        out_png = out_png or filename + ".match.png"
        fig.savefig(out_png, dpi=90)
        plt.close(fig)
        print(f"illustrate_match: wrote {out_png}")
        return out_png

    def sonify_match(self, analyzer, ht, filename: str,
                     out_wav: str | None = None):
        """Resynthesize the query's landmarks as sine-pair chirps, the
        matched ones louder (the JAX package's sonify_match).  Writes
        <filename>.sonify.wav."""
        from audfprint_torch.oracle import analyze as oa

        sr = analyzer.target_sr
        d = analyzer.read_audio(filename)
        hashes = analyzer.samples2hashes(d)
        matched = self._matched_rows(ht, hashes,
                                     self.match_hashes(ht, hashes))
        out = np.zeros(len(d), np.float32)
        t_hop = analyzer.n_hop
        bin_hz = sr / float(analyzer.n_fft)
        for (t, f1, f2, dt), (tq, hsh) in zip(
                oa.hashes2landmarks(hashes),
                ((int(r[0]), int(r[1])) for r in hashes)):
            amp = 0.5 if (tq, hsh) in matched else 0.12
            s0 = t * t_hop
            n = max(1, int(dt * t_hop))
            m = min(n, len(out) - s0)       # clip chirps at the buffer end
            if m <= 0:
                continue
            tt = np.arange(n) / sr
            env = np.hanning(n) if n > 1 else np.ones(1)
            seg = 0.5 * np.sin(2 * np.pi * f1 * bin_hz * tt)
            seg += 0.5 * np.sin(2 * np.pi * f2 * bin_hz * tt)
            out[s0: s0 + m] += (amp * env * seg)[:m].astype(np.float32)
        peak = float(np.abs(out).max())
        if peak > 0:
            out = out / peak * 0.7
        out_wav = out_wav or filename + ".sonify.wav"
        audio_io.audio_write_wav(out_wav, out, sr)
        print(f"sonify_match: wrote {out_wav}")
        return out_wav
