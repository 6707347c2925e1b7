"""Fused device ingest (port of audfprint_tpu/models/ingest.py).

`--device-store` keeps the hash table on the device for the whole run:
every chunk of decoded audio is fingerprinted and stored in one pass
whose (t, hash) rows never reach the host; the host fetches only the
per-file unique counts (for names, hashesperid and the report lines), and
`finalize()` downloads the table into the host HashTable, the persistence
mirror.

  one device : fingerprint_batch -> store_batch_local
               (fused_ingest_graph), and the store of host hashes
               (store_batch), each replayed as a captured CUDA graph per
               shape key on a CUDA device (utils/graphs.GraphCache), as
               the JAX package jits them with the table donated.
  a mesh     : each shard fingerprints its block of the chunk's batch,
               packs the entries, and routes every (hash, entry) pair to
               the shard that owns its bucket with one all_to_all, under a
               cap with 2x headroom; then the local deterministic-
               reservoir store (sharded_fused_ingest_fn).  A cap overflow
               masks every write and returns ok = 0, and the caller
               replays the chunk through the replicated store, so the
               result is the same either way.  On a mesh of logical
               shards of one device in one process the routed ingest,
               the store of host hashes and the overflow replay are
               captured graphs too, the shards' tables and counts their
               state; a mesh over several devices or processes runs them
               eagerly (each cache decides: GraphCache.replays).

Bit-identical to the sequential host store by construction: the reservoir
is keyed by (global bucket, position), the batch is cut into contiguous
file blocks, and the all_to_all receives source-major and stable within a
source, which keeps the file-major insertion order of every bucket.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.ops.config import PipelineConfig
from audfprint_torch.index import device_table as DT
from audfprint_torch.models.analyzer import _bucket_len
from audfprint_torch.ops import pipeline as pipe
from audfprint_torch.ops import scan as SC
from audfprint_torch.utils import graphs, timing


def fused_ingest_graph(table: torch.Tensor, counts: torch.Tensor,
                       audio: torch.Tensor, lengths: torch.Tensor,
                       ids: torch.Tensor, pcfg: PipelineConfig,
                       tcfg: DT.TableConfig):
    """Audio batch -> hashes -> stored table, updated in place; returns
    (table, counts, per-file unique hash counts (B,)).  Semantics ==
    sequential HashTable.store of file 0, then file 1, ..."""
    t, h, uniq, cnt = pipe.fingerprint_batch(audio, lengths, pcfg)
    DT.store_batch_local(table, counts, t, h, uniq, ids, tcfg, 0)
    return table, counts, cnt


def _ingest_step(audio, lengths, ids, table, counts, pcfg: PipelineConfig,
                 tcfg: DT.TableConfig) -> torch.Tensor:
    """fused_ingest_graph as its graph cache calls it (inputs, then the
    state it updates, then the static key) -> the per-file unique counts."""
    return fused_ingest_graph(table, counts, audio, lengths, ids, pcfg,
                              tcfg)[2]


def _store_step(times, hashes, valid, ids, table, counts,
                tcfg: DT.TableConfig) -> None:
    """DT.store_batch as its graph cache calls it."""
    DT.store_batch(table, counts, times, hashes, valid, ids, tcfg)


def _ingest_bytes(rows: int, n: int, pcfg: PipelineConfig) -> int:
    """An estimate of the device bytes a (rows, n) fused ingest keeps
    live: the fingerprint's, and the store's over every landmark slot."""
    T = pipe.n_frames_padded_static(n, pcfg)
    slots = rows * pcfg.shifts * T * pcfg.maxpksperframe * \
        pcfg.maxpairsperpeak
    return pipe.fingerprint_bytes(rows, n, pcfg) + DT.store_bytes(slots)


def _pack_entries(t, h, uniq, ids, tcfg: DT.TableConfig):
    """(B, L) streams -> flat (hash, entry, valid) in file-major order,
    packed as store_batch_local packs them: the entry (id << maxtimebits)
    | t in one int64 word, a uint32 value or, for a wide table, the whole
    uint64."""
    B, L = h.shape
    entry = ((ids.to(torch.int64)[:, None].expand(B, L) << tcfg.maxtimebits)
             | (t.to(torch.int64) & (tcfg.maxtime - 1)))
    if not tcfg.wide:
        entry = entry & 0xFFFFFFFF
    hf = h.to(torch.int64) & ((1 << tcfg.hashbits) - 1)
    return hf.reshape(-1), entry.reshape(-1), uniq.reshape(-1)


def _route(hf, entry, vf, n_local: int, ndev: int, cap: int):
    """One shard's send buffers for the routed ingest: its valid rows in a
    stable order by destination shard, the first `cap` of each destination
    in that destination's block.  Returns ([send_h, send_e, send_v], each
    (ndev, cap), ok): ok is False when a destination got more than cap
    rows.  A row that does not go is written to one spare slot past the
    blocks, sliced off here (an index out of range is an error on the
    card)."""
    dev = hf.device
    dest = torch.where(vf, hf // n_local, ndev)
    ds, order = torch.sort(dest, stable=True)
    iota = torch.arange(ds.shape[0], device=dev)
    first = torch.ones_like(vf)
    first[1:] = ds[1:] != ds[:-1]
    rank = iota - SC.cummax(torch.where(first, iota, 0))
    ok = ~((ds < ndev) & (rank >= cap)).any()
    wv = (ds < ndev) & (rank < cap)
    slot = torch.where(wv, ds * cap + rank, ndev * cap)
    ops = []
    for src in (hf[order], entry[order], wv):
        buf = torch.zeros(ndev * cap + 1, dtype=src.dtype, device=dev)
        buf[slot] = src
        ops.append(buf[:-1].view(ndev, cap))
    return ops, ok


def _routed_step(audio, lengths, ids, table, counts, mesh,
                 pcfg: PipelineConfig, tcfg: DT.TableConfig,
                 cap_override: int | None) -> torch.Tensor:
    """sharded_fused_ingest_fn as its graph cache calls it -> the per-file
    unique counts with the ok flag appended."""
    return sharded_fused_ingest_fn(mesh, pcfg, tcfg, cap_override)(
        table, counts, audio, lengths, ids)


def _replay_step(audio, lengths, ids, table, counts, mesh,
                 pcfg: PipelineConfig, tcfg: DT.TableConfig) -> torch.Tensor:
    """The routing-cap overflow's way round, as its graph cache calls it:
    every shard fingerprints its block again (sharded.dp_fingerprint_fn)
    and the whole chunk's streams go through the replicated store ->
    the per-file unique counts."""
    from audfprint_torch.parallel import sharded

    t, h, uniq, cnt = sharded.dp_fingerprint_fn(mesh, pcfg)(audio, lengths)
    sharded.store_step(t, h, uniq, ids, table, counts, mesh, tcfg)
    return cnt


@functools.lru_cache(maxsize=32)
def sharded_fused_ingest_fn(mesh, pcfg: PipelineConfig, tcfg: DT.TableConfig,
                            cap_override: int | None = None):
    """Returns fn(table, counts, audio, lengths, ids) -> cnt_and_ok on a
    bucket-sharded mesh; the table's and counts' shards are updated in
    place.

    cnt_and_ok is a (B + 1,) tensor: the per-file unique counts with the ok
    flag appended, so one small fetch resolves the chunk.  ok == 0 means a
    routing-cap overflow masked every write (table unchanged); the caller
    replays the chunk through the replicated store.  cap_override forces
    the routing cap (None = the cap with 2x headroom)."""
    from audfprint_torch.parallel import sharded

    ndev = mesh.size
    n_local = sharded.buckets_per_shard(mesh, tcfg)

    def fn(table, counts, audio, lengths, ids):
        a_l, n_l, i_l = sharded.split_batch(mesh, audio, lengths, ids)
        sends, oks, cnts = [], [], []
        for l in range(mesh.n_local):
            t, h, uniq, cnt = pipe.fingerprint_batch(a_l[l], n_l[l], pcfg)
            hf, entry, vf = _pack_entries(t, h, uniq, i_l[l], tcfg)
            # uniform hashing spreads the valid hashes evenly over the
            # shards, and they are few beside the flat capacity: twice
            # that capacity per destination is ample headroom
            cap = cap_override or P.next_pow2(
                max(128, (2 * hf.shape[0]) // ndev))
            ops, ok = _route(hf, entry, vf, n_local, ndev, cap)
            sends.append(ops)
            oks.append(ok.to(torch.int32))
            cnts.append(cnt)
        if ndev > 1:
            recv = [mesh.all_to_all([s[i] for s in sends], 0, 0)
                    for i in range(3)]
            ok = mesh.all_reduce(oks, "min")
            cnt = mesh.all_gather(cnts, 0)[0]
        else:
            recv = [[sends[0][i]] for i in range(3)]
            ok, cnt = oks, cnts[0]
        del sends
        for l in range(mesh.n_local):
            DT.store_packed_local(
                table[l], counts[l], recv[0][l].reshape(-1),
                recv[1][l].reshape(-1),
                recv[2][l].reshape(-1) & (ok[l] > 0), tcfg,
                (mesh.first + l) * n_local)
        return torch.cat([cnt, ok[0][None].to(cnt)])

    return fn


class DeviceIngest:
    """Device-resident ingest for the CLI: the table lives on the
    analyzer's device, or sharded over `ndev` shards, for the whole run
    (uploaded once, or born empty for `new`), every chunk is one fused
    fingerprint + store pass and one small counts fetch, and `finalize()`
    downloads the result into the host HashTable with a fetch sized by the
    stored entries.  On a mesh, parallel.sharded's replicated store
    stays the path of precomputed files and of the overflow replay.

    Each pass is a call of a graph cache made for the device or the
    mesh: the fused ingest (`_ingest`), the store of host hashes
    (`_store`) and, on a mesh, the overflow replay (`_replay`), the table
    and counts (or the lists of their shards) being the state.  The cache
    replays one captured graph per shape key where its placement captures
    (one device, or a mesh of logical shards of one device in one
    process) and runs the same functions eagerly elsewhere.
    cap_override forces the mesh's routing cap (None = the cap with 2x
    headroom); it is part of the routed ingest's key.

    A chunk of audio is staged in a slot (_Slot) that holds its padded
    batch, lengths and ids and gets its counts back: pinned host memory
    on a CUDA device, which the graph copies from directly, the counts
    copied back right after the chunk's own replay and an event recorded
    after them.  Its rows are copied in blocks on torch.get_num_threads()
    threads.  A slot is taken again by a later chunk of its key once its
    handle has been consumed; at most two free slots are kept.

    Spans (utils/timing), each chunk's sharing its sequence number as
    their id: ingest.dispatch over ingest.slot_wait (the wait for a
    reused slot's event), ingest.stage (the padded batch, or the padded
    host hashes), ingest.ids (id assignment) and the graph cache's
    graph.pin / graph.launch; ingest.consume over ingest.counts_fetch
    (the wait for the slot's event, or a blocking fetch); and
    ingest.finalize.  Counters: ingest.slot_made and ingest.slot_reused,
    one of them a chunk of audio."""

    def __init__(self, ht, analyzer, ndev: int = 1,
                 cap_override: int | None = None):
        self.ht = ht
        self.analyzer = analyzer
        self.ndev = ndev
        self.cap_override = cap_override
        self.cfg = DT.config_for(ht)
        self.device = analyzer.device
        fresh = not ht.counts.any()  # an empty table is born on the device
        if ndev > 1:
            from audfprint_torch.parallel import sharded
            self.mesh = sharded.make_mesh(
                ndev, sharded.mesh_devices(self.device))
            sharded.buckets_per_shard(self.mesh, self.cfg)
            if fresh:
                self.table, self.counts = sharded.empty_sharded_table(
                    self.mesh, self.cfg)
            else:
                self.table, self.counts, _ = sharded.upload_sharded(
                    ht, self.mesh)
            self._ingest = graphs.GraphCache(_routed_step, self.mesh)
            self._store = graphs.GraphCache(sharded.store_step, self.mesh)
            self._replay = graphs.GraphCache(_replay_step, self.mesh)
        else:
            self.mesh = None
            if fresh:
                self.table, self.counts = DT.empty_table(self.cfg,
                                                         self.device)
            else:
                self.table, self.counts, _ = DT.table_to_device(
                    ht, self.device)
            self._ingest = graphs.GraphCache(_ingest_step, self.device)
            self._store = graphs.GraphCache(_store_step, self.device)
        self.replays = 0            # chunks replayed after a cap overflow
        self.seq = 0                # chunks dispatched: the id of their spans
        # pinned slots for the graphs
        self._pinned = self._ingest.device.type == "cuda"
        self._free: list = []       # free slots, least recently used first
        self._pool = None           # the threads that stage a chunk's rows

    # -- chunk path -------------------------------------------------------

    def _assign_id(self, name: str, nhashes: int | None) -> int:
        """Host id assignment in strict input order; hashesperid waits for
        consume_chunk for device-counted files (nhashes None)."""
        id_ = self.ht.name_to_id(name, add_if_missing=True)
        self.ht._check_id_capacity(id_)
        if nhashes is not None:
            self.ht.hashesperid[id_] += nhashes
        return id_

    def dispatch_chunk(self, ordered, report):
        """Store one decoded chunk: maximal same-kind runs keep the global
        file order (ids and per-bucket insertion order == the sequential
        reference loop).  Precomputed `.afpt`/`.afpk` files and streamed
        WAVs carry host hashes and take store_batch directly.

        Returns a handle for consume_chunk; entries that failed decode or
        load are reported (or raise under fail_on_error) and skipped."""
        seq, self.seq = self.seq, self.seq + 1
        with timing.span("ingest.dispatch", id=seq):
            an = self.analyzer
            segs: list = []      # (kind, [(name, payload, dur)])
            for name, kind, d in ordered:
                if kind == "wav":
                    if d is None:
                        continue  # decode failed, reported
                    row = (name, d, len(d) / an.target_sr)
                elif kind == "stream":
                    if d is None:
                        continue  # stream failed, reported
                    kind = "pre"  # hashes already on host
                    row = (name, d[0], d[1])
                else:
                    try:
                        h = an.wavfile2hashes(name)
                    except (OSError, ValueError) as e:
                        if an.fail_on_error:
                            raise
                        report(f"Error reading {name}: {e}")
                        continue
                    row = (name, h, an.soundfiledur)
                if segs and segs[-1][0] == kind:
                    segs[-1][1].append(row)
                else:
                    segs.append((kind, [row]))
            return _Chunk(seq, [self._dispatch_wavs(rows) if kind == "wav"
                                else self._dispatch_pre(rows)
                                for kind, rows in segs])

    def _stage_chunk(self, sigs: list) -> "_Slot":
        """Pad a chunk's signals into a slot's (Bp, blen) batch: the
        chunk-max bucket, strict file order (no length regrouping: the
        store depends on in-order rows), Bp a power of two and a multiple
        of ndev; int16 PCM, or float32 when the chunk mixes dtypes."""
        blen = _bucket_len(max(len(s) for s in sigs))
        Bp = P.next_pow2(len(sigs), max(8, self.ndev))
        Bp += -Bp % max(1, self.ndev)
        all_i16 = all(s.dtype == np.int16 for s in sigs if len(s))
        slot = self._take_slot(
            (Bp, blen, torch.int16 if all_i16 else torch.float32))
        nthreads = torch.get_num_threads()
        if self._pool is None and nthreads > 1:
            self._pool = ThreadPoolExecutor(nthreads, "ingest-stage")
        with timing.span("ingest.stage"):
            slot.fill(sigs, self._pool, nthreads)
        return slot

    def _take_slot(self, key: tuple) -> "_Slot":
        """A free slot of `key` ((Bp, blen, dtype)), the most recently
        freed first, once its event has passed; else a new one."""
        for i in range(len(self._free) - 1, -1, -1):
            if self._free[i].key == key:
                slot = self._free.pop(i)
                timing.count("ingest.slot_reused", 1)
                with timing.span("ingest.slot_wait"):
                    slot.wait()
                return slot
        timing.count("ingest.slot_made", 1)
        # a mesh's counts carry the ok flag
        return _Slot(key, key[0] + (self.mesh is not None), self._pinned)

    def _release(self, slot: "_Slot") -> None:
        """A consumed chunk's slot is free again; past two free slots the
        least recently used one goes."""
        self._free.append(slot)
        del self._free[:-2]

    def _dispatch_wavs(self, rows):
        names = [n for n, _, _ in rows]
        durs = [dur for _, _, dur in rows]
        slot = self._stage_chunk([d for _, d, _ in rows])
        with timing.span("ingest.ids"):
            ids = slot.ids_np
            ids[len(names):] = 0
            for row, name in enumerate(names):
                ids[row] = self._assign_id(name, None)
        pcfg = self.analyzer.config
        # the ok flag is a notion of the mesh's routing
        static = ((pcfg, self.cfg) if self.mesh is None else
                  (self.mesh, pcfg, self.cfg, self.cap_override))
        cnt_ok = self._ingest(slot.inputs(), (self.table, self.counts),
                              static, _ingest_bytes(*slot.batch.shape, pcfg))
        slot.fetch(cnt_ok)
        return ("wav", names, durs, cnt_ok, slot)

    def _dispatch_pre(self, rows):
        """Host (t, hash) arrays -> one store_batch pass (replicated
        streams on a mesh: they are on the host already)."""
        tt, hh, vv, ids = self._pad_hashes(rows)
        static = ((self.cfg,) if self.mesh is None else
                  (self.mesh, self.cfg))
        self._store((tt, hh, vv, ids), (self.table, self.counts), static,
                    DT.store_bytes(hh.size))
        return ("pre", [n for n, _, _ in rows], [d for _, _, d in rows],
                [len(h) for _, h, _ in rows], None)

    def _pad_hashes(self, rows):
        hs = [np.asarray(h).reshape(-1, 2) for _, h, _ in rows]
        with timing.span("ingest.ids"):
            ids = np.zeros(P.next_pow2(len(rows), 8), np.int32)
            for b, (row, h) in enumerate(zip(rows, hs)):
                ids[b] = self._assign_id(row[0], len(h))
        with timing.span("ingest.stage"):
            tt, hh, vv = DT.pad_hashes(hs, len(ids))
        return tt, hh, vv, ids

    def consume_chunk(self, handle) -> list:
        """Resolve a dispatch_chunk handle -> ordered (name, nhash, dur)
        rows; each fused segment waits for its slot's counts.  A
        routing-cap overflow on a mesh (ok == 0) replays that segment's
        audio from its slot through a separate fingerprint and the
        replicated store: bit-identical, since the overflowing pass masked
        all its writes.  The slot is free again after."""
        with timing.span("ingest.consume", id=handle.seq):
            out = []
            for kind, names, durs, cnt, slot in handle:
                if kind == "pre":
                    out.extend(zip(names, cnt, durs))
                    continue
                with timing.span("ingest.counts_fetch"):
                    slot.wait()
                cnt = slot.counts_np
                if self.mesh is not None:
                    cnt, ok = cnt[:-1], int(cnt[-1])
                    if not ok:
                        cnt = self._replay_overflow(slot)
                for row, (name, dur) in enumerate(zip(names, durs)):
                    n = int(cnt[row])
                    self.ht.hashesperid[slot.ids_np[row]] += n
                    out.append((name, n, dur))
                self._release(slot)
            return out

    def _replay_overflow(self, slot: "_Slot"):
        """The routing-cap overflow's way round (_replay_step): every shard
        fingerprints its block again from the slot and the whole chunk's
        streams go through the replicated store.  The blocking fetch
        waits for the replay, so the slot has been read when it returns."""
        self.replays += 1
        pcfg = self.analyzer.config
        cnt = self._replay(slot.inputs(), (self.table, self.counts),
                           (self.mesh, pcfg, self.cfg),
                           _ingest_bytes(*slot.batch.shape, pcfg))
        with timing.span("ingest.counts_fetch"):
            return cnt.cpu().numpy()

    # -- finalize ---------------------------------------------------------

    def finalize(self) -> None:
        """Download the device state into the host table (_download)."""
        with timing.span("ingest.finalize"):
            self._download()

    def _download(self) -> None:
        """Download the device state into the host table.

        A fresh ingest fills a small share of the n_buckets x depth grid,
        so the occupied slots are compacted bucket-major on the device
        (_compact_slots) and only they cross to the host, whose layout
        follows from `counts` alone; a table dense enough that the column
        slice table[:, :k] is within 4x of that size comes over as the
        slice (_slice_depth), or whole.  A mesh's shards come over one by
        one in bucket order (whole, when the mesh spans processes)."""
        from audfprint_torch.parallel import sharded

        mesh = self.mesh
        tables = self.table if mesh is not None else [self.table]
        if mesh is not None:
            counts = sharded.gather_sharded(mesh, self.counts)
        else:
            counts = self.counts.cpu().numpy()
        nb, depth = self.cfg.n_buckets, self.cfg.depth
        # host entry type: uint64 for a wide table's int64 plane
        host_t = np.uint64 if self.cfg.wide else np.uint32
        kmax = int(min(depth, counts.max())) if counts.size else 0
        k = min(depth, P.next_pow2(max(1, kmax), 1))
        occ = np.minimum(counts, depth).astype(np.int64)
        total = int(occ.sum())
        if mesh is not None and mesh.nproc > 1:
            tab = sharded.gather_sharded(mesh, tables).view(host_t)
        elif P.next_pow2(max(1, total), 1) * 4 <= nb * k:
            cnts = self.counts if mesh is not None else [self.counts]
            packed = np.concatenate([
                _compact_slots(t, c, k).cpu().numpy()
                for t, c in zip(tables, cnts)]).view(host_t)
            tab = np.zeros((nb, depth), host_t)
            rowb = np.repeat(np.arange(nb), occ)
            off = np.cumsum(occ) - occ
            tab[rowb, np.arange(total) - off[rowb]] = packed
        elif kmax < depth:
            tab = np.zeros((nb, depth), host_t)
            tab[:, :k] = np.concatenate([
                _slice_depth(t, k).cpu().numpy() for t in tables]).view(host_t)
        else:                            # full buckets: the whole table
            tab = np.concatenate([t.cpu().numpy() for t in tables]).view(
                host_t)
        self.ht.table = tab
        self.ht.counts = counts.astype(np.int32)
        self.ht.dirty = True
        self.ht.rev += 1


class _Chunk(list):
    """dispatch_chunk's handle: the chunk's segments, and its sequence
    number, the id of its spans."""

    def __init__(self, seq: int, segments: list):
        super().__init__(segments)
        self.seq = seq


class _Slot:
    """One in-flight chunk's host side, reused by later chunks of its key
    (Bp, blen, dtype): the (Bp, blen) batch, the (Bp,) lengths and ids
    the graph copies to the device, and the counts (ncounts,) it copies
    back, pinned for a CUDA device, with the event recorded after that
    copy (none on the CPU, where every copy is done when it returns).
    `written[r]` is how far the last chunk staged here wrote row r, so
    a later chunk zeroes only what it no longer covers."""

    def __init__(self, key: tuple, ncounts: int, pinned: bool):
        Bp, blen, dtype = self.key = key
        self.batch = torch.zeros((Bp, blen), dtype=dtype, pin_memory=pinned)
        self.lens = torch.zeros(Bp, dtype=torch.int32, pin_memory=pinned)
        self.ids = torch.zeros(Bp, dtype=torch.int32, pin_memory=pinned)
        self.counts = torch.zeros(ncounts, dtype=torch.int32,
                                  pin_memory=pinned)
        self.event = torch.cuda.Event() if pinned else None
        self.written = np.zeros(Bp, np.int64)
        # the same memory as numpy arrays, for the host's writes and reads
        self.batch_np, self.lens_np = self.batch.numpy(), self.lens.numpy()
        self.ids_np, self.counts_np = self.ids.numpy(), self.counts.numpy()

    def inputs(self) -> tuple:
        return self.batch, self.lens, self.ids

    def fill(self, sigs: list, pool=None, nblocks: int = 1) -> None:
        """Row r of the batch holds sigs[r] and zeros after it, rows past
        the chunk zeros; int16 rows of a float32 batch are scaled to
        [-1, 1) as the analyzer scales PCM.  With a thread pool the rows
        are cut into `nblocks` contiguous blocks copied side by side
        (NumPy's copies release the interpreter lock)."""
        to_float = self.batch.dtype == torch.float32
        b, w, lens = self.batch_np, self.written, self.lens_np

        def put(lo: int, hi: int) -> None:
            for row in range(lo, hi):
                if row >= len(sigs):
                    b[row, : w[row]] = 0
                    w[row] = lens[row] = 0
                    continue
                s = sigs[row]
                if to_float and s.dtype == np.int16:
                    s = s.astype(np.float32) / float(1 << 15)
                n = len(s)
                b[row, :n] = s
                if w[row] > n:
                    b[row, n: w[row]] = 0
                w[row] = lens[row] = n

        Bp = len(w)
        if pool is None or nblocks < 2:
            put(0, Bp)
            return
        step = -(-Bp // nblocks)
        for f in [pool.submit(put, lo, min(Bp, lo + step))
                  for lo in range(0, Bp, step)]:
            f.result()

    def fetch(self, counts: torch.Tensor) -> None:
        """Queue the copy of a chunk's counts into the slot, on the stream
        that computed them, and the event after it."""
        self.counts.copy_(counts, non_blocking=True)
        if self.event is not None and counts.is_cuda:
            self.event.record(torch.cuda.current_stream(counts.device))

    def wait(self) -> None:
        """Until the last chunk's counts are in the slot, and its inputs
        read."""
        if self.event is not None:
            self.event.synchronize()


def _compact_slots(table: torch.Tensor, counts: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Every occupied slot of table[:, :k], bucket-major: entry j belongs
    to the bucket b with off[b] <= j < off[b] + occ[b], where occ =
    min(counts, k) and off = exclusive-cumsum(occ), so the host derives
    the layout from `counts` alone."""
    occ = torch.clamp(counts, max=k)
    mask = torch.arange(k, device=table.device)[None, :] < occ[:, None]
    return table[:, :k][mask]


def _slice_depth(table: torch.Tensor, k: int) -> torch.Tensor:
    return table[:, :k].contiguous()
