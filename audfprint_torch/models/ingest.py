"""Fused device ingest (port of audfprint_tpu/models/ingest.py).

`--device-store` keeps the hash table on the device for the whole run:
every chunk of decoded audio is fingerprinted and stored in one pass
whose (t, hash) rows never reach the host; the host fetches only the
per-file unique counts (for names, hashesperid and the report lines), and
`finalize()` downloads the table into the host HashTable, the persistence
mirror.

  one device : fingerprint_batch -> store_batch_local
               (fused_ingest_graph).
  a mesh     : each shard fingerprints its block of the chunk's batch,
               packs the entries, and routes every (hash, entry) pair to
               the shard that owns its bucket with one all_to_all, under a
               cap with 2x headroom; then the local deterministic-
               reservoir store (sharded_fused_ingest_fn).  A cap overflow
               masks every write and returns ok = 0, and the caller
               replays the chunk through the replicated store, so the
               result is the same either way.

Bit-identical to the sequential host store by construction: the reservoir
is keyed by (global bucket, position), the batch is cut into contiguous
file blocks, and the all_to_all receives source-major and stable within a
source, which keeps the file-major insertion order of every bucket.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.ops.config import PipelineConfig
from audfprint_torch.index import device_table as DT
from audfprint_torch.models.analyzer import _bucket_len
from audfprint_torch.ops import pipeline as pipe


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
    rank = iota - torch.cummax(torch.where(first, iota, 0), dim=0).values
    ok = ~((ds < ndev) & (rank >= cap)).any()
    wv = (ds < ndev) & (rank < cap)
    slot = torch.where(wv, ds * cap + rank, ndev * cap)
    ops = []
    for src in (hf[order], entry[order], wv):
        buf = torch.zeros(ndev * cap + 1, dtype=src.dtype, device=dev)
        buf[slot] = src
        ops.append(buf[:-1].view(ndev, cap))
    return ops, ok


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
    stored entries.  On a mesh, parallel.sharded.ShardedStore's replicated
    store stays the path of precomputed files and of the overflow
    replay."""

    def __init__(self, ht, analyzer, ndev: int = 1):
        self.ht = ht
        self.analyzer = analyzer
        self.ndev = ndev
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
            self._fn = sharded_fused_ingest_fn(self.mesh, analyzer.config,
                                               self.cfg)
        else:
            self.mesh = None
            if fresh:
                self.table, self.counts = DT.empty_table(self.cfg,
                                                         self.device)
            else:
                self.table, self.counts, _ = DT.table_to_device(
                    ht, self.device)
        self._repl_store = None     # made on first use (mesh only)
        self.replays = 0            # chunks replayed after a cap overflow

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
        an = self.analyzer
        segs: list = []      # (kind, [(name, payload, dur)])
        for name, kind, d in ordered:
            if kind == "wav":
                if d is None:
                    continue                       # decode failed, reported
                row = (name, d, len(d) / an.target_sr)
            elif kind == "stream":
                if d is None:
                    continue                       # stream failed, reported
                kind = "pre"                       # hashes already on host
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
        return [self._dispatch_wavs(rows) if kind == "wav"
                else self._dispatch_pre(rows) for kind, rows in segs]

    def _stage_chunk(self, sigs: list):
        """Pad a chunk's signals into one (Bp, blen) batch: the chunk-max
        bucket, strict file order (no length regrouping: the store depends
        on in-order rows), Bp a power of two and a multiple of ndev."""
        blen = _bucket_len(max(len(s) for s in sigs))
        Bp = P.next_pow2(len(sigs), max(8, self.ndev))
        Bp += -Bp % max(1, self.ndev)
        all_i16 = all(s.dtype == np.int16 for s in sigs if len(s))
        batch = np.zeros((Bp, blen), np.int16 if all_i16 else np.float32)
        lens = np.zeros(Bp, np.int32)
        for row, s in enumerate(sigs):
            if not all_i16 and s.dtype == np.int16:
                s = s.astype(np.float32) / float(1 << 15)
            batch[row, : len(s)] = s
            lens[row] = len(s)
        return batch, lens

    def _dispatch_wavs(self, rows):
        names = [n for n, _, _ in rows]
        durs = [dur for _, _, dur in rows]
        batch, lens = self._stage_chunk([d for _, d, _ in rows])
        ids = np.zeros(len(lens), np.int32)
        for row, name in enumerate(names):
            ids[row] = self._assign_id(name, None)
        if self.mesh is not None:
            cnt_ok = self._fn(self.table, self.counts, batch, lens, ids)
        else:
            dev = self.device
            # the ok flag is a notion of the mesh's routing
            cnt_ok = fused_ingest_graph(
                self.table, self.counts, torch.as_tensor(batch, device=dev),
                torch.as_tensor(lens, device=dev),
                torch.as_tensor(ids, device=dev), self.analyzer.config,
                self.cfg)[2]
        return ("wav", names, durs, cnt_ok, ids, batch, lens)

    def _dispatch_pre(self, rows):
        """Host (t, hash) arrays -> one store_batch pass (replicated
        streams on a mesh: they are on the host already)."""
        tt, hh, vv, ids = self._pad_hashes(rows)
        if self.mesh is not None:
            self._repl_store_fn()(self.table, self.counts, tt, hh, vv, ids)
        else:
            dev = self.device
            DT.store_batch(self.table, self.counts,
                           torch.as_tensor(tt, device=dev),
                           torch.as_tensor(hh, device=dev),
                           torch.as_tensor(vv, device=dev),
                           torch.as_tensor(ids, device=dev), self.cfg)
        return ("pre", [n for n, _, _ in rows], [d for _, _, d in rows],
                [len(h) for _, h, _ in rows], None, None, None)

    def _pad_hashes(self, rows):
        B = len(rows)
        L = P.next_pow2(max(1, max(len(h) for _, h, _ in rows)), 256)
        Bp = P.next_pow2(B, 8)
        tt = np.zeros((Bp, L), np.int32)
        hh = np.zeros((Bp, L), np.int32)
        vv = np.zeros((Bp, L), bool)
        ids = np.zeros(Bp, np.int32)
        for b, (name, h, _dur) in enumerate(rows):
            h = np.asarray(h).reshape(-1, 2)
            ids[b] = self._assign_id(name, len(h))
            tt[b, : len(h)] = h[:, 0]
            hh[b, : len(h)] = h[:, 1]
            vv[b, : len(h)] = True
        return tt, hh, vv, ids

    def _repl_store_fn(self):
        from audfprint_torch.parallel import sharded
        if self._repl_store is None:
            self._repl_store = sharded.sharded_store_fn(self.mesh, self.cfg)
        return self._repl_store

    def consume_chunk(self, handle) -> list:
        """Resolve a dispatch_chunk handle -> ordered (name, nhash, dur)
        rows; one small counts fetch per fused segment.  A routing-cap
        overflow on a mesh (ok == 0) replays that segment's audio through
        a separate fingerprint and the replicated store: bit-identical,
        since the overflowing pass masked all its writes."""
        out = []
        for kind, names, durs, cnt, ids, batch, lens in handle:
            if kind == "pre":
                out.extend(zip(names, cnt, durs))
                continue
            cnt = cnt.cpu().numpy()
            if self.mesh is not None:
                cnt, ok = cnt[:-1], int(cnt[-1])
                if not ok:
                    cnt = self._replay_overflow(batch, lens, ids)
            for row, (name, dur) in enumerate(zip(names, durs)):
                n = int(cnt[row])
                self.ht.hashesperid[ids[row]] += n
                out.append((name, n, dur))
        return out

    def _replay_overflow(self, batch, lens, ids):
        """The routing-cap overflow's way round: every shard fingerprints
        its block again (sharded.dp_fingerprint_fn), and the whole chunk's
        streams go through the replicated store."""
        from audfprint_torch.parallel import sharded

        self.replays += 1
        t, h, uniq, cnt = sharded.dp_fingerprint_fn(
            self.mesh, self.analyzer.config)(batch, lens)
        self._repl_store_fn()(self.table, self.counts, t, h, uniq, ids)
        return cnt.cpu().numpy()

    # -- finalize ---------------------------------------------------------

    def finalize(self) -> None:
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
