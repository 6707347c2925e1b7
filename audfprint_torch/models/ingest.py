"""Fused device ingest, one device (port of audfprint_tpu/models/ingest.py).

`--device-store` keeps the hash table on the device for the whole run:
every chunk of decoded audio is fingerprinted and stored in one pass
(fused_ingest) whose (t, hash) rows never reach the host; the host fetches
only the per-file unique counts (for names, hashesperid and the report
lines), and `finalize()` downloads the table into the host HashTable, the
persistence mirror.  Bit-identical to the sequential host store by
construction: files are stored in input order, and the store keeps the
host store's per-bucket insertion order and deterministic reservoir.

The mesh ingest of the JAX package (hash routing with all_to_all, the
overflow replay) belongs to the `parallel/` slice, not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.ops.config import PipelineConfig
from audfprint_torch.index import device_table as DT
from audfprint_torch.models.analyzer import _bucket_len
from audfprint_torch.ops import pipeline as pipe


def fused_ingest(table: torch.Tensor, counts: torch.Tensor,
                 audio: torch.Tensor, lengths: torch.Tensor,
                 ids: torch.Tensor, pcfg: PipelineConfig,
                 tcfg: DT.TableConfig) -> torch.Tensor:
    """Audio batch -> hashes -> stored table, updated in place; returns the
    per-file unique hash counts (B,).  Semantics == sequential
    HashTable.store of file 0, then file 1, ..."""
    t, h, uniq, cnt = pipe.fingerprint_batch(audio, lengths, pcfg)
    DT.store_batch_local(table, counts, t, h, uniq, ids, tcfg, 0)
    return cnt


class DeviceIngest:
    """Device-resident ingest for the CLI's `--device-store`: the table
    lives on the analyzer's device for the whole run (uploaded once, or
    born empty for `new`), every chunk is one fused fingerprint + store
    pass and one small counts fetch, and `finalize()` downloads the result
    into the host HashTable with a fetch sized by the stored entries."""

    def __init__(self, ht, analyzer, ndev: int = 1):
        if ndev > 1:
            raise NotImplementedError(
                "device-store ingest over --ndev > 1 devices is not yet "
                "ported to audfprint_torch (ROADMAP.md)")
        self.ht = ht
        self.analyzer = analyzer
        self.cfg = DT.config_for(ht)
        self.device = analyzer.device
        if not ht.counts.any():     # an empty table is born on the device
            self.table, self.counts = DT.empty_table(self.cfg, self.device)
        else:
            self.table, self.counts, _ = DT.table_to_device(ht, self.device)

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
        on in-order rows), Bp a power of two."""
        blen = _bucket_len(max(len(s) for s in sigs))
        Bp = P.next_pow2(len(sigs), 8)
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
        dev = self.device
        cnt = fused_ingest(self.table, self.counts,
                           torch.as_tensor(batch, device=dev),
                           torch.as_tensor(lens, device=dev),
                           torch.as_tensor(ids, device=dev),
                           self.analyzer.config, self.cfg)
        return ("wav", names, durs, cnt, ids)

    def _dispatch_pre(self, rows):
        """Host (t, hash) arrays -> one store_batch pass."""
        tt, hh, vv, ids = self._pad_hashes(rows)
        dev = self.device
        DT.store_batch(self.table, self.counts,
                       torch.as_tensor(tt, device=dev),
                       torch.as_tensor(hh, device=dev),
                       torch.as_tensor(vv, device=dev),
                       torch.as_tensor(ids, device=dev), self.cfg)
        return ("pre", [n for n, _, _ in rows], [d for _, _, d in rows],
                [len(h) for _, h, _ in rows], None)

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

    def consume_chunk(self, handle) -> list:
        """Resolve a dispatch_chunk handle -> ordered (name, nhash, dur)
        rows; one small counts fetch per fused segment."""
        out = []
        for kind, names, durs, cnt, ids in handle:
            if kind == "pre":
                out.extend(zip(names, cnt, durs))
                continue
            cnt = cnt.cpu().numpy()
            for row, (name, dur) in enumerate(zip(names, durs)):
                n = int(cnt[row])
                self.ht.hashesperid[ids[row]] += n
                out.append((name, n, dur))
        return out

    # -- finalize ---------------------------------------------------------

    def finalize(self) -> None:
        """Download the device state into the host table.

        A fresh ingest fills a small share of the n_buckets x depth grid,
        so the occupied slots are compacted bucket-major on the device
        (_compact_slots) and only they cross to the host, whose layout
        follows from `counts` alone; a table dense enough that the column
        slice table[:, :k] is within 4x of that size comes over as the
        slice (_slice_depth), or whole."""
        counts = self.counts.cpu().numpy()
        nb, depth = self.cfg.n_buckets, self.cfg.depth
        # host entry type: uint64 for a wide table's int64 plane
        host_t = np.uint64 if self.cfg.wide else np.uint32
        kmax = int(min(depth, counts.max())) if counts.size else 0
        k = min(depth, P.next_pow2(max(1, kmax), 1))
        occ = np.minimum(counts, depth).astype(np.int64)
        total = int(occ.sum())
        if P.next_pow2(max(1, total), 1) * 4 <= nb * k:
            packed = _compact_slots(self.table, self.counts, k)
            packed = packed.cpu().numpy().view(host_t)
            tab = np.zeros((nb, depth), host_t)
            rowb = np.repeat(np.arange(nb), occ)
            off = np.cumsum(occ) - occ
            tab[rowb, np.arange(total) - off[rowb]] = packed
        elif kmax < depth:
            tab = np.zeros((nb, depth), host_t)
            tab[:, :k] = _slice_depth(self.table, k).cpu().numpy().view(
                host_t)
        else:                            # full buckets: the whole table
            DT.table_to_host(self.table, self.counts, self.ht)
            self.ht.rev += 1
            return
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
