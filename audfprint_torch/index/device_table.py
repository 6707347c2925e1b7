"""Device-resident inverted hash index (port of
audfprint_tpu/index/device_table.py).

The host `HashTable` stays the canonical store and persistence format.
Gather side: `table_to_device` uploads it and `get_hits_local` gathers
each query hash's bucket row.  Store side (`--device-store` ingest,
models/ingest.py): `store_batch_local` inserts whole batches on the
device, bit-identical to the sequential host store, and `table_to_host`
brings the result back.

The table lives on the device as an int32 view of the uint32 host array
(2^20 x 100 x 4 B = 419 MB at the defaults).  PyTorch has no >>, % or
index_put_ on uint32 on the CPU, so every uint32 quantity that needs
arithmetic (gathered entries, the reservoir hash) is widened to int64 and
masked to 32 bits; an int32 shift would sign-extend entries whose top bit
is set (ids >= 2^17 at maxtimebits=14).

Wide tables (idbits + maxtimebits > 32, `--idbits`) keep their entries in
one int64 plane of the same (n_buckets, depth) shape, an int64 view of the
host uint64 array (800 MB at the defaults).  idbits and maxtimebits are
each at most 31, so an entry stays below 2^62: it is never negative as an
int64, and the arithmetic >> that torch applies to int64 equals the
logical shift of the uint64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.ops import scan as SC


class TableConfig(NamedTuple):
    hashbits: int = P.TABLE_HASHBITS
    depth: int = P.TABLE_DEPTH
    maxtimebits: int = 14
    seed: int = 0
    idbits: int = 0          # 0 = derive as 32 - maxtimebits (packed)

    @property
    def maxtime(self) -> int:
        return 1 << self.maxtimebits

    @property
    def n_buckets(self) -> int:
        return 1 << self.hashbits

    @property
    def idbits_eff(self) -> int:
        return self.idbits or (32 - self.maxtimebits)

    @property
    def wide(self) -> bool:
        return self.idbits_eff + self.maxtimebits > 32


def config_for(ht) -> TableConfig:
    return TableConfig(hashbits=ht.hashbits, depth=ht.depth,
                       maxtimebits=ht.maxtimebits, seed=ht.seed,
                       idbits=getattr(ht, "idbits", 0))


def table_to_device(ht, device) -> tuple[torch.Tensor, torch.Tensor,
                                         TableConfig]:
    """Upload a host HashTable: (table (nb, depth) int32 view of the uint32
    entries, or int64 view of the uint64 entries of a wide table, counts
    (nb,) int32, cfg)."""
    cfg = config_for(ht)
    if cfg.wide:
        host = np.ascontiguousarray(ht.table, dtype=np.uint64).view(np.int64)
    else:
        host = np.ascontiguousarray(ht.table, dtype=np.uint32).view(np.int32)
    table = torch.from_numpy(host)
    counts = torch.from_numpy(np.ascontiguousarray(ht.counts, np.int32))
    return table.to(device), counts.to(device), cfg


def get_hits_local(table: torch.Tensor, counts: torch.Tensor,
                   qtimes: torch.Tensor, qhashes: torch.Tensor,
                   qvalid: torch.Tensor, cfg: TableConfig,
                   bucket_lo: int = 0):
    """(B, Q) queries -> (ids, dts, hvalid) each (B, Q, depth) int32 /
    int32 / bool, restricted to the bucket range owned by this table.
    Row order per query == reference get_hits (slot order per query hash).
    Packed entries widen to int64 masked to 32 bits; wide ones are int64
    already and below 2^62, so the shift below is logical for both."""
    n_local = table.shape[0]
    hashmask = (1 << cfg.hashbits) - 1
    timemask = cfg.maxtime - 1
    qh = (qhashes.long() & hashmask) - bucket_lo
    own = (qh >= 0) & (qh < n_local)
    qh = torch.clamp(qh, 0, n_local - 1)
    tab = table[qh].long()                           # (B, Q, depth)
    if not cfg.wide:
        tab = tab & _M32
    nids = torch.clamp(counts[qh], max=cfg.depth)
    slotidx = torch.arange(cfg.depth, device=table.device)
    hvalid = ((slotidx[None, None, :] < nids[:, :, None])
              & (qvalid & own)[:, :, None])
    ids = (tab >> cfg.maxtimebits).to(torch.int32)
    dts = ((tab & timemask) - qtimes.long()[:, :, None]).to(torch.int32)
    return ids, dts, hvalid


def get_hits(table: torch.Tensor, counts: torch.Tensor,
             qtimes: torch.Tensor, qhashes: torch.Tensor,
             qvalid: torch.Tensor, cfg: TableConfig):
    """Full-table gather (single device); see get_hits_local."""
    return get_hits_local(table, counts, qtimes, qhashes, qvalid, cfg, 0)


def build_hpi_plane(table: torch.Tensor, hpi: torch.Tensor,
                    cfg: TableConfig) -> torch.Tensor:
    """Per-entry hashesperid plane aligned with the table: plane[b, s] =
    hpi[id of table[b, s]] (int32), for an int32 or a wide int64 table.

    The vote ranks candidates by raw count / hashesperid.  With the plane
    each hit's hashesperid comes with its bucket row (gather_plane) and
    rides the vote's sort as one more payload, instead of a per-hit
    hpi[id] gather.  A track's hashesperid is fixed once its hashes are
    stored, so the plane stays valid until the table changes.  Empty slots
    decode to id 0; their value is never read (hvalid masks them)."""
    ids = table.long()
    if not cfg.wide:
        ids = ids & _M32
    ids = ids >> cfg.maxtimebits
    return hpi[torch.clamp(ids, 0, hpi.shape[0] - 1)].to(torch.int32)


def gather_plane(plane: torch.Tensor, qhashes: torch.Tensor,
                 cfg: TableConfig, bucket_lo: int = 0) -> torch.Tensor:
    """Row-gather a per-entry plane with get_hits_local's own bucket
    indexing -> (B, Q, depth), slot-aligned with its hit arrays."""
    n_local = plane.shape[0]
    qh = (qhashes.long() & ((1 << cfg.hashbits) - 1)) - bucket_lo
    return plane[torch.clamp(qh, 0, n_local - 1)]


_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    without overflowing int64: the product is formed from x's 16-bit
    halves, each below 2^48."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values; equals
    audfprint_torch.utils.prng.mix32 (the host store's)."""
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def reservoir_slot_device(bucket: torch.Tensor, position: torch.Tensor,
                          seed: int) -> torch.Tensor:
    """Slot in [0, position] for the entry inserted at `position` into
    `bucket` (utils/prng.reservoir_slot): the uint32 hash modulo the
    position + 1 (positions are int32 counts, so + 1 cannot wrap), as
    int64."""
    pos = position.to(torch.int64) & _M32
    h = _mix32(_mul32(bucket.to(torch.int64) & _M32, _GOLDEN)
               ^ _mix32((pos + seed) & _M32))
    return h % (pos + 1)


def empty_table(cfg: TableConfig, device) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """A zeroed (n_buckets, depth) table, int32 (int64 when wide), and
    (n_buckets,) counts."""
    dtype = torch.int64 if cfg.wide else torch.int32
    return (torch.zeros((cfg.n_buckets, cfg.depth), dtype=dtype,
                        device=device),
            torch.zeros(cfg.n_buckets, dtype=torch.int32, device=device))


def store_batch_local(table: torch.Tensor, counts: torch.Tensor,
                      times: torch.Tensor, hashes: torch.Tensor,
                      valid: torch.Tensor, ids: torch.Tensor,
                      cfg: TableConfig, bucket_lo: int = 0) -> None:
    """Insert a batch of per-file hash streams into a (possibly shard-local)
    table covering buckets [bucket_lo, bucket_lo + table.shape[0]),
    updating `table` and `counts` in place.

    times/hashes/valid: (B, L) int/int/bool per-file streams (straight from
    ops.pipeline.fingerprint_batch); ids: (B,) int track ids.  Semantics
    == sequential HashTable.store of file 0, then file 1, ..., restricted
    to the owned bucket range."""
    B, L = hashes.shape
    t = times.to(torch.int64) & (cfg.maxtime - 1)
    u = ids.to(device=table.device, dtype=torch.int64)[:, None].expand(B, L)
    entry = (u << cfg.maxtimebits) | t
    if not cfg.wide:
        entry = entry & _M32
    store_packed_local(table, counts, hashes.reshape(-1), entry.reshape(-1),
                       valid.reshape(-1), cfg, bucket_lo)


def store_packed_local(table: torch.Tensor, counts: torch.Tensor,
                       hashes: torch.Tensor, entry: torch.Tensor,
                       valid: torch.Tensor, cfg: TableConfig,
                       bucket_lo: int = 0) -> None:
    """Insert pre-packed entries (= (id << maxtimebits) | t: uint32 values
    in any integer dtype, or uint64 values in int64 for a wide table) in
    arrival order, in place.

    Stable sort by bucket -> rank within the bucket -> insertion position
    counts[bucket] + rank -> the deterministic reservoir slot past the
    depth -> last write wins per (bucket, slot) -> one scatter of every
    row, whose writing rows' (bucket, slot) pairs are unique.

    Every size is fixed by the input's, and nothing is read back to the
    host, so a CUDA graph can capture the store (the JAX package's
    `.at[...].set(mode="drop")` under jit).  A row that does not write
    repeats the write of the last row that does, value and place: the
    table cannot carry a spare slot, and a repeated write of one value
    leaves the same table whichever lands last.  With no writing row at
    all, each row writes back the value its (clamped) place holds."""
    n_local, depth = table.shape
    dev = table.device
    n = hashes.shape[0]
    if n == 0:
        return
    h = (hashes.to(device=dev, dtype=torch.int64)
         & ((1 << cfg.hashbits) - 1)) - bucket_lo
    v = valid.to(dev) & (h >= 0) & (h < n_local)
    # invalid rows sort last, into a sentinel bucket that is never written
    hkey = torch.where(v, h, n_local)
    hs, order = torch.sort(hkey, stable=True)
    es = entry.to(device=dev, dtype=torch.int64)[order]
    idx = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = hs[1:] != hs[:-1]
    run_start = SC.cummax(torch.where(first, idx, 0))
    rank = idx - run_start
    pos = counts.to(torch.int64)[torch.clamp(hs, max=n_local - 1)] + rank
    slot = torch.where(
        pos < depth, pos,
        reservoir_slot_device(hs + bucket_lo, torch.clamp(pos, min=depth),
                              cfg.seed))
    write = (slot < depth) & (hs < n_local)
    # last write wins on (bucket, slot): the rows are in (bucket, arrival)
    # order, so a stable sort by the packed (bucket, slot) key orders them
    # by (bucket, slot, arrival) and the last row of each run survives
    skey = torch.where(write, slot, depth)
    if (n_local + 1) * (depth + 1) >= 1 << 62:
        raise ValueError("store_packed_local: (bucket, slot) key overflows")
    key2, perm = torch.sort(hs * (depth + 1) + skey, stable=True)
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = key2[1:] != key2[:-1]
    hs2, sk2 = hs[perm], skey[perm]
    do = last & (sk2 < depth) & (hs2 < n_local)
    es2 = es[perm]
    es2 = es2 if cfg.wide else _as_int32(es2)
    w = torch.clamp(torch.where(do, idx, -1).amax(dim=0, keepdim=True),
                    min=0)                        # (1,): the last writer
    rows = torch.where(do, hs2, torch.clamp(hs2[w], max=n_local - 1))
    cols = torch.where(do, sk2, torch.clamp(sk2[w], max=depth - 1))
    table[rows, cols] = torch.where(
        do, es2, torch.where(do[w], es2[w], table[rows, cols]))
    counts.index_add_(0, torch.clamp(hkey, max=n_local - 1),
                      v.to(counts.dtype))


def store_bytes(n: int) -> int:
    """An estimate of the device bytes store_packed_local keeps live for
    n rows: about a dozen int64 arrays of n."""
    return 96 * n


def pad_hashes(hs, rows: int, length: int | None = None):
    """Host (n, 2) (t, hash) arrays -> the (rows, length) int32 times,
    int32 hashes and bool valid planes that store_batch and the vote
    take: array b in row b, zeros past it and in the rows past the
    arrays.  length None = the longest array's, a power of two of at
    least 256."""
    if length is None:
        length = P.next_pow2(max([1] + [len(h) for h in hs]), 256)
    tt = np.zeros((rows, length), np.int32)
    hh = np.zeros((rows, length), np.int32)
    vv = np.zeros((rows, length), bool)
    for b, h in enumerate(hs):
        tt[b, : len(h)] = h[:, 0]
        hh[b, : len(h)] = h[:, 1]
        vv[b, : len(h)] = True
    return tt, hh, vv


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> the int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def store_batch(table: torch.Tensor, counts: torch.Tensor,
                times: torch.Tensor, hashes: torch.Tensor,
                valid: torch.Tensor, ids: torch.Tensor,
                cfg: TableConfig) -> None:
    """Full-table store (single device), in place; see store_batch_local."""
    store_batch_local(table, counts, times, hashes, valid, ids, cfg, 0)


def table_to_host(table: torch.Tensor, counts: torch.Tensor, ht) -> None:
    """Download device state into a host HashTable (names managed by the
    caller); an int64 table is a wide one and comes back as uint64."""
    host = table.cpu().numpy()
    ht.table = host.view(np.uint64 if host.dtype == np.int64 else np.uint32)
    ht.counts = counts.cpu().numpy().astype(np.int32)
    ht.dirty = True
