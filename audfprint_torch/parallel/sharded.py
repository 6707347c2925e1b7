"""Several devices: a bucket-sharded table and data-parallel analysis
(port of audfprint_tpu/parallel/sharded.py).

The (2^hashbits, depth) index is sharded by bucket range over the mesh:
shard g owns buckets [g * n_local, (g + 1) * n_local).  A query hash's
hits all live on the shard that owns its bucket.

  store: replicated hash streams; each shard masks to its range and runs
         the deterministic-reservoir store (device_table.store_batch_local).
         No collective.
  match: the compacted-RLE vote after one all_to_all hit exchange
         (_rle_exchange_core), or the histogram core with its partials
         summed over the mesh (sharded_match_fn).  Both give the
         single-device rows bit for bit.
  merge: another table's entry streams replayed into the sharded table
         (sharded_merge_fn): the reference's merge as resharding.

Analysis is data parallel over the batch axis (dp_fingerprint_fn).

Where the JAX package wraps a per-device body in shard_map, each body
here is a plain function of one shard's tensors and its bucket_lo, split
at its collectives into phases; parallel/mesh.py has the collectives.  A
sharded argument is a list of the local shards' tensors, a replicated one
a single array; a replicated result is the first local shard's copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audfprint_torch import params as P
from audfprint_torch.index import device_table as DT
from audfprint_torch.match import voting
from audfprint_torch.ops import pipeline as pipe
from audfprint_torch.parallel import mesh as M
from audfprint_torch.parallel.mesh import Mesh


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of n_devices shards (None = one per device), placed round-
    robin on `devices` (None = this process's CUDA devices).  A device
    named more than once carries logical shards: make_mesh(devices=["cpu"]
    * 8) and make_mesh(4, ["cuda:0"]) are real 8- and 4-shard meshes.
    After multihost.initialize the mesh spans every process, n_devices
    counting all of them."""
    world = M.current_world()
    nproc = world.nproc if world else 1
    local = list(devices) if devices is not None else M.local_devices()
    if n_devices is None:
        n_local = len(local)
    else:
        if n_devices % nproc:
            raise ValueError(f"{n_devices} shards do not divide over "
                             f"{nproc} processes")
        n_local = n_devices // nproc
    return Mesh([local[i % len(local)] for i in range(n_local)], world)


def _bucket_lo(mesh: Mesh, n_local: int) -> list:
    return [(mesh.first + l) * n_local for l in range(mesh.n_local)]


def buckets_per_shard(mesh: Mesh, cfg: DT.TableConfig) -> int:
    if cfg.n_buckets % mesh.size:
        raise ValueError(
            f"hashbits={cfg.hashbits} table not divisible over "
            f"{mesh.size} devices")
    return cfg.n_buckets // mesh.size


def shard_rows(mesh: Mesh, a) -> list:
    """A whole bucket-major array (host array or tensor) as the local
    shards' own copies of their bucket ranges."""
    a = torch.as_tensor(a)
    nb = a.shape[0] // mesh.size
    return [a[lo: lo + nb].to(d, copy=True)
            for lo, d in zip(_bucket_lo(mesh, nb), mesh.devices)]


def shard_table(mesh: Mesh, table, counts):
    """Place a whole (n_buckets, depth) table and its counts, in the
    device dtypes of DT.table_to_device, bucket-sharded over the mesh."""
    return shard_rows(mesh, table), shard_rows(mesh, counts)


def _host_views(ht, cfg: DT.TableConfig):
    """The host table as the device dtypes: an int32 view of the uint32
    entries, an int64 view of a wide table's uint64 ones."""
    tab = (np.ascontiguousarray(ht.table, np.uint64).view(np.int64)
           if cfg.wide else
           np.ascontiguousarray(ht.table, np.uint32).view(np.int32))
    return tab, np.ascontiguousarray(ht.counts, np.int32)


def upload_sharded(ht, mesh: Mesh):
    """Host HashTable -> bucket-sharded (table, counts, cfg)."""
    cfg = DT.config_for(ht)
    buckets_per_shard(mesh, cfg)
    table, counts = shard_table(mesh, *_host_views(ht, cfg))
    return table, counts, cfg


def empty_sharded_table(mesh: Mesh, cfg: DT.TableConfig):
    """A zeroed bucket-sharded table: each process allocates its own
    shards (so it serves meshes that span processes too)."""
    nb = buckets_per_shard(mesh, cfg)
    dtype = torch.int64 if cfg.wide else torch.int32
    return ([torch.zeros((nb, cfg.depth), dtype=dtype, device=d)
             for d in mesh.devices],
            [torch.zeros(nb, dtype=torch.int32, device=d)
             for d in mesh.devices])


def gather_sharded(mesh: Mesh, shards: list) -> np.ndarray:
    """The whole array of a bucket-sharded one, on the host."""
    if mesh.nproc == 1:
        return torch.cat([s.cpu() for s in shards]).numpy()
    return mesh.all_gather(shards, 0)[0].cpu().numpy()


def sharded_store_fn(mesh: Mesh, cfg: DT.TableConfig):
    """Returns fn(table, counts, times, hashes, valid, ids) -> (table,
    counts), the shards updated in place.  times/hashes/valid/ids are
    replicated (B, L) / (B,) streams."""
    los = _bucket_lo(mesh, buckets_per_shard(mesh, cfg))

    def store(table, counts, t, h, v, ids):
        streams = [mesh.replicate(a) for a in (t, h, v, ids)]
        for l, lo in enumerate(los):
            DT.store_batch_local(table[l], counts[l],
                                 *[s[l] for s in streams], cfg, lo)
        return table, counts

    return store


def _combiners(cx: M.ShardContext) -> dict:
    """The combiners of voting.match_core on one shard of a mesh.  A
    1-shard mesh has nothing to combine: identity combiners let match_core
    take its hit-domain candidate selection.  gather_all enables the
    sharded hit-domain selection: each shard's top SD merged by one
    (B, ndev * SD) sort instead of the full id-domain sort."""
    if cx.mesh.size == 1:
        return dict(sum_all=voting._ident, min_all=voting._ident)
    return dict(sum_all=cx.sum_all, min_all=cx.min_all,
                gather_all=cx.gather_all)


def _hist_match(mesh: Mesh, tcfg, mcfg, table, counts, hpi, qt, qh, qv):
    """voting.match_core on every local shard with the mesh's combiners;
    the first local shard's (replicated) result dict."""
    n_local = buckets_per_shard(mesh, tcfg)
    rep = [mesh.replicate(a) for a in (hpi, qt, qh, qv)]

    def body(cx, tab, cnt, hp, t, h, v):
        return voting.match_core(tab, cnt, hp, t, h, v, tcfg, mcfg,
                                 bucket_lo=cx.index * n_local,
                                 **_combiners(cx))

    return mesh.spmd(body, table, counts, *rep)[0]


def sharded_match_fn(mesh: Mesh, tcfg: DT.TableConfig,
                     mcfg: voting.MatchConfig):
    """Returns fn(table, counts, hashesperid, qt, qh, qv) -> result dict
    (replicated): the histogram core with its partials summed over the
    mesh.  Bit-identical to the single-device vote on the merged table."""
    return functools.partial(_hist_match, mesh, tcfg, mcfg)


@functools.lru_cache(maxsize=64)
def sharded_match_packed_cached(mesh: Mesh, tcfg: DT.TableConfig,
                                mcfg: voting.MatchConfig):
    """sharded_match_fn with the result packed into one (B, max_returns,
    7) int32 tensor (voting.match_batch_packed's format)."""
    def fn(table, counts, hpi, qt, qh, qv):
        return voting.pack_rows(_hist_match(mesh, tcfg, mcfg, table, counts,
                                            hpi, qt, qh, qv))

    return fn


def _local_hits(table, counts, plane, qt, qh, qv, tcfg, mcfg, lo: int):
    """Phase 1 of the RLE exchange on one shard: its bucket range's hits
    for all queries, as the vote's operands [(id, bin) key, qtime if the
    time range is on, hashesperid if a plane is]; each (B, Q * depth)."""
    N = mcfg.n_ids_cap
    nbins = tcfg.maxtime + mcfg.qt_cap
    if N + 1 >= 2**31 or nbins >= 2**29:
        raise ValueError("n_ids_cap or the dt-bin domain is out of range")
    ids3, dts3, hv3 = DT.get_hits_local(table, counts, qt, qh, qv, tcfg, lo)
    B, Q = qh.shape
    H = Q * tcfg.depth
    idk = torch.where(hv3.reshape(B, H),
                      torch.clamp(ids3.reshape(B, H).long(), max=N - 1), N)
    dtb = torch.clamp(dts3.reshape(B, H).long() + mcfg.qt_cap, 0, nbins - 1)
    ops = [voting._pack2(idk, dtb)]
    if mcfg.find_time_range:
        ops.append(torch.clamp(
            qt.long()[:, :, None].expand(B, Q, tcfg.depth).reshape(B, H),
            0, mcfg.qt_cap - 1))
    if plane is not None:
        ops.append(DT.gather_plane(plane, qh, tcfg, lo).reshape(B, H))
    return ops


def _rle_exchange_core(mesh: Mesh, table, counts, hpi, plane, qt, qh, qv,
                       tcfg: DT.TableConfig, mcfg: voting.MatchConfig):
    """The RLE all_to_all mesh match over the local shards: each shard
    gathers its bucket range's hits for all queries -> one all_to_all per
    operand (split the batch, concatenate the hits source-major) -> the
    single-device _vote_rle on each shard's B / ndev query slice ->
    all_gather of the packed (B, max_returns, 7) rows.  hpi, qt, qh, qv:
    lists of the shards' replicated copies; plane: the sharded plane or
    None.  Shared by the two-stage mesh matcher and the fused mesh
    path."""
    los = _bucket_lo(mesh, buckets_per_shard(mesh, tcfg))
    Q = qh[0].shape[1]
    per_shard = [_local_hits(table[l], counts[l],
                             None if plane is None else plane[l],
                             qt[l], qh[l], qv[l], tcfg, mcfg, los[l])
                 for l in range(mesh.n_local)]
    ops = [mesh.all_to_all([sh[i] for sh in per_shard], 0, 1)
           if mesh.size > 1 else [per_shard[0][i]]
           for i in range(len(per_shard[0]))]
    del per_shard
    packed = []
    for l in range(mesh.n_local):
        qt_x = ops[1][l] if mcfg.find_time_range else None
        hpi_x = ops[-1][l] if plane is not None else None
        packed.append(voting.pack_rows(voting._vote_rle(
            ops[0][l], qt_x, hpi_x, hpi[l], mesh.size * Q, tcfg, mcfg)))
    del ops
    return mesh.all_gather(packed, 0)[0]


@functools.lru_cache(maxsize=64)
def sharded_match_rle_packed_cached(mesh: Mesh, tcfg: DT.TableConfig,
                                    mcfg: voting.MatchConfig,
                                    with_plane: bool = False):
    """Sharded matching through the compacted-RLE core: an all_to_all hit
    exchange instead of the histogram core's bin-domain sums.

    The hits are small, and a query hash's hits all live on the shard
    that owns its bucket, so the union of the shards' (B, H) hit arrays is
    the single-device hit multiset:

      1. each shard row-gathers its local hits for all queries (no
         communication: the table rows never move);
      2. one all_to_all (split the batch axis, concatenate the hit axis):
         each shard then holds every shard's hits for its B / ndev queries;
      3. each shard runs voting._vote_rle on its (B / ndev, ndev * H)
         slice;
      4. the packed (B / ndev, max_returns, 7) rows are gathered.

    Bit-identity to the single-device core: the exchanged rows hold the
    same hit multiset per query (plus ndev - 1 rows' worth of invalid
    padding, which sorts last and is masked everywhere), _vote_rle is
    invariant to hit order within a (row, id, bin) group, and each
    (shard, query hash) block of `depth` slots arrives contiguous with a
    hash's real hits in exactly one shard's block, so the exact-count
    pair sort sees the same hits.  B must be a multiple of ndev (the
    Matcher pads the tail with empty queries).

    Returns fn(table, counts, hpi[, plane], qt, qh, qv) -> (B,
    max_returns, 7) int32; with_plane adds the sharded per-entry
    hashesperid plane (DT.build_hpi_plane of each shard) as one more
    exchanged operand."""
    def fn(table, counts, hpi, *rest):
        plane = rest[0] if with_plane else None
        qt, qh, qv = rest[1:] if with_plane else rest
        return _rle_exchange_core(
            mesh, table, counts, mesh.replicate(hpi), plane,
            mesh.replicate(qt), mesh.replicate(qh), mesh.replicate(qv),
            tcfg, mcfg)

    return fn


def split_batch(mesh: Mesh, *arrays) -> list:
    """Each array's rows cut into the global shards' contiguous blocks;
    the local shards' blocks on their devices: [array][local shard]."""
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        if a.shape[0] % mesh.size:
            raise ValueError(f"a batch of {a.shape[0]} rows does not split "
                             f"over {mesh.size} shards")
        per = a.shape[0] // mesh.size
        out.append([a[(mesh.first + l) * per: (mesh.first + l + 1) * per]
                    .to(d) for l, d in enumerate(mesh.devices)])
    return out


@functools.lru_cache(maxsize=64)
def sharded_fused_match_cached(mesh: Mesh, pcfg, tcfg: DT.TableConfig,
                               mcfg: voting.MatchConfig, qcap: int,
                               with_plane: bool = False):
    """Raw audio to packed match results on a mesh, the counterpart of
    matcher._fused_match_graph: each shard fingerprints its slice of the
    batch -> the query hashes are gathered -> the RLE hit exchange and
    local vote (_rle_exchange_core) -> packed rows, replicated.

    Returns fn(table, counts, hpi[, plane], audio, lengths) -> (B,
    max_returns + 1, 7) int32 with _fused_match_graph's readback row [-1]
    ([n_unique_hashes, max_frame, effective_qcap, 0...]), so
    match_fused_resolve re-routes rows past the caps unchanged.  B must be
    a multiple of ndev (the Matcher pads with empty rows)."""
    def fn(table, counts, hpi, *rest):
        plane = rest[0] if with_plane else None
        audio, lengths = rest[1:] if with_plane else rest
        a_l, n_l = split_batch(mesh, audio, lengths)
        loc = []
        for l in range(mesh.n_local):
            th, cnt = pipe.fingerprint_batch_compact(a_l[l], n_l[l], pcfg)
            qce = min(qcap, th.shape[1])
            qt = th[:, :qce, 0]
            qv = (torch.arange(qce, device=th.device)[None]
                  < torch.clamp(cnt, max=qce)[:, None])
            maxt = (torch.where(qv, qt, 0).amax(dim=1) if qce
                    else torch.zeros_like(cnt))
            loc.append((qt, th[:, :qce, 1], qv, cnt, maxt.to(cnt.dtype)))
        qt, qh, qv, cnt_g, maxt = (
            mesh.all_gather([x[i] for x in loc], 0) for i in range(5))
        packed = _rle_exchange_core(mesh, table, counts,
                                    mesh.replicate(hpi), plane, qt, qh, qv,
                                    tcfg, mcfg)
        cnt_g, maxt = cnt_g[0], maxt[0]
        zero = torch.zeros_like(cnt_g)
        extra = torch.stack([cnt_g, maxt, torch.full_like(cnt_g, qce),
                             zero, zero, zero, zero], dim=-1)
        return torch.cat([packed, extra[:, None, :].to(packed.dtype)], dim=1)

    return fn


class ShardedStore:
    """A device-resident bucket-sharded store around a host HashTable:
    the constructor uploads its table sharded over the mesh,
    `store_chunk()` replays per-file hash streams through the
    deterministic device reservoir (bit-identical to the sequential host
    store_vectorized of the same files), and `finalize()` downloads the
    result into the host table, which stays the persistence mirror."""

    def __init__(self, ht, mesh: Mesh):
        self.ht = ht
        self.mesh = mesh
        self.table, self.counts, self.cfg = upload_sharded(ht, mesh)
        self._store = sharded_store_fn(mesh, self.cfg)

    def store_chunk(self, names_hashes: list) -> None:
        """Store [(name, (n, 2) int host hashes)] in order; ids come from
        the host table's name_to_id (names and hashesperid stay on the
        host)."""
        if not names_hashes:
            return
        B = len(names_hashes)
        L = P.next_pow2(max(1, max(len(h) for _, h in names_hashes)), 256)
        Bp = P.next_pow2(B, 8)
        tt = np.zeros((Bp, L), np.int32)
        hh = np.zeros((Bp, L), np.int32)
        vv = np.zeros((Bp, L), bool)
        ids = np.zeros(Bp, np.int32)
        for b, (name, h) in enumerate(names_hashes):
            h = np.asarray(h).reshape(-1, 2)
            id_ = self.ht.name_to_id(name, add_if_missing=True)
            self.ht._check_id_capacity(id_)
            self.ht.hashesperid[id_] += len(h)
            ids[b] = id_
            tt[b, : len(h)] = h[:, 0]
            hh[b, : len(h)] = h[:, 1]
            vv[b, : len(h)] = True
        self._store(self.table, self.counts, tt, hh, vv, ids)

    def finalize(self) -> None:
        """Download the device state into the host table."""
        tab = gather_sharded(self.mesh, self.table)
        self.ht.table = tab.view(np.uint64 if self.cfg.wide else np.uint32)
        self.ht.counts = gather_sharded(self.mesh, self.counts)
        self.ht.dirty = True
        self.ht.rev += 1


def resolve_ndev(ndev: int | None, device=None) -> int:
    """--ndev resolution for the CLI and the Matcher: an explicit value
    wins (N shards, placed round-robin on the local devices); None / 0 =
    one shard per CUDA device of the job, and 1 when `device` is the CPU.
    1 = the single-device paths."""
    if ndev:
        return int(ndev)
    if device is not None and torch.device(device).type == "cpu":
        return 1
    world = M.current_world()
    return max(1, torch.cuda.device_count()) * (world.nproc if world else 1)


def mesh_devices(device):
    """make_mesh's `devices` for an entry point that runs on `device`:
    the CPU itself, or None (every local CUDA device)."""
    device = torch.device(device)
    return [device] if device.type == "cpu" else None


def sharded_merge_fn(mesh: Mesh, cfg: DT.TableConfig):
    """Merge as resharding: replay another table's stored entries into
    the sharded table.  Returns fn(table, counts, hashes (N,), entries
    (N,), valid (N,)) -> (table, counts), the shards updated in place.
    The entries already carry the id offset (entry_streams)."""
    los = _bucket_lo(mesh, buckets_per_shard(mesh, cfg))

    def merge(table, counts, h, e, v):
        streams = [mesh.replicate(a) for a in (h, e, v)]
        for l, lo in enumerate(los):
            DT.store_packed_local(table[l], counts[l],
                                  *[s[l] for s in streams], cfg, lo)
        return table, counts

    return merge


def entry_streams(ht, id_offset: int = 0):
    """Host HashTable -> flat (hashes, entries, valid) replay streams in
    bucket-major, slot order (the host merge's replay order).  Entries are
    uint32 values, or uint64 for a wide table, each as the int64 that
    DT.store_packed_local takes."""
    from audfprint_torch.index.hash_table import _stored_entry_streams

    hs, _ranks, es = _stored_entry_streams(ht)
    if getattr(ht, "wide", False):
        es = es.astype(np.uint64) + np.uint64(id_offset << ht.maxtimebits)
    else:
        es = (es + np.uint32(id_offset << ht.maxtimebits)).astype(np.uint32)
    return hs.astype(np.int32), es.astype(np.int64), np.ones(len(hs), bool)


def dp_fingerprint_fn(mesh: Mesh, cfg):
    """Data-parallel fingerprinting: each shard fingerprints its
    contiguous block of the batch; returns fn(audio, lengths) ->
    pipeline.fingerprint_batch's (times, hashes, uniq, counts) for the
    whole batch."""

    def f(audio, lengths):
        a_l, n_l = split_batch(mesh, audio, lengths)
        outs = [pipe.fingerprint_batch(a_l[l], n_l[l], cfg)
                for l in range(mesh.n_local)]
        return tuple(mesh.all_gather([o[i] for o in outs], 0)[0]
                     for i in range(4))

    return f
