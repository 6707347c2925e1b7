"""Host-side inverted hash index (the canonical table + .pklz persistence).

Behavioral spec: SURVEY.md §2.3.4 (reference hash_table.py).  State:

  table:       uint32[(1 << hashbits), depth]    entry = (id << maxtimebits) | t
  counts:      int32[1 << hashbits]              true insertion pressure/bucket
  names:       list[str|None]                    id -> filename
  hashesperid: int64[n_ids]                      hashes attempted per id
  params:      dict                              analyzer compat check on load

The store uses reservoir sampling past `depth` like the reference
(hash_table.py:~120-180) but with the deterministic keyed PRNG from
`audfprint_torch.utils.prng` instead of Python's `random` (documented
divergence; identical behavior below overflow — SURVEY §7 "Hard parts").
This is the port's own copy of audfprint_tpu/index/hash_table.py; a
database either package writes loads in the other.

This class is simultaneously the *oracle* for the device-resident table in
`audfprint_torch.index.device_table`: both must produce bit-identical tables
for the same insertion stream.

Persistence: `.pklz` = gzip-pickled plain-dict snapshot (the reference
gzip-pickles its class instance, hash_table.py:~250-330; a plain dict keeps
the format loadable without this module's class path).  Sparse tables save
their occupied slots only (`table_compact` key; `_compact_table_state`) —
gzip-compressing the dense mostly-zero 400 MB array was the single largest
cost of an end-to-end CLI ingest — with a verified tail-invariant check so
the round-trip is provably bit-exact, falling back to the dense pickle
otherwise.  Interchange with the reference (SURVEY §5 checkpoint row):
`load()` also accepts upstream class-instance pickles via an
attribute-mapping shim (any `*.HashTable` global resolves to a stub), and
`save_upstream()` writes a class-instance `.pklz` the reference tool can
read back.
"""

from __future__ import annotations

import contextlib
import gzip
import os
import pickle
import sys
import types

import numpy as np

from audfprint_torch import params as P
from audfprint_torch.utils import prng

HT_VERSION = 20260816
HT_COMPAT_VERSION = 20260816
AFDB_MAGIC = b"AFDB0001"   # mmap-able uncompressed snapshot (serving)
# Upstream audfprint version stamps (hash_table.py:~20): HT_VERSION is the
# date of the current on-disk layout; tables older than the OLD_COMPAT floor
# predate maxtimebits and are refused upstream too.
UPSTREAM_HT_VERSION = 20170724
UPSTREAM_OLD_COMPAT = 20140920


class _UpstreamStub:
    """Attribute bag standing in for upstream's pickled HashTable class.

    Upstream `.pklz` files gzip-pickle the class *instance*
    (hash_table.py:~250-330), so the stream contains a GLOBAL reference to
    `hash_table.HashTable`.  Unpickling only needs a class whose instances
    take attributes via __dict__ — this stub does, regardless of which
    module path the writing process used.
    """


class _UpstreamUnpickler(pickle.Unpickler):
    """Resolve any `*.HashTable` global to the attribute-bag stub so
    upstream-written `.pklz` files load without upstream on the path."""

    def find_class(self, module, name):
        if name == "HashTable":
            return _UpstreamStub
        return super().find_class(module, name)


@contextlib.contextmanager
def _upstream_pickle_class():
    """Yield a class that pickles as the GLOBAL (`hash_table`, `HashTable`)
    upstream expects.  If the real upstream module is already importable we
    use its class directly (instances are built via `__new__`, so its ~400 MB
    default-table `__init__` never runs); otherwise a synthetic stub module
    is registered in sys.modules ONLY for the duration of the pickle, so a
    later genuine `import hash_table` is never shadowed."""
    mod = sys.modules.get("hash_table")
    if mod is not None and getattr(getattr(mod, "HashTable", None),
                                   "__module__", None) == "hash_table":
        yield mod.HashTable
        return
    stub = types.ModuleType("hash_table")

    class HashTable:   # noqa: N801 - must match upstream's class name
        pass

    HashTable.__module__ = "hash_table"
    HashTable.__qualname__ = "HashTable"
    stub.HashTable = HashTable
    prev = sys.modules.get("hash_table")
    sys.modules["hash_table"] = stub
    try:
        yield HashTable
    finally:
        if prev is None:
            sys.modules.pop("hash_table", None)
        else:
            sys.modules["hash_table"] = prev


@contextlib.contextmanager
def _atomic_replace(name: str, opener=open):
    """Write-to-temp + atomic rename, unlinking the temp when the write
    raises so an interrupted save never leaks '{name}.tmp.{pid}' files
    (ADVICE r2).  Yields (file object, temp path)."""
    tmp = f"{name}.tmp.{os.getpid()}"
    try:
        f = opener(tmp, "wb")
        try:
            yield f, tmp
        finally:
            f.close()
        os.replace(tmp, name)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _gzip_opener(path: str, mode: str):
    # compresslevel 4: ~12x faster than gzip's default 9 on the sparse
    # table for ~1% larger output; the format is plain gzip either way
    return gzip.open(path, mode, compresslevel=4)


def _state_from_upstream(obj: "_UpstreamStub") -> dict:
    """Map an upstream HashTable instance's attributes onto the dict schema.

    Upstream attributes (hash_table.py:~60-110): hashbits, depth,
    maxtimebits, table, counts, names, hashesperid (uint32), params,
    ht_version, dirty.  Very old tables may predate maxtimebits; default 14
    (maxtime 16384), the constant upstream used before it was a parameter.
    """
    d = dict(getattr(obj, "__dict__", {}))
    version = int(d.get("ht_version", 0))
    if version < UPSTREAM_OLD_COMPAT:
        raise ValueError(
            f"upstream hash table version {version} predates "
            f"{UPSTREAM_OLD_COMPAT}; not loadable (same floor as upstream)")
    for key in ("hashbits", "depth", "table", "counts", "names"):
        if key not in d:
            raise ValueError(
                f"upstream hash table missing attribute {key!r}")
    maxtimebits = int(d.get("maxtimebits", 14))
    params = dict(d.get("params") or {})
    params.setdefault("loaded_from_upstream_version", version)
    n_ids = len(d["names"])
    hashesperid = np.asarray(
        d.get("hashesperid", np.zeros(n_ids, np.uint32))).astype(np.int64)
    return {
        "ht_version": HT_VERSION,
        "hashbits": int(d["hashbits"]),
        "depth": int(d["depth"]),
        "maxtime": 1 << maxtimebits,
        "seed": 0,
        "table": np.ascontiguousarray(d["table"], dtype=np.uint32),
        "counts": np.ascontiguousarray(d["counts"], dtype=np.int32),
        "names": list(d["names"]),
        "hashesperid": hashesperid,
        "params": params,
    }


def _table_from_compact(buckets: np.ndarray, entries: np.ndarray,
                        counts: np.ndarray, nbuckets: int, depth: int,
                        dtype) -> np.ndarray:
    """Rebuild the dense table from a compact occupied-slot stream.

    `buckets` lists the buckets with >= 1 stored entry (ascending);
    `entries` is their slot values in bucket-major slot order (the same
    order `_stored_entry_streams` emits).  Exact inverse of the compact
    save because the save path verified the tail invariant (every slot at
    index >= min(counts, depth) is zero) before choosing this format."""
    table = np.zeros((nbuckets, depth), dtype)
    stored = np.minimum(counts, depth).astype(np.int64)
    k = stored[buckets]
    hs = np.repeat(buckets, k)
    starts = np.cumsum(k) - k
    ranks = np.arange(len(hs), dtype=np.int64) - np.repeat(starts, k)
    table[hs, ranks] = entries
    return table


def _stored_entry_streams(ht: "HashTable"):
    """Flat (bucket, within-bucket rank, entry) streams of every *stored*
    entry of `ht`, in bucket-major slot order — the replay order of the
    reference's merge (hash_table.py:~340-400).  O(total entries)."""
    stored = np.minimum(ht.counts, ht.depth).astype(np.int64)
    nzb = np.nonzero(stored)[0]
    if len(nzb) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.uint32))
    k = stored[nzb]
    hs = np.repeat(nzb, k)
    starts = np.cumsum(k) - k
    ranks = np.arange(len(hs), dtype=np.int64) - np.repeat(starts, k)
    es = ht.table[hs, ranks]
    return hs, ranks, es


class HashTable:
    def __init__(self, filename: str | None = None,
                 hashbits: int = P.TABLE_HASHBITS,
                 depth: int = P.TABLE_DEPTH,
                 maxtime: int = P.TABLE_MAXTIME,
                 seed: int = 0,
                 idbits: int = 0):
        if filename is not None:
            self.load(filename)
            return
        self.hashbits = hashbits
        self.depth = depth
        assert maxtime & (maxtime - 1) == 0, "maxtime must be a power of 2"
        self.maxtime = maxtime
        self.maxtimebits = int(np.log2(maxtime))
        self.seed = seed
        # idbits = 0 (default): the reference's packed uint32 entries,
        # id capacity 2^(32 - maxtimebits).  An explicit idbits with
        # idbits + maxtimebits > 32 switches to WIDE entries (uint64 host,
        # split uint32 planes on device) — VERDICT r2 #6: capacity beyond
        # the reference's 2^18-track / mod-16384 packing cap.  Both fields
        # are capped at 31 bits (ids stay int32 in the voting core).
        if idbits < 0 or idbits > 31 or self.maxtimebits > 31:
            raise ValueError(
                "idbits must be in [0, 31] and maxtimebits <= 31")
        if not idbits and self.maxtimebits > 31:
            raise ValueError("maxtimebits must be <= 31")
        self.idbits = int(idbits)
        dtype = np.uint64 if self.wide else np.uint32
        self.table = np.zeros((1 << hashbits, depth), dtype=dtype)
        self.counts = np.zeros(1 << hashbits, dtype=np.int32)
        self.names: list = []
        self.hashesperid = np.zeros(0, dtype=np.int64)
        self.params: dict = {}
        self.ht_version = HT_VERSION
        self.dirty = False
        self.rev = 0          # bumped on every mutation (device-cache key)

    # -- packing ------------------------------------------------------------

    @property
    def idbits_eff(self) -> int:
        return self.idbits or (32 - self.maxtimebits)

    @property
    def wide(self) -> bool:
        return self.idbits_eff + self.maxtimebits > 32

    def _check_id_capacity(self, id_: int) -> None:
        if id_ >= (1 << self.idbits_eff):
            raise ValueError(
                f"track id {id_} exceeds the table's {self.idbits_eff}-bit "
                f"id capacity; rebuild with a larger --idbits (wide "
                f"entries) to store more tracks")

    # -- id management ------------------------------------------------------

    def _invalidate_index(self) -> None:
        self._name_index = None
        self._index_len = -1

    def _index(self) -> dict:
        # name -> id dict kept alongside `names` (a bare list.index scan
        # makes big ingests quadratic).  Duplicate names (possible after
        # merge, as upstream) map to their FIRST id — upstream's
        # list.index rule.  The cache is keyed on len(names) and
        # explicitly invalidated by load()/remove(), which can change
        # content without changing the length.
        idx = getattr(self, "_name_index", None)
        if idx is None or getattr(self, "_index_len", -1) != len(self.names):
            idx = {}
            for i, n in enumerate(self.names):
                if n is not None and n not in idx:
                    idx[n] = i
            self._name_index = idx
            self._index_len = len(self.names)
        return idx

    def name_to_id(self, name, add_if_missing: bool = False) -> int:
        if isinstance(name, (int, np.integer)):
            return int(name)
        idx = self._index()
        if name in idx:
            return idx[name]
        if not add_if_missing:
            raise ValueError(f"{name!r} not in table")
        self.names.append(name)
        self.hashesperid = np.append(self.hashesperid, 0)
        idx[name] = len(self.names) - 1
        self._index_len = len(self.names)
        return len(self.names) - 1

    # -- store / retrieve ---------------------------------------------------

    def store(self, name, timehashpairs) -> None:
        """Sequential reference-faithful store (hash_table.py:~120-180)."""
        id_ = self.name_to_id(name, add_if_missing=True)
        self._check_id_capacity(id_)
        hashmask = (1 << self.hashbits) - 1
        timemask = self.maxtime - 1
        idval = id_ << self.maxtimebits
        for time_, hash_ in np.asarray(timehashpairs).reshape(-1, 2):
            hash_ = int(hash_) & hashmask
            time_ = int(time_) & timemask
            count = int(self.counts[hash_])
            if count < self.depth:
                self.table[hash_, count] = idval + time_
            else:
                slot = int(prng.reservoir_slot(hash_, count, self.seed))
                if slot < self.depth:
                    self.table[hash_, slot] = idval + time_
            self.counts[hash_] = count + 1
        self.hashesperid[id_] += len(timehashpairs)
        self.dirty = True
        self.rev += 1

    def store_vectorized(self, name, timehashpairs) -> None:
        """Vectorized host store, bit-identical to `store`.

        Sorts by bucket (stable), ranks entries within each bucket run, and
        resolves reservoir slots + within-batch collisions (last write wins,
        matching sequential order) before a single scatter.  This is the same
        algorithm the on-device store kernel uses (SURVEY §7 layer 3).
        """
        id_ = self.name_to_id(name, add_if_missing=True)
        self._check_id_capacity(id_)
        pairs = np.asarray(timehashpairs, dtype=np.int64).reshape(-1, 2)
        n = len(pairs)
        if n == 0:
            self.hashesperid[id_] += 0
            self.dirty = True
            self.rev += 1
            return
        hashmask = (1 << self.hashbits) - 1
        timemask = self.maxtime - 1
        h = pairs[:, 1] & hashmask
        t = pairs[:, 0] & timemask
        entry = ((id_ << self.maxtimebits) | t).astype(self.table.dtype)
        # stable sort by bucket keeps arrival order within a bucket
        order = np.argsort(h, kind="stable")
        hs, es = h[order], entry[order]
        # rank of each element within its bucket run
        first = np.r_[True, hs[1:] != hs[:-1]]
        run_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
        rank = np.arange(n) - run_start
        pos = self.counts[hs] + rank            # insertion position
        slot = np.where(
            pos < self.depth, pos,
            prng.reservoir_slot(hs, np.maximum(pos, self.depth), self.seed))
        write = slot < self.depth
        # within-batch collisions on (bucket, slot): keep the LAST (sequential
        # semantics).  np scatter with duplicate indices keeps the last in
        # index order, and (hs, slot) pairs are in arrival order here.
        self.table[hs[write], slot[write]] = es[write]
        np.add.at(self.counts, hs, 1)
        self.hashesperid[id_] += n
        self.dirty = True
        self.rev += 1

    def get_entry(self, hash_) -> np.ndarray:
        """(id, time) rows currently stored for one hash."""
        hash_ = int(hash_) & ((1 << self.hashbits) - 1)
        nids = min(self.depth, int(self.counts[hash_]))
        vals = self.table[hash_, :nids].astype(np.int64)
        return np.stack([vals >> self.maxtimebits,
                         vals & (self.maxtime - 1)], axis=1)

    def get_hits(self, hashes) -> np.ndarray:
        """Query rows (time, hash) -> hit rows (id, dt, hash, qtime), int32.

        Reference hash_table.py:~190-240: per query hash, its stored entries
        in slot order; dt = stored_time - qtime (may be negative; mod-maxtime
        wrap tolerated).
        """
        hashes = np.asarray(hashes).reshape(-1, 2)
        hashmask = (1 << self.hashbits) - 1
        timemask = self.maxtime - 1
        qh = hashes[:, 1].astype(np.int64) & hashmask
        qt = hashes[:, 0].astype(np.int64)
        nids = np.minimum(self.depth, self.counts[qh])        # (n,)
        tab = self.table[qh].astype(np.int64)                 # (n, depth)
        valid = np.arange(self.depth)[None, :] < nids[:, None]
        ids = tab >> self.maxtimebits
        dts = (tab & timemask) - qt[:, None]
        out = np.stack([ids, dts,
                        np.broadcast_to(qh[:, None], tab.shape),
                        np.broadcast_to(qt[:, None], tab.shape)], axis=2)
        return out[valid].astype(np.int32)

    def totalhashes(self) -> int:
        return int(np.sum(np.minimum(self.counts, self.depth)))

    # -- maintenance --------------------------------------------------------

    def _merge_meta(self, other: "HashTable") -> int:
        """Parameter checks + id-space bookkeeping shared by the host merge
        and the CLI's device merge path (parallel.sharded.sharded_merge_fn):
        validates compatibility, extends names/hashesperid, and returns the
        id offset to apply to other's entries."""
        if (other.hashbits != self.hashbits or other.depth != self.depth
                or other.maxtime != self.maxtime
                or other.idbits_eff != self.idbits_eff):
            raise ValueError("hash table parameter mismatch in merge")
        self._check_params_compat(other.params)
        idoffset = len(self.names)
        if len(other.names):
            self._check_id_capacity(idoffset + len(other.names) - 1)
        self.names.extend(other.names)
        self.hashesperid = np.concatenate([self.hashesperid,
                                           other.hashesperid])
        return idoffset

    def _merge_counts(self, other: "HashTable") -> None:
        """Post-merge count/param bookkeeping shared with the device merge:
        counts become the combined true insertion pressure (what the
        reference records; replaying stored entries alone would undercount
        where `other` overflowed, changing later merges' slot decisions)."""
        self.counts = self.counts + other.counts
        if not self.params and other.params:
            self.params = dict(other.params)
        self.dirty = True
        self.rev += 1

    def merge(self, other: "HashTable") -> None:
        """Combine another table into this one (hash_table.py:~340-400).

        Other's ids are offset by len(self.names); other's *stored* entries
        are replayed through the reservoir continuing from self's counts, then
        counts are set to the combined true insertion pressure.
        """
        idoffset = self._merge_meta(other)
        idoffsetval = self.table.dtype.type(idoffset << self.maxtimebits)
        # Vectorized replay of other's stored entries in (bucket, slot) order
        # — the same sort/rank/scatter formulation as store_vectorized, O(N
        # entries) instead of a Python loop over nonzero buckets.  Sequential
        # semantics preserved: entry k of bucket h lands at insertion
        # position counts[h]+k (reservoir past depth); duplicate (bucket,
        # slot) scatters keep the LAST in replay order, as numpy fancy
        # assignment does for index-ordered duplicates.
        hs, ranks, es = _stored_entry_streams(other)
        if len(hs):
            es = (es + idoffsetval).astype(self.table.dtype)
            pos = self.counts[hs].astype(np.int64) + ranks
            slot = np.where(
                pos < self.depth, pos,
                prng.reservoir_slot(hs, np.maximum(pos, self.depth),
                                    self.seed))
            write = slot < self.depth
            self.table[hs[write], slot[write]] = es[write]
        self._merge_counts(other)

    def remove(self, name) -> None:
        """Delete all entries for `name`, compacting buckets (O(table)).

        Vectorized (VERDICT r2 #8): one full-table scan finds affected
        buckets; compaction runs only on those rows via a stable per-row
        argsort that moves kept entries to the front in slot order — the
        same result as the per-bucket boolean-index loop (regression:
        test_vectorized_remove_matches_loop), without O(affected buckets)
        interpreter iterations on a 2^20-bucket table."""
        id_ = self.name_to_id(name)
        dt = self.table.dtype.type
        hit = (self.table >> dt(self.maxtimebits)) == dt(id_)
        stored = np.minimum(self.counts, self.depth)
        slot = np.arange(self.depth)
        # only in-use slots count as entries
        hit &= slot[None, :] < stored[:, None]
        aff = np.nonzero(hit.any(axis=1))[0]
        if len(aff):
            sub = np.array(self.table[aff])             # (A, depth) copy
            keep = (slot[None, :] < stored[aff, None]) & ~hit[aff]
            # stable: kept entries keep their relative slot order
            order = np.argsort(~keep, axis=1, kind="stable")
            sub = np.take_along_axis(sub, order, axis=1)
            nkeep = keep.sum(axis=1)
            sub[slot[None, :] >= nkeep[:, None]] = 0
            self.table[aff] = sub
            self.counts[aff] = nkeep.astype(self.counts.dtype)
        self.names[id_] = None
        self.hashesperid[id_] = 0
        self._invalidate_index()   # length unchanged; content did change
        self.dirty = True
        self.rev += 1

    def list(self, print_fn=None) -> list:
        print_fn = print_fn or print
        msgs = []
        for i, name in enumerate(self.names):
            if name is None:
                continue
            msg = f"{name} ({int(self.hashesperid[i])} hashes)"
            print_fn(msg)
            msgs.append(msg)
        return msgs

    def reset(self) -> None:
        self.table[:] = 0
        self.counts[:] = 0
        self.names = []
        self.hashesperid = np.zeros(0, dtype=np.int64)
        self.dirty = True
        self.rev += 1

    # -- persistence --------------------------------------------------------

    def _check_params_compat(self, other_params: dict) -> None:
        for key in ("density", "samplerate", "n_fft", "n_hop"):
            if (key in self.params and key in other_params
                    and self.params[key] != other_params[key]):
                raise ValueError(
                    f"analyzer param mismatch: {key}: "
                    f"{self.params[key]} vs {other_params[key]}")

    # -- .afdb: mmap-able uncompressed snapshot (serving format) -----------

    def _save_afdb(self, name: str) -> None:
        """Write the `.afdb` layout: magic, JSON header, then 64-byte-
        aligned raw little-endian `counts` (int32) and `table` (uint32)
        sections.  Loads open the table as a copy-on-write memmap, so a
        multi-hundred-MB database is usable in milliseconds (the .pklz
        gunzip-unpickle of the same table takes seconds) — at the cost of
        no compression.  Additive format; .pklz stays the default and the
        reference-interchange format."""
        import json

        header = {
            "ht_version": self.ht_version,
            "hashbits": self.hashbits,
            "depth": self.depth,
            "maxtime": self.maxtime,
            "seed": self.seed,
            "idbits": self.idbits,
            "names": self.names,
            "hashesperid": [int(x) for x in self.hashesperid],
            "params": self.params,
        }
        # numpy scalars (possible when params came from a foreign .pklz)
        # aren't JSON-serializable — unwrap via .item() (ADVICE r2)
        hb = json.dumps(
            header,
            default=lambda o: o.item() if hasattr(o, "item") else str(o)
        ).encode()
        # write-to-temp + atomic rename: saving over the SAME file that
        # backs this table's live copy-on-write memmaps (load -> add ->
        # save cycle) must not truncate it under them (SIGBUS); the old
        # inode stays mapped until the memmaps are dropped
        with _atomic_replace(name) as (f, _tmp):
            f.write(AFDB_MAGIC)
            f.write(np.uint64(len(hb)).tobytes())
            f.write(hb)
            f.write(b"\0" * (-f.tell() % 64))
            np.ascontiguousarray(self.counts, np.int32).tofile(f)
            f.write(b"\0" * (-f.tell() % 64))
            np.ascontiguousarray(self.table, self.table.dtype).tofile(f)

    @staticmethod
    def _afdb_offsets(hlen: int, nbuckets: int):
        off = 16 + hlen
        off_counts = off + (-off % 64)
        off2 = off_counts + 4 * nbuckets
        off_table = off2 + (-off2 % 64)
        return off_counts, off_table

    def _load_afdb(self, name: str) -> dict:
        import json

        with open(name, "rb") as f:
            assert f.read(8) == AFDB_MAGIC
            hlen = int(np.frombuffer(f.read(8), np.uint64)[0])
            header = json.loads(f.read(hlen).decode())
        nb = 1 << header["hashbits"]
        off_counts, off_table = self._afdb_offsets(hlen, nb)
        # mode="c" (copy-on-write): reads are lazy page-ins straight from
        # the file; mutations (store/merge/remove) dirty private pages
        counts = np.memmap(name, np.int32, mode="c",
                           offset=off_counts, shape=(nb,))
        idbits = int(header.get("idbits", 0))
        mtb = int(np.log2(header["maxtime"]))
        wide = (idbits or (32 - mtb)) + mtb > 32
        table = np.memmap(name, np.uint64 if wide else np.uint32, mode="c",
                          offset=off_table,
                          shape=(nb, header["depth"]))
        return {
            "ht_version": header["ht_version"],
            "hashbits": header["hashbits"],
            "depth": header["depth"],
            "maxtime": header["maxtime"],
            "seed": header.get("seed", 0),
            "idbits": idbits,
            "table": table,
            "counts": counts,
            "names": header["names"],
            "hashesperid": np.asarray(header["hashesperid"], np.int64),
            "params": header.get("params", {}),
        }

    def _compact_table_state(self) -> dict | None:
        """Compact occupied-slot form of `table` for `.pklz` saves, or None
        when the dense array should be pickled instead.

        The dense table is (1 << hashbits) x depth — 400 MB at defaults —
        but after a typical ingest the overwhelming majority of slots are
        zero, and gzip spends seconds compressing zeros (the dominant cost
        of the end-to-end CLI ingest on this host).  The compact form
        stores only the occupied buckets and their stored-slot values;
        reconstruction scatters them into a zero table (`counts`, saved
        either way, gives every bucket's slot occupancy).

        Exactness precondition (verified, not assumed): every slot at
        index >= min(counts[b], depth) must be zero.  store/merge/remove
        maintain that invariant, but a table mutated by external code
        might not — so compare the dense table's nonzero count against the
        stored-entry stream's; any tail nonzero breaks the equality and
        forces the dense path.  (Zero-valued *stored* entries — id 0 at
        t 0 packs to 0 — reconstruct correctly either way: the target
        array starts zeroed.)"""
        stored = np.minimum(self.counts, self.depth).astype(np.int64)
        total = int(stored.sum())
        # past ~50% occupancy the index overhead outweighs the savings
        if total * 2 * self.table.itemsize >= self.table.nbytes:
            return None
        _hs, _ranks, entries = _stored_entry_streams(self)
        if np.count_nonzero(entries) != np.count_nonzero(self.table):
            return None          # tail invariant violated -> dense save
        return {
            "buckets": np.nonzero(stored)[0].astype(np.int64),
            "entries": entries,
        }

    def save(self, name: str, params: dict | None = None,
             file_object=None) -> None:
        if params:
            self.params.update(params)
        if file_object is None and name.endswith(".afdb"):
            self._save_afdb(name)
            self.dirty = False
            nhashes = self.totalhashes()
            nfiles = sum(1 for n in self.names if n is not None)
            print(f"Saved fprints for {nfiles} files "
                  f"({nhashes} hashes) to {name}")
            return
        state = {
            "ht_version": self.ht_version,
            "hashbits": self.hashbits,
            "depth": self.depth,
            "maxtime": self.maxtime,
            "seed": self.seed,
            "idbits": self.idbits,
            "table": self.table,
            "counts": self.counts,
            "names": self.names,
            "hashesperid": self.hashesperid,
            "params": self.params,
        }
        compact = self._compact_table_state()
        if compact is not None:
            del state["table"]
            state["table_compact"] = compact
        self._invalidate_index()   # never persist the derived index
        # Named saves go through a temp + atomic rename (crash safety, and
        # a re-save over a file backing live .afdb memmaps must never
        # truncate it).
        if file_object is not None:
            pickle.dump(state, file_object, protocol=4)
        else:
            with _atomic_replace(name, _gzip_opener) as (f, _tmp):
                pickle.dump(state, f, protocol=4)
        self.dirty = False
        nhashes = self.totalhashes()
        nfiles = sum(1 for n in self.names if n is not None)
        print(f"Saved fprints for {nfiles} files ({nhashes} hashes) to {name}")

    def save_upstream(self, name: str, params: dict | None = None) -> None:
        """Write an upstream-audfprint-compatible `.pklz`: a gzip pickle of a
        `hash_table.HashTable` class instance with upstream's attribute
        layout (hash_table.py:~250-330), loadable by the reference tool."""
        if self.wide:
            raise ValueError(
                "wide-entry tables (idbits + maxtimebits > 32) cannot be "
                "exported to the upstream uint32 .pklz format")
        if params:
            self.params.update(params)
        with _upstream_pickle_class() as cls:
            obj = object.__new__(cls)
            obj.ht_version = UPSTREAM_HT_VERSION
            obj.hashbits = self.hashbits
            obj.depth = self.depth
            obj.maxtimebits = self.maxtimebits
            obj.table = self.table
            obj.counts = self.counts
            obj.names = list(self.names)
            obj.hashesperid = np.asarray(
                np.minimum(self.hashesperid, 2**32 - 1), dtype=np.uint32)
            obj.params = {k: v for k, v in self.params.items()
                          if k != "loaded_from_upstream_version"}
            obj.dirty = False
            with _atomic_replace(name, _gzip_opener) as (f, _tmp):
                pickle.dump(obj, f, protocol=2)   # upstream py2/py3 pickle
        self.dirty = False
        nhashes = self.totalhashes()
        nfiles = sum(1 for n in self.names if n is not None)
        print(f"Saved fprints for {nfiles} files ({nhashes} hashes) to {name}")

    def load(self, name: str) -> None:
        # format sniff by magic bytes, not extension
        with open(name, "rb") as fraw:
            magic = fraw.read(8)
        if magic == AFDB_MAGIC:
            state = self._load_afdb(name)
        else:
            with gzip.open(name, "rb") as f:
                state = _UpstreamUnpickler(f).load()
            if isinstance(state, _UpstreamStub):
                state = _state_from_upstream(state)
            elif not isinstance(state, dict):
                raise ValueError(
                    f"unrecognized hash table pickle ({type(state).__name__})")
        if state["ht_version"] < HT_COMPAT_VERSION:
            raise ValueError(
                f"incompatible hash table version {state['ht_version']}")
        self.ht_version = state["ht_version"]
        self.hashbits = state["hashbits"]
        self.depth = state["depth"]
        self.maxtime = state["maxtime"]
        self.maxtimebits = int(np.log2(self.maxtime))
        self.seed = state.get("seed", 0)
        self.idbits = int(state.get("idbits", 0))
        self.counts = state["counts"]
        if "table_compact" in state:
            comp = state["table_compact"]
            mtb = int(np.log2(self.maxtime))
            wide = (self.idbits or (32 - mtb)) + mtb > 32
            self.table = _table_from_compact(
                comp["buckets"], comp["entries"], self.counts,
                1 << self.hashbits, self.depth,
                np.uint64 if wide else np.uint32)
        else:
            self.table = state["table"]
        self.names = state["names"]
        self.hashesperid = state["hashesperid"]
        self.params = state.get("params", {})
        self.dirty = False
        # the cached name index may coincidentally match the new names
        # list's length — always drop it on load
        self._invalidate_index()
        self.rev = getattr(self, "rev", 0) + 1
        nhashes = self.totalhashes()
        nfiles = sum(1 for n in self.names if n is not None)
        print(f"Read fprints for {nfiles} files ({nhashes} hashes) from {name}")
