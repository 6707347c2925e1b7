"""Worker of tests/test_torch_multihost.py: one of N torch.distributed
processes over gloo on the CPU, each with its own logical shards.  Builds
the global mesh, assembles the batch from the processes' slices with a
real allgather, stores the hash streams into the bucket-sharded table,
and checks, across the process boundary: the histogram core with summed
partials against the numpy oracle, Matcher(ndev = all shards) through the
RLE hit exchange against Matcher(ndev=1), the sharded store against the
host store, and the routed fused ingest against the host store.

Run: python torch_multihost_worker.py <process_id> <num_processes> <port>
     <local shards> [device]     (device: every local shard's, default cpu)
"""

import sys


def main() -> None:
    pid, nproc, port, nloc = (int(a) for a in sys.argv[1:5])
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from audfprint_torch import params as P
    from audfprint_torch.index import device_table as DT
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.match import voting
    from audfprint_torch.match.matcher import Matcher
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.models.ingest import DeviceIngest
    from audfprint_torch.oracle import match as om
    from audfprint_torch.parallel import multihost, sharded

    multihost.initialize(f"localhost:{port}", nproc, pid, backend="gloo",
                         timeout_s=120)
    assert multihost.process_count() == nproc
    mesh = multihost.global_table_mesh([device] * nloc)
    assert mesh.size == nproc * nloc and mesh.first == pid * nloc
    tcfg = DT.TableConfig(hashbits=12, depth=8, maxtimebits=10, seed=0)
    mcfg = voting.MatchConfig(search_depth=8, max_returns=2, threshcount=5,
                              qt_cap=128, n_ids_cap=16, exact_count=True,
                              find_time_range=True)

    # every process derives the same streams but feeds only its slice; the
    # replicated batch comes from the cross-process allgather.  B = 6 does
    # not divide over 4 processes (slices 2, 2, 1, 1): the padded path.
    rng = np.random.default_rng(20260816)
    B, L = 6, 64
    tt_full = rng.integers(0, 100, (B, L)).astype(np.int32)
    hh_full = rng.integers(0, 1 << tcfg.hashbits, (B, L)).astype(np.int32)
    sl = multihost.process_local_batch_slice(B)
    per, rem = divmod(B, nproc)
    start = pid * per + min(pid, rem)
    assert sl == slice(start, start + per + (1 if pid < rem else 0))
    tt = multihost.allgather_host_batch(tt_full[sl], B)
    hh = multihost.allgather_host_batch(hh_full[sl], B)
    assert np.array_equal(tt, tt_full) and np.array_equal(hh, hh_full)
    vv = np.ones((B, L), bool)

    ht = HashTable(hashbits=tcfg.hashbits, depth=tcfg.depth,
                   maxtime=tcfg.maxtime, seed=tcfg.seed)
    for b in range(B):
        ht.store_vectorized(f"t{b}", np.stack([tt[b], hh[b]], axis=1))

    table, counts = multihost.empty_sharded_table(mesh, tcfg)
    sharded.sharded_store_fn(mesh, tcfg)(table, counts, tt, hh, vv,
                                         np.arange(B, dtype=np.int32))
    assert np.array_equal(
        sharded.gather_sharded(mesh, table).view(np.uint32), ht.table)
    assert np.array_equal(sharded.gather_sharded(mesh, counts), ht.counts)

    # the histogram core, its partials summed over both processes' shards
    hpi = np.zeros(mcfg.n_ids_cap, np.int32)
    hpi[:B] = ht.hashesperid
    match = sharded.sharded_match_fn(mesh, tcfg, mcfg)
    mp = P.MatcherParams(window=mcfg.window, threshcount=mcfg.threshcount,
                         max_returns=mcfg.max_returns,
                         search_depth=mcfg.search_depth,
                         exact_count=True, find_time_range=True)
    Q = 128
    queries = []
    for b in range(B):
        qd = np.unique(np.stack([tt[b], hh[b]], axis=1), axis=0)
        queries.append(qd)
        qt1 = np.zeros((1, Q), np.int32)
        qh1 = np.zeros((1, Q), np.int32)
        qv1 = np.zeros((1, Q), bool)
        qt1[0, : len(qd)], qh1[0, : len(qd)] = qd[:, 0], qd[:, 1]
        qv1[0, : len(qd)] = True
        out = match(table, counts, hpi, qt1, qh1, qv1)
        n = int(out["n_results"][0])
        got = np.stack([out[k][0].cpu().numpy() for k in
                        ("ids", "filtcount", "mode_dt", "rawcount",
                         "min_t", "max_t")], axis=1)[:n]
        want = om.match_hashes(ht, qd, mp)
        assert np.array_equal(got, want), (pid, b, got, want)
        assert n >= 1 and got[0, 0] == b, (pid, b, got)

    # the Matcher over the global mesh (RLE hit exchange; B = 6 pads to 8)
    kw = dict(search_depth=8, max_returns=2, exact_count=True,
              find_time_range=True, verbose=0, device=device)
    want = Matcher(ndev=1, **kw).match_hashes_batch(ht, queries)
    for plane in (None, True):
        m = Matcher(ndev=mesh.size, **kw)
        m.use_hpi_plane = plane
        got = m.match_hashes_batch(ht, queries)
        assert m._device_state(ht)[5].size == mesh.size
        for a, b_ in zip(want, got):
            assert np.array_equal(a, b_), (pid, plane, a, b_)

    # the routed fused ingest: every process stages the same chunk, each
    # shard fingerprints its block, hashes cross processes to their shard
    srng = np.random.default_rng(7)
    sigs = [(0.3 * srng.standard_normal(11025 + 700 * i)).astype(np.float32)
            for i in range(5)]
    an = Analyzer(device=device)
    names = [f"n{i}.wav" for i in range(5)]
    ref = HashTable(hashbits=6, depth=4, maxtime=1024)
    for nme, h in zip(names, an.samples_batch2hashes(sigs)):
        ref.store_vectorized(nme, h)
    got_ht = HashTable(hashbits=6, depth=4, maxtime=1024)
    ing = DeviceIngest(got_ht, an, mesh.size)
    rows = ing.consume_chunk(ing.dispatch_chunk(
        [(nme, "wav", d) for nme, d in zip(names, sigs)], print))
    ing.finalize()
    assert np.array_equal(got_ht.table, ref.table)
    assert np.array_equal(got_ht.counts, ref.counts)
    assert [r[1] for r in rows] == [int(x) for x in ref.hashesperid]
    assert int(ref.counts.max()) > ref.depth      # the reservoir ran

    multihost.shutdown()
    print(f"MULTIHOST_OK proc={pid} shards={mesh.size}", flush=True)


if __name__ == "__main__":
    main()
