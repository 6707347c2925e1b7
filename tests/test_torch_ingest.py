"""audfprint_torch device store and fused ingest against the JAX package
and the host store on the CPU: the reservoir mix on values >= 2^31, the
batched store bit for bit against DT.store_batch (bucket overflow into the
reservoir, incremental stores, ids >= 2^17, a shard-local bucket range),
DeviceIngest against the sequential host store on one device and on
meshes of 2 and 8 shards (routed ingest, mixed precomputed and raw input,
the forced overflow replay, an incremental add), the fused mesh serving
path against the two-stage one, finalize's compact path against its slice
path, and the CLI's `new --device-store` and streamed `new` end to end."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audfprint_tpu import params as P  # noqa: E402
from audfprint_tpu.index import device_table as DTj  # noqa: E402
from audfprint_tpu.index.hash_table import HashTable  # noqa: E402
from audfprint_tpu.utils import formats, prng  # noqa: E402
from audfprint_tpu.utils.audio import audio_write_wav  # noqa: E402
from audfprint_torch import cli  # noqa: E402
from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.models import ingest as ING  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)
SR = 11025


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_mix32_matches_numpy_above_2_31():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    x[:4] = [0, (1 << 31), (1 << 32) - 1, 0x85EBCA6B]
    assert (x >= 1 << 31).sum() > 1000
    got = DT._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    assert np.array_equal(got, prng.mix32(x.astype(np.uint32)).astype(
        np.int64))
    bucket = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    pos = rng.integers(100, 1 << 31, 4096, dtype=np.uint64)
    got = DT.reservoir_slot_device(torch.from_numpy(bucket.astype(np.int64)),
                                   torch.from_numpy(pos.astype(np.int64)),
                                   seed=7).numpy()
    want = prng.reservoir_slot(bucket.astype(np.uint32),
                               pos.astype(np.uint32), seed=7)
    assert np.array_equal(got, want)


def _streams(rng, B, L, cfg, nb=None):
    tt = rng.integers(0, cfg.maxtime * 2, (B, L)).astype(np.int32)
    hh = rng.integers(0, nb or cfg.n_buckets, (B, L)).astype(np.int32)
    vv = rng.random((B, L)) < 0.85
    return tt, hh, vv


@pytest.mark.parametrize("hashbits,depth", [(14, 4), (16, 20)])
def test_store_batch_matches_jax(hashbits, depth):
    """The batched store against DT.store_batch, two incremental stores
    into one table: buckets overflow into the reservoir (depth 4), ids
    reach past 2^17 (top bit of the uint32 entry set)."""
    cfg = DT.TableConfig(hashbits=hashbits, depth=depth, seed=3)
    cfgj = DTj.TableConfig(hashbits=hashbits, depth=depth, seed=3)
    rng = np.random.default_rng(hashbits)
    tj, cj = DTj.empty_table(cfgj)
    tab, cnt = DT.empty_table(cfg, "cpu")
    for step in range(2):
        tt, hh, vv = _streams(rng, 6, 2048, cfg, nb=1 << 10)
        ids = (np.arange(6) + step * 6 + (1 << 17) + 5).astype(np.int32)
        tj, cj = DTj.store_batch(tj, cj, jnp.asarray(tt), jnp.asarray(hh),
                                 jnp.asarray(vv), jnp.asarray(ids), cfgj)
        DT.store_batch(tab, cnt, torch.from_numpy(tt), torch.from_numpy(hh),
                       torch.from_numpy(vv), torch.from_numpy(ids), cfg)
        assert np.array_equal(_u32(tab), np.asarray(tj))
        assert np.array_equal(cnt.numpy(), np.asarray(cj))
    assert int(cnt.max()) > depth                # the reservoir engaged
    assert (_u32(tab) >= 1 << 31).sum() > 100    # ids >= 2^17 stored


def test_store_batch_local_shard_matches_jax():
    """A table owning buckets [nb/2, nb): out-of-range hashes are masked
    and the reservoir is keyed by the global bucket, as in JAX."""
    cfg = DT.TableConfig(hashbits=12, depth=3)
    cfgj = DTj.TableConfig(hashbits=12, depth=3)
    rng = np.random.default_rng(2)
    tt, hh, vv = _streams(rng, 4, 1024, cfg)
    ids = np.arange(4, dtype=np.int32)
    half = cfg.n_buckets // 2
    store = jax.jit(DTj.store_batch_local, static_argnums=(6, 7))
    tj, cj = store(
        jnp.zeros((half, 3), jnp.uint32), jnp.zeros(half, jnp.int32),
        jnp.asarray(tt), jnp.asarray(hh), jnp.asarray(vv), jnp.asarray(ids),
        cfgj, half)
    tab = torch.zeros((half, 3), dtype=torch.int32)
    cnt = torch.zeros(half, dtype=torch.int32)
    DT.store_batch_local(tab, cnt, torch.from_numpy(tt), torch.from_numpy(hh),
                         torch.from_numpy(vv), torch.from_numpy(ids), cfg,
                         half)
    assert np.array_equal(_u32(tab), np.asarray(tj))
    assert np.array_equal(cnt.numpy(), np.asarray(cj))
    assert int(cnt.max()) > 3


def _clips(seed, n, dur=3.0):
    rng = np.random.default_rng(seed)
    return [synth_audio(rng, dur_sec=dur + 0.3 * (i % 3)) for i in range(n)]


def _assert_tables_equal(got: HashTable, want: HashTable):
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.hashesperid, want.hashesperid)
    assert got.names[: len(want.names)] == want.names


def test_device_ingest_matches_host_store(tmp_path):
    """Mixed chunks (wav, precomputed .afpt, a streamed WAV's host hashes),
    ingested incrementally into a table that already holds two files,
    equal the sequential host store over the same input order."""
    an = Analyzer(device="cpu")
    sigs = _clips(5, 6)
    hashes = an.samples_batch2hashes(sigs)
    pre = str(tmp_path / "pre3.afpt")
    formats.hashes_save(pre, hashes[3])
    names = [f"c{i}.wav" for i in range(6)]
    names[3] = pre
    want = HashTable(hashbits=8, depth=4)
    for name, h in zip(names, hashes):
        want.store_vectorized(name, h)

    ht = HashTable(hashbits=8, depth=4)
    for name, h in zip(names[:2], hashes[:2]):
        ht.store_vectorized(name, h)
    ing = ING.DeviceIngest(ht, an)
    ordered = [(names[2], "wav", sigs[2]), (pre, "pre", None),
               (names[4], "stream", (hashes[4], 3.3)),
               (names[5], "wav", sigs[5])]
    rows = ing.consume_chunk(ing.dispatch_chunk(ordered, report=print))
    ing.finalize()
    _assert_tables_equal(ht, want)
    assert [n for n, _, _ in rows] == names[2:]
    assert [nh for _, nh, _ in rows] == [len(h) for h in hashes[2:]]
    assert int(ht.counts.max()) > 4                 # overflowed buckets


def test_device_ingest_builds_mesh():
    """ndev > 1, once refused, builds a mesh of that many shards; a shard
    count that does not divide the table raises the JAX package's
    ValueError (the CLI turns it into a note and the host store)."""
    ht = HashTable(hashbits=10)
    ing = ING.DeviceIngest(ht, Analyzer(device="cpu"), ndev=2)
    assert ing.mesh.size == 2 and len(ing.table) == 2
    assert ing.table[0].shape == (512, ht.depth)
    with pytest.raises(ValueError, match="not divisible over 3 devices"):
        ING.DeviceIngest(ht, Analyzer(device="cpu"), ndev=3)


def _host_reference(an, names, sigs, **kw):
    ht = HashTable(**kw)
    for name, h in zip(names, an.samples_batch2hashes(sigs)):
        ht.store_vectorized(name, h)
    return ht


SMALL = dict(hashbits=6, depth=2, maxtime=4096)


@pytest.mark.parametrize("ndev", [2, 8])
def test_fused_ingest_matches_host(ndev):
    """The routed mesh ingest (each shard fingerprints its block, one
    all_to_all routes every hash to its bucket's shard) equals the
    sequential host store; the rows come back in input order with the
    host's counts.  The table overflows its buckets, so the reservoir's
    per-bucket insertion order is held too."""
    an = Analyzer(device="cpu")
    sigs = _clips(1, 5)
    names = [f"clip{i}.wav" for i in range(5)]
    want = _host_reference(an, names, sigs, **SMALL)
    ht = HashTable(**SMALL)
    ing = ING.DeviceIngest(ht, an, ndev)
    batch, _lens = ing._stage_chunk(sigs)
    assert batch.shape[0] % ndev == 0 and batch.shape[0] == 8
    rows = ing.consume_chunk(ing.dispatch_chunk(
        [(n, "wav", d) for n, d in zip(names, sigs)], report=print))
    ing.finalize()
    _assert_tables_equal(ht, want)
    assert ing.replays == 0
    assert [n for n, _, _ in rows] == names
    assert [nh for _, nh, _ in rows] == [int(x) for x in want.hashesperid]
    assert int(want.counts.max()) > want.depth


def test_fused_ingest_mixed_pre_and_wav(tmp_path):
    """Precomputed .afpt entries between raw audio on 8 shards: ids and
    table equal the sequential loop over the same input order."""
    an = Analyzer(device="cpu")
    sigs = _clips(2, 4)
    hashes = an.samples_batch2hashes(sigs)
    pre = str(tmp_path / "pre1.afpt")
    formats.hashes_save(pre, hashes[1])
    names = ["a.wav", pre, "c.wav", "d.wav"]
    want = HashTable(**SMALL)
    for name, h in zip(names, hashes):
        want.store_vectorized(name, h)
    ht = HashTable(**SMALL)
    ing = ING.DeviceIngest(ht, an, 8)
    ing.consume_chunk(ing.dispatch_chunk(
        [("a.wav", "wav", sigs[0]), (pre, "pre", None),
         ("c.wav", "wav", sigs[2]), ("d.wav", "wav", sigs[3])], report=print))
    ing.finalize()
    _assert_tables_equal(ht, want)
    assert ht.names[:4] == names


def test_fused_ingest_overflow_replays_identically():
    """A routing cap far below the real volume flags ok = 0 with every
    write masked, and the replay through the replicated store gives the
    same table."""
    an = Analyzer(device="cpu")
    sigs = _clips(3, 4)
    names = [f"o{i}.wav" for i in range(4)]
    want = _host_reference(an, names, sigs, **SMALL)
    ht = HashTable(**SMALL)
    ing = ING.DeviceIngest(ht, an, 8)
    ing._fn = ING.sharded_fused_ingest_fn(ing.mesh, an.config, ing.cfg,
                                          cap_override=4)
    handle = ing.dispatch_chunk([(n, "wav", d) for n, d in zip(names, sigs)],
                                report=print)
    assert int(handle[0][3][-1]) == 0, "cap=4 must overflow"
    assert not any(int(c.sum()) for c in ing.counts), "writes not masked"
    rows = ing.consume_chunk(handle)
    ing.finalize()
    assert ing.replays == 1
    _assert_tables_equal(ht, want)
    assert [nh for _, nh, _ in rows] == [int(x) for x in want.hashesperid]


def test_fused_ingest_incremental_add():
    """add into a non-empty table uploads it sharded and continues the
    reservoir bit-identically."""
    an = Analyzer(device="cpu")
    sigs = _clips(4, 6)
    names = [f"inc{i}.wav" for i in range(6)]
    want = _host_reference(an, names, sigs, **SMALL)
    ht = _host_reference(an, names[:2], sigs[:2], **SMALL)
    ing = ING.DeviceIngest(ht, an, 8)
    ing.consume_chunk(ing.dispatch_chunk(
        [(n, "wav", d) for n, d in zip(names[2:], sigs[2:])], report=print))
    ing.finalize()
    _assert_tables_equal(ht, want)


def test_pack_entries_and_route_match_jax():
    """_pack_entries gives JAX's (hash, entry) streams (one int64 word for
    its lo / hi planes, packed and wide), and _route's send buffers hold
    each destination's rows in arrival order, as JAX's sort-and-scatter."""
    from audfprint_tpu.models import ingest as INGj

    rng = np.random.default_rng(6)
    for idbits in (0, 22):
        cfg = DT.TableConfig(hashbits=12, depth=8, idbits=idbits)
        cfgj = DTj.TableConfig(hashbits=12, depth=8, idbits=idbits)
        tt, hh, vv = _streams(rng, 3, 64, cfg)
        ids = np.array([5, (1 << 18) + 3 if idbits else 9, 70], np.int32)
        hj, lo, hi, vj = INGj._pack_entries(
            jnp.asarray(tt), jnp.asarray(hh), jnp.asarray(vv),
            jnp.asarray(ids), cfgj)
        hf, entry, vf = ING._pack_entries(
            torch.from_numpy(tt), torch.from_numpy(hh), torch.from_numpy(vv),
            torch.from_numpy(ids), cfg)
        want = np.asarray(lo).astype(np.uint64)
        if idbits:
            want |= np.asarray(hi).astype(np.uint64) << np.uint64(32)
        assert np.array_equal(hf.numpy(), np.asarray(hj))
        assert np.array_equal(entry.numpy().astype(np.uint64), want)
        assert np.array_equal(vf.numpy(), np.asarray(vj))
    ops, ok = ING._route(hf, entry, vf, 1 << 10, 4, 64)
    assert bool(ok)
    dest = (hf // (1 << 10)).numpy()
    for d in range(4):
        sel = vf.numpy() & (dest == d)
        n = int(sel.sum())
        assert np.array_equal(ops[0][d, :n].numpy(), hf.numpy()[sel])
        assert np.array_equal(ops[1][d, :n].numpy(), entry.numpy()[sel])
        assert ops[2][d].numpy().sum() == n and ops[2][d, :n].all()
    assert not bool(ING._route(hf, entry, vf, 1 << 10, 4, 8)[1])


def test_fused_mesh_serving_matches_two_stage():
    """The fused fingerprint + match path on 8 shards (5 rows pad to 8)
    equals the two-stage mesh path and the single-device path, with the
    readback re-match past a low cap."""
    from audfprint_torch.match.matcher import Matcher

    an = Analyzer(device="cpu")
    sigs = _clips(8, 6, dur=4.0)
    names = [f"s{i}.wav" for i in range(6)]
    ht = _host_reference(an, names, sigs, hashbits=14, depth=20,
                         maxtime=4096)
    m = Matcher(ndev=8, verbose=0, device="cpu")
    queries = [s[: SR * 2] for s in sigs[:5]]
    fused = m.match_samples_fused(an, ht, queries)
    assert fused is not None, "the mesh fused path must be eligible"
    rows_f, nh_f = fused
    hashes = an.samples_batch2hashes(queries)
    rows_t = m.match_hashes_batch(ht, hashes)
    rows_1 = Matcher(ndev=1, verbose=0, device="cpu").match_hashes_batch(
        ht, hashes)
    assert nh_f == [len(h) for h in hashes]
    for i, (rf, rt, r1) in enumerate(zip(rows_f, rows_t, rows_1)):
        np.testing.assert_array_equal(rf, rt)
        np.testing.assert_array_equal(rf, r1)
        assert len(rf) and ht.names[int(rf[0][0])] == names[i]
    m2 = Matcher(ndev=8, verbose=0, device="cpu")
    m2.fused_qcap = 8                    # every row re-matches two-stage
    for rf, rt in zip(m2.match_samples_fused(an, ht, queries)[0], rows_t):
        np.testing.assert_array_equal(rf, rt)


@pytest.mark.parametrize("hashbits,depth,B,L,path", [
    (10, 8, 8, 256, "compact"), (4, 64, 4, 80, "slice"),
    (4, 8, 4, 80, "full")])
def test_finalize_compact_equals_slice(hashbits, depth, B, L, path):
    """finalize's compacted download (a sparse table), its column-slice
    download (a dense one) and its whole-table download (full buckets) all
    give the host table the JAX store makes."""
    cfg = DT.TableConfig(hashbits=hashbits, depth=depth)
    cfgj = DTj.TableConfig(hashbits=hashbits, depth=depth)
    rng = np.random.default_rng(7)
    tt, hh, vv = _streams(rng, B, L, cfg)
    ids = np.arange(B, dtype=np.int32)
    tj, cj = DTj.store_batch(*DTj.empty_table(cfgj), jnp.asarray(tt),
                             jnp.asarray(hh), jnp.asarray(vv),
                             jnp.asarray(ids), cfgj)
    ht = HashTable(hashbits=hashbits, depth=depth)
    ing = ING.DeviceIngest(ht, Analyzer(device="cpu"))
    DT.store_batch(ing.table, ing.counts, torch.from_numpy(tt),
                   torch.from_numpy(hh), torch.from_numpy(vv),
                   torch.from_numpy(ids), cfg)
    counts = ing.counts.numpy()
    k = P.next_pow2(min(depth, int(counts.max())), 1)
    compact = (P.next_pow2(int(np.minimum(counts, depth).sum()), 1) * 4
               <= cfg.n_buckets * k)
    taken = ("compact" if compact else
             "slice" if counts.max() < depth else "full")
    assert taken == path
    ing.finalize()
    assert np.array_equal(ht.table, np.asarray(tj))
    assert np.array_equal(ht.counts, np.asarray(cj))


def _wavs(tmp_path, n, dur, seed=3, tones=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = str(tmp_path / f"w{i}.wav")
        audio_write_wav(p, synth_audio(rng, dur_sec=dur, n_tones=tones), SR)
        out.append(p)
    return out


def test_cli_device_store_equals_host_store(tmp_path):
    """`new --device-store` writes the database `new` writes: table, counts,
    hashesperid and the ingested lines."""
    wavs = _wavs(tmp_path, 3, 4.0)
    db_host, db_dev = str(tmp_path / "host.pklz"), str(tmp_path / "dev.pklz")
    assert cli.main(["new", "-d", db_host, "-h", "16", "-o",
                     str(tmp_path / "o1"), *wavs], device="cpu") == 0
    assert cli.main(["new", "-d", db_dev, "-h", "16", "--device-store", "-o",
                     str(tmp_path / "o2"), *wavs], device="cpu") == 0
    _assert_tables_equal(HashTable(db_dev), HashTable(db_host))

    def lines(p):
        return [ln for ln in (tmp_path / p).read_text().splitlines()
                if not ln.startswith("Processed ")]
    assert lines("o1") == lines("o2") and len(lines("o1")) == 3


def test_cli_streams_long_wav_and_matches(tmp_path, capsys):
    """`new` on a WAV past --stream-above 10 takes the streamed route (the
    same hashes as Analyzer.wavfile2hashes_streaming), with --device-store
    too, and a query from the middle of it matches at rank 0."""
    rng = np.random.default_rng(4)
    x = synth_audio(rng, dur_sec=24.0, n_tones=200)
    long_wav = str(tmp_path / "long.wav")
    audio_write_wav(long_wav, x, SR)
    other = _wavs(tmp_path, 1, 5.0)
    q = str(tmp_path / "q.wav")
    audio_write_wav(q, x[256 * 600: 256 * 600 + 4 * SR], SR)
    db, dbd = str(tmp_path / "db.pklz"), str(tmp_path / "dbd.pklz")
    for d, extra in ((db, []), (dbd, ["--device-store"])):
        assert cli.main(["new", "-d", d, "-h", "16", "--stream-above", "10",
                         "--stream-chunk", "256", *extra, long_wav, *other],
                        device="cpu") == 0
    an = Analyzer(device="cpu")
    want = an.wavfile2hashes_streaming(long_wav, chunk_frames=256)
    ht = HashTable(db)
    assert ht.hashesperid[0] == len(want) > 100
    _assert_tables_equal(HashTable(dbd), ht)
    capsys.readouterr()
    assert cli.main(["match", "-d", db, "-h", "16", q], device="cpu") == 0
    out = capsys.readouterr().out
    assert f"as {long_wav} at {600 * 256 / SR:.1f} s" in out
    assert "at rank 0" in out and os.path.basename(other[0]) not in out
