"""audfprint_torch wide-entry tables (idbits + maxtimebits > 32) against
the JAX package on the CPU: one int64 entry plane on the device where JAX
keeps split (lo, hi) uint32 planes.  Store, gather, upload/download,
DeviceIngest's three download paths, Matcher rows and the CLI's
`new`/`match --idbits 20` equal JAX's for ids at 0, 2^18 - 1, 2^18,
2^19 + 7 and 2^20 - 1 (past the packed 2^18 cap)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audfprint_tpu.index import device_table as DTj  # noqa: E402
from audfprint_tpu.index.hash_table import HashTable  # noqa: E402
from audfprint_tpu.match import matcher as Mj  # noqa: E402
from audfprint_tpu.utils.audio import audio_write_wav  # noqa: E402
from audfprint_torch import cli  # noqa: E402
from audfprint_torch.index import device_table as DT  # noqa: E402
from audfprint_torch.match.matcher import Matcher  # noqa: E402
from audfprint_torch.models import ingest as ING  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)
SR = 11025
BIG_IDS = [0, (1 << 18) - 1, 1 << 18, (1 << 19) + 7, (1 << 20) - 1]
CFG = DT.TableConfig(hashbits=12, depth=8, maxtimebits=14, idbits=20)
CFGJ = DTj.TableConfig(*CFG)


def _wide_ht(hashbits=12, depth=8) -> HashTable:
    """A wide table whose names sit at BIG_IDS (tests/test_wide_table.py's
    sparse-name trick), so stores by name land on those ids."""
    ht = HashTable(hashbits=hashbits, depth=depth, maxtime=16384, idbits=20)
    n = max(BIG_IDS) + 1
    ht.names = [None] * n
    ht.hashesperid = np.zeros(n, np.int64)
    for i in BIG_IDS:
        ht.names[i] = f"t{i}"
    ht._invalidate_index()
    return ht


def _streams(rng, B, L, nb):
    tt = rng.integers(0, CFG.maxtime * 2, (B, L)).astype(np.int32)
    hh = rng.integers(0, nb, (B, L)).astype(np.int32)
    vv = rng.random((B, L)) < 0.9
    return tt, hh, vv


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_wide_config_and_empty_table():
    assert CFG.wide and CFG.idbits_eff + CFG.maxtimebits == 34
    tab, cnt = DT.empty_table(CFG, "cpu")
    assert tab.dtype == torch.int64 and tab.shape == (1 << 12, 8)
    assert cnt.dtype == torch.int32 and cnt.shape == (1 << 12,)


@pytest.mark.parametrize("nb", [1 << 12, 1 << 6])
def test_wide_store_batch_matches_jax_and_host(nb):
    """Two incremental stores: the int64 plane equals JAX's joined (lo, hi)
    planes and the sequential host store bit for bit; nb = 64 buckets
    overflow depth 8 into the reservoir."""
    rng = np.random.default_rng(nb)
    tj, cj = DTj.empty_table(CFGJ)
    tab, cnt = DT.empty_table(CFG, "cpu")
    host = _wide_ht()
    ids = np.asarray(BIG_IDS, np.int32)
    for _step in range(2):
        tt, hh, vv = _streams(rng, len(ids), 300, nb)
        tj, cj = DTj.store_batch(tj, cj, jnp.asarray(tt), jnp.asarray(hh),
                                 jnp.asarray(vv), jnp.asarray(ids), CFGJ)
        DT.store_batch(tab, cnt, torch.from_numpy(tt), torch.from_numpy(hh),
                       torch.from_numpy(vv), torch.from_numpy(ids), CFG)
        for b, i in enumerate(BIG_IDS):
            host.store_vectorized(f"t{i}", np.stack([tt[b][vv[b]],
                                                     hh[b][vv[b]]], axis=1))
        np.testing.assert_array_equal(_u64(tab), DTj.join_wide(tj))
        np.testing.assert_array_equal(_u64(tab), host.table)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(cnt.numpy(), host.counts)
    assert int((_u64(tab) >> np.uint64(14)).max()) == (1 << 20) - 1
    if nb < CFG.n_buckets:
        assert int(cnt.max()) > CFG.depth           # the reservoir engaged


def test_wide_get_hits_local_matches_jax():
    """The gather decodes ids >= 2^18 and dts from the int64 plane exactly
    as JAX decodes its split planes."""
    rng = np.random.default_rng(3)
    tt, hh, vv = _streams(rng, len(BIG_IDS), 400, 1 << 12)
    ids = np.asarray(BIG_IDS, np.int32)
    tj, cj = DTj.store_batch(*DTj.empty_table(CFGJ), jnp.asarray(tt),
                             jnp.asarray(hh), jnp.asarray(vv),
                             jnp.asarray(ids), CFGJ)
    ht = HashTable(hashbits=12, depth=8, maxtime=16384, idbits=20)
    ht.table = DTj.join_wide(tj)
    ht.counts = np.array(cj)
    tab, cnt, cfg = DT.table_to_device(ht, "cpu")
    assert cfg.wide and tab.dtype == torch.int64
    qt = rng.integers(0, 3000, (3, 64)).astype(np.int32)
    qh = hh[[0, 2, 4], :64].copy()
    qv = rng.random((3, 64)) < 0.9
    want = DTj.get_hits_local(tj, cj, jnp.asarray(qt), jnp.asarray(qh),
                              jnp.asarray(qv), CFGJ)
    got = DT.get_hits_local(tab, cnt, torch.from_numpy(qt),
                            torch.from_numpy(qh), torch.from_numpy(qv), cfg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(np.asarray(want[0]).max()) == (1 << 20) - 1


def test_wide_upload_download_roundtrip():
    """table_to_device takes the uint64 bits as int64 (a view, never a
    value cast) and table_to_host gives them back as uint64."""
    ht = _wide_ht()
    rng = np.random.default_rng(4)
    for i in BIG_IDS:
        ht.store_vectorized(f"t{i}", np.stack(
            [rng.integers(0, 16384, 50), rng.integers(0, 1 << 12, 50)],
            axis=1))
    tab, cnt, _ = DT.table_to_device(ht, "cpu")
    back = HashTable(hashbits=12, depth=8, maxtime=16384, idbits=20)
    DT.table_to_host(tab, cnt, back)
    assert back.table.dtype == np.uint64
    np.testing.assert_array_equal(back.table, ht.table)
    np.testing.assert_array_equal(back.counts, ht.counts)


def _stored_wide(seed):
    ht = _wide_ht()
    rng = np.random.default_rng(seed)
    streams = {}
    for i in BIG_IDS:
        p = np.stack([np.sort(rng.integers(0, 16384, 120)),
                      rng.integers(0, 1 << 12, 120)], axis=1)
        ht.store_vectorized(f"t{i}", p)
        streams[i] = p
    return ht, streams


def test_wide_matcher_rows_match_jax():
    """Matcher rows on a wide table equal the JAX Matcher's, and every
    BIG_IDS track matches back at rank 0."""
    ht, streams = _stored_wide(5)
    queries = []
    for i in BIG_IDS:
        q = streams[i][:60].copy()
        q[:, 0] -= q[0, 0]
        queries.append(q.astype(np.int32))
    want = Mj.Matcher(verbose=0, search_depth=8, max_returns=2) \
        .match_hashes_batch(ht, queries)
    got = Matcher(verbose=0, search_depth=8, max_returns=2,
                  device="cpu").match_hashes_batch(ht, queries)
    for i, w, g in zip(BIG_IDS, want, got):
        np.testing.assert_array_equal(g, w)
        assert g[0][0] == i


@pytest.mark.parametrize("hashbits,depth,L,path", [
    (12, 8, 256, "compact"), (4, 64, 60, "slice"), (4, 8, 60, "full")])
def test_wide_device_ingest_finalize_matches_jax(hashbits, depth, L, path):
    """DeviceIngest on a wide table: finalize's compacted, column-slice
    and whole-table downloads each give the uint64 table JAX stores."""
    cfg = DT.TableConfig(hashbits=hashbits, depth=depth, idbits=20)
    cfgj = DTj.TableConfig(*cfg)
    rng = np.random.default_rng(hashbits + depth)
    tt, hh, vv = _streams(rng, len(BIG_IDS), L, cfg.n_buckets)
    ids = np.asarray(BIG_IDS, np.int32)
    tj, cj = DTj.store_batch(*DTj.empty_table(cfgj), jnp.asarray(tt),
                             jnp.asarray(hh), jnp.asarray(vv),
                             jnp.asarray(ids), cfgj)
    ht = _wide_ht(hashbits, depth)
    ing = ING.DeviceIngest(ht, Analyzer(device="cpu"))
    assert ing.table.dtype == torch.int64
    DT.store_batch(ing.table, ing.counts, torch.from_numpy(tt),
                   torch.from_numpy(hh), torch.from_numpy(vv),
                   torch.from_numpy(ids), cfg)
    counts = ing.counts.numpy()
    k = min(depth, 1 << max(0, (int(min(depth, counts.max())) - 1)
                            .bit_length()))
    total = int(np.minimum(counts, depth).sum())
    compact = (1 << max(0, (total - 1).bit_length())) * 4 <= cfg.n_buckets * k
    assert path == ("compact" if compact else
                    "slice" if counts.max() < depth else "full")
    ing.finalize()
    assert ht.table.dtype == np.uint64
    np.testing.assert_array_equal(ht.table, DTj.join_wide(tj))
    np.testing.assert_array_equal(ht.counts, np.asarray(cj))


def test_wide_device_ingest_audio_matches_host_store():
    """The fused fingerprint + store of audio chunks into a wide table
    stored at BIG_IDS names equals the sequential host store."""
    an = Analyzer(device="cpu")
    rng = np.random.default_rng(6)
    sigs = [synth_audio(rng, dur_sec=3.0 + 0.2 * i) for i in range(5)]
    hashes = an.samples_batch2hashes(sigs)
    want = _wide_ht(10, 8)
    for i, h in zip(BIG_IDS, hashes):
        want.store_vectorized(f"t{i}", h)
    ht = _wide_ht(10, 8)
    ing = ING.DeviceIngest(ht, an)
    rows = ing.consume_chunk(ing.dispatch_chunk(
        [(f"t{i}", "wav", s) for i, s in zip(BIG_IDS, sigs)], print))
    ing.finalize()
    np.testing.assert_array_equal(ht.table, want.table)
    np.testing.assert_array_equal(ht.counts, want.counts)
    np.testing.assert_array_equal(ht.hashesperid, want.hashesperid)
    assert [nh for _, nh, _ in rows] == [len(h) for h in hashes]


def test_wide_cli_new_match_matches_jax(tmp_path, capsys):
    """`new --idbits 20` (host store and --device-store) and `match
    --idbits 20` through the port's CLI write the JAX CLI's database and
    print its lines."""
    from audfprint_tpu import cli as jcli

    rng = np.random.default_rng(7)
    wavs = []
    for i in range(3):
        p = str(tmp_path / f"w{i}.wav")
        x = synth_audio(rng, dur_sec=5.0, n_tones=40)
        audio_write_wav(p, x, SR)
        wavs.append(p)
        if i == 1:
            q = str(tmp_path / "q.wav")
            audio_write_wav(q, x[256 * 40: 256 * 40 + 3 * SR], SR)
    common = ["-h", "14", "-b", "20", "--idbits", "20"]
    dbs = {k: str(tmp_path / f"{k}.pklz") for k in ("jax", "port", "dev")}

    def run(main, argv):
        capsys.readouterr()
        assert main(argv) == 0
        out = capsys.readouterr().out
        for db in dbs.values():
            out = out.replace(db, "<DB>")
        return [ln for ln in out.splitlines()
                if not ln.startswith("Processed ")]

    want_new = run(jcli.main, ["new", "-d", dbs["jax"], *common, *wavs])
    got_new = run(lambda a: cli.main(a, device="cpu"),
                  ["new", "-d", dbs["port"], *common, *wavs])
    run(lambda a: cli.main(a, device="cpu"),
        ["new", "-d", dbs["dev"], "--device-store", *common, *wavs])
    assert got_new == want_new
    hj = HashTable(dbs["jax"])
    for k in ("port", "dev"):
        h = HashTable(dbs[k])
        assert h.wide and h.table.dtype == np.uint64
        np.testing.assert_array_equal(h.table, hj.table)
        np.testing.assert_array_equal(h.counts, hj.counts)
        np.testing.assert_array_equal(h.hashesperid, hj.hashesperid)
    want = run(jcli.main, ["match", "-d", dbs["jax"], *common, q])
    got = run(lambda a: cli.main(a, device="cpu"),
              ["match", "-d", dbs["port"], *common, q])
    assert got == want
    hit = [ln for ln in got if ln.startswith("Matched")]
    assert "w1.wav at 0.9 s" in hit[0] and "rank 0" in hit[0]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the wide store runs on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wide_store_on_card_equals_cpu(cuda_device):
    """The store and gather on the card give the CPU's int64 plane."""
    rng = np.random.default_rng(8)
    tt, hh, vv = _streams(rng, len(BIG_IDS), 500, 1 << 8)
    args = [torch.from_numpy(a) for a in
            (tt, hh, vv, np.asarray(BIG_IDS, np.int32))]
    tab, cnt = DT.empty_table(CFG, "cpu")
    DT.store_batch(tab, cnt, *args, CFG)
    tab_d, cnt_d = DT.empty_table(CFG, cuda_device)
    DT.store_batch(tab_d, cnt_d, *[a.to(cuda_device) for a in args], CFG)
    assert torch.equal(tab_d.cpu(), tab) and torch.equal(cnt_d.cpu(), cnt)
