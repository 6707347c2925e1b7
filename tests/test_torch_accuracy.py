"""tests/test_accuracy.py's retrieval harness through the port on the CPU:
16 synthetic 8 s tracks fingerprinted once per package, then clean, noisy,
SNR-swept, shifted, speed-changed and out-of-DB query sets.  On each set
the port's hashes and rows equal the JAX package's, so its top-1 does too,
and each of that file's bars holds for the port.

The query sets are that file's own: one generator seeded as there, drawn
in the order its tests draw, all at once in the fixture, so each test here
sees the same set whatever runs before it."""

from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from audfprint_tpu.index.hash_table import HashTable as HTj  # noqa: E402
from audfprint_tpu.match.matcher import Matcher as Mj  # noqa: E402
from audfprint_tpu.models.analyzer import Analyzer as Aj  # noqa: E402
from audfprint_torch.index.hash_table import HashTable  # noqa: E402
from audfprint_torch.match.matcher import Matcher  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from tests.conftest import synth_audio  # noqa: E402

torch.set_num_threads(2)
SR = 11025
N_TRACKS = 16
DUR = 8.0


def _segment(rng, track):
    start = rng.integers(0, int((DUR - 4) * SR))
    return track[start: start + 4 * SR].copy()


def _sped(clip):
    from scipy.signal import resample_poly

    return resample_poly(clip.astype(np.float64), 962, 1000).astype(
        np.float32)


def _query_sets(rng, tracks) -> dict:
    """tests/test_accuracy.py's draws from its module generator, in the
    order of its tests."""
    sets = {"clean": [_segment(rng, x) for x in tracks]}
    noisy = []
    for x in tracks:
        clip = _segment(rng, x)
        noisy.append(clip + 0.05 * rng.standard_normal(len(clip)).astype(
            np.float32))
    sets["noisy"] = noisy
    sets["noise"] = [(0.1 * rng.standard_normal(4 * SR)).astype(np.float32)
                     for _ in range(8)]
    clean0 = [_segment(rng, x) for x in tracks]
    for snr_db in (30, 20, 10, 5, 0):
        sets[f"snr{snr_db}"] = [
            (clip + np.sqrt(float(np.mean(clip ** 2)) / (10 ** (snr_db / 10)))
             * rng.standard_normal(len(clip))).astype(np.float32)
            for clip in clean0]
    sets["speed_clean"] = [_segment(rng, x) for x in tracks]
    sets["speed"] = [_sped(c) for c in sets["speed_clean"]]
    sets["sweep"] = [_sped(_segment(rng, x)) for x in tracks]
    return sets


@pytest.fixture(scope="module")
def db():
    """The JAX test's database, stored by each package from its own
    hashes, which must be equal, and its query sets."""
    rng = np.random.default_rng(2026)
    tracks = [synth_audio(rng, dur_sec=DUR, n_tones=60)
              for _ in range(N_TRACKS)]
    an, anj = Analyzer(device="cpu"), Aj()
    hashes = an.samples_batch2hashes(tracks)
    hj = anj.samples_batch2hashes(tracks)
    ht = HashTable(hashbits=18, depth=50, maxtime=8192)
    htj = HTj(hashbits=18, depth=50, maxtime=8192)
    for i, (h, w) in enumerate(zip(hashes, hj)):
        assert np.array_equal(h, w), f"track {i}"
        ht.store_vectorized(f"track{i}", h)
        htj.store_vectorized(f"track{i}", w)
    return SimpleNamespace(an=an, anj=anj, ht=ht, htj=htj, tracks=tracks,
                           q=_query_sets(rng, tracks))


TRUTHS = list(range(N_TRACKS))


def _rows(db, queries, an=None, anj=None) -> list:
    """The port's result rows for each query, after checking that its
    hashes and rows equal the JAX package's."""
    h = (an or db.an).samples_batch2hashes(queries)
    hj = (anj or db.anj).samples_batch2hashes(queries)
    for i, (a, b) in enumerate(zip(h, hj)):
        assert np.array_equal(a, b), f"query {i}: hashes differ"
    rows = Matcher(device="cpu", verbose=0).match_hashes_batch(db.ht, h)
    rowsj = Mj(verbose=0).match_hashes_batch(db.htj, hj)
    for i, (a, b) in enumerate(zip(rows, rowsj)):
        assert np.array_equal(a, b), f"query {i}: rows differ"
    return rows


def _top1(rows, truths) -> float:
    return sum(1 for r, t in zip(rows, truths)
               if len(r) and r[0][0] == t) / len(truths)


def test_clean_exact_segment_queries(db):
    assert _top1(_rows(db, db.q["clean"]), TRUTHS) >= 0.95


def test_noisy_queries(db):
    acc = _top1(_rows(db, db.q["noisy"]), TRUTHS)
    assert acc >= 0.8, acc


def test_no_false_positives_on_noise(db):
    assert sum(1 for r in _rows(db, db.q["noise"]) if len(r)) == 0


def test_shifts_improve_aligned_counts(db):
    """--shifts 4 finds a half-hop-misaligned clip of track 3 at rank 0
    with at least the plain count, with JAX's hashes and rows."""
    clip = db.tracks[3][128: 128 + 4 * SR].copy()
    r1 = _rows(db, [clip])[0]
    r4 = _rows(db, [clip], Analyzer(shifts=4, device="cpu"),
               Aj(shifts=4))[0]
    assert len(r4) and r4[0][0] == 3
    if len(r1):
        assert r4[0][1] >= r1[0][1]


def test_snr_sweep_recall_curve(db):
    """Top-1 recall over falling SNR: high while the noise is mild, and
    never rising by more than one query as it grows."""
    snrs_db = [30, 20, 10, 5, 0]
    recalls = [_top1(_rows(db, db.q[f"snr{s}"]), TRUTHS) for s in snrs_db]
    assert recalls[0] >= 0.9, (snrs_db, recalls)
    assert recalls[1] >= 0.8, (snrs_db, recalls)
    for a, b in zip(recalls, recalls[1:]):
        assert b <= a + 1.0 / N_TRACKS + 1e-9, (snrs_db, recalls)


def test_speed_shift_discriminates(db):
    """A 3.8% speed change degrades matching sharply, as in JAX."""
    r_clean = _top1(_rows(db, db.q["speed_clean"]), TRUTHS)
    r_shift = _top1(_rows(db, db.q["speed"]), TRUTHS)
    assert r_clean >= 0.9, r_clean
    assert r_shift <= r_clean - 0.3, (r_clean, r_shift)


def test_out_of_db_music_fp_rate(db):
    oodb = [synth_audio(np.random.default_rng(777000 + i), dur_sec=4.0,
                        n_tones=60) for i in range(8)]
    assert sum(1 for r in _rows(db, oodb) if len(r)) == 0


def test_speed_sweep_recovers_shifted_queries(db):
    """Matcher.match_samples_sweep at +/-4% recovers the sped queries to
    near-clean top-1, above the plain path, with a non-unity winning
    factor, and gives the JAX sweep's rows, factors and hash counts."""
    shifted = db.q["sweep"]
    r_plain = _top1(_rows(db, shifted), TRUTHS)
    best = Matcher(device="cpu", verbose=0).match_samples_sweep(
        db.an, db.ht, shifted, 4.0)
    bestj = Mj(verbose=0).match_samples_sweep(db.anj, db.htj, shifted, 4.0)
    for (rr, f, nh), (rj, fj, nhj) in zip(best, bestj):
        assert (f, nh) == (fj, nhj) and np.array_equal(rr, rj)
    r_sweep = _top1([rr for rr, _f, _nh in best], TRUTHS)
    assert r_sweep >= 0.9, (r_plain, r_sweep)
    assert r_sweep >= r_plain + 0.3, (r_plain, r_sweep)
    assert any(f != 1.0 for _rr, f, _nh in best)
