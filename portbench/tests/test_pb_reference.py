"""The plain reference against the program's CPU path (whose stages are
held bit for bit against the JAX package by tests/): the same hashes, the
same table entries and counts, the same top rows."""

import numpy as np
import pytest

from portbench import corpus
from portbench.reference import analyze as RA
from portbench.reference import table as RT
from portbench.tests.conftest import SEED

PRESETS = [{"density": 20, "shifts": 1, "fanout": 3},
           {"density": 40, "shifts": 4, "fanout": 3}]


@pytest.fixture(scope="module")
def small():
    from audfprint_torch.index.hash_table import HashTable
    from audfprint_torch.models.analyzer import Analyzer
    from audfprint_torch.models.ingest import DeviceIngest
    tr = corpus.tracks(30, 6.0, corpus.generator(SEED, "cpu"), "cpu").numpy()
    an = Analyzer(device="cpu")
    ht = HashTable(hashbits=10, depth=4, maxtime=1 << 14)
    di = DeviceIngest(ht, an)
    rows = []
    for i0 in range(0, 30, 16):
        h = di.dispatch_chunk([(f"t{i}", "wav", tr[i])
                               for i in range(i0, min(30, i0 + 16))], print)
        rows += di.consume_chunk(h)
    got = RT.from_dense(di.table, di.counts, ht.hashesperid)
    di.finalize()
    return tr, ht, got, rows


@pytest.mark.parametrize("preset", PRESETS, ids=["default", "noisy-query"])
def test_hashes_equal_the_program(small, preset):
    from audfprint_torch.models.analyzer import Analyzer
    tr = small[0][:6]
    an = Analyzer(device="cpu", density=preset["density"],
                  shifts=preset["shifts"],
                  maxpairsperpeak=preset["fanout"])
    for h, k in zip(an.samples_batch2hashes(list(tr)),
                    RA.keys_of(list(tr), preset, "cpu")):
        got = (h[:, 0].astype(np.int64) << 20) | h[:, 1]
        assert np.array_equal(np.sort(got), k.numpy())


def test_table_equals_the_program_past_the_depth(small):
    tr, ht, got, rows = small
    keys = RA.keys_of(list(tr), PRESETS[0], "cpu")
    want = RT.build(keys, hashbits=10, depth=4)
    assert int((want.counts > 4).sum()) > 0        # the reservoir engaged
    r = RT.compare(got, want, len(tr))
    assert r == {"entries_gap": 0.0, "ids_differing": 0, "counts_gap": 0.0}
    assert [n for _name, n, _d in rows] == [len(k) for k in keys]


@pytest.mark.parametrize("preset", PRESETS, ids=["default", "noisy-query"])
def test_top_rows_equal_the_program(small, preset):
    from audfprint_torch.match.matcher import Matcher
    from audfprint_torch.models.analyzer import Analyzer
    tr, ht, _got, _rows = small
    rng = np.random.default_rng(SEED)
    clips, ids, _ = corpus.excerpts(tr, 12, 3.0, rng)
    clips[-3:] = [corpus.degrade(c, rng, snr_db=0) for c in clips[-3:]]
    an = Analyzer(device="cpu", density=preset["density"],
                  shifts=preset["shifts"], maxpairsperpeak=preset["fanout"])
    res, nh = Matcher(device="cpu", ndev=1).match_samples_fused(an, ht,
                                                                clips)
    want = RT.build(RA.keys_of(list(tr), PRESETS[0], "cpu"), hashbits=10,
                    depth=4)
    qk = RA.keys_of(clips, preset, "cpu")
    rows = RT.vote(want, qk).numpy()
    for r, n, w, k in zip(res, nh, rows, qk):
        top = r[0, :4].tolist() if len(r) else [-1] * 4
        assert top == w.tolist() and n == len(k)
    assert (rows[:, 0] >= 0).sum() >= 9


def test_reservoir_slot_equals_the_programs():
    import torch
    from audfprint_torch.utils import prng
    b = np.arange(0, 5000, 7, dtype=np.int64)
    p = (b * 13) % 900 + 100
    want = prng.reservoir_slot(b, p, 3)
    got = RT.reservoir_slot(torch.as_tensor(b), torch.as_tensor(p), 3)
    assert np.array_equal(got.numpy(), want)
