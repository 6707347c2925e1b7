"""The inputs: made from the seed alone, the same for the same seed, with
the config-3 degradation recipe."""

import os
import sys

import numpy as np
import pytest
import torch

from portbench import corpus, drive, run
from portbench.tests.conftest import CONDITIONS, SEED, tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cell(files, seed=SEED):
    return drive.Cell(files["cfg"], files["mix"], seed, 1.0, False, "cpu",
                      "/nonexistent", None)


def test_tracks_follow_the_seed():
    a = corpus.tracks(3, 2.0, corpus.generator(SEED, "cpu"), "cpu")
    b = corpus.tracks(3, 2.0, corpus.generator(SEED, "cpu"), "cpu")
    c = corpus.tracks(3, 2.0, corpus.generator(SEED + 1, "cpu"), "cpu")
    assert a.dtype == torch.int16 and a.shape == (3, 2 * corpus.SR)
    assert torch.equal(a, b) and not torch.equal(a, c)
    peak = a.abs().amax(dim=1).double() / 32768
    assert torch.allclose(peak, torch.full_like(peak, 0.7), atol=1e-4)


@pytest.mark.parametrize("workload", ["c2-1k.match", "c3-noisy.match"])
def test_queries_follow_the_seed_with_one_set_of_sizes(workload):
    files = tiny(workload)
    tr = drive.make_tracks(_cell(files), 24)
    queries = run.kind("backlog").queries
    q1 = queries(_cell(files), tr, 18)
    q2 = queries(_cell(files), tr, 18)
    q3 = queries(_cell(files, SEED + 7), tr, 18)
    assert all(np.array_equal(a, b) for a, b in zip(q1, q2))
    assert not all(np.array_equal(a, b) for a, b in zip(q1, q3))
    # every seed gets the same lengths, in another order
    assert sorted(map(len, q1)) == sorted(map(len, q3))


def test_conditions_are_the_config3_conditions():
    sys.path.insert(0, ROOT)
    from benchmarks.baseline_configs import CONFIG3_CONDITIONS
    assert CONDITIONS == [kw for _n, kw in CONFIG3_CONDITIONS]


@pytest.mark.parametrize("kw", [{}, {"snr_db": 5}, {"lowpass_hz": 3000},
                                {"speed": 0.97},
                                {"snr_db": 5, "lowpass_hz": 3000,
                                 "speed": 1.02}])
def test_degradations_follow_the_recipe(kw):
    sys.path.insert(0, ROOT)
    from benchmarks.baseline_configs import _degrade
    clip = corpus.tracks(1, 3.0, corpus.generator(SEED, "cpu"),
                         "cpu")[0].numpy()
    ours = corpus.degrade(clip, np.random.default_rng(4), **kw)
    theirs = _degrade(clip.astype(np.float32) / 32768.0,
                      np.random.default_rng(4), **kw)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
