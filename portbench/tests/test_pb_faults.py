"""A run with the timed path broken underneath comes out as not correct;
the same run unbroken comes out correct.  The chip check is skipped (the
run drives the program's CPU paths at a tiny size); everything else is
the run as the benchmark makes it."""

import numpy as np
import pytest

from portbench.tests.conftest import run_tiny, tiny


def _sound(workload):
    line = run_tiny(tiny(workload))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    return line


@pytest.mark.parametrize("workload", ["c2-1k.match", "c3-noisy.match",
                                      "c2-1k.ingest"])
def test_sound_run_is_correct(workload):
    _sound(workload)


def _broken(monkeypatch, workload, where, wrap):
    monkeypatch.setattr(where[0], where[1], wrap(getattr(*where)))
    line = run_tiny(tiny(workload))
    assert not line["correct"], line["checks"]
    return line


def test_store_that_leaves_its_state_unchanged(monkeypatch):
    from audfprint_torch.models import ingest as ING

    def wrap(fn):
        def step(audio, lengths, ids, table, counts, pcfg, tcfg):
            t0, c0 = table.clone(), counts.clone()
            out = fn(audio, lengths, ids, table, counts, pcfg, tcfg)
            table.copy_(t0)
            counts.copy_(c0)
            return out
        return step
    line = _broken(monkeypatch, "c2-1k.ingest", (ING, "_ingest_step"), wrap)
    assert line["checks"]["table_entries_gap"]["value"] >= 1.0


def test_ingest_that_leaves_out_half_the_chunk(monkeypatch):
    from audfprint_torch.models import ingest as ING

    def wrap(fn):
        def step(audio, lengths, ids, table, counts, pcfg, tcfg):
            half = lengths.clone()
            half[len(half) // 2:] = 0
            return fn(audio, half, ids, table, counts, pcfg, tcfg)
        return step
    _broken(monkeypatch, "c2-1k.ingest", (ING, "_ingest_step"), wrap)


@pytest.mark.parametrize("workload", ["c2-1k.match", "c3-noisy.match"])
def test_match_that_leaves_out_half_the_batch(monkeypatch, workload):
    from audfprint_torch.match.matcher import Matcher

    def wrap(fn):
        def resolve(self, analyzer, ht, handle):
            res, nh = fn(self, analyzer, ht, handle)
            k = len(res) // 2
            return ([r if i < k else np.zeros((0, 6), np.int64)
                     for i, r in enumerate(res)], nh)
        return resolve
    _broken(monkeypatch, workload, (Matcher, "match_fused_resolve"), wrap)


@pytest.mark.parametrize("workload", ["c2-1k.match", "c3-noisy.match"])
def test_match_that_alters_an_answer(monkeypatch, workload):
    from audfprint_torch.match.matcher import Matcher

    def wrap(fn):
        def resolve(self, analyzer, ht, handle):
            res, nh = fn(self, analyzer, ht, handle)
            res = [r.copy() for r in res]
            hit = next((i for i, r in enumerate(res) if len(r)), None)
            if hit is not None:                   # every resolved batch's
                res[hit][0, 2] += 3               # first match: its offset
            return res, nh
        return resolve
    _broken(monkeypatch, workload, (Matcher, "match_fused_resolve"), wrap)


def test_ingest_that_alters_an_answer(monkeypatch):
    from audfprint_torch.models import ingest as ING

    def wrap(fn):
        def consume(self, handle):
            rows = fn(self, handle)
            name, n, d = rows[0]
            return [(name, n // 2, d)] + rows[1:]     # half its hashes
        return consume
    _broken(monkeypatch, "c2-1k.ingest", (ING.DeviceIngest, "consume_chunk"),
            wrap)
