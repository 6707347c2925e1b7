"""The streamed route's native backward prune (utils/native.bwd_prune_sparse,
the C++ loop in audfprint_torch/native/audfp_host.cpp) against the oracle
(oracle.analyze.bwd_prune_sparse): the same keep mask, bit for bit, on
seeded sparse peak streams that reach each rule of the oracle's loop."""

import shutil

import numpy as np
import pytest

from audfprint_torch import params as P
from audfprint_torch.models import streaming as STM
from audfprint_torch.oracle import analyze as oa
from audfprint_torch.utils import native, timing

AP = P.AnalyzerParams()
MAXPKS = P.MAX_PKS_PER_FRAME


def _frames(rng, T, F, rate, vals):
    """~`rate` peaks a frame (at most MAXPKS, distinct bins) over T frames,
    values drawn by `vals(rng, n)` -> ascending (t, pos, val)."""
    npk = np.minimum(rng.poisson(rate, T), MAXPKS)
    t = np.repeat(np.arange(T), npk).astype(np.int64)
    pos = np.concatenate([rng.choice(F, k, replace=False) for k in npk]
                         + [np.zeros(0, np.int64)]).astype(np.int64)
    return t, pos, vals(rng, len(t)).astype(np.float32)


def _gamma(rng, n):
    return rng.gamma(2.0, 1.5, n)


def _realistic(rng, F):
    """A 2 h file's density: ~0.8 peaks a frame, at most MAXPKS a frame."""
    T = 30000
    t, pos, val = _frames(rng, T, F, 0.8, _gamma)
    return T, t, pos, val


def _ties(rng, F):
    """Few distinct values: equal values at different bins of one frame."""
    T = 4000
    t, pos, val = _frames(rng, T, F, 3.0,
                          lambda r, n: r.integers(1, 4, n) * 2.5)
    return T, t, pos, val


def _tracks(rng, F):
    """Steady tones: the same bin in runs of consecutive frames, so a kept
    peak clears the one after it."""
    T = 3000
    ts, ps, vs = [], [], []
    for _ in range(40):
        b = int(rng.integers(0, F))
        t0 = int(rng.integers(0, T - 60))
        run = np.arange(t0, t0 + int(rng.integers(2, 60)))
        ts.append(run)
        ps.append(np.full(len(run), b))
        vs.append(rng.uniform(2.0, 9.0, len(run)))
    t, pos, val = _frames(rng, T, F, 0.3, _gamma)
    t = np.concatenate(ts + [t])
    pos = np.concatenate(ps + [pos])
    val = np.concatenate(vs + [val])
    # one peak per (t, pos), a track's before a background one, in
    # ascending (t, pos) order
    _u, sel = np.unique(t * F + pos, return_index=True)
    return (T, t[sel].astype(np.int64), pos[sel].astype(np.int64),
            val[sel].astype(np.float32))


def _silent_gap(rng, F):
    """Empty frames, and 45,000 frames of silence between two busy
    stretches: walking back, the envelope decays from ~10 through the
    subnormals to zero, and peaks of subnormal size inside the gap meet an
    envelope of the same size (a flushed envelope would keep them all)."""
    head, gap, tail = 2000, 45000, 2000
    T = head + gap + tail
    t0, p0, v0 = _frames(rng, head, F, 0.8, _gamma)
    t1, p1, v1 = _frames(rng, tail, F, 0.8, _gamma)
    t1 = t1 + head + gap
    # the envelope of ~10 reaches 2^-126 about 17,400 frames in and the
    # smallest subnormal about 20,800 frames in
    a = np.float32(AP.a_dec)
    tg = np.sort(rng.choice(np.arange(head + gap - 21500, head + gap - 16500),
                            300, replace=False)).astype(np.int64)
    env = 10.0 * np.float64(a) ** (head + gap - tg)
    vg = (env * rng.uniform(0.2, 5.0, len(tg))).astype(np.float32)
    pg = rng.integers(0, F, len(tg)).astype(np.int64)
    t = np.concatenate([t0, tg, t1])
    pos = np.concatenate([p0, pg, p1])
    val = np.concatenate([v0, vg, v1]).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    assert np.count_nonzero((val > 0) & (val < tiny)) > 50
    return T, t, pos, val


def _past_end(rng, F):
    """Peaks at t >= n_frames: never visited, so kept unless the last
    visited frame's kept peak at the same bin clears one at t = n_frames.
    The last visited frame's peaks stand high enough to be kept, and one
    frame past the end repeats their bins."""
    T = 500
    t, pos, val = _frames(rng, T + 3, F, 2.0, _gamma)
    edge = (t == T - 1) | (t == T)
    last = np.sort(rng.choice(np.arange(0, F, F // 4), 3, replace=False))
    t = np.concatenate([t[~edge], np.full(3, T - 1), np.full(3, T)])
    pos = np.concatenate([pos[~edge], last, last])
    val = np.concatenate([val[~edge], [40.0, 60.0, 80.0], _gamma(rng, 3)])
    o = np.argsort(t, kind="stable")
    return T, t[o], pos[o], val[o].astype(np.float32)


def _duplicates(rng, F):
    """Repeated (t, pos) pairs on steady tones, some with equal values
    too: the oracle's dict holds the last index of a pair for the
    deletion rule."""
    T, t, pos, val = _tracks(rng, F)
    d = rng.choice(len(t), len(t) // 3, replace=False)
    same = rng.random(len(d)) < 0.5
    dval = np.where(same, val[d], _gamma(rng, len(d))).astype(np.float32)
    t = np.concatenate([t, t[d]])
    pos = np.concatenate([pos, pos[d]])
    val = np.concatenate([val, dval])
    o = np.argsort(t, kind="stable")
    return T, t[o], pos[o], val[o]


def _no_peaks(rng, F):
    return 1000, np.zeros(0, np.int64), np.zeros(0, np.int64), \
        np.zeros(0, np.float32)


def _one_frame(rng, F):
    t, pos, val = _frames(rng, 3, F, 4.0, _gamma)
    return 1, t, pos, val


def _zero_frames(rng, F):
    t, pos, val = _frames(rng, 3, F, 4.0, _gamma)
    return 0, t, pos, val


CASES = {"realistic": _realistic, "ties": _ties, "tracks": _tracks,
         "silent_gap": _silent_gap, "past_end": _past_end,
         "duplicates": _duplicates, "no_peaks": _no_peaks,
         "one_frame": _one_frame, "zero_frames": _zero_frames}


def _lib_or_fail():
    if native.get_lib() is None:
        if shutil.which("g++"):
            pytest.fail("g++ is on PATH but the native library did not build")
        pytest.skip("no g++: the native library cannot be built")


@pytest.mark.parametrize("F", [257, 129])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_native_keep_mask_equals_oracle(case, seed, F):
    _lib_or_fail()
    rng = np.random.default_rng([seed, F, list(CASES).index(case)])
    T, t, pos, val = CASES[case](rng, F)
    last_row = (rng.standard_normal(F) * 3.0).astype(np.float32)
    want = oa.bwd_prune_sparse(T, t, pos, val, last_row, AP)
    gvec = P.gaussian_template(AP.f_sd, F - 1).astype(np.float32)
    sthresh = oa.spreadpeaksinvector(last_row, AP.f_sd, gvec=gvec
                                     ).astype(np.float32)
    got = native.bwd_prune_sparse(T, t, pos, val, sthresh, gvec,
                                  np.float32(AP.a_dec))
    assert got is not None and got.dtype == np.bool_
    assert np.array_equal(got, want)
    if case in ("realistic", "ties", "tracks", "silent_gap", "duplicates"):
        assert 0 < np.count_nonzero(want) < len(want)


@pytest.mark.parametrize("case", ["realistic", "duplicates"])
def test_unordered_peaks_fall_back_to_oracle(case):
    """Peaks whose frames are not ascending are not the native loop's
    input: the wrapper declines them and the route's prune takes the
    oracle, with the oracle's mask and no stream.bwd_native count."""
    _lib_or_fail()
    rng = np.random.default_rng(7)
    T, t, pos, val = CASES[case](rng, 257)
    o = rng.permutation(len(t))
    t, pos, val = t[o], pos[o], val[o]
    last_row = (rng.standard_normal(257) * 3.0).astype(np.float32)
    gvec = P.gaussian_template(AP.f_sd, 256).astype(np.float32)
    assert native.bwd_prune_sparse(T, t, pos, val, np.zeros(257, np.float32),
                                   gvec, np.float32(AP.a_dec)) is None
    timing.TRACER.reset()
    timing.TRACER.on = True
    try:
        got = STM._bwd_prune(T, t, pos, val, last_row, AP)
        assert "stream.bwd_native" not in timing.TRACER.counters
    finally:
        timing.TRACER.on = False
        timing.TRACER.reset()
    assert np.array_equal(got, oa.bwd_prune_sparse(T, t, pos, val, last_row,
                                                   AP))
