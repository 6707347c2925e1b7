"""Landmark pairing (ops/landmarks.slots_to_hashes) against the JAX package
on the CPU, bit for bit on times, hashes and lvalid.

Each case of chip_smoke.PAIR_CASES goes through
audfprint_tpu.ops.landmarks.slots_to_hashes (jit, CPU) and through two
counterparts: the port's plain version, which slots_to_hashes runs on a
CPU tensor, and `k3_tile_walk`, a numpy transcription of kernel K3
(csrc/pair.cu: tiles of frames with their halo, a compacted list of the
valid peaks, one worker per valid anchor, the output tile), which cannot
run here.  The card holds K3 itself against the plain version
(chip_smoke.py, and the `cuda` test below)."""

import importlib.util
import os
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from audfprint_tpu.ops import landmarks as Lj  # noqa: E402
from audfprint_tpu.ops.config import PipelineConfig  # noqa: E402
from audfprint_torch.ops import _build  # noqa: E402
from audfprint_torch.ops import landmarks as L  # noqa: E402

CASES = chip_smoke.PAIR_CASES
IDS = [c[0] for c in CASES]


def k3_tile_walk(bins: np.ndarray, valid: np.ndarray, cfg, tf: int = 8,
                 stats: dict | None = None):
    """csrc/pair.cu's algorithm in numpy, step for step, with a tile of
    `tf` frames (8 here, so that every case crosses tile edges; the
    kernel's is chip_smoke.K3_TILE).  Per tile of row b:
      1. the output tile zeroed; frames [t0, t0 + tf + targetdt) clipped
         to T, the anchors and their partner halo, loaded;
      2. the valid peaks compacted into a list of (bin, frame) in (frame,
         slot) order, with per-frame starts, an exclusive scan of the
         per-frame counts;
      3. one worker per valid anchor, the list's prefix over frames
         [t0, t0 + tf): the d < 0 steps first, one frame of the list each
         at t + slice_start(d); then for d >= 0 the run
         list[start[t + max(mindt, 0)] : start[min(t + targetdt, T)]],
         each entry's d its frame minus t; partners with |f2 - f1| <
         targetdf appended until `fanout`;
      4. the output tile stored to [b, t0 : t0 + tf].
    `stats`, when given, gets the list entries the workers examined
    (key "entries")."""
    B, T, K = bins.shape
    fanout, targetdt = cfg.maxpairsperpeak, cfg.targetdt
    hashes = np.zeros((B, T, K, fanout), np.int32)
    lvalid = np.zeros((B, T, K, fanout), bool)
    entries = 0
    for b in range(B):
        for t0 in range(0, T, tf):
            nf, nt = min(tf + targetdt, T - t0), min(tf, T - t0)
            s_h = np.zeros(nt * K * fanout, np.int32)
            s_v = np.zeros(nt * K * fanout, bool)
            s_bins = bins[b, t0:t0 + nf].reshape(-1)
            s_valid = valid[b, t0:t0 + nf].reshape(-1)
            counts = s_valid.reshape(nf, K).sum(1)
            start = np.concatenate([[0], np.cumsum(counts)])
            lpos = np.flatnonzero(s_valid)       # (frame, slot) order
            lbin, lframe = s_bins[lpos], lpos // K
            for a in range(start[nt]):
                f1, fa, o = int(lbin[a]), int(lframe[a]), lpos[a] * fanout
                count = 0

                def take(i: int, d: int) -> None:
                    nonlocal count, entries
                    entries += 1
                    f2 = int(lbin[i])
                    if abs(f2 - f1) < cfg.targetdf:
                        s_h[o + count] = (((f1 & 0xFF) << 12)
                                          | (((f2 - f1) & 0x3F) << 6)
                                          | (d & 0x3F))
                        s_v[o + count] = True
                        count += 1

                for d in range(cfg.mindt, 0):
                    if count == fanout:
                        break
                    pf = fa + L.slice_start(d, T, targetdt)
                    if pf >= nf:                 # frame >= T: the padding
                        continue
                    for i in range(start[pf], start[pf + 1]):
                        take(i, d)
                        if count == fanout:
                            break
                dlo = max(cfg.mindt, 0)
                if count < fanout and dlo < targetdt:
                    for i in range(start[min(fa + dlo, nf)],
                                   start[min(fa + targetdt, nf)]):
                        take(i, int(lframe[i]) - fa)
                        if count == fanout:
                            break
            hashes[b, t0:t0 + nt] = s_h.reshape(nt, K, fanout)
            lvalid[b, t0:t0 + nt] = s_v.reshape(nt, K, fanout)
    if stats is not None:
        stats["entries"] = entries
    times = np.broadcast_to(np.arange(T, dtype=np.int32)[None, :, None, None],
                            hashes.shape)
    return times, hashes, lvalid


def _case(name: str):
    _n, B, T, K, fields, kind = CASES[IDS.index(name)]
    cfg = PipelineConfig(**fields)
    rng = np.random.default_rng(IDS.index(name) + 80)
    bins, valid = chip_smoke.pair_input(rng, B, T, K, cfg.n_bins, kind,
                                        cfg.targetdf)
    return bins, valid, cfg


def _port_plain(bins, valid, cfg):
    return [a.numpy() for a in L.slots_to_hashes(torch.from_numpy(bins),
                                                 torch.from_numpy(valid), cfg)]


@pytest.mark.parametrize("impl", ["plain", "k3_tile_walk"])
@pytest.mark.parametrize("name", IDS)
def test_pairing_bit_exact_vs_jax(name, impl):
    bins, valid, cfg = _case(name)
    want = [np.asarray(a) for a in Lj.slots_to_hashes(
        jnp.asarray(bins), jnp.asarray(valid), cfg)]
    got = (_port_plain if impl == "plain" else k3_tile_walk)(bins, valid,
                                                             cfg)
    for w, g, what in zip(want, got, ("times", "hashes", "lvalid")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert np.array_equal(g, w), what
    if name == "dense within targetdf":      # the fanout fills at d = mindt
        head = slice(0, bins.shape[1] - cfg.mindt)
        assert want[2][:, head].all()
        assert ((want[1][:, head] & 0x3F) == cfg.mindt).all()
    if name.startswith("|df|"):              # both sides of the strict bound
        df = (want[1] >> 6) & 0x3F
        assert (df[want[2]] == cfg.targetdf - 1).any()
        assert not (df[want[2]] == cfg.targetdf).any()
        assert not (df[want[2]] == 64 - cfg.targetdf).any()


@pytest.mark.parametrize("name", ["default", "fanout 1", "sparse",
                                  "T=tile+1", "partners in the last frames"])
def test_k3_work_counts_the_tile_walk(name):
    """chip_smoke.k3_work's count of list entries examined, the figure
    printed beside K3's times, is the transcription's."""
    bins, valid, cfg = _case(name)
    stats = {}
    k3_tile_walk(bins, valid, cfg, stats=stats)
    _ex, _app, entries = chip_smoke.k3_work(
        torch, torch.from_numpy(bins), torch.from_numpy(valid), cfg)
    assert entries == stats["entries"] > 0


def test_tile_mirrors_the_kernel():
    """chip_smoke.K3_TILE, which sizes the tile-edge cases, is
    csrc/pair.cu's tile."""
    with open(f"{_build.CSRC}/pair.cu") as f:
        src = f.read()
    tile = re.search(r"constexpr int kTileFrames = (\d+);", src).group(1)
    assert int(tile) == chip_smoke.K3_TILE


def test_phase_cuts_find_their_code():
    """tools/k3_phases.py times K3 with its phases cut out of
    csrc/pair.cu's text: every piece it cuts is in the kernel."""
    spec = importlib.util.spec_from_file_location(
        "k3_phases", os.path.join(os.path.dirname(chip_smoke.__file__),
                                  "tools", "k3_phases.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(f"{_build.CSRC}/pair.cu") as f:
        src = f.read()
    cuts = [old for _name, reps in tool.CUTS for old, _new in reps]
    assert len(cuts) == 3 and all(src.count(old) == 1 for old in cuts)


def test_cpu_tensor_never_builds_the_kernel(monkeypatch):
    """A CPU tensor takes the plain version and never reaches the build."""
    def refuse():
        raise AssertionError("slots_to_hashes built the kernel for a CPU "
                             "tensor")

    monkeypatch.setattr(_build, "load", refuse)
    bins, valid, cfg = _case("default")
    before = L.launches["pair_scan"]
    got = _port_plain(bins, valid, cfg)
    want = [a.numpy() for a in L.slots_to_hashes_plain(
        torch.from_numpy(bins), torch.from_numpy(valid), cfg)]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert L.launches["pair_scan"] == before


def test_other_devices_raise():
    x = torch.empty((1, 4, 5), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        L.slots_to_hashes(x, x.bool(), PipelineConfig())


def test_signature_mirrors_the_kernel():
    """_build binds pair_scan with csrc/pair.cu's parameters: a pointer
    for each pointer and the stream, an int for each int."""
    with open(f"{_build.CSRC}/pair.cu") as f:
        src = f.read()
    assert "pair.cu" in _build.SOURCES
    params = re.search(r'extern "C" int pair_scan\(([^)]*)\)', src).group(1)
    kinds = [_build._P if "*" in p else _build._I for p in params.split(",")]
    assert kinds == _build._SIGNATURES["pair_scan"]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K3 runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", IDS)
def test_k3_matches_plain_on_card(cuda_device, name):
    bins, valid, cfg = _case(name)
    b, v = torch.from_numpy(bins).to(cuda_device), \
        torch.from_numpy(valid).to(cuda_device)
    got = L.slots_to_hashes(b, v, cfg)
    want = L.slots_to_hashes_plain(b, v, cfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
