"""audfprint_torch streamed ingest against the JAX package on the CPU.

The same numpy inputs go through the JAX functions and their ports at
small sizes (30 s WAVs, chunks of 128/300/16384 frames).  Bit-exact: the
HPF with a carry and the forward prune with its envelope carry (K1f's
plain version) inside the peaks pass, the integer whitening-stats total,
and pair_kept_slots.  Within the port, exact: chunk-size invariance,
shifts, the silence floor correction, wrong-rate WAVs, the device pairing
against the oracle pairing, and the streamed route against the in-memory
path when both use the same whitening stats.  The float front end (FFT,
log) is held to ROADMAP's tolerance: hash Jaccard > 0.9 against the JAX
streamed hashes."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from audfprint_tpu.models import streaming as JSTM  # noqa: E402
from audfprint_tpu.ops import peaks as PKj  # noqa: E402
from audfprint_tpu.ops import streaming as JST  # noqa: E402
from audfprint_tpu.ops.config import PipelineConfig  # noqa: E402
from audfprint_tpu.oracle import analyze as oa  # noqa: E402
from audfprint_tpu.utils import audio as audio_io  # noqa: E402
from audfprint_torch.models import streaming as STM  # noqa: E402
from audfprint_torch.models.analyzer import Analyzer  # noqa: E402
from audfprint_torch.ops import cuda_peaks as CP  # noqa: E402
from audfprint_torch.ops import peaks as PK  # noqa: E402
from audfprint_torch.ops import pipeline as pipe  # noqa: E402
from audfprint_torch.ops import spectro as SP  # noqa: E402
from audfprint_torch.ops import streaming as ST  # noqa: E402
from tests.test_streaming import _synth_music  # noqa: E402

torch.set_num_threads(2)
SR = 11025
CFG = PipelineConfig()
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def wav30(tmp_path_factory):
    p = tmp_path_factory.mktemp("tstream") / "song30.wav"
    x = _synth_music(30.0, seed=3)
    audio_io.audio_write_wav(str(p), x, SR)
    return str(p), x


def _stream(path, cfg=CFG, chunk=300, stats=None):
    return STM.wavfile2hashes_streaming(path, cfg, SR, CPU, chunk, stats)


def _rows(rng, S, T, F=256, quant=False):
    w = rng.standard_normal((S, T, F)).astype(np.float32) * 2.0
    for s in range(S):
        for _ in range(6):
            f0 = rng.integers(5, F - 5)
            t0, t1 = sorted(rng.integers(0, T, 2).tolist())
            w[s, t0:t1 + 1, f0] += 3.0
    return np.round(w).astype(np.float32) if quant else w


@pytest.mark.parametrize("first,ragged", [(True, False), (False, False),
                                          (False, True)])
def test_peaks_pass_bit_exact_vs_chunk_fwd_peaks(first, ragged, monkeypatch):
    """One chunk through JAX's chunk_fwd_peaks and the port's: given the
    same log magnitudes, the HPF with its carry (K2's plain version), the
    forward prune with its envelope carry (K1f's plain version), the
    ascending slots, their values, the last row and every carry out are
    bit-exact.  This is also where the JAX scan's FMA contraction shows:
    the carries out agree only if XLA fuses (x - xp) + pole * yp."""
    rng = np.random.default_rng(11)
    S, T = 2, 200
    music = _synth_music(6.0, seed=12)
    n = ST.chunk_samples(T, CFG)
    audio = np.stack([music[:n], music[128: 128 + n]])
    nf = np.array([T, T - 50 if ragged else T], np.int32)
    gmax = np.full(S, np.asarray(JST.chunk_mag_max(
        jnp.asarray(audio), jnp.asarray(nf), CFG)), np.float32)
    mean = np.array([-4.5, -4.25], np.float32)
    xprev = rng.standard_normal((S, 256)).astype(np.float32)
    yprev = rng.standard_normal((S, 256)).astype(np.float32)
    env = np.abs(rng.standard_normal((S, 256))).astype(np.float32) * 3.0
    logm = np.asarray(JST.chunk_logm(jnp.asarray(audio), jnp.asarray(gmax),
                                     CFG))
    packed, env2, xp2, yp2 = JST.chunk_fwd_peaks(
        jnp.asarray(audio), jnp.asarray(nf), jnp.asarray(gmax),
        jnp.asarray(mean), jnp.asarray(xprev), jnp.asarray(yprev),
        jnp.asarray(env), CFG, first)
    wbins, wvalid, wvals, wlast = JST.unpack_fwd_peaks(
        np.asarray(packed), T, CFG.maxpksperframe)

    monkeypatch.setattr(ST, "chunk_logm",
                        lambda a, g, cfg: torch.from_numpy(logm.copy()))
    (bins, valid, vals, last), genv, (gx, gy) = ST.chunk_fwd_peaks(
        torch.from_numpy(audio), torch.from_numpy(nf),
        torch.from_numpy(gmax), torch.from_numpy(mean),
        (torch.from_numpy(xprev), torch.from_numpy(yprev)),
        torch.from_numpy(env), torch.from_numpy(PK.gauss_vector(CFG)), CFG,
        first)
    assert np.array_equal(gx.numpy(), np.asarray(xp2))
    assert np.array_equal(gy.numpy(), np.asarray(yp2))
    assert np.array_equal(valid.numpy(), wvalid) and wvalid.sum() > 100
    assert np.array_equal(bins.numpy(), wbins)
    assert np.array_equal(vals.numpy(), wvals)
    assert np.array_equal(last.numpy(), wlast)
    assert np.array_equal(genv.numpy(), np.asarray(env2))


@pytest.mark.parametrize("use_env_in", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_k1f_plain_matches_fwd_prune_carry(use_env_in, quant):
    """K1f's plain version against PK.fwd_prune_carry: the forward mask
    and env_out, envelope in from the head or from a carry, on random and
    np.round tie-heavy input with a ragged row."""
    rng = np.random.default_rng(5 + quant)
    y = _rows(rng, 3, 90, quant=quant)
    nf = np.array([90, 61, 90], np.int32)
    env_in = (np.abs(rng.standard_normal((3, 256))) * 2.0).astype(np.float32)
    mask, env_out = PKj.fwd_prune_carry(jnp.asarray(y), jnp.asarray(nf),
                                        jnp.asarray(env_in), CFG, use_env_in)
    yt, nft = torch.from_numpy(y), torch.from_numpy(nf)
    gvec = torch.from_numpy(PK.gauss_vector(CFG))
    env0 = (torch.from_numpy(env_in) if use_env_in
            else PK.head_envelope(yt, nft, CP._bump_table(gvec, 256)))
    lpos, lval, genv = CP.prune_fwd_carry(CP.candidate_map(yt, nft), env0,
                                          gvec, CFG.a_dec, CFG.maxpksperframe)
    got = np.zeros((3, 90, 257), bool)
    p = lpos.numpy()
    b, t, _i = np.nonzero(p >= 0)
    got[b, t, p[b, t, _i]] = True
    assert np.array_equal(got[..., :256], np.asarray(mask))
    assert np.array_equal(genv.numpy(), np.asarray(env_out))
    ok = p >= 0
    assert np.array_equal(lval.numpy()[ok], y[b, t, p[ok]])
    assert np.all(np.isneginf(lval.numpy()[~ok]))


def test_hpf_carry_chunks_equal_one_pass():
    """hpf and K1f's plain version over three carried chunks equal one pass
    over the whole T (full chunks), bit for bit."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(_rows(rng, 2, 120))
    y, c = SP.hpf(w, CFG)
    parts, carry = [], None
    for a, b in ((0, 40), (40, 77), (77, 120)):
        yc, carry = SP.hpf(w[:, a:b], CFG, carry)
        parts.append(yc)
    assert torch.equal(torch.cat(parts, 1), y)
    assert all(torch.equal(u, v) for u, v in zip(carry, c))
    gvec = torch.from_numpy(PK.gauss_vector(CFG))
    nf = torch.full((2,), 120, dtype=torch.int32)
    m0 = CP.candidate_map(y, nf)
    env0 = PK.head_envelope(y, nf, CP._bump_table(gvec, 256))
    whole = CP.prune_fwd_carry(m0, env0, gvec, CFG.a_dec, 5)
    env, lp = env0, []
    for a, b in ((0, 40), (40, 77), (77, 120)):
        p_, _v, env = CP.prune_fwd_carry(m0[:, a:b], env, gvec, CFG.a_dec, 5)
        lp.append(p_)
    assert torch.equal(torch.cat(lp, 1), whole[0])
    assert torch.equal(env, whole[2])


def test_pair_kept_slots_bit_exact():
    rng = np.random.default_rng(4)
    S, Tp, K = 2, 96, 5
    slots = np.zeros((S, Tp, K), np.int16)
    for s in range(S):
        for t in range(Tp):
            n = rng.integers(0, K + 1)
            slots[s, t, :n] = np.sort(rng.choice(256, n, replace=False)) + 1
    anchors = rng.integers(0, Tp * K, (S, 64)).astype(np.int32)
    want = np.asarray(JST.pair_kept_slots(jnp.asarray(slots),
                                          jnp.asarray(anchors), CFG))
    got = ST.pair_kept_slots(torch.from_numpy(slots),
                             torch.from_numpy(anchors), CFG).numpy()
    assert np.array_equal(got, want) and (got >> 20).sum() > 50


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_stats_integer_total_matches_jax(scale):
    """Given the same f32 logs, the port's int64 level sums give the same
    Python-int total as JAX's (hi, lo) limbs (_levels_to_int)."""
    rng = np.random.default_rng(9)
    s = (rng.standard_normal((2, 300, 257)) * 30.0 * scale).astype(
        np.float32)
    take = rng.random((2, 300, 257)) < 0.9
    hi, lo, rj = JST._sum6(jnp.asarray(s), jnp.asarray(take))
    sums, rt = ST._sum6(torch.from_numpy(s), torch.from_numpy(take))
    for r in range(2):
        want = JSTM._levels_to_int(np.asarray(hi)[r], np.asarray(lo)[r])
        assert ST.levels_to_int(sums[r].tolist()) == want
    assert float(rt) == float(rj) == 0.0


def test_chunk_size_invariance(wav30):
    path, _x = wav30
    h128, d1 = _stream(path, chunk=128)
    h300, _ = _stream(path, chunk=300)
    hbig, d2 = _stream(path, chunk=1 << 14)
    assert d1 == d2 == pytest.approx(30.0, abs=0.01)
    assert len(hbig) > 100
    assert np.array_equal(h128, hbig) and np.array_equal(h300, hbig)


def test_streaming_shifts(wav30):
    """shifts = 2 streams each sub-hop offset with its own carried state:
    chunk-size invariant, and at least as many hashes as one shift."""
    path, _x = wav30
    cfg = CFG._replace(shifts=2)
    got, _ = _stream(path, cfg, chunk=256)
    one, _ = _stream(path, cfg, chunk=1 << 14)
    assert np.array_equal(got, one)
    assert len(got) >= len(_stream(path)[0])


def test_silence_triggers_exact_floor_correction(tmp_path):
    """Digital silence puts |STFT| entries below the final whitening floor:
    the integer stats flag those chunks and correct their summands, landing
    on exactly the mean of the f64 logm accumulation, and the hashes stay
    chunk-size invariant through the correction."""
    x = _synth_music(6.0, seed=9)
    x[:SR] = 0.0
    x[3 * SR: 3 * SR + SR // 2] = 0.0
    p = str(tmp_path / "gappy.wav")
    audio_io.audio_write_wav(p, x, SR)
    src = STM.open_stream_source(p, SR)
    try:
        rd = STM._ChunkReader(src, CFG, 128, CPU)
        gmax, mean = STM._stats_pass(rd, CFG)
        assert np.array_equal(mean, STM._exact_mean_fallback(rd, CFG, gmax))
        nf0 = torch.from_numpy(rd.n_frames(0))
        cnt = ST.chunk_stats_below(torch.from_numpy(rd.chunk(0)), nf0,
                                   torch.from_numpy(gmax), CFG)[0]
        assert int(cnt.sum()) > 0          # the correction really ran
    finally:
        src.close()
    h_a, _ = _stream(p, chunk=128)
    h_b, _ = _stream(p, chunk=1 << 14)
    assert np.array_equal(h_a, h_b) and len(h_a) > 30


def test_wrong_rate_wav_streams(tmp_path):
    """A 44.1 kHz WAV (2 s) streams through chunked resampling, chunk-size
    invariant, and the Analyzer routes it to the streamed path."""
    x44 = _synth_music(8.0, seed=6)
    p = str(tmp_path / "song44.wav")
    audio_io.audio_write_wav(p, x44, 44100)
    assert isinstance(STM.open_stream_source(p, SR), STM.ResampledWavSource)
    h_a, d_a = _stream(p, chunk=128)
    h_b, d_b = _stream(p, chunk=1 << 14)
    assert d_a == d_b and len(h_a) > 30
    assert np.array_equal(h_a, h_b)
    an = Analyzer(device="cpu")
    an.stream_above_sec = 1.0
    an.stream_chunk_frames = 128
    assert an._should_stream(p)
    assert np.array_equal(an.wavfile2hashes(p), h_a)


def test_device_pairing_equals_oracle(wav30):
    """The streamed tail's pairing (pair_kept_slots through
    slots_to_hashes) gives exactly the oracle peaks2landmarks /
    landmarks2hashes rows on the same kept peaks, shifts = 2."""
    path, _x = wav30
    cfg = CFG._replace(shifts=2)
    kept, tmax, _dur = STM.kept_peaks(path, cfg, SR, 256, CPU)
    ap = STM.analyzer_params(cfg)
    want = np.unique(np.concatenate(
        [oa.landmarks2hashes(oa.peaks2landmarks(
            list(zip(t.tolist(), p.tolist())), ap)) for t, p in kept]),
        axis=0)
    got = np.unique(np.concatenate(STM._pair_on_device(kept, tmax, cfg, CPU)),
                    axis=0)
    assert len(want) > 100 and np.array_equal(got, want)


def test_streamed_hashes_match_jax_streamed(wav30):
    """The float front end (torch's rfft and log against XLA's) within
    ROADMAP's tolerance: Jaccard > 0.9 against the JAX streamed hashes of
    the same WAV (identical on this file)."""
    path, _x = wav30
    got, d1 = _stream(path, chunk=300)
    want, d2 = JSTM.wavfile2hashes_streaming(path, CFG, SR, chunk_frames=300)
    a, b = set(map(tuple, got.tolist())), set(map(tuple, want.tolist()))
    assert d1 == d2
    assert len(a & b) / len(a | b) > 0.9


def test_streaming_equals_in_memory_with_its_stats(wav30):
    """Given the in-memory path's own whitening stats (the f32 max and the
    f32-summed mean of spectro.whitened_logmag), the streamed route
    reproduces the in-memory hashes exactly: carries, sparse backward
    prune and pairing add nothing of their own."""
    path, _x = wav30
    src = STM.open_stream_source(path, SR)
    x = src.read(0, src.n_samples)         # the WAV's int16 samples
    src.close()
    T = 1 + (len(x) - CFG.n_fft) // CFG.n_hop
    buf = torch.zeros((1, 1 << 19), dtype=torch.float32)
    buf[0, : len(x)] = torch.from_numpy(x)
    nf = torch.tensor([T], dtype=torch.int32)
    gmax = ST.chunk_mag_max(buf, nf, CFG)
    logm = ST.chunk_logm(buf, gmax, CFG)
    valid = (torch.arange(logm.shape[1]) < T)[None, :, None]
    mean = (torch.where(valid, logm, 0.0).sum(dim=(1, 2))
            / (T * logm.shape[-1]))
    got, _ = _stream(path, chunk=300,
                     stats=[(gmax.item(), mean.item())])
    want = pipe.fingerprint_numpy(buf.numpy(), [len(x)], CFG, "cpu")[0]
    assert len(want) > 100 and np.array_equal(got, want)


def test_analyzer_routes_long_wavs_to_streaming(wav30):
    """Files past stream_above_sec take the streamed route in the
    single-file and the batched Analyzer APIs; below it they do not."""
    path, _x = wav30
    an = Analyzer(device="cpu")
    an.stream_above_sec = 10.0
    an.stream_chunk_frames = 300
    want = an.wavfile2hashes_streaming(path)
    assert np.array_equal(an.wavfile2hashes(path), want)
    assert an.soundfiledur == pytest.approx(30.0, abs=0.1)
    assert np.array_equal(an.wavfiles2hashes([path])[0], want)
    an.stream_above_sec = 3600.0
    assert not an._should_stream(path)


def test_stream_unsupported_inputs(tmp_path):
    p = str(tmp_path / "wrongrate.wav")
    audio_io.audio_write_wav(p, np.zeros(2000, np.float32), 8000)
    with pytest.raises(STM.StreamUnsupported):
        STM.WavPCMSource(p, SR)
    q = tmp_path / "notwav.mp3"
    q.write_bytes(b"\xff\xfbnot really audio")
    with pytest.raises(STM.StreamUnsupported):
        STM.open_stream_source(str(q), SR)
    an = Analyzer(device="cpu")
    an.stream_above_sec = 0.01
    assert not an._should_stream(str(q))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1f/K2 run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_k1f_matches_plain_on_card(cuda_device, quant):
    rng = np.random.default_rng(1)
    y = torch.from_numpy(_rows(rng, 2, 400, quant=quant)).to(cuda_device)
    nf = torch.tensor([400, 233], dtype=torch.int32, device=cuda_device)
    gvec = torch.from_numpy(PK.gauss_vector(CFG)).to(cuda_device)
    m0 = CP.candidate_map(y, nf)
    env = torch.rand((2, 256), device=cuda_device)
    got = CP.prune_fwd_carry(m0, env, gvec, CFG.a_dec, 5)
    want = CP.prune_fwd_carry_plain(m0, env, gvec, CFG.a_dec, 5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,F,silent", [(3, 300, 256, False),
                                          (1, 8192, 256, False),
                                          (4, 8192, 256, False),
                                          (2, 700, 258, False),
                                          (1, 6000, 256, True)])
def test_k2_carry_matches_plain_on_card(cuda_device, B, T, F, silent):
    """K2 with a carry, bit for bit against its plain version: the
    streamed chunk shapes, a padded width, and a chunk that decays through
    silence into the subnormal range (flushed, as the reference does)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((B, T, F), generator=g)
    if silent:
        x[:, 50:] = -3.75
    c = (torch.randn(B, F, generator=g), torch.randn(B, F, generator=g))
    got = SP.hpf(x.to(cuda_device), CFG, [t.to(cuda_device) for t in c])
    want = SP.hpf_plain(x.to(cuda_device), CFG,
                        [t.to(cuda_device) for t in c])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert all(torch.equal(g_.view(torch.int32), w.view(torch.int32))
               for g_, w in zip(got[1], want[1]))
