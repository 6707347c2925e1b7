// Kernels K1 and K1f: the decaying-threshold peak prune.
//
// K1 (prune_fwd_bwd) replaces audfprint_tpu/ops/pallas_peaks.py _kernel,
// launched by fused_prune (the repo's only pl.pallas_call).  Same contract:
// given the pre-masked candidate map m0 (locmax and t < n_frames already
// applied, everything else <= -3e38), the two initial envelopes and the
// bump template, emit per frame the positions the backward pass keeps, in
// extraction order, -1 where nothing was kept (the delete-next rule is
// applied by the caller, ops/cuda_peaks.py).
//
// K1f (prune_fwd_carry) is the forward half alone with the envelope taken
// in and handed back: the port of audfprint_tpu/ops/peaks.py
// fwd_prune_carry, the lax.scan that streamed ingest (ops/streaming.py)
// runs chunk by chunk.  It writes the per-frame (pos, val) lists in
// extraction order (-1 / -inf in an empty slot) and env_out, the envelope
// after the last frame.  Both kernels run the same forward loop.
//
//   forward  : cand = m0 > env; min(k, #cand) rounds of argmax on (value
//              desc, bin desc); env = max(env, max_i v_i * g[f - p_i + F -
//              1]) * a_dec, every bump taken from the frame-start
//              envelope.  The decay follows every frame, valid or not.
//   backward : walks t downward over the forward lists, env reset to env0b
//              at t = n_frames - 1; peak i is kept when v_i >= env[p_i],
//              and a kept peak raises env by its bump before peak i + 1 is
//              tested; then env *= a_dec.
//
// What bounds it: the serial chain over T.  The bytes are few (m0 is read
// once: 0.12 ms for a 256 x 1535 x 256 batch at 3.35 TB/s, 2.6 us for one
// 8192-frame chunk), so the time is T times the latency of one frame's
// dependent steps -- the instructions one warp issues in order, each
// waiting on the last -- and the design shortens that chain:
//   * one warp per row, no block barrier anywhere: lane l holds the NB =
//     F/32 contiguous bins [l*NB, l*NB + NB) with their envelope in
//     registers.  An argmax round is one redux.sync max over an
//     order-preserving key of the lane's best value, one ballot (the
//     highest lane among equal maxima holds the highest bin, so value ties
//     go to the larger bin) and two shuffles.  The backward test env[p]
//     is a register select in the owner lane and one shuffle;
//   * candidate-count skip: a frame runs min(k, c) rounds, c the warp's
//     candidate count (redux.sync add of the lanes' popcounts), so a frame
//     with no candidate -- most frames of music -- costs one compare
//     and one logic op per bin (the candidate mask), one vote, the decay
//     and the list stores; the
//     backward pass skips the tests of a frame whose first listed slot is
//     -1.  The frame loop runs inside a loop over ring chunks, so no frame
//     pays a division or a barrier, and the list pointers step;
//   * m0 arrives through a ring in shared memory filled by TMA bulk copies
//     (cp.async.bulk + one mbarrier per stage, issued by lane 0), kStages
//     stages of about kStageBytes each.  The ring's depth is chosen so the
//     copies in flight cover HBM latency: three stages (24 KB: 24 frames
//     at F = 256, 6 at F = 1024) are ahead of the frame being read,
//     several microseconds of the chain, so it never waits on memory;
//   * K1 keeps its forward lists in shared memory when they fit beside the
//     ring with two rows per SM (T*k*8 bytes, 61 KB at 1535 x 5), else in
//     the global scratch the wrapper passes (256 rows x 61 KB = 15.7 MB
//     stays in L2); lanes 0..k-1 write a frame's slots as one coalesced
//     warp store.
// Rows run in parallel: one 32-thread block per row, so K1 at B = 256
// spreads over the 132 SMs (two rows per SM); a streamed chunk (K1f) has
// one row per shift, and its time is the chain's latency alone.
//
// Bit-exactness: every bump is the single f32 product v * g that the plain
// version forms (the TPU kernel's 3 x bf16 split existed only to reach the
// MXU); max is exact in any order; no add follows a multiply, so nothing
// can be contracted into an FMA.  The compares, maxima and products of the
// envelopes are the .ftz forms (common.cuh): the reference flushes
// subnormal inputs and results, and an envelope decays into that range
// over minutes of digital silence (ops/ftz.py mirrors the rule in the
// plain versions).
//
// Preconditions (checked by the wrapper, which pads F to a multiple of 4
// with non-candidate bins): F % 4 == 0 (16-byte bulk copies), 0 < F <=
// 1024, 0 < k <= 16; m0 rows 16-byte aligned.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace audfp;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 4;             // ring stages, one mbarrier each
constexpr int kStageBytes = 8192;      // m0 bytes per stage (about)
constexpr int kMaxSmem = 232448;       // a block's shared memory on sm_90
constexpr int kListSmemMax = 113 * 1024;  // two K1 rows per SM

__host__ __device__ __forceinline__ int stage_frames(int F) {
  const int sf = kStageBytes / (F * 4);
  return sf > 0 ? sf : 1;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// dynamic shared memory layout: ring | mbarriers | template | lists
struct Layout {
  size_t ring, bars, tmpl, lists, total;
  __host__ __device__ Layout(int T, int F, int k, bool lists_in_smem) {
    ring = 0;
    bars = (size_t)kStages * stage_frames(F) * F * sizeof(float);
    tmpl = bars + kStages * sizeof(uint64_t);
    lists = align16(tmpl + (size_t)(2 * F - 1) * sizeof(float));
    total = lists + (lists_in_smem ? (size_t)T * k * 8 : 0);
  }
};

// The ring of m0 frames of one row: kStages slots of SF frames, chunk c
// (frames [c*SF, c*SF + SF)) in slot c % kStages.
struct Ring {
  const float* src;   // the row's m0, (T, F) in global memory
  float* buf;         // kStages * SF * F floats in shared memory
  uint64_t* bar;      // kStages mbarriers
  int T, F, SF;

  // lane 0: start the bulk copy of chunk c, if it exists
  __device__ void issue(int c) const {
    const int t0 = c * SF;
    if (t0 >= T) return;
    const int n = min(SF, T - t0);
    const uint32_t bytes = (uint32_t)n * F * sizeof(float);
    uint64_t* b = bar + c % kStages;
    mbar_expect_tx(b, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_u32(buf + (size_t)(c % kStages) *
                                                    SF * F)),
        "l"(src + (size_t)t0 * F), "r"(bytes), "r"(smem_u32(b))
        : "memory");
  }

  // every lane: initialise the barriers and start the first kStages chunks
  __device__ void start(int lane) const {
    if (lane == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(bar + s, 1);
      mbar_init_fence();
      for (int c = 0; c < kStages; ++c) issue(c);
    }
    __syncwarp();
  }

  // every lane: wait for chunk c (slot s = c % kStages, its use c /
  // kStages) and return its first frame
  __device__ const float* wait(int c, int s) const {
    mbar_wait(bar + s, (uint32_t)(c / kStages) & 1);
    return buf + (size_t)s * SF * F;
  }

  // every lane, after the last frame of chunk c: refill its slot with
  // chunk c + kStages (every lane has consumed its loads: the values are
  // in registers)
  __device__ void refill(int c, int lane) const {
    __syncwarp();
    if (lane == 0) {
      fence_proxy_async();
      issue(c + kStages);
    }
  }
};

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The lane's NB bins of one frame (bins past F read as -inf).
template <int NB>
__device__ __forceinline__ void load_bins(const float* fr, int base, int F,
                                          float (&x)[NB]) {
  if constexpr (NB % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      float4 v = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                             -CUDART_INF_F);
      if (base + 4 * q < F) v = *reinterpret_cast<const float4*>(fr + base + 4 * q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j)
      x[j] = base + j < F ? fr[base + j] : -CUDART_INF_F;
  }
}

// The forward pass of one row, run by one warp: walks the ring chunk by
// chunk, writes the (pos, val) lists lp/lv (k slots per frame, generic
// pointers: shared or global memory) and leaves the envelope after the
// last frame in env.  gs is the 2F - 1 template in shared memory.  The
// chain is a few dozen instructions of one warp per frame, so the loop
// keeps them few: no division per frame, pointers stepped, and a frame
// with no candidate costs a compare and a logic op per bin and one vote.
template <int NB>
__device__ void forward_pass(const Ring& ring, const float* gs, int* lp,
                             float* lv, float (&env)[NB], int T, int F, int k,
                             float a_dec, int lane) {
  const int base = lane * NB;
  const float* gl = gs + (F - 1) + base;   // gl[j - p] = g[base + j - p + F - 1]
  const int SF = ring.SF;
  for (int c = 0, t0 = 0, s = 0; t0 < T; ++c, t0 += SF, s = (s + 1) % kStages) {
    const float* fr = ring.wait(c, s);
    const int n = min(SF, T - t0);
    for (int u = 0; u < n; ++u, fr += F, lp += k, lv += k) {
      float x[NB];
      load_bins<NB>(fr, base, F, x);
      uint32_t mask = 0;
#pragma unroll
      for (int j = 0; j < NB; ++j) mask |= gt_ftz_mask(x[j], env[j]) & (1u << j);
      int myp = -1;
      float myv = -CUDART_INF_F;
      if (__any_sync(kFull, mask != 0)) {
        const int rounds = min(k, __reduce_add_sync(kFull, __popc(mask)));
        float ne[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) ne[j] = 0.0f;
        for (int i = 0; i < rounds; ++i) {
          float bv = -CUDART_INF_F;
          int bj = 0;
#pragma unroll
          for (int j = 0; j < NB; ++j)
            if (((mask >> j) & 1u) && x[j] >= bv) {
              bv = x[j];
              bj = j;
            }
          const uint32_t key = mask ? order_key(bv) : 0u;
          const uint32_t mx = __reduce_max_sync(kFull, key);
          const int wl = 31 - __clz(__ballot_sync(kFull, key == mx));
          const int p = __shfl_sync(kFull, base + bj, wl);
          const float v = __shfl_sync(kFull, bv, wl);
          if (lane == wl) mask &= ~(1u << bj);
          if (lane == i) {
            myp = p;
            myv = v;
          }
          const float* g = gl - p;
#pragma unroll
          for (int j = 0; j < NB; ++j)
            if (base + j < F) ne[j] = max_ftz(ne[j], mul_ftz(v, g[j]));
        }
#pragma unroll
        for (int j = 0; j < NB; ++j)
          env[j] = mul_ftz(max_ftz(env[j], ne[j]), a_dec);
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          env[j] = mul_ftz(max_ftz(env[j], 0.0f), a_dec);
      }
      if (lane < k) {
        lp[lane] = myp;
        lv[lane] = myv;
      }
    }
    ring.refill(c, lane);
  }
}

// Per-row setup shared by both kernels: the ring over this row's m0 and
// the template in shared memory.
__device__ __forceinline__ Ring setup_row(unsigned char* smem,
                                          const Layout& L,
                                          const float* __restrict__ m0,
                                          const float* __restrict__ gvec,
                                          int b, int T, int F, int lane) {
  float* gs = reinterpret_cast<float*>(smem + L.tmpl);
  for (int i = lane; i < 2 * F - 1; i += 32) gs[i] = gvec[i];
  Ring ring{m0 + (size_t)b * T * F, reinterpret_cast<float*>(smem + L.ring),
            reinterpret_cast<uint64_t*>(smem + L.bars), T, F,
            stage_frames(F)};
  ring.start(lane);   // its __syncwarp also publishes the template
  return ring;
}

template <int NB>
__global__ void __launch_bounds__(32)
    prune_fwd_bwd_kernel(const float* __restrict__ m0,
                         const int* __restrict__ n_frames,
                         const float* __restrict__ env0f,
                         const float* __restrict__ env0b,
                         const float* __restrict__ gvec, int* lpos,
                         float* lval, int* __restrict__ kept, int T, int F,
                         int k, float a_dec, int lists_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(T, F, k, lists_in_smem);
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int base = lane * NB;
  const Ring ring = setup_row(smem, L, m0, gvec, b, T, F, lane);
  const float* gl =
      reinterpret_cast<const float*>(smem + L.tmpl) + (F - 1) + base;
  int* lp;
  float* lv;
  if (lists_in_smem) {
    lp = reinterpret_cast<int*>(smem + L.lists);
    lv = reinterpret_cast<float*>(lp + (size_t)T * k);
  } else {
    lp = lpos + (size_t)b * T * k;
    lv = lval + (size_t)b * T * k;
  }

  // ---- forward pass ----
  float env[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    env[j] = base + j < F ? env0f[(size_t)b * F + base + j] : 0.0f;
  forward_pass<NB>(ring, reinterpret_cast<const float*>(smem + L.tmpl), lp,
                   lv, env, T, F, k, a_dec, lane);

  // ---- backward pass ----  (lane i reads back the slot it wrote, so no
  // barrier is needed between the passes)
  int* kb = kept + (size_t)b * T * k;
  const int tv = min(n_frames[b], T);       // frames t >= tv keep nothing
  for (int t = T - 1; t >= max(tv, 0); --t)
    if (lane < k) kb[(size_t)t * k + lane] = -1;
#pragma unroll
  for (int j = 0; j < NB; ++j)
    env[j] = base + j < F ? env0b[(size_t)b * F + base + j] : 0.0f;
  int nxp = -1;
  float nxv = 0.0f;
  if (tv > 0 && lane < k) {
    nxp = lp[(size_t)(tv - 1) * k + lane];
    nxv = lv[(size_t)(tv - 1) * k + lane];
  }
  const int* lpt = lp + (long long)(tv - 1) * k + lane;
  const float* lvt = lv + (long long)(tv - 1) * k + lane;
  int* kt = kb + (long long)(tv - 1) * k + lane;
  for (int t = tv - 1; t >= 0; --t, lpt -= k, lvt -= k, kt -= k) {
    const int myp = nxp;
    const float myv = nxv;
    if (t > 0 && lane < k) {                 // next frame's slots, early
      nxp = lpt[-k];
      nxv = lvt[-k];
    }
    const int n = __popc(__ballot_sync(kFull, lane < k && myp >= 0));
    int rec = -1;
    for (int i = 0; i < n; ++i) {
      const int p = __shfl_sync(kFull, myp, i);
      const float v = __shfl_sync(kFull, myv, i);
      const int jj = p % NB;
      float e = env[0];
#pragma unroll
      for (int j = 1; j < NB; ++j)
        if (j == jj) e = env[j];
      e = __shfl_sync(kFull, e, p / NB);
      if (ge_ftz(v, e)) {
        if (lane == i) rec = p;
        const float* g = gl - p;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (base + j < F) env[j] = max_ftz(env[j], mul_ftz(v, g[j]));
      }
    }
    if (lane < k) *kt = rec;
#pragma unroll
    for (int j = 0; j < NB; ++j) env[j] = mul_ftz(env[j], a_dec);
  }
}

template <int NB>
__global__ void __launch_bounds__(32)
    prune_fwd_carry_kernel(const float* __restrict__ m0,
                           const float* __restrict__ env_in,
                           const float* __restrict__ gvec, int* lpos,
                           float* lval, float* __restrict__ env_out, int T,
                           int F, int k, float a_dec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(T, F, k, false);
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int base = lane * NB;
  const Ring ring = setup_row(smem, L, m0, gvec, b, T, F, lane);
  float env[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    env[j] = base + j < F ? env_in[(size_t)b * F + base + j] : 0.0f;
  forward_pass<NB>(ring, reinterpret_cast<const float*>(smem + L.tmpl),
                   lpos + (size_t)b * T * k, lval + (size_t)b * T * k, env, T,
                   F, k, a_dec, lane);
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (base + j < F) env_out[(size_t)b * F + base + j] = env[j];
}

// bins per lane: the least power of two with 32 * NB >= F
int bins_per_lane(int F) {
  int nb = 1;
  while (32 * nb < F) nb *= 2;
  return nb;
}

bool bad_shape(int F, int k) {
  return F <= 0 || F > 1024 || F % 4 != 0 || k <= 0 || k > 16;
}

template <int NB>
cudaError_t launch_fwd_bwd(const float* m0, const int* n_frames,
                           const float* env0f, const float* env0b,
                           const float* gvec, int* lpos, float* lval,
                           int* kept, int B, int T, int F, int k, float a_dec,
                           cudaStream_t stream) {
  const bool in_smem = Layout(T, F, k, true).total <= (size_t)kListSmemMax;
  const size_t smem = Layout(T, F, k, in_smem).total;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      prune_fwd_bwd_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  prune_fwd_bwd_kernel<NB><<<B, 32, smem, stream>>>(
      m0, n_frames, env0f, env0b, gvec, lpos, lval, kept, T, F, k, a_dec,
      in_smem ? 1 : 0);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_fwd_carry(const float* m0, const float* env_in,
                             const float* gvec, int* lpos, float* lval,
                             float* env_out, int B, int T, int F, int k,
                             float a_dec, cudaStream_t stream) {
  const size_t smem = Layout(T, F, k, false).total;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      prune_fwd_carry_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  prune_fwd_carry_kernel<NB><<<B, 32, smem, stream>>>(
      m0, env_in, gvec, lpos, lval, env_out, T, F, k, a_dec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int prune_fwd_bwd(const float* m0, const int* n_frames,
                             const float* env0f, const float* env0b,
                             const float* gvec, int* lpos, float* lval,
                             int* kept, int B, int T, int F, int k,
                             float a_dec, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaGetLastError();
  if (bad_shape(F, k)) return (int)cudaErrorInvalidValue;
#define AUDFP_CALL(NB)                                                      \
  launch_fwd_bwd<NB>(m0, n_frames, env0f, env0b, gvec, lpos, lval, kept, B, \
                     T, F, k, a_dec, (cudaStream_t)stream)
  switch (bins_per_lane(F)) {
    case 1: return (int)AUDFP_CALL(1);
    case 2: return (int)AUDFP_CALL(2);
    case 4: return (int)AUDFP_CALL(4);
    case 8: return (int)AUDFP_CALL(8);
    case 16: return (int)AUDFP_CALL(16);
    default: return (int)AUDFP_CALL(32);
  }
#undef AUDFP_CALL
}

extern "C" int prune_fwd_carry(const float* m0, const float* env_in,
                               const float* gvec, int* lpos, float* lval,
                               float* env_out, int B, int T, int F, int k,
                               float a_dec, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (bad_shape(F, k)) return (int)cudaErrorInvalidValue;
#define AUDFP_CALL(NB)                                                     \
  launch_fwd_carry<NB>(m0, env_in, gvec, lpos, lval, env_out, B, T, F, k, \
                       a_dec, (cudaStream_t)stream)
  switch (bins_per_lane(F)) {
    case 1: return (int)AUDFP_CALL(1);
    case 2: return (int)AUDFP_CALL(2);
    case 4: return (int)AUDFP_CALL(4);
    case 8: return (int)AUDFP_CALL(8);
    case 16: return (int)AUDFP_CALL(16);
    default: return (int)AUDFP_CALL(32);
  }
#undef AUDFP_CALL
}
