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
//   forward  : cand = m0 > env; k rounds of argmax on (value desc, bin
//              desc); env = max(env, max_i v_i * g[f - p_i + F - 1]) * a_dec,
//              every bump taken from the frame-start envelope.  The
//              (pos, val) lists go to a global (B, T, k) buffer.  The decay
//              follows every frame, valid or not.
//   backward : walks t downward over those lists, env reset to env0b at
//              t = n_frames - 1; peak i is kept when v_i >= env[p_i], and a
//              kept peak raises env by its bump before peak i + 1 is tested;
//              then env *= a_dec.
//
// Launch shape: one block per batch row, one thread per bin (blockDim = F
// rounded up to a warp).  The envelope lives in a register per thread, the
// 2F-1 float template in shared memory.  Each argmax round is a warp-shuffle
// butterfly plus a shared-memory combine across warps; the scalar env[p]
// of the backward test is broadcast through shared memory.
//
// What bounds it: the serial chain over T (k block-wide reductions and
// about k + 2k barriers per frame).  Parallelism comes only from the rows:
// 256 rows per dispatch put about two blocks on each of the 132 SMs, while
// a streamed chunk (K1f) has one row per shift and runs on one SM.  The
// design keeps the chain short: the next frame's m0 load issues before the
// current frame's reductions, and no product leaves a register.
//
// Bit-exactness: every bump is the single f32 product v * g that the plain
// version forms (the TPU kernel's 3 x bf16 split existed only to reach the
// MXU); max is exact in any order; no add follows a multiply, so nothing
// can be contracted into an FMA.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxWarps = 32;

__device__ __forceinline__ bool better(float v1, int p1, float v2, int p2) {
  return v1 > v2 || (v1 == v2 && p1 > p2);
}

// block-wide argmax of (v, p) under `better`; every thread gets the winner.
// `buf` alternates between calls, so one barrier per call suffices.
__device__ __forceinline__ void block_argmax(float& v, int& p,
                                             float (*wv)[kMaxWarps],
                                             int (*wp)[kMaxWarps], int buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int op = __shfl_xor_sync(0xffffffffu, p, off);
    if (better(ov, op, v, p)) {
      v = ov;
      p = op;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    wv[buf][warp] = v;
    wp[buf][warp] = p;
  }
  __syncthreads();
  v = wv[buf][0];
  p = wp[buf][0];
  const int nwarps = blockDim.x >> 5;
  for (int w = 1; w < nwarps; ++w) {
    if (better(wv[buf][w], wp[buf][w], v, p)) {
      v = wv[buf][w];
      p = wp[buf][w];
    }
  }
}

// The forward pass of one row: walks t over m0b, extends the (pos, val)
// lists lpb/lvb, and returns the envelope after the last frame.  Every
// thread of the block calls it with its own bin's starting envelope.
__device__ float forward_pass(const float* __restrict__ m0b,
                              const float* gf, int* lpb, float* lvb,
                              float env, int T, int F, int k, float a_dec,
                              float (*wv)[kMaxWarps], int (*wp)[kMaxWarps]) {
  const int f = threadIdx.x;
  const bool active = f < F;
  const float NEG = -CUDART_INF_F;
  float x_next = (active && T > 0) ? m0b[f] : NEG;
  int round = 0;
  for (int t = 0; t < T; ++t) {
    const float x = x_next;
    if (active && t + 1 < T) x_next = m0b[(long long)(t + 1) * F + f];
    float m = (active && x > env) ? x : NEG;
    float newenv = 0.0f;
    for (int i = 0; i < k; ++i, ++round) {
      float v = m;
      int p = active ? f : -1;
      block_argmax(v, p, wv, wp, round & 1);
      const bool got = v > NEG;
      if (got) {
        if (f == p) m = NEG;
        if (active) newenv = fmaxf(newenv, v * gf[-p]);
      }
      if (f == 0) {
        lpb[(long long)t * k + i] = got ? p : -1;
        lvb[(long long)t * k + i] = v;
      }
    }
    env = fmaxf(env, newenv) * a_dec;
  }
  return env;
}

// Stage the 2F - 1 bump template in shared memory; returns the thread's
// view gf with gf[-p] = g[f - p + F - 1].
__device__ __forceinline__ const float* load_template(
    float* g_s, const float* __restrict__ gvec, int F) {
  for (int i = threadIdx.x; i < 2 * F - 1; i += blockDim.x) g_s[i] = gvec[i];
  __syncthreads();
  return g_s + (F - 1) + threadIdx.x;
}

__global__ void prune_fwd_bwd_kernel(const float* __restrict__ m0,
                                     const int* __restrict__ n_frames,
                                     const float* __restrict__ env0f,
                                     const float* __restrict__ env0b,
                                     const float* __restrict__ gvec,
                                     int* lpos, float* lval,
                                     int* __restrict__ kept,
                                     int T, int F, int k, float a_dec) {
  extern __shared__ float g_s[];            // 2F - 1 bump template
  __shared__ float wv[2][kMaxWarps];
  __shared__ int wp[2][kMaxWarps];
  __shared__ float cur_s;

  const int b = blockIdx.x;
  const int f = threadIdx.x;
  const bool active = f < F;
  const int nf = n_frames[b];
  int* lpb = lpos + (long long)b * T * k;
  float* lvb = lval + (long long)b * T * k;
  int* kb = kept + (long long)b * T * k;
  const float* gf = load_template(g_s, gvec, F);

  // ---- forward pass ----
  forward_pass(m0 + (long long)b * T * F, gf, lpb, lvb,
               active ? env0f[(long long)b * F + f] : 0.0f, T, F, k, a_dec,
               wv, wp);
  __syncthreads();                          // lists visible block-wide

  // ---- backward pass ----
  const float e0b = active ? env0b[(long long)b * F + f] : 0.0f;
  float env = e0b;
  for (int t = T - 1; t >= 0; --t) {
    if (t == nf - 1) env = e0b;
    const bool valid_t = t < nf;
    for (int i = 0; i < k; ++i) {
      const int p = lpb[t * k + i];
      const float v = lvb[t * k + i];
      const bool got = p >= 0;
      if (got && f == p) cur_s = env;
      __syncthreads();
      const bool keep = got && valid_t && v >= cur_s;
      __syncthreads();                      // cur_s is rewritten next round
      if (keep && active) env = fmaxf(env, v * gf[-p]);
      if (f == 0) kb[t * k + i] = keep ? p : -1;
    }
    env *= a_dec;
  }
}

__global__ void prune_fwd_carry_kernel(const float* __restrict__ m0,
                                       const float* __restrict__ env_in,
                                       const float* __restrict__ gvec,
                                       int* lpos, float* lval,
                                       float* __restrict__ env_out,
                                       int T, int F, int k, float a_dec) {
  extern __shared__ float g_s[];            // 2F - 1 bump template
  __shared__ float wv[2][kMaxWarps];
  __shared__ int wp[2][kMaxWarps];

  const int b = blockIdx.x;
  const int f = threadIdx.x;
  const bool active = f < F;
  const float* gf = load_template(g_s, gvec, F);
  const float env = forward_pass(
      m0 + (long long)b * T * F, gf, lpos + (long long)b * T * k,
      lval + (long long)b * T * k,
      active ? env_in[(long long)b * F + f] : 0.0f, T, F, k, a_dec, wv, wp);
  if (active) env_out[(long long)b * F + f] = env;
}

}  // namespace

extern "C" int prune_fwd_bwd(const float* m0, const int* n_frames,
                             const float* env0f, const float* env0b,
                             const float* gvec, int* lpos, float* lval,
                             int* kept, int B, int T, int F, int k,
                             float a_dec, void* stream) {
  if (B > 0 && T > 0 && k > 0) {
    const int threads = ((F + 31) / 32) * 32;
    const size_t smem = (size_t)(2 * F - 1) * sizeof(float);
    prune_fwd_bwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        m0, n_frames, env0f, env0b, gvec, lpos, lval, kept, T, F, k, a_dec);
  }
  return (int)cudaGetLastError();
}

extern "C" int prune_fwd_carry(const float* m0, const float* env_in,
                               const float* gvec, int* lpos, float* lval,
                               float* env_out, int B, int T, int F, int k,
                               float a_dec, void* stream) {
  if (B > 0 && k > 0) {
    const int threads = ((F + 31) / 32) * 32;
    const size_t smem = (size_t)(2 * F - 1) * sizeof(float);
    prune_fwd_carry_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        m0, env_in, gvec, lpos, lval, env_out, T, F, k, a_dec);
  }
  return (int)cudaGetLastError();
}
