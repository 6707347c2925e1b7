// Kernel K2: the causal onset high-pass filter along time,
//   y[t] = fma(pole, y[t-1], x[t] - x[t-1]),
// over a (B, T, F) float32 spectrogram, with an optional carry: (x[-1],
// y[-1]) are read from x0/y0 (each (B, F)) or are zero when those pointers
// are null, and (x[T-1], y[T-1]) are written to xT/yT when those are not
// null.  Chaining the carry over consecutive chunks of T gives exactly the
// one-pass result (streamed ingest, ops/streaming.py).
//
// Replaces: audfprint_tpu/ops/spectro.py:77-89 hpf and the scan at
// audfprint_tpu/ops/streaming.py:334-342 in chunk_fwd_peaks, both
// lax.scans that XLA runs outside any Pallas kernel.  PyTorch has no scan
// primitive, and a Python loop over T issues a few launches per frame.
//
// Rounding: the reference (XLA on the CPU) contracts the step into one
// fused multiply-add with the difference rounded first, and runs with DAZ
// and FTZ: subnormal inputs read as zeros of their sign and subnormal
// results become zeros of their sign.  The step is therefore written as
// sub.rn.ftz then fma.rn.ftz (common.cuh), whatever nvcc's contraction and
// -ftz flags are.  Without the flush, y decays by `pole` a frame through
// the subnormal range after ~100 s of digital silence instead of reaching
// zero, and the carry handed to the next chunk differs from the
// reference's.  The plain version (ops/spectro.py hpf_plain, ops/ftz.py)
// forms the same roundings.
//
// What bounds it.  Bytes: x read and y written once, 2 * B * T * F * 4
// over 3.35 TB/s: 0.24 ms for a 256 x 1535 x 256 batch, 5 us for a
// 1 x 8192 x 256 streamed chunk.  The chain: each (row, bin) column is a
// recurrence of T dependent FMAs (the difference does not depend on y), so
// a column takes at least T times the FMA latency, ~4 cycles: 8192 frames
// are ~33k cycles, 17 us at 1.98 GHz.  At the chunk shape the chain, not
// the bytes, is the floor, and an associative scan over time would round
// differently, so time is never split.
//
// The design, against both:
//   * columns over SMs: a block owns a strip of kStrip = 32 consecutive
//     bins (128 B a frame) of one row.  The grid covers B * ceil(F / 32)
//     strips, so a streamed chunk (B = 1, F = 256) spreads over 8 SMs
//     instead of one block on one SM (16-bin strips, on 16 SMs, measured
//     2 % slower and were dropped);
//   * the loads never wait on the chain: frames arrive as TMA boxes
//     (`frames` x 32 floats of a 3D tensor map over (F, T, B), so a
//     box never reads past its row or past T: the unit zero-fills there),
//     `stages` boxes in flight, one full and one empty mbarrier per slot.
//     A streamed chunk's strip keeps three 32 KB boxes in flight;
//   * the chain in registers, in a warp of its own: lane l reads word l of
//     each staged frame (no bank conflict), 64 frames at a time, forms the
//     flushed difference and FMA, and writes y into an output box in shared
//     memory; another warp sends each box back whole with a TMA store
//     (clipped at F and T), a third issues the loads, so the scanning warp
//     spends only barrier waits and arrivals on the copies, once a box;
//   * the lane that owns a column reads x0/y0 and writes xT/yT.
// What the card showed (NVIDIA H100 80GB HBM3, 700 W): a strip costs ~6
// cycles a frame of chain alone and ~12 with its loads and stores, whatever
// the strip width (16 or 32 bins), the row stride, the stages in flight or
// the SM that issues the stores; per box there is a fixed cost, so boxes
// are as long as the TMA allows (256 frames).  Direct stores from the
// chain's warp, cp.async loads, a ping-pong of register buffers, a second
// block storing through distributed shared memory and a transposed output
// box each measured slower (PERF.md).
// The launch plan (frames, stages) is chosen by ops/spectro.py
// k2_plan, which the CPU tests reach; F must be a multiple of 4 (16-byte
// rows for the tensor map): the wrapper pads other widths with zero bins
// and cuts them off the results.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace audfp;

constexpr int kStrip = 32;         // bins of a strip: lane l owns bin l
constexpr int kYStages = 3;        // output boxes of a strip
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

// a block's shared memory: `stages` input boxes and kYStages output boxes
// of frames x kStrip floats, then the four rings of mbarriers
__host__ __device__ __forceinline__ size_t block_bytes(int frames,
                                                       int stages) {
  return (size_t)(stages + kYStages) * frames * kStrip * 4 +
         (size_t)2 * (stages + kYStages) * sizeof(uint64_t);
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int f, int t, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(f), "r"(t), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int f, int t,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group"
      " [%0, {%1, %2, %3}], [%4];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(f), "r"(t), "r"(b), "r"(smem_u32(src))
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The chain over one box of n frames (frame u at xs[u * kStrip], its y to
// yo[u * kStrip]).  The loads do not depend on the chain: each group of G
// frames is loaded into registers first, so the group pays the latency of
// shared memory once and then runs G dependent FMAs back to back (on the
// card G = 64 measured faster than 8, 16, 32 and a two-buffer ping-pong).
__device__ __forceinline__ void scan_box(const float* __restrict__ xs,
                                         float* __restrict__ yo, int n,
                                         float pole, float& xp, float& yp) {
  constexpr int G = 64;
  int u = 0;
  for (; u + G <= n; u += G) {
    float a[G];
#pragma unroll
    for (int j = 0; j < G; ++j) a[j] = xs[(u + j) * kStrip];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      yp = fma_ftz(pole, yp, sub_ftz(a[j], xp));
      yo[(u + j) * kStrip] = yp;
      xp = a[j];
    }
  }
  for (; u < n; ++u) {
    const float xv = xs[u * kStrip];
    yp = fma_ftz(pole, yp, sub_ftz(xv, xp));
    yo[u * kStrip] = yp;
    xp = xv;
  }
}

// One block scans one strip: warp 0 runs the chain, warp 1 keeps the
// input boxes coming (TMA loads), warp 2 sends the output boxes back (TMA
// stores).  Box c lives in input slot c % stages and output slot c %
// kYStages; a full/empty mbarrier pair guards each slot, so the scanning
// warp spends nothing on the copies but two barrier waits and two arrivals
// a box.
__global__ void __launch_bounds__(96)
    hpf_scan_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap ty,
                    const float* __restrict__ x0,
                    const float* __restrict__ y0, float* __restrict__ xT,
                    float* __restrict__ yT, int T, int F, float pole,
                    int frames, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_row = (F + kStrip - 1) / kStrip;
  const int b = blockIdx.x / per_row;
  const int f0 = (blockIdx.x - b * per_row) * kStrip;
  const int box = frames * kStrip;               // floats of one box
  const int nbox = (T + frames - 1) / frames;
  float* xr = reinterpret_cast<float*>(smem);
  float* yr = xr + (size_t)stages * box;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(yr + (size_t)kYStages * box);
  uint64_t* x_empty = x_full + stages;
  uint64_t* y_full = x_empty + stages;
  uint64_t* y_empty = y_full + kYStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * (stages + kYStages); ++i) mbar_init(x_full + i, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 1) {                               // the loads
    if (lane == 0)
      for (int c = 0, s = 0; c < nbox; ++c, s = s + 1 == stages ? 0 : s + 1) {
        if (c >= stages) mbar_wait(x_empty + s, (uint32_t)(c / stages - 1) & 1);
        mbar_expect_tx(x_full + s, (uint32_t)box * 4);
        tma_load(xr + (size_t)s * box, &tx, f0, c * frames, b, x_full + s);
      }
    return;
  }
  if (warp == 2) {                               // the stores
    if (lane == 0) {
      for (int c = 0, k = 0; c < nbox; ++c, k = k + 1 == kYStages ? 0 : k + 1) {
        mbar_wait(y_full + k, (uint32_t)(c / kYStages) & 1);
        tma_store(&ty, yr + (size_t)k * box, f0, c * frames, b);
        if (c > 0) {             // box c - 1 is read: its slot is free
          asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
          mbar_arrive(y_empty + (k == 0 ? kYStages - 1 : k - 1));
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
    return;
  }

  const bool live = f0 + lane < F;               // the chain
  const size_t col = (size_t)b * F + f0 + lane;
  float xp = 0.0f, yp = 0.0f;
  if (live && x0) {
    xp = x0[col];
    yp = y0[col];
  }
  for (int c = 0, s = 0, k = 0; c < nbox; ++c, s = s + 1 == stages ? 0 : s + 1,
           k = k + 1 == kYStages ? 0 : k + 1) {
    mbar_wait(x_full + s, (uint32_t)(c / stages) & 1);
    if (c >= kYStages) mbar_wait(y_empty + k, (uint32_t)(c / kYStages - 1) & 1);
    scan_box(xr + (size_t)s * box + lane, yr + (size_t)k * box + lane,
             min(frames, T - c * frames), pole, xp, yp);
    fence_proxy_async();     // this lane's y, seen by the store's TMA reads
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(x_empty + s);
      mbar_arrive(y_full + k);
    }
  }
  if (live && xT) {
    xT[col] = xp;
    yT[col] = yp;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library links only
// the CUDA runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the (F, T, B) tensor at p in boxes of kStrip x frames x 1; the unit
// zero-fills a box past F or T on a load and clips it there on a store
bool tensor_map(CUtensorMap* map, const float* p, int B, int T, int F,
                int frames) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)F * 4, (cuuint64_t)T * F * 4};
  const cuuint32_t boxdim[3] = {(cuuint32_t)kStrip, (cuuint32_t)frames, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p),
            dims, strides, boxdim, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The plan (frames, stages) is spectro.k2_plan's; x and y 16-byte aligned,
// F a multiple of 4; x0/y0 both null or both set.
extern "C" int hpf_scan(const float* x, float* y, const float* x0,
                        const float* y0, float* xT, float* yT, int B, int T,
                        int F, float pole, int frames, int stages,
                        void* stream) {
  if (B <= 0 || T <= 0 || F <= 0) return (int)cudaGetLastError();
  const long long strips = (long long)B * ((F + kStrip - 1) / kStrip);
  if (F % 4 || (uintptr_t)x % 16 || (uintptr_t)y % 16 || frames < 1 ||
      frames > 256 || (frames * kStrip * 4) % 128 || stages < 1 ||
      (x0 == nullptr) != (y0 == nullptr) || strips > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = block_bytes(frames, stages);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, ty;
  if (!tensor_map(&tx, x, B, T, F, frames) ||
      !tensor_map(&ty, y, B, T, F, frames))
    return (int)cudaErrorNotSupported;
  static const cudaError_t attr = cudaFuncSetAttribute(
      hpf_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  hpf_scan_kernel<<<(unsigned)strips, 96, smem, (cudaStream_t)stream>>>(
      tx, ty, x0, y0, xT, yT, T, F, pole, frames, stages);
  return (int)cudaGetLastError();
}

extern "C" const char* audfp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
