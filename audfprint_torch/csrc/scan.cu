// Kernel K4: seg_scan, an inclusive max, min or add scan along the last
// axis of a contiguous (B, H) int64 tensor, forward or reverse.
//
//   forward:  y[b, i] = x[b, 0] op x[b, 1] op ... op x[b, i]
//   reverse:  y[b, i] = x[b, i] op x[b, i + 1] op ... op x[b, H - 1]
//
// The add wraps modulo 2^64, as torch's and XLA's int64 cumsum do, so
// every op is associative and commutative and the result is bit-exact
// whatever the order of the partial sums.
//
// Replaces: the JAX package's segmented and prefix scans over hit rows
// and hash runs, which XLA fuses into its own scan loops:
// audfprint_tpu/match/voting.py:546 (_Runs.from_first's lax.cummax) and
// :543 (its flipped lax.cummin), :562 (_seg_spread's associative_scan),
// :798 (seg_best's lexicographic associative_scan, a max over a packed
// key in the port), the cumsums at :756, :880, :894 and :1021,
// audfprint_tpu/index/device_table.py:160 and
// audfprint_tpu/models/ingest.py:110 (associative_scan(maximum) of run
// starts).  The plain version is ops/scan.py seg_scan_plain (torch's
// cummax, cummin and cumsum, with flips for the reverse direction).
//
// What bounds it.  Bytes: x read once and y written once, 16 bytes an
// element: 3.3 MB for one 204,800-hit row of a 4-shard mesh query,
// 0.98 us at 3.35 TB/s (NVIDIA H100 SXM); one 64-bit op an element is far
// below the int32 rate.  torch's cummax/cummin give each row one thread
// block whatever its length (and write an int64 index tensor beside the
// values), so a long row runs on one SM.
//
// The design (simple first: reduce, then scan, two launches).
//  A. seg_reduce_kernel: a block per tile of kTile elements of a row
//     (the tiles in the scan's own order, so a reverse scan's tile 0 is
//     the row's end) reduces its tile to one aggregate in a (B, ntiles)
//     workspace.  A row of one tile skips this launch.
//  B. seg_scan_kernel: a block per tile takes the op of its row's
//     earlier aggregates as its carry (the block reduces them
//     together), then scans its tile: each warp owns kTile / 8
//     consecutive elements and walks them 64 at a time, two a lane (one
//     16-byte load where the pair is aligned), with a shuffle scan of the
//     pairs and a running warp total; the warp totals meet in shared
//     memory, and each element gets the carry, the earlier warps' totals
//     and its own prefix.  The tile is written the same way.
// Indices are 64-bit, B and H have no limit at compile time (a block
// walks tiles by a grid stride when B * ntiles passes 2^31 - 1), and a
// zero-size call launches nothing.  The kernel allocates nothing and does
// not synchronise: the wrapper hands it the workspace and the stream, so
// a CUDA graph can capture it.  A single-pass variant (decoupled
// look-back: each block publishes its aggregate and reads its
// predecessors' as they arrive) would read x once instead of twice; it is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

// A named namespace: an anonymous one takes a name made from the file and
// its first symbol (seg_scan), which would put "seg_scan" into the
// aggregate kernel's name in a profile too.
namespace audfp_k4 {

constexpr int kTile = 4096;                  // int64 elements a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpSpan = kTile / kWarps;    // 512 consecutive elements
constexpr int kSteps = kWarpSpan / 64;       // 64 elements a warp step

enum Op { kMax = 0, kMin = 1, kAdd = 2 };

template <int OP>
__device__ __forceinline__ long long identity() {
  return OP == kMax ? LLONG_MIN : (OP == kMin ? LLONG_MAX : 0LL);
}

template <int OP>
__device__ __forceinline__ long long combine(long long a, long long b) {
  if (OP == kMax) return a > b ? a : b;
  if (OP == kMin) return a < b ? a : b;
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// Elements j and j + 1 of the scan's order of row `r` (physical j, j + 1
// forward; H - 1 - j, H - 2 - j reverse), the identity past the row.
template <int OP, bool REV>
__device__ __forceinline__ void load2(const long long* r, long long H,
                                      long long j, long long& a,
                                      long long& b) {
  const long long lo = REV ? H - 2 - j : j;   // the pair's lower address
  if (j + 1 < H && ((uintptr_t)(r + lo) & 15) == 0) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(r + lo);
    a = REV ? v.y : v.x;
    b = REV ? v.x : v.y;
    return;
  }
  a = j < H ? r[REV ? H - 1 - j : j] : identity<OP>();
  b = j + 1 < H ? r[REV ? H - 2 - j : j + 1] : identity<OP>();
}

template <bool REV>
__device__ __forceinline__ void store2(long long* r, long long H, long long j,
                                       long long a, long long b) {
  const long long lo = REV ? H - 2 - j : j;
  if (j + 1 < H && ((uintptr_t)(r + lo) & 15) == 0) {
    *reinterpret_cast<longlong2*>(r + lo) =
        REV ? make_longlong2(b, a) : make_longlong2(a, b);
    return;
  }
  if (j < H) r[REV ? H - 1 - j : j] = a;
  if (j + 1 < H) r[REV ? H - 2 - j : j + 1] = b;
}

template <int OP>
__device__ __forceinline__ long long warp_reduce(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = combine<OP>(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The op over the block's values, in every thread (two barriers; `part`
// is free again on return).
template <int OP>
__device__ __forceinline__ long long block_reduce(long long v,
                                                  long long* part) {
  v = warp_reduce<OP>(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = identity<OP>();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r = combine<OP>(r, part[w]);
  __syncthreads();
  return r;
}

template <int OP, bool REV>
__global__ void __launch_bounds__(kThreads)
    seg_reduce_kernel(const long long* __restrict__ x,
                      long long* __restrict__ ws, long long H,
                      long long ntiles, long long total) {
  __shared__ long long part[kWarps];
  for (long long id = blockIdx.x; id < total; id += gridDim.x) {
    const long long row = id / ntiles, t = id - row * ntiles;
    const long long* r = x + row * H;
    long long acc = identity<OP>();
#pragma unroll 4
    for (int s = 0; s < kTile / (2 * kThreads); ++s) {
      const long long j = t * kTile + 2LL * (s * kThreads + threadIdx.x);
      long long a, b;
      load2<OP, REV>(r, H, j, a, b);
      acc = combine<OP>(acc, combine<OP>(a, b));
    }
    acc = block_reduce<OP>(acc, part);
    if (threadIdx.x == 0) ws[id] = acc;
  }
}

template <int OP, bool REV>
__global__ void __launch_bounds__(kThreads)
    seg_scan_kernel(const long long* __restrict__ x, long long* __restrict__ y,
                    const long long* __restrict__ ws, long long H,
                    long long ntiles, long long total) {
  __shared__ long long part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long id = blockIdx.x; id < total; id += gridDim.x) {
    const long long row = id / ntiles, t = id - row * ntiles;
    // the carry: the row's aggregates of the tiles before this one
    long long carry = identity<OP>();
    if (t > 0) {
      for (long long i = threadIdx.x; i < t; i += kThreads)
        carry = combine<OP>(carry, ws[row * ntiles + i]);
      carry = block_reduce<OP>(carry, part);
    }
    const long long* xr = x + row * H;
    const long long j0 = t * kTile + (long long)warp * kWarpSpan + 2 * lane;
    long long v[2 * kSteps];
    long long run = identity<OP>();    // the warp's total of earlier steps
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      long long a, b;
      load2<OP, REV>(xr, H, j0 + 64LL * s, a, b);
      b = combine<OP>(a, b);
      long long incl = b;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long n = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl = combine<OP>(n, incl);
      }
      long long excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = identity<OP>();
      const long long pre = combine<OP>(run, excl);
      v[2 * s] = combine<OP>(pre, a);
      v[2 * s + 1] = combine<OP>(pre, b);
      run = combine<OP>(run, __shfl_sync(0xffffffffu, incl, 31));
    }
    if (lane == 0) part[warp] = run;
    __syncthreads();
    long long pre = carry;
    for (int w = 0; w < warp; ++w) pre = combine<OP>(pre, part[w]);
    long long* yr = y + row * H;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
      store2<REV>(yr, H, j0 + 64LL * s, combine<OP>(pre, v[2 * s]),
                  combine<OP>(pre, v[2 * s + 1]));
    __syncthreads();
  }
}

template <int OP, bool REV>
cudaError_t launch(const long long* x, long long* y, long long* ws,
                   long long H, long long ntiles, long long total,
                   cudaStream_t stream) {
  const unsigned grid = (unsigned)(total < INT_MAX ? total : INT_MAX);
  if (ntiles > 1) {
    seg_reduce_kernel<OP, REV>
        <<<grid, kThreads, 0, stream>>>(x, ws, H, ntiles, total);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  seg_scan_kernel<OP, REV>
      <<<grid, kThreads, 0, stream>>>(x, y, ws, H, ntiles, total);
  return cudaGetLastError();
}

}  // namespace audfp_k4

// x and y (B, H) int64, contiguous; workspace (B, ceil(H / 4096)) int64,
// read and written only when a row spans more than one tile (it may be 0
// otherwise); op 0 = max, 1 = min, 2 = add; reverse 0 or 1.  Nothing is
// launched when B * H is 0.
extern "C" int seg_scan(const long long* x, long long* y, long long* workspace,
                        long long B, long long H, int op, int reverse,
                        void* stream) {
  using namespace audfp_k4;
  if (B < 0 || H < 0 || op < kMax || op > kAdd)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  const long long ntiles = (H + kTile - 1) / kTile;
  if (ntiles > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  const long long total = B * ntiles;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (op == kMax)
    e = reverse ? launch<kMax, true>(x, y, workspace, H, ntiles, total, s)
                : launch<kMax, false>(x, y, workspace, H, ntiles, total, s);
  else if (op == kMin)
    e = reverse ? launch<kMin, true>(x, y, workspace, H, ntiles, total, s)
                : launch<kMin, false>(x, y, workspace, H, ntiles, total, s);
  else
    e = reverse ? launch<kAdd, true>(x, y, workspace, H, ntiles, total, s)
                : launch<kAdd, false>(x, y, workspace, H, ntiles, total, s);
  return (int)e;
}
