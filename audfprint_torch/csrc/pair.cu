// Kernel K3: landmark pairing and the 20-bit hash pack.
//
// For every anchor peak (b, t, k) whose valid flag is set, walk the
// partner frames t + d for d = mindt .. targetdt - 1 and, in each, the
// partner slots j = 0 .. K - 1 (bins ascending); append each valid
// partner with |f2 - f1| < targetdf until `fanout` are found.  Partner i
// of the anchor goes to hashes[b, t, k, i] as
//   ((f1 & 0xFF) << 12) | (((f2 - f1) & 0x3F) << 6) | (d & 0x3F)
// with lvalid[b, t, k, i] = 1; the slots past the last partner (all of
// them for an invalid anchor) get 0 and 0.
//
// Replaces: the lax.scan of audfprint_tpu/ops/landmarks.py:77
// (slots_to_hashes, :30-84), which XLA compiles into one while loop over
// the dt offsets.  PyTorch has no scan primitive: the plain version
// (ops/landmarks.py slots_to_hashes_plain) issues ~14 small launches for
// each of the (targetdt - mindt) x K steps, ~4,300 for the default config.
//
// The scan's zero padding past frame T - 1 is never valid, so the walk
// stops at the first t + d >= T, and it stops at `fanout` partners: the
// scan order (d ascending, then j ascending) is the reference's, so the
// first `fanout` qualifying partners are the same ones.  A negative d
// (mindt < 0) reads where the reference's dynamic_slice does: the start
// wraps by the padded length and is clamped, so it lands on frame
// t + targetdt (t + d + T + targetdt for d < -T).
//
// What bounds it.  Bytes: bins and valid read once, hashes and lvalid
// written once: 39.3 MB for a 256 x 1535 x 5 batch at fanout 3, 0.0117 ms
// at 3.35 TB/s.  The walk's integer work depends on the data (it ends
// early) and is smaller.  The partner reads of neighbouring anchors
// overlap (the next targetdt frames of the row), so they hit in L1/L2.
//
// The design: one thread per anchor over a grid-stride loop with 64-bit
// indices; a partner is written straight to its output slot, so there is
// no compile-time limit on K, fanout, T or targetdt.  Making it fast
// (a tile of frames plus its targetdt halo in shared memory, coalesced
// stores) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    pair_scan_kernel(const int32_t* __restrict__ bins,
                     const uint8_t* __restrict__ valid,
                     int32_t* __restrict__ hashes,
                     uint8_t* __restrict__ lvalid, int T, int K,
                     int fanout, int mindt, int targetdt, int targetdf,
                     long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long frame = i / K;               // b * T + t
    const int t = (int)(frame % T);
    int32_t* h = hashes + i * fanout;
    uint8_t* lv = lvalid + i * fanout;
    int count = 0;
    if (valid[i]) {
      const int f1 = bins[i];
      const int32_t head = (f1 & 0xFF) << 12;
      for (int d = mindt; d < targetdt && count < fanout; ++d) {
        // the scan's dynamic_slice start: a negative d wraps by the
        // padded length T + targetdt, then the start is clamped to
        // [0, targetdt]
        int s = d < 0 ? d + T + targetdt : d;
        s = s < 0 ? 0 : (s > targetdt ? targetdt : s);
        const int pt = t + s;
        if (pt >= T) {                           // the scan's zero padding
          if (d >= 0) break;
          continue;
        }
        const long long p = (frame - t + pt) * K;
        for (int j = 0; j < K; ++j) {
          const int f2 = bins[p + j];
          const int df = f2 - f1;
          if (valid[p + j] && (df < 0 ? -df : df) < targetdf) {
            h[count] = head | (int32_t)(((uint32_t)df & 0x3Fu) << 6) |
                       (int32_t)((uint32_t)d & 0x3Fu);
            lv[count] = 1;
            if (++count == fanout) break;
          }
        }
      }
    }
    for (int c = count; c < fanout; ++c) {
      h[c] = 0;
      lv[c] = 0;
    }
  }
}

}  // namespace

// bins (B, T, K) int32 and valid (B, T, K) as bytes 0/1, both contiguous;
// hashes (B, T, K, fanout) int32 and lvalid (B, T, K, fanout) bytes,
// written whole.  Nothing is launched when B * T * K or fanout is 0.
extern "C" int pair_scan(const int32_t* bins, const uint8_t* valid,
                         int32_t* hashes, uint8_t* lvalid, int B, int T,
                         int K, int fanout, int mindt, int targetdt,
                         int targetdf, void* stream) {
  if (B < 0 || T < 0 || K < 0 || fanout < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * T * K;
  if (n == 0 || fanout == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // enough blocks to fill every SM several times over; the grid-stride
  // loop covers the rest
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  pair_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      bins, valid, hashes, lvalid, T, K, fanout, mindt, targetdt, targetdf,
      n);
  return (int)cudaGetLastError();
}
