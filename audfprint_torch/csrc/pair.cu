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
// the dt offsets.  The plain version is ops/landmarks.py
// slots_to_hashes_plain.
//
// The scan's zero padding past frame T - 1 is never valid.  A negative d
// (mindt < 0) reads where the reference's dynamic_slice does: the start
// wraps by the padded length and is clamped to [0, targetdt]
// (landmarks.slice_start), so it lands on frame t + targetdt, or on
// t + d + T + targetdt for d < -T.  No step reads a frame before t.
//
// What bounds it.  Bytes: bins and valid read once, hashes and lvalid
// written once: 39.3 MB for a 256 x 1535 x 5 batch at fanout 3, 0.0117 ms
// at 3.35 TB/s (NVIDIA H100 SXM).  The walk's int32 work depends on the
// data and is smaller.  About 97 % of the output is zeros on real peak
// slots, where 3.2 % of the slots are valid.
//
// The design.  The first version (one thread per slot, partners written
// straight to global memory) lost time four ways; each part below answers
// one of them.
//  1. One block owns a tile of TF frames of one row b: a grid of
//     B * ceil(T / TF) blocks, with b and the tile's first frame t0 from
//     blockIdx by one 32-bit division a block.  (Was: a 64-bit i / K and
//     frame % T for every slot.)
//  2. The block loads frames [t0, t0 + TF + targetdt) clipped to T, its
//     anchors and every frame their walks read, into shared memory as
//     16-byte vectors (each shared copy starts at its global range's
//     offset mod 16 bytes, so both sides of every vector are aligned; a
//     ragged head and tail go element by element), in one round trip.
//     The halo starts at t0, not t0 + mindt, because no step reads a
//     frame before t.  It then compacts the valid peaks into a list of
//     (bin, frame) ordered (frame, slot) beside per-frame start offsets
//     (a block scan of per-frame counts, one thread a frame).  That order
//     is the scan's (d ascending, partner slot ascending), so for d >= 0
//     an anchor at frame t walks one contiguous run,
//     list[start[t + max(mindt, 0)] : start[min(t + targetdt, T)]], and
//     examines valid peaks only.  (Was: 251 partner slots examined per
//     valid anchor on real slots, each two dependent loads.)  The valid
//     flags are not folded into the bins: the compaction reads each flag
//     once, and no sentinel bin would keep |f2 - f1| exact for every
//     int32 bin.
//  3. The list's prefix over frames [t0, t0 + TF) is the block's work
//     list: thread i takes the i-th valid anchor, so no lane waits on an
//     invalid slot.  (Was: ~31 of 32 lanes idle on real slots.)  Each
//     thread reads an entry's successor before it tests the entry.
//  4. The d < 0 steps (mindt < 0, which no real configuration has) come
//     first, one frame of the list each, at t + slice_start(d); the hash
//     carries d & 0x3F.
//  5. The tile's hashes and lvalid are built in shared memory, zeroed,
//     with partners written in place, then stored as 16-byte vectors the
//     same way: [b, t0 : t0 + TF] is contiguous in both outputs.  (Was:
//     each thread's own fanout 4-byte and 1-byte stores, 12 B and 3 B
//     apart from its neighbour's.)
// TF is 128 frames, halved at launch until the block's shared memory fits
// the device's opt-in limit, so nothing is limited at compile time; when
// even one frame does not fit, pair_scan returns
// cudaErrorInvalidConfiguration and the wrapper raises.  At the default
// configuration a block of 256 threads takes 25,424 bytes.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6,
// tools/k3_phases.py): the store of the zeroed output alone takes about
// the byte bound; the load, the compaction and, on random slots, the
// anchors' walk (a thread's run ends at its fanout-th partner, so the
// lanes of a warp diverge) take the rest.  A persistent variant that
// loads the next tile by TMA while it pairs the current one gained on
// real slots and lost on random ones, so the simpler one-tile-a-block
// form stays.  (TMA boxes of a 1-D map must start on 16 bytes: an
// unaligned start faulted with an illegal instruction.)

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFrames = 128;

inline long long align16(long long n) { return (n + 15) & ~15LL; }

// Byte offsets of the shared-memory regions of a block, from the host;
// `total` is the dynamic shared memory the block needs.
struct Layout {
  int out_h, out_v, list, lpos, start, bins, valid, total;
};

// The layout for tf anchor frames, or total = -1 when it passes `limit`.
Layout layout(int tf, int K, int fanout, int targetdt, long long limit) {
  const long long nf = (long long)tf + targetdt;  // frames loaded, at most
  const long long na = (long long)tf * K;         // anchor slots
  const long long no = na * fanout;               // output elements
  long long off[8];
  off[0] = 0;                                     // hashes, int32
  off[1] = off[0] + align16(4 * no + 12);         // lvalid, bytes
  off[2] = off[1] + align16(no + 15);             // list: int2 (bin, frame)
  off[3] = off[2] + align16(8 * nf * K);          // lpos: anchor's slot
  off[4] = off[3] + align16(4 * na);              // start: per-frame offsets
  off[5] = off[4] + align16(4 * (nf + 1));        // bins, int32
  off[6] = off[5] + align16(4 * nf * K + 12);     // valid, bytes
  off[7] = off[6] + align16(nf * K + 15);
  Layout l;
  l.total = off[7] <= limit ? (int)off[7] : -1;
  if (l.total < 0) return l;
  l.out_h = (int)off[0];
  l.out_v = (int)off[1];
  l.list = (int)off[2];
  l.lpos = (int)off[3];
  l.start = (int)off[4];
  l.bins = (int)off[5];
  l.valid = (int)off[6];
  return l;
}

__device__ __forceinline__ int slice_start(int d, int T, int targetdt) {
  const int s = d < 0 ? d + T + targetdt : d;
  return s < 0 ? 0 : (s > targetdt ? targetdt : s);
}

// |f2 - f1| < targetdf in wrapping int32 arithmetic, as the reference's
__device__ __forceinline__ bool near(int32_t f2, int32_t f1, int targetdf) {
  const uint32_t df = (uint32_t)f2 - (uint32_t)f1;
  return (int32_t)((int32_t)df < 0 ? 0u - df : df) < targetdf;
}

__device__ __forceinline__ int32_t pack(int32_t head, int32_t f2, int32_t f1,
                                        int d) {
  return head | (int32_t)((((uint32_t)f2 - (uint32_t)f1) & 0x3Fu) << 6) |
         (int32_t)((uint32_t)d & 0x3Fu);
}

// Copies n elements from src to dst, which agree mod 16 bytes, as 16-byte
// vectors between an element-wise head and tail.  Each thread takes one
// unit (an element of the head or tail, or a vector) a round, so a tile
// of up to kThreads units moves in one round trip.
template <typename E>
__device__ __forceinline__ void copy_tile(E* __restrict__ dst,
                                          const E* __restrict__ src, int n) {
  constexpr int kVec = 16 / sizeof(E);
  const int mis = (int)((uintptr_t)src & 15);
  const int head = min(n, mis ? (16 - mis) / (int)sizeof(E) : 0);
  const int nvec = (n - head) / kVec;
  const int units = n - nvec * (kVec - 1);
  for (int u = threadIdx.x; u < units; u += kThreads) {
    if (u >= head && u < head + nvec) {
      const int i = head + (u - head) * kVec;
      *reinterpret_cast<uint4*>(dst + i) =
          *reinterpret_cast<const uint4*>(src + i);
    } else {
      const int i = u < head ? u : u + nvec * (kVec - 1);
      dst[i] = src[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_scan_kernel(const int32_t* __restrict__ bins,
                     const uint8_t* __restrict__ valid,
                     int32_t* __restrict__ hashes,
                     uint8_t* __restrict__ lvalid, int T, int K, int fanout,
                     int mindt, int targetdt, int targetdf, int tf,
                     int tiles, const Layout l) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[kWarps];
  const int b = (int)blockIdx.x / tiles;
  const int t0 = ((int)blockIdx.x - b * tiles) * tf;
  const int nf = min(tf + targetdt, T - t0);  // frames in shared memory
  const int nt = min(tf, T - t0);             // anchor frames
  const long long gin = ((long long)b * T + t0) * K;
  const int32_t* g_bins = bins + gin;
  const uint8_t* g_valid = valid + gin;
  int32_t* g_h = hashes + gin * fanout;
  uint8_t* g_v = lvalid + gin * fanout;
  // each shared copy of a global range starts at the range's offset mod 16
  int32_t* s_h = reinterpret_cast<int32_t*>(smem + l.out_h +
                                            ((uintptr_t)g_h & 15));
  uint8_t* s_v = smem + l.out_v + ((uintptr_t)g_v & 15);
  int32_t* s_bins = reinterpret_cast<int32_t*>(smem + l.bins +
                                               ((uintptr_t)g_bins & 15));
  uint8_t* s_valid = smem + l.valid + ((uintptr_t)g_valid & 15);
  int2* list = reinterpret_cast<int2*>(smem + l.list);
  int* lpos = reinterpret_cast<int*>(smem + l.lpos);
  int* start = reinterpret_cast<int*>(smem + l.start);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. zero the output tiles; load the frames, coalesced
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < l.list / 16; i += kThreads)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  copy_tile(s_bins, g_bins, nf * K);
  copy_tile(s_valid, g_valid, nf * K);
  __syncthreads();

  // 2. compact the valid peaks in (frame, slot) order: one thread a
  // frame, an exclusive block scan of the per-frame counts
  int base = 0;
  for (int f0 = 0; f0 < nf; f0 += kThreads) {
    const int f = f0 + tid;
    int cnt = 0;
    if (f < nf)
      for (int k = 0; k < K; ++k) cnt += s_valid[f * K + k] != 0;
    int x = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kWarps) warp_sum[lane] = w;
    }
    __syncthreads();
    if (f < nf) {
      int pos = base + (warp ? warp_sum[warp - 1] : 0) + x - cnt;
      start[f] = pos;
      for (int k = 0; k < K; ++k) {
        const int e = f * K + k;
        if (s_valid[e]) {
          list[pos] = make_int2(s_bins[e], f);
          if (f < nt) lpos[pos] = e;
          ++pos;
        }
      }
      if (f == nf - 1) start[nf] = pos;
    }
    base += warp_sum[kWarps - 1];
    __syncthreads();
  }

  // 3. one thread a valid anchor of frames [t0, t0 + nt)
  const int dlo = min(max(mindt, 0), targetdt);  // the first d >= 0
  for (int a = tid; a < start[nt]; a += kThreads) {
    const int2 an = list[a];
    const int32_t f1 = an.x;
    const int fa = an.y;
    const int32_t head = (f1 & 0xFF) << 12;
    int32_t* h = s_h + lpos[a] * fanout;
    uint8_t* v = s_v + lpos[a] * fanout;
    int count = 0;
    // 4. the d < 0 steps, each one frame of the list
    for (int d = mindt; d < 0 && count < fanout; ++d) {
      const int pf = fa + slice_start(d, T, targetdt);
      if (pf >= nf) continue;  // frame >= T: the scan's zero padding
      for (int i = start[pf]; i < start[pf + 1]; ++i) {
        const int2 p = list[i];
        if (near(p.x, f1, targetdf)) {
          h[count] = pack(head, p.x, f1, d);
          v[count] = 1;
          if (++count == fanout) break;
        }
      }
    }
    // d >= 0: one run of the list, frames t + dlo .. min(t + targetdt, T)
    // - 1, each entry's successor read before the entry is tested
    const int end = start[min(fa + targetdt, nf)];
    int i = start[min(fa + dlo, nf)];
    if (count < fanout && i < end) {
      int2 p = list[i];
      for (; i < end; ++i) {
        const int2 q = list[i + 1 < end ? i + 1 : i];
        if (near(p.x, f1, targetdf)) {
          h[count] = pack(head, p.x, f1, p.y - fa);
          v[count] = 1;
          if (++count == fanout) break;
        }
        p = q;
      }
    }
  }
  __syncthreads();

  // 5. store the tiles: [b, t0 : t0 + nt] is contiguous in both outputs
  copy_tile(g_h, s_h, nt * K * fanout);
  copy_tile(g_v, s_v, nt * K * fanout);
}

}  // namespace

// bins (B, T, K) int32 and valid (B, T, K) as bytes 0/1, both contiguous;
// hashes (B, T, K, fanout) int32 and lvalid (B, T, K, fanout) bytes,
// written whole.  Nothing is launched when B * T * K or fanout is 0.
extern "C" int pair_scan(const int32_t* bins, const uint8_t* valid,
                         int32_t* hashes, uint8_t* lvalid, int B, int T,
                         int K, int fanout, int mindt, int targetdt,
                         int targetdf, void* stream) {
  if (B < 0 || T < 0 || K < 0 || fanout < 0 || targetdt < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * T * K == 0 || fanout == 0)
    return (int)cudaGetLastError();
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  limit -= kWarps * (int)sizeof(int);  // the static warp sums
  int tf = kTileFrames;
  Layout l = layout(tf, K, fanout, targetdt, limit);
  while (l.total < 0 && tf > 1) {
    tf >>= 1;
    l = layout(tf, K, fanout, targetdt, limit);
  }
  const long long tiles = ((long long)T + tf - 1) / tf;
  if (l.total < 0 || tiles * B > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  if (l.total > 48 * 1024) {
    e = cudaFuncSetAttribute(pair_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             l.total);
    if (e != cudaSuccess) return (int)e;
  }
  pair_scan_kernel<<<(unsigned)(tiles * B), kThreads, l.total,
                     (cudaStream_t)stream>>>(bins, valid, hashes, lvalid, T, K,
                                            fanout, mindt, targetdt, targetdf,
                                            tf, (int)tiles, l);
  return (int)cudaGetLastError();
}
