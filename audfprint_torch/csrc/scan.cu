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
// The design: one launch, a single pass with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016).  A row is cut into tiles of TILE elements, in the
// scan's own order (a reverse scan's tile 0 is the row's end); the tiles
// of all rows are numbered row-major, B * ntiles in all.
//  1. A block takes a tile id from an atomicAdd on a counter in the
//     workspace, not from blockIdx: every tile it waits on then belongs
//     to a block that took its id earlier and is running, so the wait
//     ends (forward progress whatever order the card schedules blocks
//     in).  Blocks loop on the counter while ids remain, which also
//     covers B * ntiles past the grid's 2^31 - 1.
//  2. It loads its tile into registers at once (16-byte loads where a
//     pair is aligned), then scans it: each warp owns an equal share of
//     consecutive elements and walks them 64 at a time, two a lane, with
//     a shuffle scan of the pairs and a running warp total; the warp
//     totals meet in shared memory and give the tile's aggregate.
//  3. Warp 0 publishes the aggregate at once (the row's first tile
//     publishes it as its inclusive prefix), then looks back over its
//     predecessors in the row, 32 a step, one a lane: a step waits until
//     every predecessor nearer than the nearest inclusive prefix shows at
//     least its aggregate, folds those aggregates and that prefix (or all
//     32 aggregates, and steps back 32), and stops at the first inclusive
//     prefix; the row's first tile always publishes one, so the walk
//     never crosses into another row.  It then publishes its own
//     inclusive prefix (the row's last tile, which no tile reads, skips
//     both publications), and every element gets the row's earlier
//     tiles, the earlier warps' totals and its own prefix, written back
//     the way it was read.
// Publication: a tile's status and value share one 16-byte slot, stored
// and loaded as one access (see publish below for why a torn read is
// harmless under the PTX memory model); a reader of a window takes one
// load a lane, not a status and then a value.  The workspace is
// [counter | unused | slot[total]], int64 words, 2 + 2 * total; the
// entry zeroes it with cudaMemsetAsync on the caller's stream before
// each launch (a CUDA graph captures it as a memset node, so every
// replay starts from zero).  A launch of one tile a row needs no
// look-back and no workspace: its blocks walk the rows by blockIdx.
// The tile's loads are issued before anything waits: its aggregate needs
// them, and the look-back comes after the aggregate is published (a
// look-back first would hold up every successor); an SM holds several
// blocks, so one block's look-back runs under the others' loads.
// Three tiles, chosen by the caller (ops/scan.py plan: the largest that
// gives about 100 blocks): 4,096 elements (256 threads, 16 a thread)
// stream large inputs; 2,048 (256 threads) and 1,024 (128 threads, 8 a
// thread) spread a serving row over the card, e.g. the mesh row (1,
// 204,800) in 100 blocks and the one-query vote row (1, 51,200) in 50
// instead of 13; more, smaller tiles make a row's look-back chain
// longer than the spread saves.  Indices are 64-bit, B and H have no
// limit at compile time, and a zero-size call launches nothing.  The kernel allocates nothing and does not synchronise: the
// wrapper hands it the workspace and the stream, so a CUDA graph can
// capture it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

// A named namespace: an anonymous one takes a name made from the file and
// its first symbol, which could put "seg_scan" into a helper's name in a
// profile; the scan kernel is the only symbol that holds it.
namespace audfp_k4 {

constexpr int kTileSmall = 1024;             // int64 elements a block
constexpr int kThreadsSmall = 128;           // 8 elements a thread
constexpr int kTileMedium = 2048;
constexpr int kTileLarge = 4096;
constexpr int kThreadsLarge = 256;           // 8 or 16 elements a thread
constexpr int kWindow = 32;                  // predecessors a look-back step

enum Op { kMax = 0, kMin = 1, kAdd = 2 };
enum Status : unsigned { kNone = 0, kAggregate = 1, kInclusive = 2 };

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

// ---- the tile status: one 16-byte word a tile ----

// A tile's slot holds its status and its published value in one aligned
// 16-byte word, {status << 32 | low half, status << 32 | high half},
// stored and loaded as one access (st/ld.volatile.v2: relaxed, system
// scope, never cached in L1, re-read by every load of the spin).  The
// PTX memory model makes each 8-byte half single-copy atomic but not the
// 16-byte pair, so each half carries the status: a reader that sees two
// different statuses saw halves of two stores and reads again, and two
// equal non-zero statuses are halves of that status's one store in this
// launch (the entry zeroes every slot first), so the value is whole.
// The value is all that passes between blocks, so no fence is needed.
__device__ __forceinline__ void publish(unsigned long long* slot, long long v,
                                        Status s) {
  const unsigned long long tag = (unsigned long long)s << 32;
  const unsigned long long lo = tag | ((unsigned long long)v & 0xffffffffull);
  const unsigned long long hi = tag | ((unsigned long long)v >> 32);
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};"
               :: "l"(slot), "l"(lo), "l"(hi) : "memory");
}

__device__ __forceinline__ Status read_slot(const unsigned long long* slot,
                                            long long& v) {
  unsigned long long lo, hi;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(lo), "=l"(hi) : "l"(slot) : "memory");
  v = (long long)((hi << 32) | (lo & 0xffffffffull));
  return (lo >> 32) == (hi >> 32) ? (Status)(lo >> 32) : kNone;
}

// ---- the tile's elements ----

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

// The op over the row's tiles before tile t, in every lane of warp 0.
// slots points at the row's tile 0.
template <int OP>
__device__ __forceinline__ long long look_back(
    const unsigned long long* slots, long long t) {
  const int lane = threadIdx.x & 31;
  long long excl = identity<OP>();
  for (long long p = t - 1;; p -= kWindow) {   // p: the window's nearest
    const long long i = p - lane;
    long long v = identity<OP>();
    int k;                                      // the nearest inclusive lane
    for (int spin = 0;; ++spin) {
      // before the row's first tile: nothing, read as an identity prefix
      const Status st = i >= 0 ? read_slot(slots + 2 * i, v) : kInclusive;
      const unsigned none = __ballot_sync(0xffffffffu, st == kNone);
      const unsigned inc = __ballot_sync(0xffffffffu, st == kInclusive);
      k = inc ? __ffs(inc) - 1 : kWindow;
      const unsigned nearer = k == kWindow ? 0xffffffffu : (1u << k) - 1u;
      if ((none & nearer) == 0) break;
      if (spin > 4) __nanosleep(64);
      // every tile waited on publishes within microseconds (step 1); a
      // wait of seconds is a fault, reported as a launch error
      if (spin > (1 << 26)) __trap();
    }
    if (lane > k || i < 0) v = identity<OP>();
    excl = combine<OP>(excl, warp_reduce<OP>(v));
    if (k < kWindow) return excl;
  }
}

template <int OP, bool REV, int TILE, int THREADS>
__global__ void __launch_bounds__(THREADS)
    seg_scan_kernel(const long long* __restrict__ x, long long* __restrict__ y,
                    long long* ws, long long H, long long ntiles,
                    long long total) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kSpan = TILE / kWarps;        // consecutive elements a warp
  constexpr int kSteps = kSpan / 64;          // 64 elements a warp step
  static_assert(kSteps * 64 * kWarps == TILE, "a tile is whole warp steps");
  __shared__ long long part[kWarps];
  __shared__ long long carry_s;
  __shared__ long long id_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool chained = ntiles > 1;     // else ws may be null
  unsigned long long* counter = reinterpret_cast<unsigned long long*>(ws);
  unsigned long long* slots = chained ? counter + 2 : nullptr;  // 16-byte

  for (long long k = 0;; ++k) {
    long long id = blockIdx.x + k * gridDim.x;
    if (chained) {
      if (threadIdx.x == 0) id_s = (long long)atomicAdd(counter, 1ULL);
      __syncthreads();
      id = id_s;
    }
    if (id >= total) break;
    const long long row = id / ntiles, t = id - row * ntiles;
    const long long* xr = x + row * H;
    const long long j0 = t * TILE + (long long)warp * kSpan + 2 * lane;
    // the pairs of a whole tile are 16-byte aligned or none are (forward
    // pair j starts at xr + j, reverse at xr + H - 2 - j, j even)
    const bool fast = (t + 1) * TILE <= H &&
                      ((uintptr_t)(REV ? xr + H : xr) & 15) == 0;
    long long a[kSteps], b[kSteps];
    if (fast) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const long long j = j0 + 64LL * s;
        const longlong2 v =
            *reinterpret_cast<const longlong2*>(xr + (REV ? H - 2 - j : j));
        a[s] = REV ? v.y : v.x;
        b[s] = REV ? v.x : v.y;
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        load2<OP, REV>(xr, H, j0 + 64LL * s, a[s], b[s]);
    }
    long long run = identity<OP>();    // the warp's total of earlier steps
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const long long pair = combine<OP>(a[s], b[s]);
      long long inc = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long n = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc = combine<OP>(n, inc);
      }
      long long exc = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) exc = identity<OP>();
      const long long pre = combine<OP>(run, exc);
      a[s] = combine<OP>(pre, a[s]);
      b[s] = combine<OP>(pre, pair);
      run = combine<OP>(run, __shfl_sync(0xffffffffu, inc, 31));
    }
    if (lane == 0) part[warp] = run;
    __syncthreads();
    if (warp == 0) {
      long long carry = identity<OP>();
      if (chained) {
        const long long aggregate =
            warp_reduce<OP>(lane < kWarps ? part[lane] : identity<OP>());
        const long long first = row * ntiles;   // the row's tile 0
        const bool last = t == ntiles - 1;
        unsigned long long* slot = slots + 2 * id;
        if (t == 0) {
          if (lane == 0) publish(slot, aggregate, kInclusive);
        } else {
          if (lane == 0 && !last) publish(slot, aggregate, kAggregate);
          carry = look_back<OP>(slots + 2 * first, t);
          if (lane == 0 && !last)
            publish(slot, combine<OP>(carry, aggregate), kInclusive);
        }
      }
      if (lane == 0) carry_s = carry;
    }
    __syncthreads();
    long long pre = carry_s;
    for (int w = 0; w < warp; ++w) pre = combine<OP>(pre, part[w]);
    long long* yr = y + row * H;
    if (fast) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const long long j = j0 + 64LL * s;
        const long long u = combine<OP>(pre, a[s]);
        const long long v = combine<OP>(pre, b[s]);
        *reinterpret_cast<longlong2*>(yr + (REV ? H - 2 - j : j)) =
            REV ? make_longlong2(v, u) : make_longlong2(u, v);
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        store2<REV>(yr, H, j0 + 64LL * s, combine<OP>(pre, a[s]),
                    combine<OP>(pre, b[s]));
    }
    // a grid of one block a tile takes exactly one id a block
    if (chained && total <= gridDim.x) break;
    __syncthreads();                   // part, carry_s and id_s are reused
  }
}

template <int OP, bool REV, int TILE, int THREADS>
cudaError_t launch(const long long* x, long long* y, long long* ws,
                   long long H, long long ntiles, long long total,
                   cudaStream_t stream) {
  const unsigned grid = (unsigned)(total < INT_MAX ? total : INT_MAX);
  seg_scan_kernel<OP, REV, TILE, THREADS>
      <<<grid, THREADS, 0, stream>>>(x, y, ws, H, ntiles, total);
  return cudaGetLastError();
}

template <int OP, bool REV>
cudaError_t launch_tile(const long long* x, long long* y, long long* ws,
                        long long H, long long ntiles, long long total,
                        int tile, cudaStream_t stream) {
  switch (tile) {
    case kTileSmall:
      return launch<OP, REV, kTileSmall, kThreadsSmall>(x, y, ws, H, ntiles,
                                                        total, stream);
    case kTileMedium:
      return launch<OP, REV, kTileMedium, kThreadsLarge>(x, y, ws, H, ntiles,
                                                         total, stream);
    default:
      return launch<OP, REV, kTileLarge, kThreadsLarge>(x, y, ws, H, ntiles,
                                                        total, stream);
  }
}

}  // namespace audfp_k4

// x and y (B, H) int64, contiguous; tile 1024, 2048 or 4096 (elements a
// block); workspace 2 + 2 * B * ceil(H / tile) int64 words, 16-byte
// aligned, zeroed here and read and written only when a row spans more
// than one tile (it may be 0 otherwise); op 0 = max, 1 = min, 2 = add;
// reverse 0 or 1.  Nothing is launched when B * H is 0.
extern "C" int seg_scan(const long long* x, long long* y, long long* workspace,
                        long long B, long long H, int tile, int op,
                        int reverse, void* stream) {
  using namespace audfp_k4;
  if (B < 0 || H < 0 || op < kMax || op > kAdd ||
      (tile != kTileSmall && tile != kTileMedium && tile != kTileLarge))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  const long long ntiles = (H + tile - 1) / tile;
  const long long total = B * ntiles;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ntiles > 1) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    // the tile counter and the slots start at zero every launch
    const cudaError_t e = cudaMemsetAsync(
        workspace, 0, (size_t)(2 + 2 * total) * sizeof(long long), s);
    if (e != cudaSuccess) return (int)e;
  }
  const int r = reverse != 0;
  cudaError_t e;
  if (op == kMax)
    e = r ? launch_tile<kMax, true>(x, y, workspace, H, ntiles, total, tile, s)
          : launch_tile<kMax, false>(x, y, workspace, H, ntiles, total, tile,
                                     s);
  else if (op == kMin)
    e = r ? launch_tile<kMin, true>(x, y, workspace, H, ntiles, total, tile, s)
          : launch_tile<kMin, false>(x, y, workspace, H, ntiles, total, tile,
                                     s);
  else
    e = r ? launch_tile<kAdd, true>(x, y, workspace, H, ntiles, total, tile, s)
          : launch_tile<kAdd, false>(x, y, workspace, H, ntiles, total, tile,
                                     s);
  return (int)e;
}
