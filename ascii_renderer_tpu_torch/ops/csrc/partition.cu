// X13: a stable partition of a flag vector, one launch a call.
//
// Stands for XLA code, not a Pallas kernel: the raster's valid compaction
// (ascii_renderer_tpu/backends/raster_channels.py:325 compact_valid_ch:
// the sort of the unique key where(valid, i, n + i), the 13 screen
// channels' stack and one wide row gather) and the path tracer's
// compacted stream (ascii_renderer_tpu/backends/pathtrace.py:524-531: the
// lax.sort of the unique key (1 - active) * pc + i, the active count, and
// the 1,024-ray block gates of its megakernel). Both sort unique keys, so
// their order is the stable partition: flag i, if set, goes to position
// s(i) = #set before i; if unset, to n_set + i - s(i). The plain versions
// are ops/partition.py's *_ref, the torch chains the backends ran before
// (an argsort, a 13-channel stack and gather, repeats and amaxes); kernel
// and plain version agree bit for bit (integers and copied floats).
//
// Design: one launch at every size, in one of two forms by the flag count
// (a host choice from n, each form its own kernel). A block is 256
// threads (the count-all channels form's 512); a tile is 1,024 flags (the
// co-resident order form's 2,048), a warp's 128 ranked by 4 ballots (8)
// (a lane's flag is its byte != 0: its rank in the warp the popcount of
// the ballot below its lane).
// - Up to kCountAll flags, an ordinary launch whose every block counts all
//   the flags itself (at most 32 KB, read again from L2 by each block), so
//   no block waits on another. The channels form gives block b the out
//   rows [b * kRows, ...): it ranks the flags 16 to a lane (a lane's count
//   by __vcmpne4 and __popc, the lanes' counts scanned by shuffles),
//   stages in shared memory the ids ranked in its rows, then writes its
//   rows as one contiguous span, a float a thread (the loads: the staged
//   id, then the channel), zeros past the kept rows: two barriers. The
//   order form's block b places tile b, its offset from the flags before
//   it, counted.
// - Above, one cooperative launch (cudaLaunchCooperativeKernel) on a grid
//   the card holds at once (the occupancy query x the SMs; a launch the
//   card cannot hold fails, and the wrapper raises): each block counts a
//   run of tiles, the blocks meet at grid.sync(), each sums the counts
//   before its own and places its run (a cross-block handoff measured ~2
//   us on an H100, however made: this is the order form's only one). The
//   channels form writes the kept ids there, meets the others again, and
//   the whole grid writes out, grid-stride.
// Nothing carries over between calls or between replays of a captured
// graph: the blocks' counts are written before they are read in each
// call, and grid.sync()'s barrier is the runtime's own. No wait can hang:
// the ordinary launch has none, and the co-resident one waits only at
// grid.sync(), whose blocks the cooperative launch guarantees are all
// resident.
//
// The two forms (the co-resident kernel's template flag):
// - channels (compact_valid_ch): the set flags below v_cap are the kept
//   slots; kept slot p = s(i) gets cidx[p] = i, valid[p] = 1 and row p of
//   out (channel k of flag i, read at ch.p[k] + i * ch.stride[k]: X4's row
//   views in place). The rows past the kept ones are zeros with cidx n and
//   valid 0; the overflow (set flags at s(i) >= v_cap) is dropped, as the
//   sort's truncation drops it.
// - order (_FrameRays): slot[pos(i)] = i and pix_uid[pos(i)] = i + uid0 for
//   every flag, a warp's 32 flags stored as two runs; the block gates of
//   the megakernel's stream of 1 and of `samples` samples (ray s * n + p is
//   live where p < n_set): gate[b] = 1 iff a ray of block b is live, in
//   closed form from n_set; and, where given, a zeroed int32 buffer (the
//   frame's ray counters), block 0's.
// Both write n_set to count (0-d int32), on the device: no host sync.
//
// Bytes-bound: a flag read once, a kept slot's 52 bytes read and a v_cap
// row's 57 bytes written (channels), 8 bytes written a flag and 4 a gate
// (order). At the mid HD arm's call (29,768 flags, v_cap 16,384) that is
// ~1.4 MB, 0.0004 ms at 3.35 TB/s: a launch's floor (~0.002 ms) decides.
// Built with -fmad=false like every source; it does no float arithmetic.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Flags up to which a call counts all the flags in every block (at most
// what a block of that channels form holds in registers, 16 words a
// lane), the out rows a block of that channels form owns, and its
// threads; a warp's ballots a tile (the co-resident order form's its
// own); tools/partition_variants builds other values.
#ifndef PTN_ROUNDS
#define PTN_ROUNDS 4
#endif
#ifndef PTN_ORDER_ROUNDS
#define PTN_ORDER_ROUNDS 8
#endif
#ifndef PTN_COUNT_ALL
#define PTN_COUNT_ALL 32768
#endif
#ifndef PTN_ROWS
#define PTN_ROWS 128
#endif
#ifndef PTN_ROWS_THREADS
#define PTN_ROWS_THREADS 512
#endif


// Block 0's phase stamps, for tools/partition_variants, which builds this
// source with tools/csrc/stamps.cuh prepended (it defines STAMP).
#ifndef STAMP
#define STAMP(i)
#define STAMP_NS(i)
#endif
#define STAMP0(i) \
  if (blockIdx.x == 0) { STAMP(i) }
#define STAMP0_NS(i) \
  if (blockIdx.x == 0) { STAMP_NS(i) }

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = PTN_ROUNDS;   // ballots of a warp's segment
constexpr int kSeg = 32 * kRounds;    // 128 flags a warp
constexpr int kTile = kWarps * kSeg;  // 1,024 flags a tile (shipped)
// the co-resident order form's: tiles of 2,048 flags halve its grid, and
// the barrier's wait with it (0.00639 → 0.00590 ms at 518,400 flags on an
// H100); the count-all order form at 3,456 lost 18% with them
constexpr int kOrderRounds = PTN_ORDER_ROUNDS;
constexpr int kCountAll = PTN_COUNT_ALL;
constexpr int kRows = PTN_ROWS;
// the count-all channels form's threads a block (its count and its
// gather take more loads in flight than the other kernels' 256), and the
// 16-byte words of flags a lane holds
constexpr int kRowsThreads = PTN_ROWS_THREADS;
constexpr int kWords =
    kCountAll > 16 * kRowsThreads ? (kCountAll + 16 * kRowsThreads - 1) /
                                        (16 * kRowsThreads)
                                  : 1;
constexpr int kChan = 13;      // the compacted screen channels
constexpr int kFillPer = 8;    // out floats a thread, the co-resident grid
constexpr int kBatch = 8;      // a thread's row gathers in flight
static_assert(kWords <= 16 && kWords * 16 * kRowsThreads >= kCountAll,
              "PTN_COUNT_ALL: more flags than a block holds");

struct Chans {
  const float* p[kChan];
  long long stride[kChan];
};

struct ChanOut {
  static constexpr bool kChannels = true;
  static constexpr int kCoopRounds = kRounds;  // co-resident tiles
  Chans ch;
  int v_cap;
  float* out;            // [v_cap, kChan]
  int* cidx;             // [v_cap]
  unsigned char* valid;  // [v_cap] bool
};

struct OrderOut {
  static constexpr bool kChannels = false;
  static constexpr int kCoopRounds = kOrderRounds;
  int uid0;
  int samples;
  int ray_block;  // rays a gate covers (1,024)
  int nb1, nbs;   // gates of 1 sample, of `samples` (0 when samples is 1)
  int* slot;      // [n]
  int* pix_uid;   // [n]
  int* gate1;     // [nb1]
  int* gates;     // [nbs]
  int* zero;      // [nzero], zeroed by block 0 (or null)
  int nzero;
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// The sums of a and b over the block (every thread gets them); red is
// free again on return.
__device__ __forceinline__ void block_sum2(int& a, int& b,
                                           int (*red)[kWarps]) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][w] = a;
    red[1][w] = b;
  }
  __syncthreads();
  a = 0;
  b = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    a += red[0][k];
    b += red[1][k];
  }
  __syncthreads();
}

__device__ __forceinline__ int set_bytes(unsigned w) {
  return __popc(__vcmpne4(w, 0u)) >> 3;
}

__device__ __forceinline__ int set_bytes(uint4 v) {
  return set_bytes(v.x) + set_bytes(v.y) + set_bytes(v.z) + set_bytes(v.w);
}

// Flags [i, i + 16) as one word, the bytes at or past n zero.
__device__ __forceinline__ uint4 load16(const unsigned char* __restrict__ f,
                                        int n, int i, bool aligned) {
  if (aligned && i + 16 <= n)
    return __ldg(reinterpret_cast<const uint4*>(f + i));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < 16; ++q)
    if (i + q < n) w[q >> 2] |= (unsigned)(__ldg(f + i + q) != 0)
                                << (8 * (q & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// This thread's share of the set flags in [0, split) and in [0, n).
__device__ __forceinline__ void count_share(const unsigned char* __restrict__ f,
                                            int n, int split, int& before,
                                            int& total) {
  int b = 0, t = 0, i0 = 0;
  if ((reinterpret_cast<uintptr_t>(f) & 15) == 0) {  // 16 bytes a load
    const uint4* q = reinterpret_cast<const uint4*>(f);
    const int nq = n >> 4, sq = split >> 4;  // split: a multiple of 16
#pragma unroll 4
    for (int i = threadIdx.x; i < nq; i += kThreads) {
      const int c = set_bytes(__ldg(q + i));
      t += c;
      b += i < sq ? c : 0;
    }
    i0 = 16 * nq;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads) {  // the rest
    const int c = __ldg(f + i) != 0;
    t += c;
    b += i < split ? c : 0;
  }
  before = b;
  total = t;
}

// This thread's share of the set flags in [lo, hi) (lo a multiple of 16).
__device__ __forceinline__ int count_range(const unsigned char* __restrict__ f,
                                           long long lo, long long hi) {
  int c = 0;
  long long i0 = lo;
  if ((reinterpret_cast<uintptr_t>(f) & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(f);
    const long long nq = hi >> 4;
#pragma unroll 4
    for (long long i = (lo >> 4) + threadIdx.x; i < nq; i += kThreads)
      c += set_bytes(__ldg(q + i));
    i0 = lo > 16 * nq ? lo : 16 * nq;
  }
  for (long long i = i0 + threadIdx.x; i < hi; i += kThreads)
    c += __ldg(f + i) != 0;
  return c;
}

// Flag i, its rank r among the set flags: a kept slot's id, or its place
// in the order (a warp's set flags one run, its unset flags another).
__device__ __forceinline__ void emit(const ChanOut& o, unsigned i, int r,
                                     bool set, int /*total*/) {
  if (!set || r >= o.v_cap) return;
  o.cidx[r] = (int)i;
  o.valid[r] = 1;
}

__device__ __forceinline__ void emit(const OrderOut& o, unsigned i, int r,
                                     bool set, int total) {
  const int pos = set ? r : total + ((int)i - r);
  o.slot[pos] = (int)i;
  o.pix_uid[pos] = (int)i + o.uid0;
}

// A tile's flags from its warps' ballots m (R a warp); s: the set flags
// before this warp's segment.
template <int R, class Out>
__device__ __forceinline__ void place(const Out& o, int n, int total,
                                      unsigned seg, const unsigned* m,
                                      int s) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const unsigned i = seg + j * 32 + lane;
    if (i < (unsigned)n)
      emit(o, i, s + __popc(m[j] & below), (m[j] >> lane) & 1u, total);
    s += __popc(m[j]);
  }
}

// The R ballots of a warp's segment of the tile at seg; its count.
template <int R>
__device__ __forceinline__ int ballots(const unsigned char* __restrict__ f,
                                       int n, unsigned seg, bool live,
                                       unsigned* m) {
  const int lane = threadIdx.x & 31;
  int wc = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const unsigned i = seg + j * 32 + lane;
    m[j] = __ballot_sync(~0u, live && i < (unsigned)n && __ldg(f + i) != 0);
    wc += __popc(m[j]);
  }
  return wc;
}

// What the rest of the call owes besides the flags' places, a grid-stride
// share a thread: the order form's gates (and the zeroed buffer, block
// 0's), the co-resident channels form's ids and flags of the rows past the
// kept ones (their floats are the gather's).
__device__ __forceinline__ void finish(const ChanOut& o, int n, int total) {
  const int kept = min(total, o.v_cap);
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long gs = (long long)gridDim.x * kThreads;
  for (long long r = kept + g; r < o.v_cap; r += gs) {
    o.cidx[r] = n;
    o.valid[r] = 0;
  }
}

__device__ __forceinline__ void finish(const OrderOut& o, int n, int total) {
  // 32-bit: the rays of `samples` samples number below 2^31 (the wrapper
  // checks), so do a gate's and its rays' indices
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  const unsigned gs = gridDim.x * kThreads, un = (unsigned)n;
  if (blockIdx.x == 0)
    for (int k = threadIdx.x; k < o.nzero; k += kThreads) o.zero[k] = 0;
  for (unsigned q = g; q < (unsigned)(o.nb1 + o.nbs); q += gs) {
    const bool one = q < (unsigned)o.nb1;
    const unsigned blk = one ? q : q - o.nb1;
    const unsigned rays = (one ? 1u : (unsigned)o.samples) * un;
    const unsigned lo = blk * o.ray_block;
    const unsigned len = min(lo + o.ray_block, rays) - lo;
    // the rays' slots run from lo % n for len slots, wrapping past n to 0;
    // slot p is live where p < total
    const unsigned r0 = lo % un;
    const int live = total > 0 &&
                     (len >= un || r0 < (unsigned)total || r0 + len > un);
    (one ? o.gate1 : o.gates)[blk] = live;
  }
}

// The channels' pointers and strides in shared memory (a parameter indexed
// at run time would go to local memory); read after the next barrier.
__device__ __forceinline__ void stage_chans(const ChanOut& o,
                                            const float** ptr,
                                            long long* stride) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kChan; ++k) {
      ptr[k] = o.ch.p[k];
      stride[k] = o.ch.stride[k];
    }
  }
}

// The channels form's rows [r0, r1) of out, cidx and valid as one span,
// rows [r0, r0 + kept) from the ids staged for them, the rest the fill: a
// float a thread, kBatch loads in flight (the staged id, then the
// channel) before their stores.
__device__ __forceinline__ void write_rows(const ChanOut& o, int n, int r0,
                                           int r1, int kept,
                                           const int* staged,
                                           const float* const* ptr,
                                           const long long* stride) {
  constexpr int kT = kRowsThreads;
  float* out = o.out + (long long)r0 * kChan;
  const int items = (r1 - r0) * kChan;
  for (int e0 = threadIdx.x; e0 < items; e0 += kT * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kT;
      const int row = e / kChan, k = e - row * kChan;
      v[u] = e < items && row < kept
                 ? __ldg(ptr[k] + (long long)staged[row] * stride[k])
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kT;
      if (e < items) out[e] = v[u];
    }
  }
  for (int row = threadIdx.x; row < r1 - r0; row += kT) {
    o.cidx[r0 + row] = row < kept ? staged[row] : n;
    o.valid[r0 + row] = row < kept;
  }
}

// The count-all channels form: block b writes rows [r0, r1) of out, cidx
// and valid, r0 = b * kRows.
__global__ void __launch_bounds__(kRowsThreads)
partition_rows_kernel(const unsigned char* __restrict__ f, int n, ChanOut o,
                      int* __restrict__ count) {
  constexpr int kW = kRowsThreads / 32;
  __shared__ int wtot[kW];
  __shared__ int staged[kRows];
  __shared__ const float* ptr[kChan];
  __shared__ long long stride[kChan];
  STAMP0_NS(6);
  STAMP0(0);
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, o.v_cap);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_chans(o, ptr, stride);
  int total = 0, hi = r0;  // the kept rows of this block: [r0, hi)
  if (r0 < n) {  // a block's rows at or past n are past every kept row
    const bool aligned = (reinterpret_cast<uintptr_t>(f) & 15) == 0;
    const int base = w * (kWords * 512);  // warp w's flags
    uint4 v[kWords];
    int c[kWords];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int i = base + (j * 32 + lane) * 16;
      v[j] = i < n ? load16(f, n, i, aligned) : make_uint4(0u, 0u, 0u, 0u);
      c[j] = set_bytes(v[j]);
      mine += c[j];
    }
    mine = warp_sum(mine);
    STAMP0(1);
    if (lane == 0) wtot[w] = mine;
    __syncthreads();
    int s = 0;  // set flags before this warp's
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      total += wtot[k];
      s += k < w ? wtot[k] : 0;
    }
    hi = min(r1, total);
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      int x = c[j];  // the lanes' inclusive scan of round j's counts
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(~0u, x, d);
        if (lane >= d) x += y;
      }
      int r = s + x - c[j];  // this lane's first rank
      if (r < hi && r + c[j] > r0) {
        // its 16 flags in turn, unrolled (a loop over the set bits by
        // __ffs measured 29% slower at the mid HD arm's call on an H100)
        const int i = base + (j * 32 + lane) * 16;
        const unsigned ws[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          if ((ws[q >> 2] >> (8 * (q & 3))) & 0xffu) {
            if (r >= r0 && r < hi) staged[r - r0] = i + q;
            ++r;
          }
        }
      }
      s += __shfl_sync(~0u, x, 31);
    }
  }
  STAMP0(2);
  __syncthreads();  // the ids staged, the pointers too
  STAMP0(3);
  write_rows(o, n, r0, r1, hi - r0, staged, ptr, stride);
  STAMP0(4);
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = total;
  STAMP0(5);
  STAMP0_NS(7);
}

// The count-all order form: block b < ntiles places tile b; every block
// does its share of finish().
__global__ void __launch_bounds__(kThreads)
partition_order_kernel(const unsigned char* __restrict__ f, int n,
                       int ntiles, OrderOut o, int* __restrict__ count) {
  __shared__ int red[2][kWarps];
  __shared__ int wcnt[kWarps];
  const int b = blockIdx.x, w = threadIdx.x >> 5;
  int before, total;
  count_share(f, n, min(b, ntiles) * kTile, before, total);
  block_sum2(before, total, red);
  if (b < ntiles) {
    const unsigned seg = (unsigned)b * kTile + w * kSeg;
    unsigned m[kRounds];
    const int wc = ballots<kRounds>(f, n, seg, true, m);
    if ((threadIdx.x & 31) == 0) wcnt[w] = wc;
    __syncthreads();
    int s = before;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += k < w ? wcnt[k] : 0;
    place<kRounds>(o, n, total, seg, m, s);
  }
  finish(o, n, total);
  if (b == 0 && threadIdx.x == 0) *count = total;
}

// The co-resident form, on a grid the card holds at once: block b takes
// tiles [t0, t1) of ntiles (an empty run where the grid has more blocks
// than tiles); part [gridDim.x]: the blocks' counts. Its first tile is
// ranked by ballots, kept in registers, the rest counted; after the
// grid's barrier it sums the counts before its own and all of them and
// places its tiles. The channels form writes the kept ids (cidx, valid)
// there, the ids and flags of the rows past the kept ones (finish), and
// after a second barrier the whole grid writes out [v_cap, 13] a float a
// thread, grid-stride (the row's id, then the channel).
template <class Out>
__global__ void __launch_bounds__(kThreads)
partition_coop_kernel(const unsigned char* __restrict__ f, int n,
                      int ntiles, Out o, int* __restrict__ part,
                      int* __restrict__ count) {
  __shared__ int red[2][kWarps];
  __shared__ int wcnt[kWarps];
  __shared__ const float* ptr[Out::kChannels ? kChan : 1];
  __shared__ long long stride[Out::kChannels ? kChan : 1];
  constexpr int R = Out::kCoopRounds, kS = 32 * R, kT = kWarps * kS;
  STAMP0_NS(6);
  STAMP0(0);
  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x, G = gridDim.x, w = threadIdx.x >> 5;
  const int t0 = (int)((long long)b * ntiles / G);
  const int t1 = (int)((long long)(b + 1) * ntiles / G);
  if constexpr (Out::kChannels) stage_chans(o, ptr, stride);
  // the run's first tile by ballots, kept for its places; the rest counted
  const unsigned seg = (unsigned)t0 * kT + w * kS;
  unsigned m[R];
  const int wc = ballots<R>(f, n, seg, t0 < t1, m);
  if ((threadIdx.x & 31) == 0) wcnt[w] = wc;
  int rest = 0;  // the rest of the run's set flags (a block-wide sum)
  if (t0 + 1 < t1) {
    rest = count_range(f, (long long)(t0 + 1) * kT,
                       min((long long)t1 * kT, (long long)n));
    int unused = 0;
    block_sum2(rest, unused, red);  // its barrier publishes wcnt too
  } else {
    __syncthreads();  // wcnt
  }
  STAMP0(1);
  int first = 0;  // the first tile's set flags
#pragma unroll
  for (int k = 0; k < kWarps; ++k) first += wcnt[k];
  if (threadIdx.x == 0) part[b] = first + rest;
  STAMP0(2);
  grid.sync();
  STAMP0(3);
  int before = 0, total = 0;
  for (int k = threadIdx.x; k < G; k += kThreads) {
    // written in this launch before grid.sync(), which orders memory, so
    // through L1: the blocks of an SM read the same lines (past L1,
    // 0.00703 ms against 0.00653 at 518,400 flags on an H100)
    const int c = part[k];
    total += c;
    before += k < b ? c : 0;
  }
  block_sum2(before, total, red);
  STAMP0(4);
  if (t0 < t1) {
    int s = before;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += k < w ? wcnt[k] : 0;
    place<R>(o, n, total, seg, m, s);
    int off = before + first;
    for (int t = t0 + 1; t < t1; ++t) {
      const unsigned tseg = (unsigned)t * kT + w * kS;
      const int twc = ballots<R>(f, n, tseg, true, m);
      __syncthreads();  // the last tile's wcnt read
      if ((threadIdx.x & 31) == 0) wcnt[w] = twc;
      __syncthreads();
      int ts = off, tile_set = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        ts += k < w ? wcnt[k] : 0;
        tile_set += wcnt[k];
      }
      place<R>(o, n, total, tseg, m, ts);
      off += tile_set;
    }
  }
  finish(o, n, total);
  if constexpr (Out::kChannels) {
    grid.sync();  // every kept id written
    // out [v_cap, 13], a float a thread over the whole grid: the row's
    // id, then the channel; zeros past the kept rows
    const int kept = min(total, o.v_cap);
    const unsigned items = (unsigned)o.v_cap * kChan;
    const unsigned g = (unsigned)b * kThreads + threadIdx.x;
    const unsigned gs = (unsigned)G * kThreads;
    for (unsigned e0 = g; e0 < items; e0 += gs * kBatch) {
      int id[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned e = e0 + u * gs;
        const int row = (int)(e / kChan);
        id[u] = e < items && row < kept ? __ldcg(o.cidx + row) : -1;
      }
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned e = e0 + u * gs;
        const int k = (int)(e % kChan);
        v[u] = id[u] >= 0 ? __ldg(ptr[k] + (long long)id[u] * stride[k])
                          : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned e = e0 + u * gs;
        if (e < items) o.out[e] = v[u];
      }
    }
  }
  if (b == 0 && threadIdx.x == 0) *count = total;
  STAMP0(5);
  STAMP0_NS(7);
}

// Blocks of the co-resident kernel the current device holds at once.
template <class Out>
int coop_capacity(int& cap) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    cap = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, partition_coop_kernel<Out>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  cap = sms * per_sm;
  if (dev >= 0 && dev < 64) cached[dev] = cap;
  return 0;
}

// Above kCountAll flags, the co-resident launch on a grid of min(capacity,
// max(ntiles, blocks)) blocks; part: at least max(ntiles, blocks) ints.
template <class Out>
int launch_coop(const unsigned char* flags, int n, int* part, int nparts,
                const Out& o, long long blocks, int* count, cudaStream_t s) {
  constexpr int kT = kWarps * 32 * Out::kCoopRounds;  // flags a tile
  const int ntiles = (int)(((long long)n + kT - 1) / kT);
  int cap = 0;
  const int e = coop_capacity<Out>(cap);
  if (e != 0) return e;
  const long long want = blocks > ntiles ? blocks : ntiles;
  const int grid = (int)(want < cap ? want : cap);
  if (grid <= 0 || part == nullptr || nparts < want)
    return (int)cudaErrorInvalidValue;
  Out oo = o;
  const unsigned char* ff = flags;
  int nn = n, nt = ntiles;
  int* pp = part;
  int* cc = count;
  void* args[] = {&ff, &nn, &nt, &oo, &pp, &cc};
  const cudaError_t r = cudaLaunchCooperativeKernel(
      (const void*)partition_coop_kernel<Out>, dim3(grid), dim3(kThreads),
      args, 0, s);
  return r != cudaSuccess ? (int)r : (int)cudaGetLastError();
}

}  // namespace

// The channels form (compact_valid_ch): flags bool [n] (contiguous);
// chans26: the 13 channels' device pointers, then their element strides;
// out f32 [v_cap, 13], cidx i32 [v_cap], valid bool [v_cap], count i32
// [1]; part: above kCountAll flags nparts ints for the blocks' counts (at
// least max(ntiles, v_cap * 13 / (8 * kThreads)), rounded up), else null.
extern "C" int partition_channels_launch(const unsigned char* flags, int n,
                                         const long long* chans26, int v_cap,
                                         float* out, int* cidx,
                                         unsigned char* valid, int* count,
                                         int* part, int nparts,
                                         void* stream) {
  if (n <= 0 || v_cap <= 0 || (long long)v_cap * kChan >= (1LL << 31) ||
      (n > kCountAll) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  ChanOut o;
  for (int k = 0; k < kChan; ++k) {
    o.ch.p[k] = reinterpret_cast<const float*>(chans26[k]);
    o.ch.stride[k] = chans26[kChan + k];
  }
  o.v_cap = v_cap;
  o.out = out;
  o.cidx = cidx;
  o.valid = valid;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= kCountAll) {
    partition_rows_kernel<<<(v_cap + kRows - 1) / kRows, kRowsThreads, 0,
                            s>>>(flags, n, o, count);
    return (int)cudaGetLastError();
  }
  const long long fill =
      ((long long)v_cap * kChan + kThreads * kFillPer - 1) /
      (kThreads * kFillPer);
  return launch_coop(flags, n, part, nparts, o, fill, count, s);
}

// The order form (_FrameRays): flags bool [n] (contiguous); slot and
// pix_uid i32 [n]; gate1 i32 [nb1] = the gates of one sample's n rays in
// blocks of ray_block, gates i32 [nbs] those of `samples` samples' (nbs 0
// and gates null when samples is 1); zero i32 [nzero], zeroed (or null);
// count i32 [1]; part: above kCountAll flags nparts ints (at least
// max(ntiles, (nb1 + nbs) / kThreads), rounded up), else null.
extern "C" int partition_order_launch(const unsigned char* flags, int n,
                                      int uid0, int samples, int ray_block,
                                      int* slot, int* pix_uid, int* gate1,
                                      int nb1, int* gates, int nbs,
                                      int* zero, int nzero, int* count,
                                      int* part, int nparts,
                                      void* stream) {
  if (n <= 0 || samples <= 0 || ray_block <= 0 ||
      nb1 != (int)(((long long)n + ray_block - 1) / ray_block) ||
      (long long)nbs != (samples == 1
                             ? 0
                             : ((long long)samples * n + ray_block - 1) /
                                   ray_block) ||
      (nbs > 0 && gates == nullptr) || nzero < 0 ||
      (nzero > 0 && zero == nullptr) ||
      (n > kCountAll) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  OrderOut o;
  o.uid0 = uid0;
  o.samples = samples;
  o.ray_block = ray_block;
  o.nb1 = nb1;
  o.nbs = nbs;
  o.slot = slot;
  o.pix_uid = pix_uid;
  o.gate1 = gate1;
  o.gates = gates;
  o.zero = zero;
  o.nzero = nzero;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = ((long long)nb1 + nbs + kThreads - 1) / kThreads;
  if (n <= kCountAll) {
    const int ntiles = (n + kTile - 1) / kTile;
    const long long grid = blocks > ntiles ? blocks : ntiles;
    if (grid > 65535LL * 32) return (int)cudaErrorInvalidValue;
    partition_order_kernel<<<(unsigned)grid, kThreads, 0, s>>>(flags, n,
                                                                ntiles, o,
                                                                count);
    return (int)cudaGetLastError();
  }
  return launch_coop(flags, n, part, nparts, o, blocks, count, s);
}

// Blocks of the co-resident form (the channels form's where channels is
// not 0, else the order form's) the current device holds at once, or a
// negative CUDA error.
extern "C" int partition_coop_capacity(int channels) {
  int cap = 0;
  const int e = channels ? coop_capacity<ChanOut>(cap)
                         : coop_capacity<OrderOut>(cap);
  return e != 0 ? -e : cap;
}
