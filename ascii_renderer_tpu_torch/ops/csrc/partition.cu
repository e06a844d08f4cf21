// X13: a stable partition of a flag vector, one or two launches a call.
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
// Design. A block takes a tile of 1,024 flags, each warp a 128-flag
// segment in 4 rounds of 32 with a ballot a round (a lane's flag is its
// byte != 0): a flag's rank in its warp is the popcount of the ballot
// below its lane, and the warp's count the popcounts of its 4 ballots,
// which stay in registers for the scatter. The tile's offset (the set
// flags before it) and the total n_set: up to kOneLaunch flags every block
// counts all the flags itself (16 bytes a load, a word's set bytes by
// __vcmpne4 and __popc; 32 KB at most, read again from L2 by each block),
// so the call is one launch; above it a first launch counts each tile and
// each block of the second sums the tile counts before its own and all of
// them. No block waits on another and nothing carries over between calls:
// no look-back, no flag to reset, nothing that can hang.
//
// Two forms, a template flag:
// - channels (compact_valid_ch): the set flags below v_cap are the kept
//   slots; kept slot p = s(i) gets cidx[p] = i, valid[p] = 1 and row p of
//   out [v_cap, 13] (channel k of flag i, read at ch.p[k] + i *
//   ch.stride[k]: X4's row views in place). A tile's kept ids are staged
//   in shared memory, then its rows, one contiguous span of out, are
//   gathered a float a thread, kBatch loads in flight before their stores
//   (a flag's 13 loads and stores in turn, 16 flags a thread, took 0.024
//   ms at the mid HD arm's call on an H100: the stores held the loads
//   back; this form 0.008).
//   The rows past the kept ones are zeros with cidx n and valid 0, each
//   block writing a grid-stride share; the overflow (set flags at s(i) >=
//   v_cap) is dropped, as the sort's truncation drops it.
// - order (_FrameRays): slot[pos(i)] = i and pix_uid[pos(i)] = i + uid0 for
//   every flag; and the block gates of the megakernel's stream of 1 and of
//   `samples` samples (ray s * n + p is live where p < n_set): gate[b] = 1
//   iff a ray of block b is live, in closed form from n_set.
// Both write n_set to count (0-d int32), on the device: no host sync.
//
// Bytes-bound: a flag read once (every block reads them again in the
// one-launch form, from L2), a kept slot's 52 bytes read and a v_cap
// row's 57 bytes written (channels), 8 bytes written a flag and 4 a gate
// (order). At the mid HD arm's call (29,768 flags, v_cap 16,384) that is
// ~1.4 MB, 0.0004 ms at 3.35 TB/s: a launch's floor (~0.002 ms) decides.
// Built with -fmad=false like every source; it does no float arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;            // ballots of a warp's segment
constexpr int kSeg = 32 * kRounds;    // 128 flags a warp
constexpr int kTile = kWarps * kSeg;  // 1,024 flags a block
constexpr int kOneLaunch = 32768;     // flags every block may count itself
constexpr int kChan = 13;             // the compacted screen channels
constexpr int kFillPer = 8;           // fill floats a thread, for the grid
constexpr int kBatch = 8;             // a thread's row gathers in flight

struct Chans {
  const float* p[kChan];
  long long stride[kChan];
};

struct ChanOut {
  static constexpr bool kChannels = true;
  Chans ch;
  int v_cap;
  float* out;            // [v_cap, kChan]
  int* cidx;             // [v_cap]
  unsigned char* valid;  // [v_cap] bool
};

struct OrderOut {
  static constexpr bool kChannels = false;
  int uid0;
  int samples;
  int ray_block;  // rays a gate covers (1,024)
  int nb1, nbs;   // gates of 1 sample, of `samples` (0 when samples is 1)
  int* slot;      // [n]
  int* pix_uid;   // [n]
  int* gate1;     // [nb1]
  int* gates;     // [nbs]
};

// The sums of a and b over the block (every thread gets them); red is
// free again on return.
__device__ __forceinline__ void block_sum2(int& a, int& b,
                                           int (*red)[kWarps]) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(~0u, a, o);
    b += __shfl_xor_sync(~0u, b, o);
  }
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
      const uint4 v = __ldg(q + i);
      const int c = set_bytes(v.x) + set_bytes(v.y) + set_bytes(v.z) +
                    set_bytes(v.w);
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

// Flag i, its rank r among the set flags: a kept slot's id (staged at
// r - before for the tile's gather), or its place in the order.
__device__ __forceinline__ void emit(const ChanOut& o, int i, int r,
                                     bool set, int /*total*/, int* staged,
                                     int before) {
  if (!set || r >= o.v_cap) return;
  staged[r - before] = i;
  o.cidx[r] = i;
  o.valid[r] = 1;
}

__device__ __forceinline__ void emit(const OrderOut& o, int i, int r,
                                     bool set, int total, int* /*staged*/,
                                     int /*before*/) {
  const int pos = set ? r : total + (i - r);
  o.slot[pos] = i;
  o.pix_uid[pos] = i + o.uid0;
}

// The tile's kept rows [before, before + rows) of out: a float a thread,
// kBatch loads in flight before their stores. ptr / stride: the channels'
// pointers and strides, staged in shared memory (a parameter indexed at
// run time would go to local memory).
__device__ __forceinline__ void gather_rows(const ChanOut& o,
                                            const int* staged, int before,
                                            int rows, const float* const* ptr,
                                            const long long* stride) {
  float* out = o.out + (long long)before * kChan;
  const int items = rows * kChan;
  for (int e0 = threadIdx.x; e0 < items; e0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e < items) {
        const int row = e / kChan, k = e - row * kChan;
        v[u] = __ldg(ptr[k] + (long long)staged[row] * stride[k]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e < items) out[e] = v[u];
    }
  }
}

// What the rest of the call owes besides the tiles' flags, a grid-stride
// share a thread.
__device__ __forceinline__ void finish(const ChanOut& o, int n, int total) {
  const int kept = min(total, o.v_cap);
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long gs = (long long)gridDim.x * kThreads;
  const long long end = (long long)o.v_cap * kChan;
  for (long long e = (long long)kept * kChan + g; e < end; e += gs)
    o.out[e] = 0.0f;
  for (long long r = kept + g; r < o.v_cap; r += gs) {
    o.cidx[r] = n;
    o.valid[r] = 0;
  }
}

__device__ __forceinline__ void finish(const OrderOut& o, int n, int total) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long gs = (long long)gridDim.x * kThreads;
  for (long long q = g; q < (long long)o.nb1 + o.nbs; q += gs) {
    const bool one = q < o.nb1;
    const long long blk = one ? q : q - o.nb1;
    const long long rays = (long long)(one ? 1 : o.samples) * n;
    const long long lo = blk * o.ray_block;
    const long long len = min(lo + o.ray_block, rays) - lo;
    // the rays' slots run from lo % n for len slots, wrapping past n to 0;
    // slot p is live where p < total
    const long long r0 = lo % n;
    const int live = total > 0 && (len >= n || r0 < total || r0 + len > n);
    (one ? o.gate1 : o.gates)[blk] = live;
  }
}

// The first of two launches: each block's count of its tile's set flags.
__global__ void __launch_bounds__(kThreads)
partition_count_kernel(const unsigned char* __restrict__ f, int n,
                       int* __restrict__ counts) {
  __shared__ int red[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kTile + (threadIdx.x >> 5) * kSeg;
  int c = 0, unused = 0;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = seg + j * 32 + lane;
    c += i < n && __ldg(f + i) != 0;
  }
  block_sum2(c, unused, red);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// The partition: counts null (one launch: every block counts the flags)
// or the first launch's tile counts [ntiles]. Blocks below ntiles place
// their tile's flags; every block does its share of finish().
template <class Out>
__global__ void __launch_bounds__(kThreads)
partition_kernel(const unsigned char* __restrict__ f, int n, int ntiles,
                 const int* __restrict__ counts, Out o,
                 int* __restrict__ count) {
  __shared__ int red[2][kWarps];
  __shared__ int wcnt[kWarps];
  __shared__ int staged[Out::kChannels ? kTile : 1];
  __shared__ const float* ptr[kChan];
  __shared__ long long stride[kChan];
  const int b = blockIdx.x;
  if constexpr (Out::kChannels) {
    if (threadIdx.x == 0) {  // read by the gather after block_sum2's barrier
#pragma unroll
      for (int k = 0; k < kChan; ++k) {
        ptr[k] = o.ch.p[k];
        stride[k] = o.ch.stride[k];
      }
    }
  }
  int before = 0, total = 0;
  if (counts == nullptr) {
    count_share(f, n, min(b, ntiles) * kTile, before, total);
  } else {
    for (int t = threadIdx.x; t < ntiles; t += kThreads) {
      const int c = __ldg(counts + t);
      total += c;
      before += t < b ? c : 0;
    }
  }
  block_sum2(before, total, red);
  if (b < ntiles) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int seg = b * kTile + w * kSeg;
    unsigned m[kRounds];
    int wc = 0;
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      const int i = seg + j * 32 + lane;
      m[j] = __ballot_sync(~0u, i < n && __ldg(f + i) != 0);
      wc += __popc(m[j]);
    }
    if (lane == 0) wcnt[w] = wc;
    __syncthreads();
    int s = before, tile_set = 0;  // set flags before this warp's segment
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      s += k < w ? wcnt[k] : 0;
      tile_set += wcnt[k];
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      const int i = seg + j * 32 + lane;
      if (i < n)
        emit(o, i, s + __popc(m[j] & below), (m[j] >> lane) & 1u, total,
             staged, before);
      s += __popc(m[j]);
    }
    if constexpr (Out::kChannels) {
      __syncthreads();  // the tile's kept ids staged
      gather_rows(o, staged, before,
                  max(0, min(tile_set, o.v_cap - before)), ptr, stride);
    }
  }
  finish(o, n, total);
  if (b == 0 && threadIdx.x == 0) *count = total;
}

// The call's launches: tile counts first above kOneLaunch flags (scratch:
// ntiles ints, else null), then the partition on a grid of max(ntiles,
// fill) blocks.
template <class Out>
int launch(const unsigned char* flags, int n, int* scratch, const Out& o,
           long long fill, int* count, cudaStream_t s) {
  const int ntiles = (n + kTile - 1) / kTile;
  if ((n > kOneLaunch) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  if (scratch != nullptr) {
    partition_count_kernel<<<ntiles, kThreads, 0, s>>>(flags, n, scratch);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = fill > ntiles ? fill : ntiles;
  if (grid > 65535 * 32) return (int)cudaErrorInvalidValue;
  partition_kernel<Out><<<(unsigned)grid, kThreads, 0, s>>>(
      flags, n, ntiles, scratch, o, count);
  return (int)cudaGetLastError();
}

}  // namespace

// The channels form (compact_valid_ch): flags bool [n] (contiguous);
// chans26: the 13 channels' device pointers, then their element strides;
// out f32 [v_cap, 13], cidx i32 [v_cap], valid bool [v_cap], count i32
// [1]; scratch: (n + 4,095) / 4,096 ints above 32,768 flags, else null.
extern "C" int partition_channels_launch(const unsigned char* flags, int n,
                                         const long long* chans26, int v_cap,
                                         float* out, int* cidx,
                                         unsigned char* valid, int* count,
                                         int* scratch, void* stream) {
  if (n <= 0 || v_cap <= 0 || (long long)v_cap * kChan >= (1LL << 31))
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
  const long long fill =
      ((long long)v_cap * kChan + kThreads * kFillPer - 1) /
      (kThreads * kFillPer);
  return launch(flags, n, scratch, o, fill, count, (cudaStream_t)stream);
}

// The order form (_FrameRays): flags bool [n] (contiguous); slot and
// pix_uid i32 [n]; gate1 i32 [nb1] = the gates of one sample's n rays in
// blocks of ray_block, gates i32 [nbs] those of `samples` samples' (nbs 0
// and gates null when samples is 1); count i32 [1]; scratch as above.
extern "C" int partition_order_launch(const unsigned char* flags, int n,
                                      int uid0, int samples, int ray_block,
                                      int* slot, int* pix_uid, int* gate1,
                                      int nb1, int* gates, int nbs,
                                      int* count, int* scratch,
                                      void* stream) {
  if (n <= 0 || samples <= 0 || ray_block <= 0 ||
      nb1 != (n + ray_block - 1) / ray_block ||
      (long long)nbs != (samples == 1
                             ? 0
                             : ((long long)samples * n + ray_block - 1) /
                                   ray_block) ||
      (nbs > 0 && gates == nullptr))
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
  const long long fill = ((long long)nb1 + nbs + kThreads - 1) / kThreads;
  return launch(flags, n, scratch, o, fill, count, (cudaStream_t)stream);
}
