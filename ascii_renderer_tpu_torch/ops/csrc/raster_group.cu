// Depth-grouped bin walks. One group = 8 depth-similar bins of 8 x 16
// pixels, laid side by side as an 8 x 128 pixel block (lane l is in bin slot
// g = l / 16). Each pixel keeps the nearest covering entry of its slot's
// bin: all three edge planes <= 0, 0 <= z <= 1, the entry index inside the
// bin's live window, and a strict z < best merge, so the smallest triangle
// id wins depth ties.
//
// One template, four entry sources (ops/raster_group.py describes the
// layouts); each has its own __global__ kernel and extern "C" launcher:
//   kSkip    walk_grouped_skip_kernel  rows128 [r_cap, 128], live iff
//            skip <= idx < skip + depth.  Replaces
//            ascii_renderer_tpu/ops/raster_group.py:_kernel_grouped_skip (B1)
//   kNoSkip  walk_grouped_kernel       rows128, live iff idx < depth.
//            Replaces :_kernel_grouped (B9d)
//   kTwo     walk_grouped_k2_kernel    rows256 [r_cap/2, 256], two entries
//            per row (lane g*32 + j*16 + c), idx = 2*row + j, skip window.
//            Replaces :_kernel_grouped_k2 (B9f)
//   kDirect  walk_direct_kernel        src_pair [p_max + 32, 32]: each slot
//            reads its bin's 32-entry strip at min(goff + c*32, p_max),
//            live iff idx < depth.  Replaces :_kernel_direct (B9e)
// The TPU kernels expanded each slab through an MXU selection dot to
// broadcast channels to lanes; here each thread reads its slot's channels
// from shared memory (a 16-way broadcast), so no expand matrix exists.
//
// What bounds them on the H100: issue rate of the per-pixel test, not
// memory: every 64-byte entry is used by 128 pixels (about 20 flops each).
// Design: one block per group (grid = grp_cap), one thread per pixel (1024
// threads), the group's entries staged through shared memory in slabs of
// 32 entries per slot (16 KB, one float4 load per thread), the running
// (z, id) in registers. The slab start is clamped exactly where the
// reference clamps it, so an overflowing cap re-reads the same rows.
//
// Exactness: w = (C + A*x) + B*y in the op order of raster_group.py:341-364,
// both products fused as the reference's compiler fuses them (explicit
// fmaf; -fmad=false keeps anything else from fusing), so the winners and
// depths equal the plain-torch versions (ops/raster_group.py) and the JAX
// walks bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 32;     // entries per slot per slab (= CHUNK_RG)
constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kSubW = 16;
constexpr int kChan = 16;      // walk channels per entry
constexpr int kThreads = kTileH * kTileW;

// walk-entry channels (ops/raster_subtile.py): edge k has its x, y and
// constant coefficients at 3k, 3k + 1 and 3k + 2
constexpr int kZX = 9, kZY = 10, kZC = 11, kPair = 12;

enum Source { kSkip, kNoSkip, kTwo, kDirect };

struct WalkArgs {
  const float* data;   // rows128, rows256 or src_pair
  const int* start;    // rowptr [grp_cap + 1] (row units) or goff [grp_cap*8]
  const int* gdepth;   // [grp_cap * 8]
  const int* aux;      // gskip [grp_cap * 8] (kSkip, kTwo), gchunks
                       // [grp_cap] (kDirect), unused (kNoSkip)
  const float* xl;
  const float* yl;
  float* z_out;
  float* e_out;
  int n;               // rows of data (kSkip, kNoSkip, kTwo) or p_max
};

template <Source S>
__device__ __forceinline__ void walk(const WalkArgs& a) {
  __shared__ float4 slab[kChunk * kTileW / 4];  // [32 entries][8 slots][16]
  // layouts read as one contiguous slab: data rows per slab, floats per row
  constexpr int kRows = S == kTwo ? kChunk / 2 : kChunk;
  constexpr int kRowF = S == kTwo ? 2 * kTileW : kTileW;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = tid / kTileW;  // pixel row inside the group block
  const int l = tid % kTileW;  // lane
  const int g = l / kSubW;     // bin slot

  int r0 = 0, n_chunks, off = 0;
  if (S == kDirect) {
    n_chunks = a.aux[t];
    // this thread stages entry tid / 32, slot (tid / 4) % 8, channels
    // 4 * (tid % 4) .. + 3 of every slab
    off = a.start[t * 8 + (tid / 4) % 8];
  } else {
    r0 = a.start[t];
    n_chunks = (a.start[t + 1] - r0) / kRows;
  }
  const float x = a.xl[t * kTileW + l];
  const float y = ((float)s + 0.5f) + a.yl[t * kTileW + l];
  const int depth = a.gdepth[t * 8 + g];
  const int skip = (S == kSkip || S == kTwo) ? a.aux[t * 8 + g] : 0;

  float zb = INFINITY;
  float eb = -1.0f;
  const float* buf = reinterpret_cast<const float*>(slab);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // previous slab fully consumed
    if (S == kDirect) {
      const int row = min(off + c * kChunk, a.n) + tid / 32;
      slab[tid] = reinterpret_cast<const float4*>(a.data)[(size_t)row * 8 +
                                                          tid % 4];
    } else {
      const int start = min(r0 + c * kRows, a.n - kRows);
      slab[tid] = reinterpret_cast<const float4*>(a.data +
                                                  (size_t)start * kRowF)[tid];
    }
    __syncthreads();
    const int d0 = c * kChunk;
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      // entry r of slot g: two-entry rows hold sub-entry r & 1 of row r / 2
      const float* ent =
          S == kTwo ? buf + (r >> 1) * kRowF + g * 2 * kChan + (r & 1) * kChan
                    : buf + r * kTileW + g * kChan;
      float w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        w[k] = fmaf(ent[3 * k + 1], y, fmaf(ent[3 * k], x, ent[3 * k + 2]));
      const float z = fmaf(ent[kZY], y, fmaf(ent[kZX], x, ent[kZC]));
      const int idx = d0 + r;
      const bool ok = (w[0] <= 0.0f) && (w[1] <= 0.0f) && (w[2] <= 0.0f) &&
                      (z >= 0.0f) && (z <= 1.0f) && (idx >= skip) &&
                      (idx < skip + depth);
      const float zm = ok ? z : INFINITY;
      if (zm < zb) {  // strict: the earlier (smaller tri id) entry wins ties
        zb = zm;
        eb = ent[kPair];
      }
    }
  }
  a.z_out[(size_t)t * kThreads + tid] = zb;
  a.e_out[(size_t)t * kThreads + tid] = eb;
}

__global__ void __launch_bounds__(kThreads)
walk_grouped_skip_kernel(WalkArgs a) { walk<kSkip>(a); }
__global__ void __launch_bounds__(kThreads)
walk_grouped_kernel(WalkArgs a) { walk<kNoSkip>(a); }
__global__ void __launch_bounds__(kThreads)
walk_grouped_k2_kernel(WalkArgs a) { walk<kTwo>(a); }
__global__ void __launch_bounds__(kThreads)
walk_direct_kernel(WalkArgs a) { walk<kDirect>(a); }

int launch(void (*kernel)(WalkArgs), const WalkArgs& a, int grp_cap,
           void* stream) {
  kernel<<<grp_cap, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int walk_grouped_skip_launch(const float* rows128,
                                        const int* rowptr, const int* gdepth,
                                        const int* gskip, const float* xl,
                                        const float* yl, float* z, float* e,
                                        int r_cap, int grp_cap, void* stream) {
  return launch(walk_grouped_skip_kernel,
                {rows128, rowptr, gdepth, gskip, xl, yl, z, e, r_cap},
                grp_cap, stream);
}

extern "C" int walk_grouped_launch(const float* rows128, const int* rowptr,
                                   const int* gdepth, const float* xl,
                                   const float* yl, float* z, float* e,
                                   int r_cap, int grp_cap, void* stream) {
  return launch(walk_grouped_kernel,
                {rows128, rowptr, gdepth, nullptr, xl, yl, z, e, r_cap},
                grp_cap, stream);
}

extern "C" int walk_grouped_k2_launch(const float* rows256, const int* rowptr,
                                      const int* gdepth, const int* gskip,
                                      const float* xl, const float* yl,
                                      float* z, float* e, int r_cap2,
                                      int grp_cap, void* stream) {
  return launch(walk_grouped_k2_kernel,
                {rows256, rowptr, gdepth, gskip, xl, yl, z, e, r_cap2},
                grp_cap, stream);
}

extern "C" int walk_direct_launch(const float* src_pair, const int* goff,
                                  const int* gdepth, const int* gchunks,
                                  const float* xl, const float* yl, float* z,
                                  float* e, int p_max, int grp_cap,
                                  void* stream) {
  return launch(walk_direct_kernel,
                {src_pair, goff, gdepth, gchunks, xl, yl, z, e, p_max},
                grp_cap, stream);
}
