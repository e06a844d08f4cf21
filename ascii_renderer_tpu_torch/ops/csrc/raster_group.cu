// Depth-grouped bin walks. One group = 8 depth-similar bins of 8 x 16
// pixels, laid side by side as an 8 x 128 pixel block (lane l is in bin slot
// g = l / 16). Each pixel keeps the nearest covering entry of its slot's
// bin: all three edge planes <= 0, 0 <= z <= 1, the entry index inside the
// bin's live window, and a strict z < best merge, so the smallest triangle
// id wins depth ties.
//
// Four entry sources (ops/raster_group.py describes the layouts), each with
// its own __global__ kernel and extern "C" launcher:
//   B1   walk_grouped_skip_kernel + walk_grouped_skip_kernel_merge: rows128
//        [r_cap, 128], live iff skip <= idx < skip + depth.  Replaces
//        ascii_renderer_tpu/ops/raster_group.py:_kernel_grouped_skip
//   B9f  walk_grouped_k2_kernel + walk_grouped_k2_kernel_merge: rows256
//        [r_cap/2, 256], two entries per row (lane g*32 + j*16 + c),
//        idx = 2*row + j, skip window.  Replaces :_kernel_grouped_k2
//   B9d  walk_grouped_kernel       rows128, live iff idx < depth.
//        Replaces :_kernel_grouped (template walk<kNoSkip>)
//   B9e  walk_direct_kernel        src_pair [p_max + 32, 32]: each slot
//        reads its bin's 32-entry strip at min(goff + c*32, p_max),
//        live iff idx < depth.  Replaces :_kernel_direct (walk<kDirect>)
// The TPU kernels expanded each slab through an MXU selection dot to
// broadcast channels to lanes; here each thread reads its slot's channels
// from shared memory (a 16-way broadcast), so no expand matrix exists.
//
// What bounds them on the H100: issue rate of the per-pixel test, not
// memory: every 64-byte entry is used by 128 pixels (about 20 flops each).
//
// B1 (the headline's walk) and B9f take B6's design (ops/csrc/raster_bins.cu)
// on one template, slab_walk<kPer> (kPer entries per layout row: 1 for
// rows128, 2 for rows256):
// - Work items of one 32-entry slab (32 / kPer rows, 16 KB) of one group
//   and a quarter of its pixel block. Slab c of group t reads rows
//   min(r0 + c*R, r_cap - R) + r, R = 32 / kPer, as entries idx = c*32 + r
//   (the clamp re-reads the same rows under shifted indices where a cap
//   overflows) and takes slot r0 / R + t + c: slots increase with (t, c)
//   and number fewer than rowptr[grp_cap] / R + grp_cap, which the kernel
//   reads: its blocks (at most 2,048, so a cap far above the rows in use
//   launches no idle blocks) stride over the items below that bound, and
//   find each item's (group, slab) by a binary search over rowptr.
// - Each thread takes one lane and two pixel rows: the slot's entry is
//   read as four float4s, the lane's products C + A*x (fused) serve both
//   rows, and only the entries inside its slot's skip window are walked.
// - A group with one slab writes its (z, id) directly; the others write
//   partial results per slot, folded by slab_merge in slot order with a
//   strict z < best (the leftmost minimum, the reference's merge), which
//   also writes groups without slabs.
// B9d and B9e keep the template walk below: one block per group (grid =
// grp_cap), one thread per pixel (1024 threads), the group's entries
// staged through shared memory in slabs of 32 entries per slot (16 KB, one
// float4 load per thread), the running (z, id) in registers. The slab
// start is clamped exactly where the reference clamps it, so an
// overflowing cap re-reads the same rows.
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

enum Source { kNoSkip, kDirect };

struct WalkArgs {
  const float* data;   // rows128 or src_pair
  const int* start;    // rowptr [grp_cap + 1] or goff [grp_cap*8]
  const int* gdepth;   // [grp_cap * 8]
  const int* aux;      // gchunks [grp_cap] (kDirect), unused (kNoSkip)
  const float* xl;
  const float* yl;
  float* z_out;
  float* e_out;
  int n;               // rows of data (kNoSkip) or p_max (kDirect)
};

template <Source S>
__device__ __forceinline__ void walk(const WalkArgs& a) {
  __shared__ float4 slab[kChunk * kTileW / 4];  // [32 entries][8 slots][16]
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
    n_chunks = (a.start[t + 1] - r0) / kChunk;
  }
  const float x = a.xl[t * kTileW + l];
  const float y = ((float)s + 0.5f) + a.yl[t * kTileW + l];
  const int depth = a.gdepth[t * 8 + g];

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
      const int start = min(r0 + c * kChunk, a.n - kChunk);
      slab[tid] = reinterpret_cast<const float4*>(a.data +
                                                  (size_t)start * kTileW)[tid];
    }
    __syncthreads();
    const int d0 = c * kChunk;
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      const float* ent = buf + r * kTileW + g * kChan;
      float w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        w[k] = fmaf(ent[3 * k + 1], y, fmaf(ent[3 * k], x, ent[3 * k + 2]));
      const float z = fmaf(ent[kZY], y, fmaf(ent[kZX], x, ent[kZC]));
      const int idx = d0 + r;
      const bool ok = (w[0] <= 0.0f) && (w[1] <= 0.0f) && (w[2] <= 0.0f) &&
                      (z >= 0.0f) && (z <= 1.0f) && (idx < depth);
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
walk_grouped_kernel(WalkArgs a) { walk<kNoSkip>(a); }
__global__ void __launch_bounds__(kThreads)
walk_direct_kernel(WalkArgs a) { walk<kDirect>(a); }

int launch(void (*kernel)(WalkArgs), const WalkArgs& a, int grp_cap,
           void* stream) {
  kernel<<<grp_cap, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}


// ---- B1 and B9f: slab work items and their merge --------------------------
constexpr int kRowsPT = 2;                 // pixel rows per slab walk thread
constexpr int kSplit = kTileH / kRowsPT;   // work items per slab
constexpr int kItemThreads = kTileW;
constexpr int kMaxItemBlocks = 2048;       // ~16 blocks of 128 threads an SM
constexpr int kMergeThreads = 256;
constexpr int kFold = 8;                   // partials a merge thread loads at once

// The slab count of group t and its first slot, slabs of kSlabRows layout
// rows (rowptr clamped to r_cap).
template <int kSlabRows>
__device__ __forceinline__ void group_slots(const int* __restrict__ rowptr,
                                            int t, int* n, int* s) {
  const int r0 = rowptr[t];
  *s = r0 / kSlabRows + t;
  *n = max((rowptr[t + 1] - r0) / kSlabRows, 0);
}

// The walk over slab work items; kPer entries per layout row (rows128: 1,
// rows256: 2, sub-entry j of row q at lanes g*32 + j*16), so a slab of 32
// entries is 32 / kPer rows of 128 * kPer floats and r_cap counts rows.
template <int kPer>
__device__ __forceinline__ void slab_walk(
    const float* __restrict__ rows, const int* __restrict__ rowptr,
    const int* __restrict__ gdepth, const int* __restrict__ gskip,
    const float* __restrict__ xl, const float* __restrict__ yl,
    float* __restrict__ z_out, float* __restrict__ e_out,
    float* __restrict__ part, int r_cap, int grp_cap) {
  constexpr int kSlabRows = kChunk / kPer;
  constexpr int kRowF4 = kPer * kTileW / 4;  // float4s per layout row
  __shared__ float4 slab[kChunk * kTileW / 4];  // one slab, 16 KB
  const int l = threadIdx.x;                     // lane
  const int g = l / kSubW;                       // bin slot
  // items in use lie below this bound; the grid strides over them
  const int limit = (rowptr[grp_cap] / kSlabRows + grp_cap) * kSplit;
  for (int item = blockIdx.x; item < limit; item += gridDim.x) {
    const int slot = item / kSplit;
    const int quarter = item % kSplit;  // its pixel rows
    // the group: the largest t with rowptr[t] / R + t <= slot
    int lo = 0, hi = grp_cap - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (rowptr[mid] / kSlabRows + mid <= slot) lo = mid;
      else hi = mid - 1;
    }
    const int t = lo;
    int n, s;
    group_slots<kSlabRows>(rowptr, t, &n, &s);
    const int c = slot - s;
    if (c < 0 || c >= n) continue;  // a slot no group uses (block-uniform)
    const int start = min(rowptr[t] + c * kSlabRows, r_cap - kSlabRows);
    const float4* src = reinterpret_cast<const float4*>(
        rows + (size_t)start * kPer * kTileW);
    __syncthreads();  // the previous item's slab fully consumed
#pragma unroll
    for (int i = 0; i < kChunk * kTileW / 4 / kItemThreads; ++i)
      slab[i * kItemThreads + l] = src[i * kItemThreads + l];
    __syncthreads();

    const float x = xl[t * kTileW + l];
    const int row0 = quarter * kRowsPT;
    float y[kRowsPT], zb[kRowsPT], eb[kRowsPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      y[i] = ((float)(row0 + i) + 0.5f) + yl[t * kTileW + l];
      zb[i] = INFINITY;
      eb[i] = -1.0f;
    }
    // entries idx = c*32 + r of the slot's window skip <= idx < skip + depth
    const int skip = gskip[t * 8 + g];
    const int r_lo = max(skip - c * kChunk, 0);
    const int r_hi = min(skip + gdepth[t * 8 + g] - c * kChunk, kChunk);
    for (int r = r_lo; r < r_hi; ++r) {
      const float4* ent = slab + (r / kPer) * kRowF4 + g * (kPer * kSubW / 4) +
                          (r % kPer) * (kSubW / 4);
      // channels: q0 = (A0 B0 G0 A1), q1 = (B1 G1 A2 B2),
      // q2 = (G2 ZX ZY ZC), q3 = (PAIR . . .)
      const float4 q0 = ent[0], q1 = ent[1], q2 = ent[2], q3 = ent[3];
      const float c0 = fmaf(q0.x, x, q0.z), c1 = fmaf(q0.w, x, q1.y);
      const float c2 = fmaf(q1.z, x, q2.x), cz = fmaf(q2.y, x, q2.w);
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i) {
        const float z = fmaf(q2.z, y[i], cz);
        const bool ok = fmaf(q0.y, y[i], c0) <= 0.0f &&
                        fmaf(q1.x, y[i], c1) <= 0.0f &&
                        fmaf(q1.w, y[i], c2) <= 0.0f && z >= 0.0f &&
                        z <= 1.0f;
        if (ok && z < zb[i]) {  // strict: the earlier entry wins ties
          zb[i] = z;
          eb[i] = q3.x;
        }
      }
    }
    float* zo;
    float* eo;
    if (n == 1) {
      zo = z_out + (size_t)t * kThreads;
      eo = e_out + (size_t)t * kThreads;
    } else {
      zo = part + (size_t)slot * 2 * kThreads;
      eo = zo + kThreads;
    }
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      zo[(row0 + i) * kTileW + l] = zb[i];
      eo[(row0 + i) * kTileW + l] = eb[i];
    }
  }
}

// Folds each group's per-slot (z, id) in slot order (strict z < best);
// writes (inf, -1) for a group without slabs. One-slab groups were
// written by the walk.
template <int kSlabRows>
__device__ __forceinline__ void slab_merge(const int* __restrict__ rowptr,
                                           const float* __restrict__ part,
                                           float* __restrict__ z_out,
                                           float* __restrict__ e_out,
                                           int n_slots) {
  const int t = blockIdx.x;
  int n, s;
  group_slots<kSlabRows>(rowptr, t, &n, &s);
  if (n == 1) return;
  const int m = min(n, n_slots - s);
  for (int p = threadIdx.x; p < kThreads; p += kMergeThreads) {
    // kFold partial depths loaded together, then folded in slot order: the
    // loads of a deep group's slabs overlap instead of queueing one by one
    float zb = INFINITY;
    int win = -1;
    for (int c0 = 0; c0 < m; c0 += kFold) {
      float z[kFold];
#pragma unroll
      for (int j = 0; j < kFold; ++j)
        z[j] = c0 + j < m ? part[(size_t)(s + c0 + j) * 2 * kThreads + p]
                          : INFINITY;
#pragma unroll
      for (int j = 0; j < kFold; ++j)
        if (z[j] < zb) {
          zb = z[j];
          win = c0 + j;
        }
    }
    z_out[(size_t)t * kThreads + p] = zb;
    e_out[(size_t)t * kThreads + p] =
        win < 0 ? -1.0f
                : part[(size_t)(s + win) * 2 * kThreads + kThreads + p];
  }
}

#define SLAB_WALK_ARGS                                                      \
  const float *__restrict__ rows, const int *__restrict__ rowptr,          \
      const int *__restrict__ gdepth, const int *__restrict__ gskip,       \
      const float *__restrict__ xl, const float *__restrict__ yl,          \
      float *__restrict__ z_out, float *__restrict__ e_out,                \
      float *__restrict__ part, int r_cap, int grp_cap
#define SLAB_MERGE_ARGS                                                     \
  const int *__restrict__ rowptr, const float *__restrict__ part,          \
      float *__restrict__ z_out, float *__restrict__ e_out, int n_slots

__global__ void __launch_bounds__(kItemThreads)
walk_grouped_skip_kernel(SLAB_WALK_ARGS) {
  slab_walk<1>(rows, rowptr, gdepth, gskip, xl, yl, z_out, e_out, part, r_cap,
               grp_cap);
}
__global__ void __launch_bounds__(kMergeThreads)
walk_grouped_skip_kernel_merge(SLAB_MERGE_ARGS) {
  slab_merge<kChunk>(rowptr, part, z_out, e_out, n_slots);
}
__global__ void __launch_bounds__(kItemThreads)
walk_grouped_k2_kernel(SLAB_WALK_ARGS) {
  slab_walk<2>(rows, rowptr, gdepth, gskip, xl, yl, z_out, e_out, part, r_cap,
               grp_cap);
}
__global__ void __launch_bounds__(kMergeThreads)
walk_grouped_k2_kernel_merge(SLAB_MERGE_ARGS) {
  slab_merge<kChunk / 2>(rowptr, part, z_out, e_out, n_slots);
}

// The walk over at most 2,048 blocks, then the merge over every group.
int slab_launch(void (*walk_kernel)(SLAB_WALK_ARGS),
                void (*merge_kernel)(SLAB_MERGE_ARGS), const float* rows,
                const int* rowptr, const int* gdepth, const int* gskip,
                const float* xl, const float* yl, float* z, float* e,
                float* part, int n_slots, int r_cap, int grp_cap,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = n_slots * kSplit < kMaxItemBlocks ? n_slots * kSplit
                                                      : kMaxItemBlocks;
  walk_kernel<<<blocks, kItemThreads, 0, st>>>(rows, rowptr, gdepth, gskip,
                                               xl, yl, z, e, part, r_cap,
                                               grp_cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<grp_cap, kMergeThreads, 0, st>>>(rowptr, part, z, e,
                                                  n_slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int walk_grouped_skip_launch(const float* rows128,
                                        const int* rowptr, const int* gdepth,
                                        const int* gskip, const float* xl,
                                        const float* yl, float* z, float* e,
                                        float* part, int n_slots, int r_cap,
                                        int grp_cap, void* stream) {
  return slab_launch(walk_grouped_skip_kernel, walk_grouped_skip_kernel_merge,
                     rows128, rowptr, gdepth, gskip, xl, yl, z, e, part,
                     n_slots, r_cap, grp_cap, stream);
}

extern "C" int walk_grouped_k2_launch(const float* rows256, const int* rowptr,
                                      const int* gdepth, const int* gskip,
                                      const float* xl, const float* yl,
                                      float* z, float* e, float* part,
                                      int n_slots, int r_cap2, int grp_cap,
                                      void* stream) {
  return slab_launch(walk_grouped_k2_kernel, walk_grouped_k2_kernel_merge,
                     rows256, rowptr, gdepth, gskip, xl, yl, z, e, part,
                     n_slots, r_cap2, grp_cap, stream);
}

extern "C" int walk_grouped_launch(const float* rows128, const int* rowptr,
                                   const int* gdepth, const float* xl,
                                   const float* yl, float* z, float* e,
                                   int r_cap, int grp_cap, void* stream) {
  return launch(walk_grouped_kernel,
                {rows128, rowptr, gdepth, nullptr, xl, yl, z, e, r_cap},
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
