// Depth-grouped bin walks. One group = 8 depth-similar bins of 8 x 16
// pixels, laid side by side as an 8 x 128 pixel block (lane l is in bin slot
// g = l / 16). Each pixel keeps the nearest covering entry of its slot's
// bin: all three edge planes <= 0, 0 <= z <= 1, the entry index inside the
// bin's live window, and a strict z < best merge, so the smallest triangle
// id wins depth ties.
//
// Four walks on one template (ops/raster_group.py describes the layouts),
// each a walk kernel over slab work items and a merge kernel, behind one
// extern "C" launcher:
//   B1   walk_grouped_skip_kernel (+ _merge): rows128 [r_cap, 128], live
//        iff skip <= idx < skip + depth.  Replaces
//        ascii_renderer_tpu/ops/raster_group.py:_kernel_grouped_skip
//   B9f  walk_grouped_k2_kernel (+ _merge): rows256 [r_cap/2, 256], two
//        entries per row (lane g*32 + j*16 + c), idx = 2*row + j, skip
//        window.  Replaces :_kernel_grouped_k2
//   B9d  walk_grouped_kernel (+ _merge): rows128, live iff idx < depth.
//        Replaces :_kernel_grouped
//   B9e  walk_direct_kernel (+ _merge): src_pair [p_max + 32, 32], slot g
//        of slab c reads its bin's 32-entry strip at min(goff + c*32,
//        p_max), live iff idx < depth.  Replaces :_kernel_direct
// The TPU kernels expanded each slab through an MXU selection dot to
// broadcast channels to lanes; here each thread reads its slot's channels
// from shared memory (a 16-way broadcast), so no expand matrix exists.
//
// What bounds them on the H100: issue rate of the per-pixel test, not
// memory: every 64-byte entry is used by 128 pixels (about 20 flops each).
//
// The template, slab_walk, takes B6's design (ops/csrc/raster_bins.cu):
// - Work items of one 32-entry slab (16 KB staged in shared memory) of one
//   group and a quarter of its pixel block. The layouts (B1, B9d, B9f;
//   kPer entries a row: 1 for rows128, 2 for rows256) read slab c of
//   group t from rows min(r0 + c*R, r_cap - R) + r, R = 32 / kPer, as
//   entries idx = c*32 + r (the clamp re-reads the same rows under shifted
//   indices where a cap overflows, and those rows can be live); B9e fills
//   the slab from 8 strips, slot g from rows min(goff + c*32, p_max) + r.
// - Slab c of group t takes slot r0 / R + t + c, r0 = rowptr[t]: slots
//   increase with (t, c) and number fewer than n_slots, the bound the host
//   sizes the partials by. The walk's blocks (at most 2,048, so a cap far
//   above the rows in use launches no idle blocks) stride over the items
//   below rowptr[grp_cap] / R + grp_cap (and n_slots) and find each item's
//   (group, slab) by a binary search over rowptr. B9e has no rowptr: each
//   block of its walk first forms one in shared memory, 32 times the
//   exclusive prefix of gchunks (group_prefix), and block 0 also stores it
//   for the merge, so the search, the slot numbering and the merge serve
//   it unchanged.
// - Each thread takes one lane and two pixel rows: the slot's entry is
//   read as four float4s, the lane's products C + A*x (fused) serve both
//   rows, and only the entries inside its slot's live window are walked.
// - A group with one slab writes its (z, id) directly; the others write
//   partial results per slot, folded by slab_merge in slot order with a
//   strict z < best (the leftmost minimum, the reference's merge), which
//   also writes groups without slabs.
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
constexpr int kPix = kTileH * kTileW;      // pixels per group
constexpr int kRowsPT = 2;                 // pixel rows per slab walk thread
constexpr int kSplit = kTileH / kRowsPT;   // work items per slab
constexpr int kItemThreads = kTileW;
constexpr int kMaxItemBlocks = 2048;       // ~16 blocks of 128 threads an SM
constexpr int kMergeThreads = 256;
constexpr int kFold = 8;                   // partials a merge thread loads at once

// Where a walk's slab comes from: rows of a materialised layout, or one
// strip of the pair-ordered table per bin slot (B9e)
enum Stage { kRows, kStrips };

// The slab count of group t and its first slot, slabs of kSlabRows layout
// rows (rowptr clamped to r_cap).
template <int kSlabRows>
__device__ __forceinline__ void group_slots(const int* __restrict__ rowptr,
                                            int t, int* n, int* s) {
  const int r0 = rowptr[t];
  *s = r0 / kSlabRows + t;
  *n = max((rowptr[t + 1] - r0) / kSlabRows, 0);
}

// B9e's rowptr, formed by each block of kN threads: ptr[t] = 32 * the
// exclusive prefix of gchunks, each count clamped to [0, cap] and the sum
// saturating at cap (= n_slots): a gchunks that is not the build's cannot
// number a slot past the partials, and ptr never decreases.
template <int kN>
__device__ __forceinline__ void group_prefix(const int* __restrict__ gchunks,
                                             int grp_cap, int cap, int* ptr) {
  __shared__ int warp_sum[kN / 32];
  const int l = threadIdx.x;
  const int per = (grp_cap + kN - 1) / kN;   // groups a thread sums in order
  const int lo = min(l * per, grp_cap), hi = min(lo + per, grp_cap);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum = min(sum + min(max(gchunks[i], 0), cap), cap);
  int inc = sum;  // inclusive saturating scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (l % 32 >= o) inc = min(inc + v, cap);
  }
  int run = __shfl_up_sync(0xffffffffu, inc, 1);
  if (l % 32 == 0) run = 0;
  if (l % 32 == 31) warp_sum[l / 32] = inc;
  __syncthreads();
  for (int w = 0; w < l / 32; ++w) run = min(run + warp_sum[w], cap);
  for (int i = lo; i < hi; ++i) {
    ptr[i] = run * kChunk;
    run = min(run + min(max(gchunks[i], 0), cap), cap);
  }
  if (l == kN - 1) ptr[grp_cap] = run * kChunk;
  __syncthreads();
}

// The walk over slab work items. kPer entries per layout row (rows128: 1,
// rows256: 2, sub-entry j of row q at lanes g*32 + j*16), so a slab of 32
// entries is 32 / kPer rows of 128 * kPer floats and r_cap counts rows;
// kStrips (kPer 1): rows is src_pair, r_cap its p_max and goff the strips'
// starts. kSkip: the live window is skip <= idx < skip + depth, else
// idx < depth (gskip unread).
template <int kPer, bool kSkip, Stage kStage>
__device__ __forceinline__ void slab_walk(
    const float* __restrict__ rows, const int* __restrict__ rowptr,
    const int* __restrict__ goff, const int* __restrict__ gdepth,
    const int* __restrict__ gskip, const float* __restrict__ xl,
    const float* __restrict__ yl, float* __restrict__ z_out,
    float* __restrict__ e_out, float* __restrict__ part, int n_slots,
    int r_cap, int grp_cap) {
  constexpr int kSlabRows = kChunk / kPer;
  constexpr int kRowF4 = kPer * kTileW / 4;  // float4s per layout row
  static_assert(kStage == kRows || kPer == 1, "strips hold one entry a row");
  __shared__ float4 slab[kChunk * kTileW / 4];  // one slab, 16 KB
  const int l = threadIdx.x;                     // lane
  const int g = l / kSubW;                       // bin slot
  // items in use lie below this bound; the grid strides over them
  const int limit = min(rowptr[grp_cap] / kSlabRows + grp_cap, n_slots) *
                    kSplit;
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
    __syncthreads();  // the previous item's slab fully consumed
    if (kStage == kRows) {
      const int start = min(rowptr[t] + c * kSlabRows, r_cap - kSlabRows);
      const float4* src = reinterpret_cast<const float4*>(
          rows + (size_t)start * kPer * kTileW);
#pragma unroll
      for (int i = 0; i < kChunk * kTileW / 4 / kItemThreads; ++i)
        slab[i * kItemThreads + l] = src[i * kItemThreads + l];
    } else {
      // float4 f = i*128 + l of the slab is entry f / 32, slot (f / 4) % 8,
      // channels 4 * (f % 4) .. + 3: this thread's slot is (l / 4) % 8 for
      // every i, its entries l / 32 + 4i of that slot's strip
      const int row = min(goff[t * 8 + (l / 4) % 8] + c * kChunk, r_cap) +
                      l / 32;
      const float4* src = reinterpret_cast<const float4*>(rows) +
                          (size_t)row * 8 + l % 4;
#pragma unroll
      for (int i = 0; i < kChunk * kTileW / 4 / kItemThreads; ++i)
        slab[i * kItemThreads + l] = src[(size_t)i * 4 * 8];
    }
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
    const int skip = kSkip ? gskip[t * 8 + g] : 0;
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
      zo = z_out + (size_t)t * kPix;
      eo = e_out + (size_t)t * kPix;
    } else {
      zo = part + (size_t)slot * 2 * kPix;
      eo = zo + kPix;
    }
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      zo[(row0 + i) * kTileW + l] = zb[i];
      eo[(row0 + i) * kTileW + l] = eb[i];
    }
  }
}

// Folds each group's per-slot (z, id) in slot order (strict z < best);
// writes (inf, -1) for a group without slabs (or whose slots the walk's
// n_slots bound left out). One-slab groups were written by the walk.
template <int kSlabRows>
__device__ __forceinline__ void slab_merge(const int* __restrict__ rowptr,
                                           const float* __restrict__ part,
                                           float* __restrict__ z_out,
                                           float* __restrict__ e_out,
                                           int n_slots) {
  const int t = blockIdx.x;
  int n, s;
  group_slots<kSlabRows>(rowptr, t, &n, &s);
  if (n == 1 && s < n_slots) return;
  const int m = min(n, n_slots - s);
  for (int p = threadIdx.x; p < kPix; p += kMergeThreads) {
    // kFold partial depths loaded together, then folded in slot order: the
    // loads of a deep group's slabs overlap instead of queueing one by one
    float zb = INFINITY;
    int win = -1;
    for (int c0 = 0; c0 < m; c0 += kFold) {
      float z[kFold];
#pragma unroll
      for (int j = 0; j < kFold; ++j)
        z[j] = c0 + j < m ? part[(size_t)(s + c0 + j) * 2 * kPix + p]
                          : INFINITY;
#pragma unroll
      for (int j = 0; j < kFold; ++j)
        if (z[j] < zb) {
          zb = z[j];
          win = c0 + j;
        }
    }
    z_out[(size_t)t * kPix + p] = zb;
    e_out[(size_t)t * kPix + p] =
        win < 0 ? -1.0f : part[(size_t)(s + win) * 2 * kPix + kPix + p];
  }
}

#define SLAB_WALK_ARGS                                                      \
  const float *__restrict__ rows, const int *__restrict__ rowptr,          \
      const int *__restrict__ gdepth, const int *__restrict__ gskip,       \
      const float *__restrict__ xl, const float *__restrict__ yl,          \
      float *__restrict__ z_out, float *__restrict__ e_out,                \
      float *__restrict__ part, int n_slots, int r_cap, int grp_cap
#define SLAB_MERGE_ARGS                                                     \
  const int *__restrict__ rowptr, const float *__restrict__ part,          \
      float *__restrict__ z_out, float *__restrict__ e_out, int n_slots
#define DIRECT_WALK_ARGS                                                    \
  const float *__restrict__ src_pair, const int *__restrict__ goff,        \
      const int *__restrict__ gdepth, const int *__restrict__ gchunks,     \
      const float *__restrict__ xl, const float *__restrict__ yl,          \
      float *__restrict__ z_out, float *__restrict__ e_out,                \
      float *__restrict__ part, int *__restrict__ rowptr, int n_slots,     \
      int p_max, int grp_cap

__global__ void __launch_bounds__(kItemThreads)
walk_grouped_skip_kernel(SLAB_WALK_ARGS) {
  slab_walk<1, true, kRows>(rows, rowptr, nullptr, gdepth, gskip, xl, yl,
                            z_out, e_out, part, n_slots, r_cap, grp_cap);
}
__global__ void __launch_bounds__(kMergeThreads)
walk_grouped_skip_kernel_merge(SLAB_MERGE_ARGS) {
  slab_merge<kChunk>(rowptr, part, z_out, e_out, n_slots);
}
__global__ void __launch_bounds__(kItemThreads)
walk_grouped_k2_kernel(SLAB_WALK_ARGS) {
  slab_walk<2, true, kRows>(rows, rowptr, nullptr, gdepth, gskip, xl, yl,
                            z_out, e_out, part, n_slots, r_cap, grp_cap);
}
__global__ void __launch_bounds__(kMergeThreads)
walk_grouped_k2_kernel_merge(SLAB_MERGE_ARGS) {
  slab_merge<kChunk / 2>(rowptr, part, z_out, e_out, n_slots);
}
__global__ void __launch_bounds__(kItemThreads)
walk_grouped_kernel(SLAB_WALK_ARGS) {
  slab_walk<1, false, kRows>(rows, rowptr, nullptr, gdepth, nullptr, xl, yl,
                             z_out, e_out, part, n_slots, r_cap, grp_cap);
}
__global__ void __launch_bounds__(kMergeThreads)
walk_grouped_kernel_merge(SLAB_MERGE_ARGS) {
  slab_merge<kChunk>(rowptr, part, z_out, e_out, n_slots);
}
// B9e's rowptr [grp_cap + 1] is dynamic shared memory; block 0 stores it
// to rowptr for the merge
__global__ void __launch_bounds__(kItemThreads)
walk_direct_kernel(DIRECT_WALK_ARGS) {
  extern __shared__ int gptr[];
  group_prefix<kItemThreads>(gchunks, grp_cap, n_slots, gptr);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i <= grp_cap; i += kItemThreads)
      rowptr[i] = gptr[i];
  slab_walk<1, false, kStrips>(src_pair, gptr, goff, gdepth, nullptr, xl, yl,
                               z_out, e_out, part, n_slots, p_max, grp_cap);
}
__global__ void __launch_bounds__(kMergeThreads)
walk_direct_kernel_merge(SLAB_MERGE_ARGS) {
  slab_merge<kChunk>(rowptr, part, z_out, e_out, n_slots);
}

// Blocks of a walk: one an item of n_slots slots, at most 2,048.
int item_blocks(int n_slots) {
  return n_slots * kSplit < kMaxItemBlocks ? n_slots * kSplit
                                           : kMaxItemBlocks;
}

// The walk over the work items, then the merge over every group.
int slab_launch(void (*walk_kernel)(SLAB_WALK_ARGS),
                void (*merge_kernel)(SLAB_MERGE_ARGS), const float* rows,
                const int* rowptr, const int* gdepth, const int* gskip,
                const float* xl, const float* yl, float* z, float* e,
                float* part, int n_slots, int r_cap, int grp_cap,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  walk_kernel<<<item_blocks(n_slots), kItemThreads, 0, st>>>(
      rows, rowptr, gdepth, gskip, xl, yl, z, e, part, n_slots, r_cap,
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
                                   float* part, int n_slots, int r_cap,
                                   int grp_cap, void* stream) {
  return slab_launch(walk_grouped_kernel, walk_grouped_kernel_merge, rows128,
                     rowptr, gdepth, nullptr, xl, yl, z, e, part, n_slots,
                     r_cap, grp_cap, stream);
}

// rowptr: int [grp_cap + 1] scratch, the gchunks prefix the walk stores
extern "C" int walk_direct_launch(const float* src_pair, const int* goff,
                                  const int* gdepth, const int* gchunks,
                                  const float* xl, const float* yl, float* z,
                                  float* e, float* part, int* rowptr,
                                  int n_slots, int p_max, int grp_cap,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(int) * ((size_t)grp_cap + 1);
  if (smem > 16 * 1024)  // beside the walk's 16 KB slab: raise the cap
    cudaFuncSetAttribute(walk_direct_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  walk_direct_kernel<<<item_blocks(n_slots), kItemThreads, smem, st>>>(
      src_pair, goff, gdepth, gchunks, xl, yl, z, e, part, rowptr, n_slots,
      p_max, grp_cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  walk_direct_kernel_merge<<<grp_cap, kMergeThreads, 0, st>>>(
      rowptr, part, z, e, n_slots);
  return (int)cudaGetLastError();
}
