// Channel-era subtile walks. Each 8 x 128 pixel tile walks its 8 column
// bins of 8 x 16 pixels side by side: lane l is in lane group g = l / 16,
// and row r of the tile's range [rowptr[t], rowptr[t+1]) holds, for each
// group, the r-th entry of bin (t, g) (ops/raster_subtile.py describes the
// layouts). Each pixel keeps the nearest covering entry: all three edge
// planes <= 0, 0 <= z <= 1, and a strict z < best merge in row order, so
// the smallest triangle id wins depth ties.
//
// Three walks, each a work-item kernel and a merge launch:
//   B9a  subtile_walk_expanded_kernel (+ _merge): expanded rows
//        [r_cap, 16, 128], channel c of group g broadcast over lanes
//        16g..16g+15, reference chunks of 8 rows. Replaces
//        ascii_renderer_tpu/ops/raster_subtile.py:_kernel
//   B9b  subtile_walk_kernel<kPacked> (+ subtile_walk_kernel_merge):
//        packed rows [r_cap, 128], lane g*16 + c, reference chunks of 32
//        rows. Replaces :_kernel_packed
//   B9c  subtile_walk_kernel<kPackedDepth> (+ the same merge): B9b plus
//        the per-bin depth mask: slot d = 32c + r of group g is live iff
//        d < depth[t*8 + g] (dead slots hold other pairs' live rows, so
//        only the mask kills them). Replaces :_kernel_packed_d
// The TPU kernels expand a packed chunk to lanes through a selection dot
// on the matrix unit; here each thread reads its group's channels from
// shared memory (a 16-way broadcast), so no expand matrix exists.
//
// Exactness (explicit fmaf; -fmad=false keeps anything else from fusing),
// in the rounding of each reference on its compiler:
//   B9a:       w = fma(A, x, B*y) + G, x and y the global pixel centre;
//   B9b, B9c:  P = A*(l + 0.5) + G rounded twice (the expand dot, l the
//              tile-local lane), then w = fma(B, y, fma(bx, A, P)) with
//              bx = 128 * tile column.
// Each reference chunk c starts at min(r0 + c*chunk, r_cap - chunk),
// exactly where the reference clamps it, so an overflowing r_cap re-reads
// the same rows.
//
// What bounds them on the H100: bytes. Each live (bin, triangle) pair is
// a 64-byte entry tested by its bin's 128 pixels at about 20 operations,
// so the function needs 64 B a live pair plus the (z, id) outputs, which
// on the bunny (58,657 pairs, 4.5 MB of outputs) outweigh the tests
// (~2,560 operations a pair at 67 TFLOP/s) a little. What
// the walks lose against that bound is first idle SMs: a tile is as deep
// as its deepest bin (1,600-1,760 rows on the bunny), so one block a tile
// left one SM walking the deepest tile while the others waited.
// The design (B6's and B8's, ops/csrc/raster_bins.cu): work items of one
// run of kItemRows = 32 rows of one tile, four B9a reference chunks or one
// B9b / B9c chunk. Item k of tile t takes slot r0 / 32 + t + k (tile_items):
// slots increase with (t, k) and number at most rowptr[n_tiles] / 32 +
// n_tiles (slot_bound), which the kernels read; their blocks (at most
// 2,048) stride over the items below it and find each item's tile by a
// binary search over rowptr (slot_tile). A tile of one item writes (z, id)
// directly; the others write partials that the merge launch folds in slot
// order with a strict z < best (merge_tile, one thread a pixel), the
// reference's row-order merge, which keeps an earlier item's +0.0 against
// a later -0.0.
// - B9b / B9c: one block of 256 threads an item over the whole tile, each
//   thread one lane and four pixel rows. The item's 32 packed rows (16 KB,
//   contiguous) are staged once as float4s, one neighbouring address a
//   thread, and each entry's y-free plane parts fma(bx, A, A*lx + G) are
//   formed once for the four rows. A quarter-tile split (four 128-thread
//   blocks an item, two rows a thread, each staging the item) took 0.0366
//   ms against this design's 0.0275 at the bunny's subtile call (H100 SXM,
//   700 W; tools/kernel_ab.py).
// - B9a: a quarter of the tile's pixel rows an item (kSplit blocks of 128
//   threads, one lane and two pixel rows a thread). An item stages lane 16g
//   of channels 0..12 of its rows, each value a 32-byte sector of its own,
//   into a [row][group][16] table; each 8-row chunk is clamped on its own.
// Both walk a staged entry as four float4 loads (a 16-way broadcast).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kSubW = 16;
constexpr int kNSub = kTileW / kSubW;
constexpr int kChan = 16;  // walk channels per entry
constexpr int kPix = kTileH * kTileW;
// walk-entry channels (ops/raster_subtile.py): edge k has its x, y and
// constant coefficients at 3k, 3k + 1 and 3k + 2
constexpr int kZX = 9, kZY = 10, kZC = 11, kPair = 12;

// subtile_walk_launch's source: B9a, B9b, B9c
enum Source { kExpanded = 0, kPacked = 1, kPackedDepth = 2 };

// ---- The work list and the merge, shared by the three walks --------------
constexpr int kItemRows = 32;  // ITEM_R = CHUNK_RP: rows of a work item
constexpr int kMaxItemBlocks = 2048;  // the walks' grid at most
// one merge thread a pixel: the deepest tile's fold (51 items on the
// bunny) is the merge's critical path
constexpr int kMergeThreads = kPix;
constexpr int kFold = 8;  // partials a merge thread loads at once

// The item count of tile t and its first slot (rowptr clamped to r_cap).
__device__ __forceinline__ void tile_items(const int* __restrict__ rowptr,
                                           int t, int* n, int* s) {
  const int r0 = rowptr[t];
  *s = r0 / kItemRows + t;
  *n = max((rowptr[t + 1] - r0 + kItemRows - 1) / kItemRows, 0);
}

// Slots in use lie below this bound; the walks' grids stride over them.
__device__ __forceinline__ int slot_bound(const int* __restrict__ rowptr,
                                          int n_tiles) {
  return (rowptr[n_tiles] + kItemRows - 1) / kItemRows + n_tiles;
}

// The tile of a slot: the largest t with rowptr[t] / 32 + t <= slot.
__device__ __forceinline__ int slot_tile(const int* __restrict__ rowptr,
                                         int n_tiles, int slot) {
  int lo = 0, hi = n_tiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rowptr[mid] / kItemRows + mid <= slot) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Folds tile blockIdx.x's per-slot (z, id) in slot order (strict z <
// best); writes (inf, -1) for a tile without rows. One-item tiles were
// written by the walk.
__device__ __forceinline__ void merge_tile(const int* __restrict__ rowptr,
                                           const float* __restrict__ part,
                                           float* __restrict__ z_out,
                                           float* __restrict__ e_out,
                                           int n_slots) {
  const int t = blockIdx.x;
  int n, s;
  tile_items(rowptr, t, &n, &s);
  if (n == 1) return;
  const int m = min(n, n_slots - s);
  const int p = threadIdx.x;  // the pixel
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

// ---- B9b / B9c: packed chunk work items ----------------------------------
constexpr int kPRowsPT = 4;                 // pixel rows a packed thread
constexpr int kPThreads = kPix / kPRowsPT;  // one block an item, whole tile
template <Source S>
__global__ void __launch_bounds__(kPThreads)
subtile_walk_kernel(const float* __restrict__ rows,
                    const int* __restrict__ rowptr,
                    const int* __restrict__ depth, float* __restrict__ z_out,
                    float* __restrict__ e_out, float* __restrict__ part,
                    int n_tiles, int tiles_x, int r_cap) {
  __shared__ float4 slab4[kItemRows * kTileW / 4];  // [row][group][channel]
  const int l = threadIdx.x % kTileW;  // lane
  const int g = l / kSubW;             // lane group (bin of the tile)
  const int row0 = threadIdx.x / kTileW * kPRowsPT;  // its pixel rows
  const float lx = (float)l + 0.5f;
  const int limit = slot_bound(rowptr, n_tiles);
  for (int slot = blockIdx.x; slot < limit; slot += gridDim.x) {
    const int t = slot_tile(rowptr, n_tiles, slot);
    int n, s;
    tile_items(rowptr, t, &n, &s);
    const int k = slot - s;
    if (k < 0 || k >= n) continue;  // a slot no tile uses (block-uniform)
    const int start = min(rowptr[t] + k * kItemRows, r_cap - kItemRows);
    __syncthreads();  // the previous item's rows fully consumed
    const float4* src =
        reinterpret_cast<const float4*>(rows + (size_t)start * kTileW);
#pragma unroll
    for (int v = threadIdx.x; v < kItemRows * kTileW / 4; v += kPThreads)
      slab4[v] = src[v];
    __syncthreads();

    const int tx = t % tiles_x, ty = t / tiles_x;
    const float bx = (float)(tx * kTileW);
    // B9c: item row i is the tile's slot 32k + i, live below the bin depth
    const int live = S == kPackedDepth
                         ? depth[t * kNSub + g] - k * kItemRows
                         : kItemRows;
    float y[kPRowsPT], zb[kPRowsPT], eb[kPRowsPT];
#pragma unroll
    for (int j = 0; j < kPRowsPT; ++j) {
      y[j] = (float)(row0 + j + ty * kTileH) + 0.5f;
      zb[j] = INFINITY;
      eb[j] = -1.0f;
    }
#pragma unroll 4
    for (int i = 0; i < kItemRows; ++i) {
      const float4* ent = slab4 + (i * kTileW + g * kChan) / 4;
      // channels: q0 = (A0 B0 G0 A1), q1 = (B1 G1 A2 B2),
      // q2 = (G2 ZX ZY ZC), q3 = (PAIR . . .)
      const float4 q0 = ent[0], q1 = ent[1], q2 = ent[2], q3 = ent[3];
      // each plane's part without y: fma(bx, A, A*lx + G), the product
      // and the sum rounded apart (the reference's expand dot)
      const float c0 = fmaf(bx, q0.x, q0.x * lx + q0.z);
      const float c1 = fmaf(bx, q0.w, q0.w * lx + q1.y);
      const float c2 = fmaf(bx, q1.z, q1.z * lx + q2.x);
      const float cz = fmaf(bx, q2.y, q2.y * lx + q2.w);
#pragma unroll
      for (int j = 0; j < kPRowsPT; ++j) {
        const float z = fmaf(q2.z, y[j], cz);
        bool ok = fmaf(q0.y, y[j], c0) <= 0.0f &&
                  fmaf(q1.x, y[j], c1) <= 0.0f &&
                  fmaf(q1.w, y[j], c2) <= 0.0f && z >= 0.0f && z <= 1.0f;
        if (S == kPackedDepth) ok = ok && i < live;
        if (ok && z < zb[j]) {  // strict: the earlier row wins ties
          zb[j] = z;
          eb[j] = q3.x;
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
    for (int j = 0; j < kPRowsPT; ++j) {
      zo[(row0 + j) * kTileW + l] = zb[j];
      eo[(row0 + j) * kTileW + l] = eb[j];
    }
  }
}

// ---- B9a: expanded chunk work items --------------------------------------
constexpr int kChunkR = 8;                 // CHUNK_R: B9a's reference chunk
constexpr int kItemChunks = kItemRows / kChunkR;
constexpr int kUsedChan = kPair + 1;       // the planes and the id
constexpr int kRowsPT = 2;                 // pixel rows per walk thread
constexpr int kSplit = kTileH / kRowsPT;   // work items per run of rows
constexpr int kItemThreads = kTileW;
__global__ void __launch_bounds__(kItemThreads)
subtile_walk_expanded_kernel(const float* __restrict__ rows,
                             const int* __restrict__ rowptr,
                             float* __restrict__ z_out,
                             float* __restrict__ e_out,
                             float* __restrict__ part, int n_tiles,
                             int tiles_x, int r_cap) {
  __shared__ float4 ent4[kItemRows * kNSub * kChan / 4];  // [row][group][16]
  float* ent_s = reinterpret_cast<float*>(ent4);
  const int l = threadIdx.x;  // lane
  const int g = l / kSubW;    // lane group (bin of the tile)
  const int limit = slot_bound(rowptr, n_tiles) * kSplit;
  for (int item = blockIdx.x; item < limit; item += gridDim.x) {
    const int slot = item / kSplit;
    const int quarter = item % kSplit;  // its pixel rows
    const int t = slot_tile(rowptr, n_tiles, slot);
    int n, s;
    tile_items(rowptr, t, &n, &s);
    const int k = slot - s;
    if (k < 0 || k >= n) continue;  // a slot no tile uses (block-uniform)
    const int r0 = rowptr[t];
    // rows d = 32k + i of the tile, i < m (a CHUNK_R multiple)
    const int m = min(rowptr[t + 1] - r0 - k * kItemRows, kItemRows);
    __syncthreads();  // the previous item's table fully consumed
    // value v: group v % 8 of channel (v / 8) % 13 of item row v / 104
    for (int v = l; v < m * kUsedChan * kNSub; v += kItemThreads) {
      const int gg = v % kNSub, cc = (v / kNSub) % kUsedChan;
      const int i = v / (kNSub * kUsedChan);
      const int c = k * kItemChunks + i / kChunkR;  // the tile's chunk
      const int row = min(r0 + c * kChunkR, r_cap - kChunkR) + i % kChunkR;
      ent_s[(i * kNSub + gg) * kChan + cc] =
          rows[((size_t)row * kChan + cc) * kTileW + gg * kSubW];
    }
    __syncthreads();

    const int tx = t % tiles_x, ty = t / tiles_x;
    const float x = (float)(l + tx * kTileW) + 0.5f;
    const int row0 = quarter * kRowsPT;
    float y[kRowsPT], zb[kRowsPT], eb[kRowsPT];
#pragma unroll
    for (int j = 0; j < kRowsPT; ++j) {
      y[j] = (float)(row0 + j + ty * kTileH) + 0.5f;
      zb[j] = INFINITY;
      eb[j] = -1.0f;
    }
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const float4* ent = ent4 + (i * kNSub + g) * (kChan / 4);
      // channels: q0 = (A0 B0 G0 A1), q1 = (B1 G1 A2 B2),
      // q2 = (G2 ZX ZY ZC), q3 = (PAIR . . .)
      const float4 q0 = ent[0], q1 = ent[1], q2 = ent[2], q3 = ent[3];
#pragma unroll
      for (int j = 0; j < kRowsPT; ++j) {
        const float z = fmaf(q2.y, x, q2.z * y[j]) + q2.w;
        const bool ok = fmaf(q0.x, x, q0.y * y[j]) + q0.z <= 0.0f &&
                        fmaf(q0.w, x, q1.x * y[j]) + q1.y <= 0.0f &&
                        fmaf(q1.z, x, q1.w * y[j]) + q2.x <= 0.0f &&
                        z >= 0.0f && z <= 1.0f;
        if (ok && z < zb[j]) {  // strict: the earlier row wins ties
          zb[j] = z;
          eb[j] = q3.x;
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
    for (int j = 0; j < kRowsPT; ++j) {
      zo[(row0 + j) * kTileW + l] = zb[j];
      eo[(row0 + j) * kTileW + l] = eb[j];
    }
  }
}

// One merge body behind two names, so that a profiler row names its walk.
__global__ void __launch_bounds__(kMergeThreads)
subtile_walk_expanded_kernel_merge(const int* __restrict__ rowptr,
                                   const float* __restrict__ part,
                                   float* __restrict__ z_out,
                                   float* __restrict__ e_out, int n_slots) {
  merge_tile(rowptr, part, z_out, e_out, n_slots);
}

__global__ void __launch_bounds__(kMergeThreads)
subtile_walk_kernel_merge(const int* __restrict__ rowptr,
                          const float* __restrict__ part,
                          float* __restrict__ z_out,
                          float* __restrict__ e_out, int n_slots) {
  merge_tile(rowptr, part, z_out, e_out, n_slots);
}

static_assert(kZX == 9 && kZY == kZX + 1 && kZC == kZX + 2,
              "the depth plane is read as (ZX, ZY, ZC) like an edge");

// The walks' grid: a block an item, at most kMaxItemBlocks.
int item_blocks(int items) {
  return items < kMaxItemBlocks ? items : kMaxItemBlocks;
}

}  // namespace

extern "C" int subtile_walk_launch(const float* rows, const int* rowptr,
                                   const int* depth, float* z, float* e,
                                   float* part, int n_slots, int n_tiles,
                                   int tiles_x, int r_cap, int source,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (source) {
    case kExpanded:
      subtile_walk_expanded_kernel<<<item_blocks(n_slots * kSplit),
                                     kItemThreads, 0, st>>>(
          rows, rowptr, z, e, part, n_tiles, tiles_x, r_cap);
      break;
    case kPacked:
      subtile_walk_kernel<kPacked><<<item_blocks(n_slots), kPThreads, 0,
                                     st>>>(rows, rowptr, depth, z, e, part,
                                           n_tiles, tiles_x, r_cap);
      break;
    case kPackedDepth:
      subtile_walk_kernel<kPackedDepth><<<item_blocks(n_slots), kPThreads, 0,
                                          st>>>(rows, rowptr, depth, z, e,
                                                part, n_tiles, tiles_x,
                                                r_cap);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (source == kExpanded)
    subtile_walk_expanded_kernel_merge<<<n_tiles, kMergeThreads, 0, st>>>(
        rowptr, part, z, e, n_slots);
  else
    subtile_walk_kernel_merge<<<n_tiles, kMergeThreads, 0, st>>>(
        rowptr, part, z, e, n_slots);
  return (int)cudaGetLastError();
}
