// Channel-era subtile walks. Each 8 x 128 pixel tile walks its 8 column
// bins of 8 x 16 pixels side by side: lane l is in lane group g = l / 16,
// and row r of the tile's range [rowptr[t], rowptr[t+1]) holds, for each
// group, the r-th entry of bin (t, g) (ops/raster_subtile.py describes the
// layouts). Each pixel keeps the nearest covering entry: all three edge
// planes <= 0, 0 <= z <= 1, and a strict z < best merge in row order, so
// the smallest triangle id wins depth ties.
//
// Three entry sources:
//   kExpanded     rows [r_cap, 16, 128], channel c of group g broadcast
//                 over lanes 16g..16g+15; chunks of 8 rows. Replaces
//                 ascii_renderer_tpu/ops/raster_subtile.py:_kernel (B9a):
//                 subtile_walk_expanded_kernel + its merge
//   kPacked       rows [r_cap, 128], lane g*16 + c; chunks of 32 rows.
//                 Replaces :_kernel_packed (B9b)
//   kPackedDepth  kPacked plus the per-bin depth mask: slot c*32 + r of
//                 group g is live iff it is < depth[t*8 + g] (dead slots
//                 hold other pairs' live rows). Replaces :_kernel_packed_d
//                 (B9c)
// The TPU kernels expand a packed chunk to lanes through a selection dot
// on the matrix unit; here each thread reads its group's channels from
// shared memory (a 16-way broadcast), so no expand matrix exists.
//
// Exactness (explicit fmaf; -fmad=false keeps anything else from fusing),
// in the rounding of each reference on its compiler:
//   kExpanded:  w = fma(A, x, B*y) + G, x and y the global pixel centre;
//   kPacked*:   P = A*(l + 0.5) + G rounded twice (the expand dot, l the
//               tile-local lane), then w = fma(B, y, fma(bx, A, P)) with
//               bx = 128 * tile column.
// Each chunk starts at min(r0 + c*chunk, r_cap - chunk), exactly where the
// reference clamps it, so an overflowing r_cap re-reads the same rows.
//
// What bounds them on the H100: the per-pixel test (every 64-byte entry is
// tested by its bin's 128 pixels, about 20 operations each) and, for
// kExpanded, the layout: an entry's 13 used channels lie 512 bytes apart
// and its group's value repeats over 16 lanes (64 bytes), so each value
// read costs a 32-byte sector of its own and no two values of a warp's
// request can share one.
// B9a's design (B6's and B8's, ops/csrc/raster_bins.cu): work items of a
// run of up to kItemRows = 32 rows (four reference chunks) of one tile and
// a quarter of its pixel rows, 128 threads, each one lane and two pixel
// rows. Item k of tile t takes slot r0 / 32 + t + k: slots increase with
// (t, k) and number at most rowptr[n_tiles] / 32 + n_tiles, the bound the
// kernel reads; its blocks (at most 2,048) stride over the items below it
// and find each item's (tile, k) by a binary search over rowptr. An item
// stages lane 16g of channels 0..12 of its rows (a warp's 32 loads span
// two channels' 8 groups: 2 KB) into a [row][group][16] table, then walks
// it with four float4 loads an entry. A tile of one item writes (z, id)
// directly; the others write partials that the merge launch folds in slot
// order with a strict z < best, the reference's row-order merge.
// kPacked and kPackedDepth keep one block per tile (1,024 threads, one per
// pixel), 32 packed rows (16 KB) staged a chunk, one float4 per thread.
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

enum Source { kPacked = 1, kPackedDepth = 2 };  // subtile_walk_launch's source

template <Source S>
__device__ __forceinline__ float plane(const float* ent, int ca, float x,
                                       float lx, float bx, float y) {
  const float a = ent[ca], b = ent[ca + 1], g = ent[ca + 2];
  const float p = a * lx + g;  // two roundings: the reference's dot
  return fmaf(b, y, fmaf(bx, a, p));
}

template <Source S>
__global__ void __launch_bounds__(kPix)
subtile_walk_kernel(const float* __restrict__ rows,
                    const int* __restrict__ rowptr,
                    const int* __restrict__ depth, float* __restrict__ z_out,
                    float* __restrict__ e_out, int tiles_x, int r_cap) {
  constexpr int kChunk = 32;  // CHUNK_RP
  __shared__ float4 slab4[kChunk * kTileW / 4];  // [row][group][channel]
  const float* slab = reinterpret_cast<const float*>(slab4);
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = tid / kTileW;  // pixel row in the tile
  const int l = tid % kTileW;  // lane
  const int g = l / kSubW;     // lane group (bin of the tile)
  const int tx = t % tiles_x, ty = t / tiles_x;
  const float x = (float)(l + tx * kTileW) + 0.5f;
  const float y = (float)(s + ty * kTileH) + 0.5f;
  const float lx = (float)l + 0.5f;
  const float bx = (float)(tx * kTileW);
  const int r0 = rowptr[t];
  const int n_chunks = (rowptr[t + 1] - r0) / kChunk;
  const int dep = S == kPackedDepth ? depth[t * kNSub + g] : 0;

  float zb = INFINITY;
  float eb = -1.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int start = min(r0 + c * kChunk, r_cap - kChunk);
    __syncthreads();  // previous chunk fully consumed
    slab4[tid] = reinterpret_cast<const float4*>(
        rows + (size_t)start * kTileW)[tid];
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      const float* ent = slab + r * kTileW + g * kChan;
      const float w0 = plane<S>(ent, 0, x, lx, bx, y);
      const float w1 = plane<S>(ent, 3, x, lx, bx, y);
      const float w2 = plane<S>(ent, 6, x, lx, bx, y);
      const float z = plane<S>(ent, kZX, x, lx, bx, y);
      bool ok = (w0 <= 0.0f) && (w1 <= 0.0f) && (w2 <= 0.0f) &&
                (z >= 0.0f) && (z <= 1.0f);
      if (S == kPackedDepth) ok = ok && (c * kChunk + r < dep);
      const float zm = ok ? z : INFINITY;
      if (zm < zb) {  // strict: the earlier (smaller tri id) entry wins ties
        zb = zm;
        eb = ent[kPair];
      }
    }
  }
  z_out[(size_t)t * kPix + tid] = zb;
  e_out[(size_t)t * kPix + tid] = eb;
}

// ---- B9a: chunk work items of the expanded layout, and their merge -------
constexpr int kChunkR = 8;                 // CHUNK_R: the reference's chunk
constexpr int kItemRows = 32;              // ITEM_R: rows of a work item
constexpr int kItemChunks = kItemRows / kChunkR;
constexpr int kUsedChan = kPair + 1;       // the planes and the id
constexpr int kRowsPT = 2;                 // pixel rows per walk thread
constexpr int kSplit = kTileH / kRowsPT;   // work items per run of rows
constexpr int kItemThreads = kTileW;
constexpr int kMaxItemBlocks = 2048;
// one merge thread a pixel: the deepest tile's fold (51 items on the
// bunny) is the merge's critical path
constexpr int kMergeThreads = kPix;
constexpr int kFold = 8;                   // partials a merge thread loads at once

// The item count of tile t and its first slot (rowptr clamped to r_cap).
__device__ __forceinline__ void tile_items(const int* __restrict__ rowptr,
                                           int t, int* n, int* s) {
  const int r0 = rowptr[t];
  *s = r0 / kItemRows + t;
  *n = max((rowptr[t + 1] - r0 + kItemRows - 1) / kItemRows, 0);
}

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
  // items in use lie below this bound; the grid strides over them
  const int limit =
      ((rowptr[n_tiles] + kItemRows - 1) / kItemRows + n_tiles) * kSplit;
  for (int item = blockIdx.x; item < limit; item += gridDim.x) {
    const int slot = item / kSplit;
    const int quarter = item % kSplit;  // its pixel rows
    // the tile: the largest t with rowptr[t] / 32 + t <= slot
    int lo = 0, hi = n_tiles - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (rowptr[mid] / kItemRows + mid <= slot) lo = mid;
      else hi = mid - 1;
    }
    const int t = lo;
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

// Folds each tile's per-slot (z, id) in slot order (strict z < best);
// writes (inf, -1) for a tile without rows. One-item tiles were written
// by the walk.
__global__ void __launch_bounds__(kMergeThreads)
subtile_walk_expanded_kernel_merge(const int* __restrict__ rowptr,
                                   const float* __restrict__ part,
                                   float* __restrict__ z_out,
                                   float* __restrict__ e_out, int n_slots) {
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

static_assert(kZX == 9 && kZY == kZX + 1 && kZC == kZX + 2,
              "the depth plane is read as (ZX, ZY, ZC) like an edge");

}  // namespace

extern "C" int subtile_walk_launch(const float* rows, const int* rowptr,
                                   const int* depth, float* z, float* e,
                                   int n_tiles, int tiles_x, int r_cap,
                                   int source, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (source) {
    case kPacked:
      subtile_walk_kernel<kPacked><<<n_tiles, kPix, 0, st>>>(
          rows, rowptr, depth, z, e, tiles_x, r_cap);
      break;
    case kPackedDepth:
      subtile_walk_kernel<kPackedDepth><<<n_tiles, kPix, 0, st>>>(
          rows, rowptr, depth, z, e, tiles_x, r_cap);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int subtile_walk_expanded_launch(const float* rows,
                                            const int* rowptr, float* z,
                                            float* e, float* part,
                                            int n_slots, int n_tiles,
                                            int tiles_x, int r_cap,
                                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = n_slots * kSplit < kMaxItemBlocks ? n_slots * kSplit
                                                      : kMaxItemBlocks;
  subtile_walk_expanded_kernel<<<blocks, kItemThreads, 0, st>>>(
      rows, rowptr, z, e, part, n_tiles, tiles_x, r_cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  subtile_walk_expanded_kernel_merge<<<n_tiles, kMergeThreads, 0, st>>>(
      rowptr, part, z, e, n_slots);
  return (int)cudaGetLastError();
}
