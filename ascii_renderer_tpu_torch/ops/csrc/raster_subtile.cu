// Channel-era subtile walks. Each 8 x 128 pixel tile walks its 8 column
// bins of 8 x 16 pixels side by side: lane l is in lane group g = l / 16,
// and row r of the tile's range [rowptr[t], rowptr[t+1]) holds, for each
// group, the r-th entry of bin (t, g) (ops/raster_subtile.py describes the
// layouts). Each pixel keeps the nearest covering entry: all three edge
// planes <= 0, 0 <= z <= 1, and a strict z < best merge in row order, so
// the smallest triangle id wins depth ties.
//
// One template, three entry sources (one kernel, selected per launch):
//   kExpanded     rows [r_cap, 16, 128], channel c of group g broadcast
//                 over lanes 16g..16g+15; chunks of 8 rows. Replaces
//                 ascii_renderer_tpu/ops/raster_subtile.py:_kernel (B9a)
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
// The chunk start is clamped to r_cap - chunk exactly where the reference
// clamps it, so an overflowing r_cap re-reads the same rows.
//
// What bounds them on the H100: issue rate of the per-pixel test, not
// memory: every 64-byte entry is tested by its bin's 128 pixels, about 20
// operations each. Design: one block per tile (1,024 threads, one per
// pixel), each chunk staged through shared memory (8 rows x 8 groups x 16
// channels = 4 KB for kExpanded, reading only lane 16g of each channel;
// 32 packed rows = 16 KB, one float4 per thread, for kPacked*), the
// running (z, id) in registers. No cp.async double buffering yet.
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

enum Source { kExpanded = 0, kPacked = 1, kPackedDepth = 2 };

template <Source S>
__device__ __forceinline__ float plane(const float* ent, int ca, float x,
                                       float lx, float bx, float y) {
  const float a = ent[ca], b = ent[ca + 1], g = ent[ca + 2];
  if (S == kExpanded) return fmaf(a, x, b * y) + g;
  const float p = a * lx + g;  // two roundings: the reference's dot
  return fmaf(b, y, fmaf(bx, a, p));
}

template <Source S>
__global__ void __launch_bounds__(kPix)
subtile_walk_kernel(const float* __restrict__ rows,
                    const int* __restrict__ rowptr,
                    const int* __restrict__ depth, float* __restrict__ z_out,
                    float* __restrict__ e_out, int tiles_x, int r_cap) {
  constexpr int kChunk = S == kExpanded ? 8 : 32;  // CHUNK_R, CHUNK_RP
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
    if (S == kExpanded) {
      // thread tid stages channel tid % 16 of group (tid / 16) % 8 of row
      // tid / 128: lane 16 g of that channel's 128 lanes
      const int r = tid / kTileW, gg = (tid / kChan) % kNSub, cc = tid % kChan;
      reinterpret_cast<float*>(slab4)[tid] =
          rows[((size_t)(start + r) * kChan + cc) * kTileW + gg * kSubW];
    } else {
      slab4[tid] = reinterpret_cast<const float4*>(
          rows + (size_t)start * kTileW)[tid];
    }
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

static_assert(kZX == 9 && kZY == kZX + 1 && kZC == kZX + 2,
              "the depth plane is read as (ZX, ZY, ZC) like an edge");

}  // namespace

extern "C" int subtile_walk_launch(const float* rows, const int* rowptr,
                                   const int* depth, float* z, float* e,
                                   int n_tiles, int tiles_x, int r_cap,
                                   int source, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (source) {
    case kExpanded:
      subtile_walk_kernel<kExpanded><<<n_tiles, kPix, 0, st>>>(
          rows, rowptr, depth, z, e, tiles_x, r_cap);
      break;
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
