// Fused-shading walk of 8 x 128 pixel tiles: visibility, perspective-
// correct interpolation and lighting, with no visibility buffer in device
// memory. Tile t's bin is entries [off0, off1) of the pair-sorted table;
// an entry is 64 channels (ops/raster_bins.py S_*): a valid flag, the three
// screen vertices x, y, z and their 1/w, and 9 attributes per vertex
// (normal, colour, world position). Each pixel keeps the nearest entry with
// every edge function <= 0 and 0 <= z <= 1 (strict z < best in bin order,
// so the smallest triangle id wins a depth tie) and the winner's
// interpolated attributes; then ambient + one directional + up to 8 point
// lights (attenuation 1 / (1 + 0.05 d^2)), clamped to [0, 1], black where
// nothing hit.
//
// Replaces: ascii_renderer_tpu/ops/raster_bins.py:_shaded_kernel (B8,
// Pallas, TPU; called through tile_eval_bins_shaded).
//
// Exactness: every chain rounds as the reference's compiler rounds it on
// the CPU (explicit fmaf, -fmad=false): the edge functions in vertex form
// (x2 - x1)(py - y1) - (y2 - y1)(px - x1) with the left product fused,
// z = fma(w2, z2, fma(w0, z0, w1 z1)) / area as a product with the IEEE
// reciprocal, the attribute sums fused alike; rsqrt is 1 / sqrtf, and the
// comparisons stay as written, so a degenerate entry (z = NaN) never wins
// and NaN propagates through max and clamp as in torch.clamp. Kernel and
// plain version (ops/raster_bins.tile_eval_bins_shaded_ref) agree bit for
// bit.
//
// What bounds it on the H100: issue rate, about 30 operations for each
// live (tile, entry) pair and each of the tile's 1,024 pixels; the
// 256-byte entries are read once per tile. One block per tile left most
// SMs idle while the deepest bins of the silhouette walked alone, a
// 1,024-thread block capped the registers at 64 (the ten running values
// spilled), and every test paid an IEEE division. Design:
// - Work items of one 64-entry chunk of one tile's bin and a quarter of
//   its rows. A chunk starts at off0 rounded down to 16 entries, as the
//   reference's DMA does, plus a multiple of 64; chunk c of tile t takes
//   slot off0 / 64 + t + c. Slots increase with (t, c) and number fewer
//   than offsets[n_tiles] / 64 + n_tiles, which the kernel reads: its
//   blocks (at most 2,048: the table behind the bins may be ten times
//   longer than the binned entries) stride over the items below that
//   bound, and find each item's (tile, chunk) by a binary search over the
//   offsets.
// - The walk keeps (z, entry index) per pixel, two pixels (rows of one
//   column) per thread: each chunk entry is staged once as a 16-float
//   record (its vertices, the edge vectors, the depths and its live flag:
//   off0 <= p < off1 and valid > 0, zeros read past the table), the
//   column's products (y_j - y_i)(px - x_i) serve both rows, and the
//   division and depth run only where all three edges pass.
// - A merge launch folds a tile's items in slot order with a strict
//   z < best (the leftmost minimum, as the reference's walk in bin order
//   keeps), then recomputes the winner's edge functions, barycentrics and
//   9 attributes from the winning entry with the walk's expressions (the
//   bits of the reference's keep-where-better), and lights the pixel.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kPix = kTileH * kTileW;
constexpr int kChan = 64;   // raster_bins.NS_CHAN
constexpr int kChunk = 64;  // raster_bins.S_CHUNK entries per chunk
constexpr int kAlign = 16;  // 8 * NS_PACK: the chunk start's alignment
constexpr int kValid = 0, kX = 1, kY = 4, kZ = 7, kIW = 10, kAttr = 13;
constexpr int kMaxPl = 8;   // raster_bins.L_MAX_PL
constexpr int kRows = 2;    // pixels (rows of one column) per walk thread
constexpr int kSplit = kTileH / kRows;  // work items per chunk
constexpr int kWalkThreads = kTileW;
constexpr int kMaxWalkBlocks = 2048;  // ~16 blocks of 128 threads an SM
constexpr int kMergeThreads = 256;
constexpr int kFold = 8;    // partials a merge thread loads at once

// NaN-propagating max / clamp (torch.clamp, jnp.maximum, jnp.clip)
__device__ __forceinline__ float maxn(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float clampn(float x, float lo, float hi) {
  if (x != x) return x;
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float rsqrt_ieee(float x) {
  return 1.0f / sqrtf(x);
}
// a*b - c*d with the left product fused
__device__ __forceinline__ float diff2(float a, float b, float c, float d) {
  return fmaf(a, b, -(c * d));
}

// The chunk count of tile t and its first slot.
__device__ __forceinline__ void tile_slots(const int* __restrict__ offsets,
                                           int t, int* n, int* s) {
  const int off0 = offsets[t];
  const int off1 = offsets[t + 1];
  const int start = (off0 / kAlign) * kAlign;
  *s = off0 / kChunk + t;
  *n = off1 > off0 ? (off1 - start + kChunk - 1) / kChunk : 0;
}

__global__ void __launch_bounds__(kWalkThreads)
shaded_walk_kernel(const float* __restrict__ data,
                   const int* __restrict__ offsets, float* __restrict__ part,
                   int n_tiles, int tiles_x, int n_entries) {
  __shared__ float4 rec[kChunk * 4];
  const int col = threadIdx.x;
  // items in use lie below this bound; the grid strides over them
  const int limit = (offsets[n_tiles] / kChunk + n_tiles) * kSplit;
  for (int item = blockIdx.x; item < limit; item += gridDim.x) {
    const int slot = item / kSplit;
    const int group = item % kSplit;  // its rows
    // the tile: the largest t with off0(t) / 64 + t <= slot
    int lo = 0, hi = n_tiles - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (offsets[mid] / kChunk + mid <= slot) lo = mid;
      else hi = mid - 1;
    }
    const int t = lo;
    int n, s;
    tile_slots(offsets, t, &n, &s);
    const int c = slot - s;
    if (c < 0 || c >= n) continue;  // a slot no tile uses (block-uniform)
    const int off0 = offsets[t];
    const int off1 = offsets[t + 1];
    const int base = (off0 / kAlign) * kAlign + c * kChunk;

    __syncthreads();  // the previous item's records fully consumed
    // stage the chunk as one 16-float record per entry: (x0 x1 x2 x2-x1)
    // (y0 y1 y2 y2-y1) (x0-x2 y0-y2 x1-x0 y1-y0) (z0 z1 z2 live)
    if (threadIdx.x < kChunk) {
      const int e = threadIdx.x;
      const int p = base + e;
      float v[12];
      const float4* src =
          reinterpret_cast<const float4*>(data) + (size_t)p * 16;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 f =
            p < n_entries ? src[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
      const float x0 = v[kX], x1 = v[kX + 1], x2 = v[kX + 2];
      const float y0 = v[kY], y1 = v[kY + 1], y2 = v[kY + 2];
      const bool live = p >= off0 && p < off1 && v[kValid] > 0.0f;
      rec[4 * e] = make_float4(x0, x1, x2, x2 - x1);
      rec[4 * e + 1] = make_float4(y0, y1, y2, y2 - y1);
      rec[4 * e + 2] = make_float4(x0 - x2, y0 - y2, x1 - x0, y1 - y0);
      rec[4 * e + 3] = make_float4(v[kZ], v[kZ + 1], v[kZ + 2],
                                   live ? 1.0f : 0.0f);
    }
    __syncthreads();

    const int ty = t / tiles_x, tx = t % tiles_x;
    const int row0 = group * kRows;
    const float px = (float)(col + tx * kTileW) + 0.5f;
    float py[kRows], zb[kRows];
    int eb[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      py[i] = (float)(row0 + i + ty * kTileH) + 0.5f;
      zb[i] = INFINITY;
      eb[i] = -1;
    }
    const int e0 = max(off0 - base, 0);
    const int e1 = min(off1 - base, kChunk);
    for (int e = e0; e < e1; ++e) {
      const float4 q3 = rec[4 * e + 3];
      if (!(q3.w > 0.0f)) continue;  // not live: the same for every pixel
      const float4 qx = rec[4 * e], qy = rec[4 * e + 1];
      const float4 qd = rec[4 * e + 2];
      // the column's halves: -(y_j - y_i) (px - x_i)
      const float m0 = -(qy.w * (px - qx.y));
      const float m1 = -(qd.y * (px - qx.z));
      const float m2 = -(qd.w * (px - qx.x));
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float w0 = fmaf(qx.w, py[i] - qy.y, m0);
        const float w1 = fmaf(qd.x, py[i] - qy.z, m1);
        const float w2 = fmaf(qd.z, py[i] - qy.x, m2);
        if (w0 <= 0.0f && w1 <= 0.0f && w2 <= 0.0f) {
          const float inv_area = 1.0f / ((w0 + w1) + w2);
          const float z =
              fmaf(w2, q3.z, fmaf(w0, q3.x, w1 * q3.y)) * inv_area;
          // strict: the earlier (smaller tri id) entry wins ties
          if (z >= 0.0f && z <= 1.0f && z < zb[i]) {
            zb[i] = z;
            eb[i] = base + e;
          }
        }
      }
    }
    float* zo = part + (size_t)slot * 2 * kPix;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      zo[(row0 + i) * kTileW + col] = zb[i];
      zo[kPix + (row0 + i) * kTileW + col] = __int_as_float(eb[i]);
    }
  }
}

// The winner's perspective-correct attributes, lit: rgb of one pixel.
__device__ void shade(const float* __restrict__ ent, float px, float py,
                      const float* lp, float out[3]) {
  const float x0 = ent[kX], x1 = ent[kX + 1], x2 = ent[kX + 2];
  const float y0 = ent[kY], y1 = ent[kY + 1], y2 = ent[kY + 2];
  const float w0 = diff2(x2 - x1, py - y1, y2 - y1, px - x1);
  const float w1 = diff2(x0 - x2, py - y2, y0 - y2, px - x2);
  const float w2 = diff2(x1 - x0, py - y0, y1 - y0, px - x0);
  const float bw0 = w0 * ent[kIW], bw1 = w1 * ent[kIW + 1],
              bw2 = w2 * ent[kIW + 2];
  const float dnm = (bw0 + bw1) + bw2;
  const float inv_dnm = 1.0f / (fabsf(dnm) < 1e-30f ? 1e-30f : dnm);
  const float p0 = bw0 * inv_dnm, p1 = bw1 * inv_dnm, p2 = bw2 * inv_dnm;
  float at[9];
#pragma unroll
  for (int a = 0; a < 9; ++a)
    at[a] = fmaf(p2, ent[kAttr + 18 + a],
                 fmaf(p0, ent[kAttr + a], p1 * ent[kAttr + 9 + a]));

  float nx = at[0], ny = at[1], nz = at[2];
  const float wx = at[6], wy = at[7], wz = at[8];
  const float inv_nl = rsqrt_ieee(maxn(fmaf(nz, nz, fmaf(nx, nx, ny * ny)),
                                       1e-24f));
  nx = nx * inv_nl;
  ny = ny * inv_nl;
  nz = nz * inv_nl;
  const float ndl =
      maxn(-fmaf(nz, lp[5], fmaf(nx, lp[3], ny * lp[4])), 0.0f);
  float lit[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lit[k] = fmaf(lp[6 + k], ndl, lp[k]);
    out[k] = at[3 + k] * lit[k];
  }
  const float n_pl = lp[9];
#pragma unroll
  for (int i = 0; i < kMaxPl; ++i) {
    const int b = 10 + 6 * i;
    const float lx = lp[b] - wx, ly = lp[b + 1] - wy, lz = lp[b + 2] - wz;
    const float d2 = maxn(fmaf(lz, lz, fmaf(lx, lx, ly * ly)), 1e-4f);
    const float ndlp =
        maxn(fmaf(nz, lz, fmaf(nx, lx, ny * ly)) * rsqrt_ieee(d2), 0.0f);
    const float att = 1.0f / fmaf(d2, 0.05f, 1.0f);
    const float on = n_pl > (float)i + 0.5f ? ndlp * att : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // out + (c * col) * on: the first light's add sees two products and
      // fuses the left one, c * lit
      if (i == 0)
        out[k] = fmaf(at[3 + k], lit[k], (at[3 + k] * lp[b + 3 + k]) * on);
      else
        out[k] = fmaf(at[3 + k] * lp[b + 3 + k], on, out[k]);
    }
  }
}

// Folds each tile's per-slot (z, entry) in slot order (strict z < best)
// and shades each pixel from its winning entry; black where none.
__global__ void __launch_bounds__(kMergeThreads)
shaded_walk_kernel_merge(const float* __restrict__ data,
                         const int* __restrict__ offsets,
                         const float* __restrict__ light,
                         const float* __restrict__ part,
                         float* __restrict__ rgb, int tiles_x, int n_slots) {
  __shared__ float lp[64];
  const int t = blockIdx.x;
  if (threadIdx.x < 64) lp[threadIdx.x] = light[threadIdx.x];
  __syncthreads();
  int n, s;
  tile_slots(offsets, t, &n, &s);
  const int ty = t / tiles_x, tx = t % tiles_x;
  const int m = min(n, n_slots - s);
  for (int p = threadIdx.x; p < kPix; p += kMergeThreads) {
    // kFold partial depths loaded together, then folded in slot order: the
    // loads of a deep bin's chunks overlap instead of queueing one by one
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
    float out[3] = {0.0f, 0.0f, 0.0f};
    if (win >= 0) {
      const int eb =
          __float_as_int(part[(size_t)(s + win) * 2 * kPix + kPix + p]);
      const float px = (float)(p % kTileW + tx * kTileW) + 0.5f;
      const float py = (float)(p / kTileW + ty * kTileH) + 0.5f;
      shade(data + (size_t)eb * kChan, px, py, lp, out);
#pragma unroll
      for (int k = 0; k < 3; ++k) out[k] = clampn(out[k], 0.0f, 1.0f);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[((size_t)t * 3 + k) * kPix + p] = out[k];
  }
}

}  // namespace

extern "C" int shaded_walk_launch(const float* data, const int* offsets,
                                  const float* light, float* rgb, float* part,
                                  int n_slots, int n_tiles, int tiles_x,
                                  int n_entries, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = n_slots * kSplit < kMaxWalkBlocks ? n_slots * kSplit
                                                      : kMaxWalkBlocks;
  shaded_walk_kernel<<<blocks, kWalkThreads, 0, st>>>(
      data, offsets, part, n_tiles, tiles_x, n_entries);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  shaded_walk_kernel_merge<<<n_tiles, kMergeThreads, 0, st>>>(
      data, offsets, light, part, rgb, tiles_x, n_slots);
  return (int)cudaGetLastError();
}
