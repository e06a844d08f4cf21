// Fused-shading walk of one 8 x 128 pixel tile: visibility, perspective-
// correct interpolation and lighting in one pass, with no visibility
// buffer. The tile's bin is entries [off0, off1) of the pair-sorted table;
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
// and NaN propagates through max and clamp as in torch.clamp. The
// interpolation runs only when an entry becomes the best, which gives the
// bits of the reference's keep-where-better. Kernel and plain version
// (ops/raster_bins.tile_eval_bins_shaded_ref) agree bit for bit.
//
// What bounds it on the H100: issue rate, about 30 operations for each
// live (tile, entry) pair and each of the tile's 1,024 pixels, plus the
// interpolation on a win; the 256-byte entries are read once per tile.
// Design: one block per tile (1,024 threads, one per pixel), each chunk of
// 64 entries (16 KB) staged through shared memory with one float4 per
// thread (a broadcast read per entry and channel), the ten running values
// (z and nine attributes) in registers, the light parameters in shared
// memory. The chunk starts at off0 rounded down to 16 entries, as the
// reference's DMA does; reads past the table's end load zeros (not live).
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

__global__ void __launch_bounds__(kPix)
shaded_walk_kernel(const float* __restrict__ data,
                   const int* __restrict__ offsets,
                   const float* __restrict__ light, float* __restrict__ rgb,
                   int tiles_x, int n_entries) {
  __shared__ float4 slab4[kChunk * kChan / 4];  // [entry][channel]
  __shared__ float lp[64];
  const float* slab = reinterpret_cast<const float*>(slab4);
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int ty = t / tiles_x, tx = t % tiles_x;
  const float px = (float)(tid % kTileW + tx * kTileW) + 0.5f;
  const float py = (float)(tid / kTileW + ty * kTileH) + 0.5f;
  if (tid < 64) lp[tid] = light[tid];
  __syncthreads();  // lp is read after the walk, which may run no chunk

  const int off0 = offsets[t];
  const int off1 = offsets[t + 1];
  const int start = (off0 / kAlign) * kAlign;
  const int n_chunks = off1 > off0 ? (off1 - start + kChunk - 1) / kChunk : 0;

  float zb = INFINITY;
  float at[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const int base = start + c * kChunk;
    __syncthreads();  // previous chunk fully consumed
    // float4 tid holds channels 4 (tid % 16) .. + 3 of entry tid / 16
    slab4[tid] = base + tid / 16 < n_entries
                     ? reinterpret_cast<const float4*>(data)[(size_t)base * 16 +
                                                             tid]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int e = 0; e < kChunk; ++e) {
      const float* ent = slab + e * kChan;
      const int p = base + e;
      const bool live = p >= off0 && p < off1 && ent[kValid] > 0.0f;
      const float x0 = ent[kX], x1 = ent[kX + 1], x2 = ent[kX + 2];
      const float y0 = ent[kY], y1 = ent[kY + 1], y2 = ent[kY + 2];
      const float w0 = diff2(x2 - x1, py - y1, y2 - y1, px - x1);
      const float w1 = diff2(x0 - x2, py - y2, y0 - y2, px - x2);
      const float w2 = diff2(x1 - x0, py - y0, y1 - y0, px - x0);
      const float inv_area = 1.0f / ((w0 + w1) + w2);
      const float z =
          fmaf(w2, ent[kZ + 2], fmaf(w0, ent[kZ], w1 * ent[kZ + 1])) *
          inv_area;
      const bool ok = live && w0 <= 0.0f && w1 <= 0.0f && w2 <= 0.0f &&
                      z >= 0.0f && z <= 1.0f;
      const float zm = ok ? z : INFINITY;
      if (zm < zb) {  // strict: the earlier (smaller tri id) entry wins ties
        zb = zm;
        // perspective-correct barycentrics, then the 9 attributes
        const float bw0 = w0 * ent[kIW], bw1 = w1 * ent[kIW + 1],
                    bw2 = w2 * ent[kIW + 2];
        const float dnm = (bw0 + bw1) + bw2;
        const float inv_dnm = 1.0f / (fabsf(dnm) < 1e-30f ? 1e-30f : dnm);
        const float p0 = bw0 * inv_dnm, p1 = bw1 * inv_dnm,
                    p2 = bw2 * inv_dnm;
#pragma unroll
        for (int a = 0; a < 9; ++a)
          at[a] = fmaf(p2, ent[kAttr + 18 + a],
                       fmaf(p0, ent[kAttr + a], p1 * ent[kAttr + 9 + a]));
      }
    }
  }

  float nx = at[0], ny = at[1], nz = at[2];
  const float cr = at[3], cg = at[4], cb = at[5];
  const float wx = at[6], wy = at[7], wz = at[8];
  const float inv_nl = rsqrt_ieee(maxn(fmaf(nz, nz, fmaf(nx, nx, ny * ny)),
                                       1e-24f));
  nx = nx * inv_nl;
  ny = ny * inv_nl;
  nz = nz * inv_nl;
  const float ndl =
      maxn(-fmaf(nz, lp[5], fmaf(nx, lp[3], ny * lp[4])), 0.0f);
  const float col[3] = {cr, cg, cb};
  float out[3];
  float lit[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lit[k] = fmaf(lp[6 + k], ndl, lp[k]);
    out[k] = col[k] * lit[k];
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
        out[k] = fmaf(col[k], lit[k], (col[k] * lp[b + 3 + k]) * on);
      else
        out[k] = fmaf(col[k] * lp[b + 3 + k], on, out[k]);
    }
  }
  const bool hit = zb < INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    rgb[((size_t)t * 3 + k) * kPix + tid] =
        hit ? clampn(out[k], 0.0f, 1.0f) : 0.0f;
}

}  // namespace

extern "C" int shaded_walk_launch(const float* data, const int* offsets,
                                  const float* light, float* rgb, int n_tiles,
                                  int tiles_x, int n_entries, void* stream) {
  shaded_walk_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
      data, offsets, light, rgb, tiles_x, n_entries);
  return (int)cudaGetLastError();
}
