// Depth-grouped skip-window bin walk. One group = 8 depth-similar bins of
// 8 x 16 pixels, laid side by side as an 8 x 128 pixel block (lane l is in
// bin slot g = l / 16). Row r of rows128 holds, in lanes 16g..16g+15, the
// 16 walk channels of the r-th entry of slot g's bin. Each pixel keeps the
// nearest covering entry: all three edge planes <= 0, 0 <= z <= 1, the
// entry index inside the bin's [skip, skip + depth) window, and a strict
// z < best merge, so the smallest triangle id wins depth ties.
//
// Replaces: ascii_renderer_tpu/ops/raster_group.py:_kernel_grouped_skip
// (Pallas, TPU), called through tile_eval_grouped_skip. The TPU kernel
// expanded each slab through an MXU selection dot to broadcast channels to
// lanes; here each thread reads its slot's channels from shared memory
// (a 16-way broadcast), so no expand matrix exists.
//
// What bounds it on the H100: issue rate of the per-pixel test, not memory:
// every 512-byte row is used by 1024 pixels (about 20 flops each). Design:
// one block per group (grid = grp_cap), one thread per pixel (1024
// threads), the group's rows staged through shared memory in CHUNK-row
// slabs of 16 KB with one float4 load per thread, and the running (z, id)
// kept in registers. Rows past rowptr[t + 1] are never read.
//
// Exactness: w = (C + A*x) + B*y in the op order of raster_group.py:341-364,
// both products fused as the reference's compiler fuses them (explicit
// fmaf; -fmad=false keeps anything else from fusing), so the winners and
// depths equal the plain-torch version (ops/raster_group.py) and the JAX
// walk bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 32;     // rows per slab (= raster_group.CHUNK_RG)
constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kSubW = 16;
constexpr int kThreads = kTileH * kTileW;

// walk-entry channels (ops/raster_subtile.py): edge k has its x, y and
// constant coefficients at 3k, 3k + 1 and 3k + 2
constexpr int kZX = 9, kZY = 10, kZC = 11, kPair = 12;

__global__ void __launch_bounds__(kThreads)
walk_grouped_skip_kernel(const float* __restrict__ rows128,
                         const int* __restrict__ rowptr,
                         const int* __restrict__ gdepth,
                         const int* __restrict__ gskip,
                         const float* __restrict__ xl,
                         const float* __restrict__ yl, float* __restrict__ z_out,
                         float* __restrict__ e_out, int r_cap) {
  __shared__ float4 slab[kChunk * kTileW / 4];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = tid / kTileW;  // pixel row inside the group block
  const int l = tid % kTileW;  // lane
  const int g = l / kSubW;     // bin slot

  const int r0 = rowptr[t];
  const int r1 = rowptr[t + 1];
  const int n_chunks = (r1 - r0) / kChunk;
  const float x = xl[t * kTileW + l];
  const float y = ((float)s + 0.5f) + yl[t * kTileW + l];
  const int depth = gdepth[t * 8 + g];
  const int skip = gskip[t * 8 + g];
  const int max_start = r_cap - kChunk;

  float zb = INFINITY;
  float eb = -1.0f;
  const float* buf = reinterpret_cast<const float*>(slab) + g * kSubW;
  for (int c = 0; c < n_chunks; ++c) {
    const int start = min(r0 + c * kChunk, max_start);
    __syncthreads();  // previous slab fully consumed
    slab[tid] = reinterpret_cast<const float4*>(rows128 +
                                                (size_t)start * kTileW)[tid];
    __syncthreads();
    const int d0 = c * kChunk;
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      const float* ent = buf + r * kTileW;
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
  z_out[(size_t)t * kThreads + tid] = zb;
  e_out[(size_t)t * kThreads + tid] = eb;
}

}  // namespace

extern "C" int walk_grouped_skip_launch(const float* rows128,
                                        const int* rowptr, const int* gdepth,
                                        const int* gskip, const float* xl,
                                        const float* yl, float* z, float* e,
                                        int r_cap, int grp_cap, void* stream) {
  walk_grouped_skip_kernel<<<grp_cap, kThreads, 0, (cudaStream_t)stream>>>(
      rows128, rowptr, gdepth, gskip, xl, yl, z, e, r_cap);
  return (int)cudaGetLastError();
}
