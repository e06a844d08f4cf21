// Exact-bin walk of one 8 x 128 pixel tile. Entries of the tile's bin,
// [off0, off1) in sorted (tile, tri) pair order, are plane-form triangles:
// three edge planes w_k = A_k px + B_k py + G_k (inside <=> every w_k <= 0)
// and the screen-depth plane z = ZX px + ZY py + ZC. Each pixel keeps the
// nearest entry with 0 <= z <= 1.
//
// Replaces: ascii_renderer_tpu/ops/raster_bins.py:_kernel_mm (B6, Pallas,
// TPU; called through tile_eval_bins_mm) and :_kernel (B6', the same walk
// as a scalar loop; tile_eval_bins). One template serves both:
//   kMM = true  (B6):  entries in channel-major 128-entry chunks
//                      [P/128, 16, 128]; the chunk's winner is the least z,
//                      then the least triangle id among equal z; chunks
//                      merge with a strict z < best. The planes round as
//                      the reference's K = 3 dot does on its compiler:
//                      (B*py fused onto A*px) + G.
//   kMM = false (B6'): row-major entries [P, 16]; entries with
//                      CH_VALID <= 0 are skipped; strict z < best in bin
//                      order. The planes round as (A*px fused onto B*py)
//                      + G, the reference loop kernel's contraction.
// Chunks start at multiples of 128 entries, as B6's do: its tie rule is
// per chunk. Both flags read the chunk's 2,048 floats from the same
// addresses (base * 16 + i); only the (channel, entry) of float i differs.
//
// What bounds it on the H100: the per-pixel plane tests (about 20 flops
// per entry and pixel; every entry is tested by the tile's 1,024 pixels),
// not memory. Design: one block per tile, one thread per pixel, each
// 128-entry chunk (8 KB) staged through shared memory (a broadcast read
// per entry and channel), the running (z, id) in registers. A tile with an
// empty bin runs no chunk. No cp.async double buffering yet.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kPix = kTileH * kTileW;
constexpr int kChan = 16;    // raster_bins.N_CHAN
constexpr int kChunk = 128;  // raster_bins.MM_CHUNK
constexpr int kValid = 12, kTid = 13;

template <bool kMM>
__device__ __forceinline__ float plane(float a, float b, float g, float px,
                                       float py) {
  if (kMM) return fmaf(b, py, a * px) + g;
  return fmaf(a, px, b * py) + g;
}

template <bool kMM>
__global__ void __launch_bounds__(kPix)
bins_walk_kernel(const float* __restrict__ data,
                 const int* __restrict__ offsets, float* __restrict__ z_out,
                 float* __restrict__ t_out, int tiles_x, int n_entries) {
  __shared__ float chunk[kChan][kChunk + 1];  // +1: no bank conflicts
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int ty = t / tiles_x, tx = t % tiles_x;
  const float px = (float)(tid % kTileW + tx * kTileW) + 0.5f;
  const float py = (float)(tid / kTileW + ty * kTileH) + 0.5f;

  const int off0 = offsets[t];
  const int off1 = offsets[t + 1];
  const int start = (off0 / kChunk) * kChunk;
  const int n_chunks = off1 > off0 ? (off1 - start + kChunk - 1) / kChunk : 0;

  float zb = INFINITY;
  float tb = -1.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = start + c * kChunk;
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < kChan * kChunk; i += kPix) {
      const int e = kMM ? i % kChunk : i / kChan;
      const int ch = kMM ? i / kChunk : i % kChan;
      chunk[ch][e] =
          base + e < n_entries ? data[(size_t)base * kChan + i] : 0.0f;
    }
    __syncthreads();
    float zc = INFINITY;  // B6: the chunk's own winner
    float tc = INFINITY;
    for (int e = 0; e < kChunk; ++e) {
      const int p = base + e;
      bool ok = p >= off0 && p < off1;
      if (!kMM) ok = ok && chunk[kValid][e] > 0.0f;
      const float w0 = plane<kMM>(chunk[0][e], chunk[1][e], chunk[2][e], px,
                                  py);
      const float w1 = plane<kMM>(chunk[3][e], chunk[4][e], chunk[5][e], px,
                                  py);
      const float w2 = plane<kMM>(chunk[6][e], chunk[7][e], chunk[8][e], px,
                                  py);
      const float z = plane<kMM>(chunk[9][e], chunk[10][e], chunk[11][e], px,
                                 py);
      ok = ok && w0 <= 0.0f && w1 <= 0.0f && w2 <= 0.0f && z >= 0.0f &&
           z <= 1.0f;
      if (!ok) continue;
      const float id = chunk[kTid][e];
      if (kMM) {
        if (z < zc || (z == zc && id < tc)) {
          zc = z;
          tc = id;
        }
      } else if (z < zb) {  // strict: the earlier entry wins ties
        zb = z;
        tb = id;
      }
    }
    if (kMM && zc < zb) {
      zb = zc;
      tb = tc;
    }
  }
  z_out[(size_t)t * kPix + tid] = zb;
  t_out[(size_t)t * kPix + tid] = tb;
}

}  // namespace

extern "C" int bins_walk_launch(const float* data, const int* offsets,
                                float* z, float* tid, int n_tiles, int tiles_x,
                                int n_entries, int mm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mm)
    bins_walk_kernel<true><<<n_tiles, kPix, 0, s>>>(data, offsets, z, tid,
                                                     tiles_x, n_entries);
  else
    bins_walk_kernel<false><<<n_tiles, kPix, 0, s>>>(data, offsets, z, tid,
                                                      tiles_x, n_entries);
  return (int)cudaGetLastError();
}
