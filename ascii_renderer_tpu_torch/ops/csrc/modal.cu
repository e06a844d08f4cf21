// The modal (majority-vote) glyph smoothing stencil: per cell, a
// Boyer-Moore candidate over the (2r+1)^2 - 1 neighbours (the centre and
// UI-override neighbours excluded, the grid edge clamped), scanned dy outer,
// dx inner, both ascending (the GLSL order; Boyer-Moore depends on it);
// then a second pass counts the candidate's true votes; the cell adopts the
// candidate iff cand >= 0, votes >= thresh, cand != its own index and the
// cell is not an override.
//
// Replaces: ascii_renderer_tpu/ops/ascii_kernel.py:_kernel (Pallas, TPU),
// called through modal_filter_pallas. The TPU kernel DMA'd row bands with a
// 3-row halo into VMEM by hand; here a block stages its tile plus a
// 3-cell edge-clamped halo of idx and override in shared memory.
//
// What bounds it on the H100: device memory traffic, about 5 bytes read
// (int32 index + override byte) and 4 written per cell; at 3.35 TB/s the
// 540 x 960 grid is ~1.4 us. The 48 compare-and-select steps per cell at
// r = 3 are ~100 integer ops from shared memory, also far under the card's
// issue rate. Design: 32 x 8 cells per block, one thread per cell, the
// (8 + 6) x (32 + 6) halo tile loaded once with clamped coordinates, both
// passes over shared memory, one coalesced int32 store per cell.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 3;  // MAX_MODE_RADIUS (ascii_pass_shader.js:83)
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHaloW = kTileW + 2 * kPad;
constexpr int kHaloH = kTileH + 2 * kPad;

__global__ void __launch_bounds__(kTileW * kTileH)
modal_kernel(const int* __restrict__ idx, const uint8_t* __restrict__ ovr,
             int* __restrict__ out, int H, int W, int radius, int thresh) {
  __shared__ int s_idx[kHaloH][kHaloW];
  __shared__ uint8_t s_ovr[kHaloH][kHaloW];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int k = tid; k < kHaloH * kHaloW; k += kTileW * kTileH) {
    const int hy = k / kHaloW, hx = k % kHaloW;
    const int y = min(max(y0 + hy - kPad, 0), H - 1);
    const int x = min(max(x0 + hx - kPad, 0), W - 1);
    s_idx[hy][hx] = idx[(size_t)y * W + x];
    s_ovr[hy][hx] = ovr[(size_t)y * W + x];
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + kPad, cx = threadIdx.x + kPad;

  int cand = -1, cnt = 0;
  for (int dy = -radius; dy <= radius; ++dy) {
    for (int dx = -radius; dx <= radius; ++dx) {
      if (dy == 0 && dx == 0) continue;
      if (s_ovr[cy + dy][cx + dx]) continue;  // override cells do not vote
      const int ni = s_idx[cy + dy][cx + dx];
      if (cnt == 0) {
        cand = ni;
        cnt = 1;
      } else {
        cnt += (ni == cand) ? 1 : -1;
      }
    }
  }
  int votes = 0;
  for (int dy = -radius; dy <= radius; ++dy)
    for (int dx = -radius; dx <= radius; ++dx)
      if (!(dy == 0 && dx == 0) && !s_ovr[cy + dy][cx + dx] &&
          s_idx[cy + dy][cx + dx] == cand)
        ++votes;
  const int base = s_idx[cy][cx];
  const bool adopt =
      cand >= 0 && votes >= thresh && cand != base && !s_ovr[cy][cx];
  out[(size_t)y * W + x] = adopt ? cand : base;
}

}  // namespace

extern "C" int modal_launch(const int* idx, const uint8_t* ovr, int* out,
                            int H, int W, int radius, int thresh,
                            void* stream) {
  dim3 block(kTileW, kTileH);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  modal_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(idx, ovr, out, H, W,
                                                         radius, thresh);
  return (int)cudaGetLastError();
}
