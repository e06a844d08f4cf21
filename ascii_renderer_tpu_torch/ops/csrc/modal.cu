// The modal (majority-vote) glyph smoothing stencil: per cell, a
// Boyer-Moore candidate over the (2r+1)^2 - 1 neighbours (the centre and
// UI-override neighbours excluded, the grid edge clamped), scanned dy outer,
// dx inner, both ascending (the GLSL order; Boyer-Moore depends on it);
// then a second pass counts the candidate's true votes; the cell adopts the
// candidate iff cand >= 0, votes >= thresh, cand != its own index and the
// cell is not an override.
//
// Replaces: ascii_renderer_tpu/ops/ascii_kernel.py:_kernel (Pallas, TPU),
// called through modal_filter_pallas. A batch of V grids (a view farm's
// glyph planes) is one launch, the view on the grid's z dimension; a view's
// edges clamp as a lone grid's do, so no vote crosses views. The TPU kernel DMA'd row bands with a
// 3-row halo into VMEM by hand and voted with whole-band selects; here a
// block stages its tile plus an edge-clamped halo in shared memory and each
// thread votes for a column of cells from registers.
//
// What bounds it on the H100: integer instructions. Memory traffic is ~9
// bytes a cell (int32 index and override byte in, int32 out), ~1.4 us at
// 540 x 960; the vote is 2 passes x (2r+1)^2 - 1 neighbours of a compare,
// a select and an add each, ~4.5 us at r = 2 on the 16.7 T INT32
// instructions/s of the card. Design, so that only the vote is left:
// - the radius is a template argument (modal_kernel<R, K>): both scans
//   unroll, and the centre test and loop control disappear;
// - each thread walks a column of K vertically adjacent cells, keeping the
//   (2R+1) x (2R+1) window of indices, and a bit mask of valid (not
//   override) flags a window row, in registers; both passes read them
//   there, and moving down one cell loads one new row of 2R+1 indices and
//   one 64-bit mask word from shared memory. K = 4 at 540 x 960 (faster
//   there than 1, 2 or 8); K = 1 serves small grids, whose cells are too
//   few to fill the card with 4-cell threads;
// - the valid flags are kept apart from the indices, so every int32 index
//   (negatives, -1, INT_MIN) votes as itself: no sentinel;
// - the Boyer-Moore step is written as selects, as the reference's is; a
//   warp none of whose window rows holds an override (every warp of a
//   raster frame) votes without reading the valid bits, and the second
//   pass runs only where a lane's candidate could be adopted. Both
//   branches are taken a warp at a time: taken a thread at a time they
//   diverge on scattered overrides and cost more than they save there;
// - the halo is staged a row per warp, with no division: each lane loads
//   the index and override byte of its column (and of column 32 + lane),
//   and one ballot a 32-column word turns the override bytes into the row's
//   valid mask.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;  // cells a block row: one warp
constexpr int kWarps = 4;   // block rows of threads

// The votes of a column of K cells: x0 + lane, rows y0 + r0 .. + K - 1,
// each over its (2R+1) x (2R+1) window of s_idx / s_valid (halo rows r0 ..
// r0 + K + 2R - 1). kAllValid: no neighbour in those rows is an override, so
// no valid bit is read.
template <int R, int K, bool kAllValid>
__device__ __forceinline__ void column(const int (*s_idx)[kTileW + 8],
                                       const unsigned long long* s_valid,
                                       int* __restrict__ out, int H, int W,
                                       int thresh, int lane, int r0, int x,
                                       int y) {
  constexpr int kD = 2 * R + 1;
  constexpr unsigned kRowMask = (1u << kD) - 1u;
  // the window: w[i][j] = index at (cell row - R + i, x - R + j); bit j of
  // m[i] set iff that neighbour is not an override
  int w[kD][kD];
  unsigned m[kD];
#pragma unroll
  for (int i = 0; i < 2 * R; ++i) {
#pragma unroll
    for (int j = 0; j < kD; ++j) w[i][j] = s_idx[r0 + i][lane + j];
    m[i] = kAllValid ? kRowMask
                     : (unsigned)(s_valid[r0 + i] >> lane) & kRowMask;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < kD; ++j) w[2 * R][j] = s_idx[r0 + k + 2 * R][lane + j];
    m[2 * R] = kAllValid
                   ? kRowMask
                   : (unsigned)(s_valid[r0 + k + 2 * R] >> lane) & kRowMask;
    int cand = -1, cnt = 0;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        if (i == R && j == R) continue;  // the centre does not vote
        const bool valid = kAllValid || ((m[i] >> j) & 1u);
        const int ni = w[i][j];
        // Boyer-Moore: an empty count takes ni as its candidate (count 1);
        // else a match adds one and a miss takes one away. Override
        // neighbours leave both as they were.
        const int nc = (cnt == 0) ? ni : cand;
        const int step = (ni == nc) ? 1 : -1;
        cand = valid ? nc : cand;
        cnt = valid ? cnt + step : cnt;
      }
    }
    const int base = w[R][R];
    const bool centre_valid = kAllValid || ((m[R] >> R) & 1u);
    bool adopt = cand >= 0 && cand != base && centre_valid;
    // the true votes decide only here; the warp counts them together
    // (where no lane needs them, as in a smooth region, none does)
    if (__any_sync(0xffffffffu, adopt)) {
      int votes = 0;
#pragma unroll
      for (int i = 0; i < kD; ++i) {
#pragma unroll
        for (int j = 0; j < kD; ++j) {
          if (i == R && j == R) continue;
          const bool valid = kAllValid || ((m[i] >> j) & 1u);
          votes += (valid && w[i][j] == cand) ? 1 : 0;
        }
      }
      adopt = adopt && votes >= thresh;
    }
    if (x < W && y + k < H) out[(size_t)(y + k) * W + x] = adopt ? cand : base;

#pragma unroll
    for (int i = 0; i < 2 * R; ++i) {
#pragma unroll
      for (int j = 0; j < kD; ++j) w[i][j] = w[i + 1][j];
      m[i] = m[i + 1];
    }
  }
}

// kBatch: a batch of grids, blockIdx.z the grid; a lone grid (V = 1) runs
// the instantiation without it, whose code is the one-grid kernel's (the
// plane offsets cost the K = 4 kernels 4 registers and an occupancy step)
template <int R, int K, bool kBatch>
__global__ void __launch_bounds__(kTileW * kWarps)
modal_kernel(const int* __restrict__ idx, const uint8_t* __restrict__ ovr,
             int* __restrict__ out, int H, int W, int thresh) {
  constexpr int kTileH = K * kWarps;          // cells a block column
  constexpr int kHaloH = kTileH + 2 * R;
  constexpr int kHaloW = kTileW + 2 * R;      // <= 38: two mask words
  constexpr unsigned kRowMask = (1u << (2 * R + 1)) - 1u;
  __shared__ int s_idx[kHaloH][kTileW + 8];
  __shared__ unsigned long long s_valid[kHaloH];

  if constexpr (kBatch) {  // blockIdx.z's grid, voted alone
    const size_t plane = (size_t)blockIdx.z * H * W;
    idx += plane;
    ovr += plane;
    out += plane;
  }
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  // stage: warp w takes halo rows w, w + kWarps, ...; lane l columns l and
  // 32 + l of the halo (global column x0 - R + that, clamped)
  const int xa = min(max(x0 - R + lane, 0), W - 1);
  const int xb = min(max(x0 - R + kTileW + lane, 0), W - 1);
  const bool has_b = kTileW + lane < kHaloW;
  for (int hy = warp; hy < kHaloH; hy += kWarps) {
    const size_t row = (size_t)min(max(y0 - R + hy, 0), H - 1) * W;
    s_idx[hy][lane] = idx[row + xa];
    const bool va = ovr[row + xa] == 0;
    bool vb = false;
    if (has_b) {
      s_idx[hy][kTileW + lane] = idx[row + xb];
      vb = ovr[row + xb] == 0;
    }
    const unsigned wa = __ballot_sync(0xffffffffu, va);
    const unsigned wb = __ballot_sync(0xffffffffu, vb);
    if (lane == 0) s_valid[hy] = ((unsigned long long)wb << 32) | wa;
  }
  __syncthreads();

  const int r0 = warp * K;  // this thread's first tile row
  // one branch a warp: no override among any lane's K + 2R window rows
  // (every warp of a raster frame), or some
  unsigned long long all = ~0ull;
#pragma unroll
  for (int i = 0; i < K + 2 * R; ++i) all &= s_valid[r0 + i] >> lane;
  if (__all_sync(0xffffffffu, (all & kRowMask) == kRowMask))
    column<R, K, true>(s_idx, s_valid, out, H, W, thresh, lane, r0, x0 + lane,
                       y0 + r0);
  else
    column<R, K, false>(s_idx, s_valid, out, H, W, thresh, lane, r0,
                        x0 + lane, y0 + r0);
}

template <int R, int K>
int launch(const int* idx, const uint8_t* ovr, int* out, int V, int H, int W,
           int thresh, cudaStream_t stream) {
  dim3 block(kTileW, kWarps);
  dim3 grid((W + kTileW - 1) / kTileW, (H + K * kWarps - 1) / (K * kWarps),
            V);
  if (V == 1)
    modal_kernel<R, K, false><<<grid, block, 0, stream>>>(idx, ovr, out, H, W,
                                                          thresh);
  else
    modal_kernel<R, K, true><<<grid, block, 0, stream>>>(idx, ovr, out, H, W,
                                                         thresh);
  return (int)cudaGetLastError();
}

template <int R>
int launch_k(const int* idx, const uint8_t* ovr, int* out, int V, int H,
             int W, int thresh, int k, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<R, 1>(idx, ovr, out, V, H, W, thresh, stream);
    case 4: return launch<R, 4>(idx, ovr, out, V, H, W, thresh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// V grids of H x W, one after another (V = 1: a lone grid);
// cells_per_thread: K, 1 or 4 (ops/ascii_kernel.cells_per_thread)
extern "C" int modal_launch(const int* idx, const uint8_t* ovr, int* out,
                            int V, int H, int W, int radius, int thresh,
                            int cells_per_thread, void* stream) {
  if (V < 1 || V > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int k = cells_per_thread;
  switch (radius) {
    case 1: return launch_k<1>(idx, ovr, out, V, H, W, thresh, k, s);
    case 2: return launch_k<2>(idx, ovr, out, V, H, W, thresh, k, s);
    case 3: return launch_k<3>(idx, ovr, out, V, H, W, thresh, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
