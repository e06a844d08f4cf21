// Exact-bin walk of 8 x 128 pixel tiles. Entries of tile t's bin,
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
// per chunk.
//
// What bounds it on the H100: the per-pixel plane tests (about 20
// operations per entry and pixel), not memory. The TPU walked one tile per
// grid step; one CUDA block per tile left most SMs idle and let the
// deepest bin set the time (a 1,071-entry bin walked alone on one SM).
// Design:
// - Work items of one 128-entry chunk of one tile's bin and a quarter of
//   its rows (kSplit row groups). Tile t's chunks are the global chunks
//   off0 / 128 .. (off1 - 1) / 128; chunk c of tile t takes slot
//   off0 / 128 + t + c. Slots increase with (t, c) and number at most
//   P / 128 + n_tiles, so the host sizes the grid without reading the
//   offsets, and a block finds its (tile, chunk) by a binary search over
//   the offsets: the largest t with off0(t) / 128 + t <= slot. A block
//   past the last slot in use leaves after one load.
// - One thread per column and kRows rows: every entry read from shared
//   memory (four 128-bit broadcast loads) serves kRows pixels, and the
//   column's products A*px (B6) are shared by its pixels. Each pixel's
//   planes keep the reference's rounding.
// - A tile with one chunk writes its result directly; the others write
//   partial (z, id) per slot, and bins_walk_kernel_merge folds them in slot
//   order with a strict z < best, which is the reference's merge (the
//   leftmost minimum is associative), and writes empty tiles.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kPix = kTileH * kTileW;
constexpr int kChan = 16;    // raster_bins.N_CHAN
constexpr int kChunk = 128;  // raster_bins.MM_CHUNK
constexpr int kRows = 2;     // pixels (rows of one column) per thread
constexpr int kSplit = kTileH / kRows;  // work items per chunk
constexpr int kWalkThreads = kTileW;
constexpr int kMergeThreads = 256;
static_assert(kChan == 16, "an entry is four float4s");

// The chunk count of tile t and its first slot.
__device__ __forceinline__ void tile_slots(const int* __restrict__ offsets,
                                           int t, int* n, int* s) {
  const int off0 = offsets[t];
  const int off1 = offsets[t + 1];
  *s = off0 / kChunk + t;
  *n = off1 > off0 ? (off1 - 1) / kChunk - off0 / kChunk + 1 : 0;
}

template <bool kMM>
__global__ void __launch_bounds__(kWalkThreads)
bins_walk_kernel(const float* __restrict__ data,
                 const int* __restrict__ offsets, float* __restrict__ z_out,
                 float* __restrict__ t_out, float* __restrict__ part,
                 int n_tiles, int tiles_x, int n_entries) {
  __shared__ float4 rec[kChunk * 4];
  const int slot = blockIdx.x / kSplit;
  const int group = blockIdx.x % kSplit;  // its rows
  const int col = threadIdx.x;
  const int end = offsets[n_tiles];
  if (end <= 0 || slot > (end - 1) / kChunk + n_tiles - 1) return;
  // the tile: the largest t with off0(t) / 128 + t <= slot
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
  if (c < 0 || c >= n) return;  // a slot no tile uses
  const int off0 = offsets[t];
  const int off1 = offsets[t + 1];
  const int base = (off0 / kChunk + c) * kChunk;

  // stage the chunk as one 16-float record per entry; zeros past the end
  {
    const int e = threadIdx.x;
    const bool in = base + e < n_entries;
    float v[kChan];
    if (kMM) {
      const float* src = data + (size_t)base * kChan + e;
#pragma unroll
      for (int ch = 0; ch < kChan; ++ch) v[ch] = in ? src[ch * kChunk] : 0.0f;
    } else {
      const float4* src =
          reinterpret_cast<const float4*>(data + (size_t)(base + e) * kChan);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 f = in ? src[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rec[4 * e + q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                   v[4 * q + 3]);
  }
  __syncthreads();

  const int ty = t / tiles_x, tx = t % tiles_x;
  const int row0 = group * kRows;
  const float px = (float)(col + tx * kTileW) + 0.5f;
  float py[kRows], zb[kRows], tb[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    py[i] = (float)(row0 + i + ty * kTileH) + 0.5f;
    zb[i] = INFINITY;
    tb[i] = kMM ? INFINITY : -1.0f;  // B6: the chunk's own winner
  }
  const int e0 = max(off0 - base, 0);
  const int e1 = min(off1 - base, kChunk);
  for (int e = e0; e < e1; ++e) {
    const float4 q0 = rec[4 * e], q1 = rec[4 * e + 1];
    const float4 q2 = rec[4 * e + 2], q3 = rec[4 * e + 3];
    // channels: q0 = (A0 B0 G0 A1), q1 = (B1 G1 A2 B2),
    // q2 = (G2 ZX ZY ZC), q3 = (VALID TID . .)
    if (!kMM && !(q3.x > 0.0f)) continue;
    const float id = q3.y;
    // B6: A*px, the product the reference fuses B*py onto, is the
    // column's; B6': B*py is the pixel's own
    const float a0 = q0.x * px, a1 = q0.w * px, a2 = q1.z * px;
    const float az = q2.y * px;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float w0, w1, w2, z;
      if (kMM) {
        w0 = fmaf(q0.y, py[i], a0) + q0.z;
        w1 = fmaf(q1.x, py[i], a1) + q1.y;
        w2 = fmaf(q1.w, py[i], a2) + q2.x;
        z = fmaf(q2.z, py[i], az) + q2.w;
      } else {
        w0 = fmaf(q0.x, px, q0.y * py[i]) + q0.z;
        w1 = fmaf(q0.w, px, q1.x * py[i]) + q1.y;
        w2 = fmaf(q1.z, px, q1.w * py[i]) + q2.x;
        z = fmaf(q2.y, px, q2.z * py[i]) + q2.w;
      }
      const bool ok = w0 <= 0.0f && w1 <= 0.0f && w2 <= 0.0f && z >= 0.0f &&
                      z <= 1.0f;
      if (kMM) {
        if (ok && (z < zb[i] || (z == zb[i] && id < tb[i]))) {
          zb[i] = z;
          tb[i] = id;
        }
      } else if (ok && z < zb[i]) {  // strict: the earlier entry wins ties
        zb[i] = z;
        tb[i] = id;
      }
    }
  }
  float* zo;
  float* to;
  if (n == 1) {
    zo = z_out + (size_t)t * kPix;
    to = t_out + (size_t)t * kPix;
  } else {
    zo = part + (size_t)slot * 2 * kPix;
    to = zo + kPix;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool hit = zb[i] < INFINITY;  // B6: a chunk with no winner
    zo[(row0 + i) * kTileW + col] = zb[i];
    to[(row0 + i) * kTileW + col] = hit ? tb[i] : -1.0f;
  }
}

// Folds each tile's per-slot partial results in slot order (strict z <
// best) into (z, id); writes (inf, -1) for an empty bin. One-chunk tiles
// were written by the walk.
__global__ void __launch_bounds__(kMergeThreads)
bins_walk_kernel_merge(const int* __restrict__ offsets,
                       const float* __restrict__ part,
                       float* __restrict__ z_out, float* __restrict__ t_out,
                       int n_slots) {
  const int t = blockIdx.x;
  int n, s;
  tile_slots(offsets, t, &n, &s);
  if (n == 1) return;
  for (int p = threadIdx.x; p < kPix; p += kMergeThreads) {
    float zb = INFINITY, tb = -1.0f;
    for (int c = 0; c < n && s + c < n_slots; ++c) {
      const float* zp = part + (size_t)(s + c) * 2 * kPix;
      const float z = zp[p];
      if (z < zb) {
        zb = z;
        tb = zp[kPix + p];
      }
    }
    z_out[(size_t)t * kPix + p] = zb;
    t_out[(size_t)t * kPix + p] = tb;
  }
}

}  // namespace

extern "C" int bins_walk_launch(const float* data, const int* offsets,
                                float* z, float* tid, float* part,
                                int n_slots, int n_tiles, int tiles_x,
                                int n_entries, int mm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = n_slots * kSplit;
  if (mm)
    bins_walk_kernel<true><<<blocks, kWalkThreads, 0, s>>>(
        data, offsets, z, tid, part, n_tiles, tiles_x, n_entries);
  else
    bins_walk_kernel<false><<<blocks, kWalkThreads, 0, s>>>(
        data, offsets, z, tid, part, n_tiles, tiles_x, n_entries);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bins_walk_kernel_merge<<<n_tiles, kMergeThreads, 0, s>>>(offsets, part, z,
                                                           tid, n_slots);
  return (int)cudaGetLastError();
}
