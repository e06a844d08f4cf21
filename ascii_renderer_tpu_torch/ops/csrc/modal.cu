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
//
// The chars form (X12's second launch: ascii/ascii_pass.glyph_decide and
// glyph_from_index from a frame's bytes to its chars): the same kernel,
// instantiated with kChars, so that the int form's code stays as it was
// (runtime branches for the form slowed the int form by a quarter to
// three quarters at 540 x 960), its inputs a Glyph by value:
// - as it stages its window it forms each cell's ramp index from the
//   cell's rgb bytes (core/quantize.quantize_index: the byte sum over 3,
//   over 255, both IEEE divisions, the clamp to 1 - 1e-6, then x * n and
//   + 0.5 each rounded on its own, floor, the clamp to [0, n]; a block
//   forms the index of every byte sum 0..765 while its window's loads are
//   in flight, and each cell takes its sum's: with the divisions in the
//   staging's own path the launch took about twice as long),
//   or reads a given index plane; and each cell's override flag from its
//   alpha byte (2..254, core/quantize.is_override) instead of an override
//   plane;
// - it writes chars: the voted index's ramp code, or the alpha byte at an
//   override cell. The codes are a device copy the wrapper makes once for
//   each ramp, read through the read-only cache (a ramp's few bytes stay
//   in L1 for the whole launch).
// Without the vote (mode filter off) glyph_map_kernel does the same a
// thread a cell. The int form (modal_launch) runs with an empty Glyph.
// The kernels copy the Glyph's fields into registers: a kernel parameter
// passed on by reference is copied to every thread's local memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;  // cells a block row: one warp
constexpr int kWarps = 4;   // block rows of threads
constexpr int kOverrideMin = 2, kOverrideMax = 254;  // core/quantize.py
// float32(1 - 1e-6), quantize_index's upper clamp
constexpr float kClampHi = 0x1.ffffdep-1f;

constexpr int kByteSums = 3 * 255 + 1;  // the sums of a cell's rgb bytes

// What the chars form reads and writes beyond the int form's planes; all
// null (n_codes 0) in the int form.
struct Glyph {
  const uint8_t* rgb;        // non-null: indices from these bytes [.., 3]
  const uint8_t* alpha;      // non-null: overrides from these bytes, and
  uint8_t* chars;            // the chars written here
  const uint8_t* codes;      // the ramp's n_codes codes, on the device
  float n;                   // ramp length - 1, quantize_index's n
  int n_codes;
};

// quantize_index of a cell whose rgb bytes sum to s
__device__ __forceinline__ int quantize_sum(int s, float n) {
  float x = __fdiv_rn(__fdiv_rn((float)s, 3.0f), 255.0f);
  x = x > kClampHi ? kClampHi : x;  // s >= 0: x >= 0
  float t = floorf(__fadd_rn(__fmul_rn(x, n), 0.5f));
  t = t < 0.0f ? 0.0f : (t > n ? n : t);
  return (int)t;
}

__device__ __forceinline__ int byte_sum(const uint8_t* px) {
  return (int)px[0] + (int)px[1] + (int)px[2];
}

// not an override: the int form's override byte is 0; the chars form's
// alpha byte lies outside 2..254
template <bool kChars>
__device__ __forceinline__ bool cell_valid(const uint8_t* ovr,
                                           const uint8_t* alpha, size_t i) {
  if constexpr (!kChars) {
    return ovr[i] == 0;
  } else {
    const int a = alpha[i];
    return a < kOverrideMin || a > kOverrideMax;
  }
}

// Where a vote goes: the int plane, or the chars (the code of the index,
// clamped into the ramp, or the alpha byte of an override cell)
struct Sink {
  int* out;
  uint8_t* chars;
  const uint8_t* alpha;
  const uint8_t* codes;
  int n_max;
};

template <bool kChars>
__device__ __forceinline__ void emit(const Sink& k, size_t o, int v,
                                     bool centre_valid) {
  if constexpr (!kChars)
    k.out[o] = v;
  else
    k.chars[o] = centre_valid ? __ldg(k.codes + min(max(v, 0), k.n_max))
                              : k.alpha[o];
}

// The votes of a column of K cells: x0 + lane, rows y0 + r0 .. + K - 1,
// each over its (2R+1) x (2R+1) window of s_idx / s_valid (halo rows r0 ..
// r0 + K + 2R - 1). kAllValid: no neighbour in those rows is an override, so
// no valid bit is read.
template <int R, int K, bool kAllValid, bool kChars>
__device__ __forceinline__ void column(const int (*s_idx)[kTileW + 8],
                                       const unsigned long long* s_valid,
                                       const Sink& sink, int H, int W,
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
    if (x < W && y + k < H)
      emit<kChars>(sink, (size_t)(y + k) * W + x, adopt ? cand : base,
                   centre_valid);

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
// plane offsets cost the K = 4 kernels 4 registers and an occupancy step).
// kChars: the chars form (g), else the int form (idx, ovr, out; g unused).
// The chars form at R <= 2 is held to 64 registers, 8 blocks an SM: a
// 540 x 960 grid's 1,013 blocks of K = 4 then run in one wave, where at 72
// registers (7 blocks an SM) they took two. The other instances name no
// least number of blocks (0), as the int form's always did
template <int R, int K, bool kBatch, bool kChars>
__global__ void __launch_bounds__(kTileW * kWarps,
                                  (kChars && R <= 2) ? 8 : 0)
modal_kernel(const int* __restrict__ idx, const uint8_t* __restrict__ ovr,
             int* __restrict__ out, int H, int W, int thresh,
             const Glyph g) {
  constexpr int kTileH = K * kWarps;          // cells a block column
  constexpr int kHaloH = kTileH + 2 * R;
  constexpr int kHaloW = kTileW + 2 * R;      // <= 38: two mask words
  constexpr unsigned kRowMask = (1u << (2 * R + 1)) - 1u;
  __shared__ int s_idx[kHaloH][kTileW + 8];
  __shared__ unsigned long long s_valid[kHaloH];

  const uint8_t* rgb = kChars ? g.rgb : nullptr;
  const uint8_t* alpha = kChars ? g.alpha : nullptr;
  uint8_t* chars = kChars ? g.chars : nullptr;
  const float n = kChars ? g.n : 0.0f;
  if constexpr (kBatch) {  // blockIdx.z's grid, voted alone
    const size_t plane = (size_t)blockIdx.z * H * W;
    if constexpr (kChars) {
      if (rgb != nullptr) rgb += 3 * plane;
      alpha += plane;
      chars += plane;
    } else {
      ovr += plane;
      out += plane;
    }
    if (rgb == nullptr) idx += plane;
  }
  const int lane = threadIdx.x, warp = threadIdx.y;
  const Sink sink{out, chars, alpha, kChars ? g.codes : nullptr,
                  kChars ? g.n_codes - 1 : 0};
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  // stage: warp w takes halo rows w, w + kWarps, ...; lane l columns l and
  // 32 + l of the halo (global column x0 - R + that, clamped)
  const int xa = min(max(x0 - R + lane, 0), W - 1);
  const int xb = min(max(x0 - R + kTileW + lane, 0), W - 1);
  const bool has_b = kTileW + lane < kHaloW;
  if (kChars && rgb != nullptr) {
    // from the rgb bytes: every row's bytes loaded first (byte sum and
    // alpha byte packed in one word); while they are in flight the block
    // forms the ramp index of every byte sum 0..765 by quantize_index's
    // rule; then each cell takes its sum's, and the rows are balloted
    __shared__ int s_lut[kByteSums];
    constexpr int kRowsEach = (kHaloH + kWarps - 1) / kWarps;
    unsigned pa[kRowsEach], pb[kRowsEach];
#pragma unroll
    for (int it = 0; it < kRowsEach; ++it) {
      const int hy = warp + it * kWarps;
      if (hy < kHaloH) {
        const size_t row = (size_t)min(max(y0 - R + hy, 0), H - 1) * W;
        pa[it] = byte_sum(rgb + 3 * (row + xa)) | (alpha[row + xa] << 16);
        if (has_b)
          pb[it] = byte_sum(rgb + 3 * (row + xb)) | (alpha[row + xb] << 16);
      }
    }
    for (int v = warp * kTileW + lane; v < kByteSums; v += kTileW * kWarps)
      s_lut[v] = quantize_sum(v, n);
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kRowsEach; ++it) {
      const int hy = warp + it * kWarps;
      if (hy < kHaloH) {  // the same for the whole warp
        s_idx[hy][lane] = s_lut[pa[it] & 0xffff];
        const int a_a = pa[it] >> 16;
        const bool va = a_a < kOverrideMin || a_a > kOverrideMax;
        bool vb = false;
        if (has_b) {
          s_idx[hy][kTileW + lane] = s_lut[pb[it] & 0xffff];
          const int a_b = pb[it] >> 16;
          vb = a_b < kOverrideMin || a_b > kOverrideMax;
        }
        const unsigned wa = __ballot_sync(0xffffffffu, va);
        const unsigned wb = __ballot_sync(0xffffffffu, vb);
        if (lane == 0) s_valid[hy] = ((unsigned long long)wb << 32) | wa;
      }
    }
  } else {  // the int form, and the chars form's index plane
    for (int hy = warp; hy < kHaloH; hy += kWarps) {
      const size_t row = (size_t)min(max(y0 - R + hy, 0), H - 1) * W;
      s_idx[hy][lane] = idx[row + xa];
      const bool va = cell_valid<kChars>(ovr, alpha, row + xa);
      bool vb = false;
      if (has_b) {
        s_idx[hy][kTileW + lane] = idx[row + xb];
        vb = cell_valid<kChars>(ovr, alpha, row + xb);
      }
      const unsigned wa = __ballot_sync(0xffffffffu, va);
      const unsigned wb = __ballot_sync(0xffffffffu, vb);
      if (lane == 0) s_valid[hy] = ((unsigned long long)wb << 32) | wa;
    }
  }
  __syncthreads();

  const int r0 = warp * K;  // this thread's first tile row
  // one branch a warp: no override among any lane's K + 2R window rows
  // (every warp of a raster frame), or some
  unsigned long long all = ~0ull;
#pragma unroll
  for (int i = 0; i < K + 2 * R; ++i) all &= s_valid[r0 + i] >> lane;
  if (__all_sync(0xffffffffu, (all & kRowMask) == kRowMask))
    column<R, K, true, kChars>(s_idx, s_valid, sink, H, W, thresh, lane, r0,
                               x0 + lane, y0 + r0);
  else
    column<R, K, false, kChars>(s_idx, s_valid, sink, H, W, thresh, lane, r0,
                                x0 + lane, y0 + r0);
}

// The chars form without the vote: a thread a cell of the n cells
constexpr int kMapThreads = 256;

__global__ void __launch_bounds__(kMapThreads)
glyph_map_kernel(const int* __restrict__ idx, const Glyph g, long long n) {
  const long long i = (long long)blockIdx.x * kMapThreads + threadIdx.x;
  if (i >= n) return;
  const Sink sink{nullptr, g.chars, g.alpha, g.codes, g.n_codes - 1};
  const int v = g.rgb != nullptr ? quantize_sum(byte_sum(g.rgb + 3 * i), g.n)
                                 : idx[i];
  emit<true>(sink, (size_t)i, v, cell_valid<true>(nullptr, g.alpha, i));
}

template <int R, int K, bool kChars>
void launch_form(const int* idx, const uint8_t* ovr, int* out, int V, int H,
                 int W, int thresh, const Glyph& g, cudaStream_t stream) {
  dim3 block(kTileW, kWarps);
  dim3 grid((W + kTileW - 1) / kTileW, (H + K * kWarps - 1) / (K * kWarps),
            V);
  if (V == 1)
    modal_kernel<R, K, false, kChars><<<grid, block, 0, stream>>>(
        idx, ovr, out, H, W, thresh, g);
  else
    modal_kernel<R, K, true, kChars><<<grid, block, 0, stream>>>(
        idx, ovr, out, H, W, thresh, g);
}

template <int R, int K>
int launch(const int* idx, const uint8_t* ovr, int* out, int V, int H, int W,
           int thresh, const Glyph& g, cudaStream_t stream) {
  if (g.chars != nullptr)
    launch_form<R, K, true>(idx, ovr, out, V, H, W, thresh, g, stream);
  else
    launch_form<R, K, false>(idx, ovr, out, V, H, W, thresh, g, stream);
  return (int)cudaGetLastError();
}

template <int R>
int launch_k(const int* idx, const uint8_t* ovr, int* out, int V, int H,
             int W, int thresh, int k, const Glyph& g, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<R, 1>(idx, ovr, out, V, H, W, thresh, g, stream);
    case 4: return launch<R, 4>(idx, ovr, out, V, H, W, thresh, g, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_r(const int* idx, const uint8_t* ovr, int* out, int V, int H,
             int W, int radius, int thresh, int k, const Glyph& g,
             cudaStream_t s) {
  if (V < 1 || V > 65535) return (int)cudaErrorInvalidValue;
  switch (radius) {
    case 1: return launch_k<1>(idx, ovr, out, V, H, W, thresh, k, g, s);
    case 2: return launch_k<2>(idx, ovr, out, V, H, W, thresh, k, g, s);
    case 3: return launch_k<3>(idx, ovr, out, V, H, W, thresh, k, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// V grids of H x W, one after another (V = 1: a lone grid);
// cells_per_thread: K, 1 or 4 (ops/ascii_kernel.cells_per_thread)
extern "C" int modal_launch(const int* idx, const uint8_t* ovr, int* out,
                            int V, int H, int W, int radius, int thresh,
                            int cells_per_thread, void* stream) {
  const Glyph g{};
  return launch_r(idx, ovr, out, V, H, W, radius, thresh, cells_per_thread,
                  g, (cudaStream_t)stream);
}

// The chars form: chars [V, H, W] from the rgb bytes [V, H, W, 3] (idx
// null) or the index plane idx [V, H, W] (rgb null) and the alpha bytes;
// the ramp's n_codes codes a device copy; the vote when mode_on
extern "C" int glyph_launch(const int* idx, const uint8_t* rgb,
                            const uint8_t* alpha, uint8_t* chars,
                            const uint8_t* codes, int n_codes, int V, int H,
                            int W, int mode_on, int radius, int thresh,
                            int cells_per_thread, void* stream) {
  if (n_codes < 1 || codes == nullptr || (idx == nullptr) == (rgb == nullptr)
      || alpha == nullptr || chars == nullptr)
    return (int)cudaErrorInvalidValue;
  const Glyph g{rgb, alpha, chars, codes, (float)(n_codes - 1), n_codes};
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode_on)
    return launch_r(idx, nullptr, nullptr, V, H, W, radius, thresh,
                    cells_per_thread, g, s);
  const long long n = (long long)V * H * W;
  const long long blocks = (n + kMapThreads - 1) / kMapThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  glyph_map_kernel<<<(unsigned)blocks, kMapThreads, 0, s>>>(idx, g, n);
  return (int)cudaGetLastError();
}
