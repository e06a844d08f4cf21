// The small and mid raster paths' bin entries (X9): the input of the bin
// walk B6 / B6' built from the clipped triangles' screen channels, in four
// launches, the sort of the pair keys (tile << 19) | tri a counting sort
// of their tiles:
//   bin_tris_kernel    a thread a triangle: the bbox tile span (floor of a
//                      true division by TILE_W = 128 / TILE_H = 8,
//                      saturated to int32 as XLA converts), the small / big
//                      test, the tiles of its S = tw^2 small pairs (n_tiles
//                      where a pair is not emitted), its source row (the 12
//                      plane channels, 1.0, the id as float, two zeros; row
//                      T is zero) and its bit of the big triangles' mask;
//   bin_seq_kernel     a thread a key: every block ranks the first big_cap
//                      big triangles in id order from the mask (a block
//                      scan of the words' bit counts), then writes the keys
//                      in SEQUENCE order, which puts every tile's keys in
//                      ascending triangle order: triangle t's S small keys,
//                      then, where t is the b-th ranked big triangle, its
//                      n_tiles overlap keys (n_tiles << 19 | t off its
//                      span), and last the fill ranks' keys (n_tiles << 19
//                      | T - 1); and the histogram of its chunk's tiles;
//   bin_scan_kernel    one block: the exclusive scan of the histograms,
//                      tile-major, gives each (tile, chunk) its first
//                      output position and the bins' offsets (the
//                      reference's searchsorted); it zeroes the data's
//                      inert tail;
//   bin_scatter_kernel a thread a key: its rank among the same tile's keys
//                      of its chunk, in sequence order (a match in the
//                      warp, the warps in turn), gives its place in the
//                      sorted keys, where it writes its source row in walk
//                      "mm"'s channel-major [P/128, 16, 128] chunks or
//                      row-major [P, 16].
// The counting sort is stable and each tile's keys come in ascending
// triangle order, so its order is the sorted keys' (the tail's equal keys
// are equal rows). ops/bin_entries.binned_entries_ref is the plain version
// (tile_pairs, plane_entries and the gather); its fused chains are fmaf
// here, in its order (core/fp.py gives the rules):
//   gamma_k  fma(y2 - y1, x1, -((x2 - x1) * y1))   (the left product fuses)
//   area     fma(xb - xa, yc - ya, -((yb - ya) * (xc - xa)))
//   z_x      fma(a2, zc, fma(a1, zb, a0 * za)) * inv_area
//   z_y, z_c fma(c2, zc, fma(c0, za, c1 * zb)) * inv_area
// with inv_area the IEEE reciprocal (__frcp_rn) of the area guarded at
// 1e-12. Min and max keep a NaN as torch's do; int32 sums wrap as torch's.
//
// Stands for XLA code, not a Pallas kernel: the front of
// visibility_binned_ch in ascii_renderer_tpu/backends/raster_channels.py
// (:546), which XLA compiles into each frame's program (its sort is
// lax.sort). The plain version on CUDA tensors is some 250 launches; this
// is four.
//
// What bounds it on the H100: bytes. A triangle reads 9 screen floats and
// its flag and writes its S tiles and a 64-byte source row; a key is
// written, read and its 64-byte row gathered (P = S T + big_cap n_tiles
// keys); the histograms are (n_tiles + 1) ints a chunk of 1,024 keys; the
// operations (~60 a triangle) are few. The source rows are staged in
// shared memory (a row padded by one float) and stored as one span (B10's
// lesson); the keys are written in sequence order, coalesced.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kChan = 16;  // raster_bins.N_CHAN
constexpr int kTileW = 128, kTileH = 8;
constexpr int kTriBits = 19;
constexpr int kThreadsA = 128;
constexpr int kChunk = 1024;  // keys a block of the sequence and scatter
constexpr int kThreadsS = 1024;
constexpr int kMaxBigCap = 8192;  // ops/bin_entries.MAX_BIG_CAP

// sx a b c, sy a b c, sz a b c (ops/bin_entries.KEYS) and the valid flag:
// pointers and element strides
struct Tris {
  const float* p[9];
  const bool* valid;
  long long st[9];
  long long vst;
};

// torch.minimum / maximum: a NaN wins
__device__ __forceinline__ float nmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// bin_entries._floor_i32 of a true division by d: floor, clamp to
// [-2^31, 2^31 - 128] (NaN kept), convert
__device__ __forceinline__ int tile_of(float x, float d) {
  float f = floorf(__fdiv_rn(x, d));
  if (!isnan(f)) f = fminf(fmaxf(f, -2147483648.0f), 2147483520.0f);
  return (int)f;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__global__ void __launch_bounds__(kThreadsA)
bin_tris_kernel(Tris tr, int T, int rows, int cols, int tw, int tiles_x,
                int tiles_y, int* __restrict__ tiles, int4* __restrict__ span,
                unsigned* __restrict__ mask, float* __restrict__ src) {
  constexpr int kPitch = kChan + 1;
  __shared__ float rowbuf[kThreadsA * kPitch];
  const int t = blockIdx.x * kThreadsA + threadIdx.x;
  const int n_tiles = tiles_x * tiles_y;
  float* row = rowbuf + threadIdx.x * kPitch;
  bool big = false;
  if (t < T) {
    float v[9];
    for (int k = 0; k < 9; ++k) v[k] = tr.p[k][t * tr.st[k]];
    const bool valid = tr.valid[t * tr.vst];
    const float xa = v[0], xb = v[1], xc = v[2];
    const float ya = v[3], yb = v[4], yc = v[5];
    const float za = v[6], zb = v[7], zc = v[8];
    const float xmin = nmin(nmin(xa, xb), xc), xmax = nmax(nmax(xa, xb), xc);
    const float ymin = nmin(nmin(ya, yb), yc), ymax = nmax(nmax(ya, yb), yc);
    const int tx0 = tile_of(xmin, (float)kTileW);
    const int ty0 = tile_of(ymin, (float)kTileH);
    const int tx1 = tile_of(xmax, (float)kTileW);
    const int ty1 = tile_of(ymax, (float)kTileH);
    const bool onscreen = xmax > 0.0f && xmin < (float)cols &&
                          ymax > 0.0f && ymin < (float)rows;
    const bool fits = wrap_sub(tx1, tx0) < tw && wrap_sub(ty1, ty0) < tw;
    const bool small = valid && onscreen && fits;
    big = valid && onscreen && !fits;
    for (int k = 0; k < tw * tw; ++k) {
      const int ty = wrap_add(ty0, k / tw), tx = wrap_add(tx0, k % tw);
      const bool ok = small && ty >= 0 && ty < tiles_y && tx >= 0 &&
                      tx < tiles_x && ty <= ty1 && tx <= tx1;
      tiles[(long long)t * tw * tw + k] = ok ? ty * tiles_x + tx : n_tiles;
    }
    span[t] = make_int4(tx0, tx1, ty0, ty1);
    // the edge planes w_k = A_k px + B_k py + G_k and the depth plane
    const float sx[3] = {xa, xb, xc}, sy[3] = {ya, yb, yc};
    float a[3], b[3], g[3];
    for (int k = 0; k < 3; ++k) {
      const float x1 = sx[(k + 1) % 3], y1 = sy[(k + 1) % 3];
      const float x2 = sx[(k + 2) % 3], y2 = sy[(k + 2) % 3];
      a[k] = -(y2 - y1);
      b[k] = x2 - x1;
      g[k] = fmaf(y2 - y1, x1, -((x2 - x1) * y1));
    }
    const float area = fmaf(xb - xa, yc - ya, -((yb - ya) * (xc - xa)));
    const float inv_area = __frcp_rn(fabsf(area) < 1e-12f ? 1e-12f : area);
    for (int k = 0; k < 3; ++k) {
      row[3 * k] = a[k];
      row[3 * k + 1] = b[k];
      row[3 * k + 2] = g[k];
    }
    row[9] = fmaf(a[2], zc, fmaf(a[1], zb, a[0] * za)) * inv_area;
    row[10] = fmaf(b[2], zc, fmaf(b[0], za, b[1] * zb)) * inv_area;
    row[11] = fmaf(g[2], zc, fmaf(g[0], za, g[1] * zb)) * inv_area;
    row[12] = 1.0f;
    row[13] = (float)t;
    row[14] = row[15] = 0.0f;
  } else if (t == T) {
    for (int c = 0; c < kChan; ++c) row[c] = 0.0f;  // the tail's row
  }
  const unsigned bal = __ballot_sync(0xffffffffu, big);
  if ((threadIdx.x & 31) == 0 && t < T) mask[t >> 5] = bal;
  __syncthreads();
  const int first = blockIdx.x * kThreadsA;
  const int n_rows = min(kThreadsA, T + 1 - first);
  float* out = src + (long long)first * kChan;
  for (int f = threadIdx.x; f < n_rows * kChan; f += kThreadsA)
    out[f] = rowbuf[(f / kChan) * kPitch + f % kChan];
}

// The inclusive sum of v over a block of 1,024 threads: each thread gets
// its own prefix and the block's total.
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < 32; ++w) {
    before += w < warp ? warp_tot[w] : 0;
    total += warp_tot[w];
  }
  __syncthreads();  // warp_tot is written again
  return before + v;
}

__global__ void __launch_bounds__(kChunk)
bin_seq_kernel(const int* __restrict__ tiles, int S,
               const unsigned* __restrict__ mask,
               const int4* __restrict__ span, int T, int tiles_x,
               int n_tiles, int big_cap, int P, int n_chunks,
               int* __restrict__ seq, int* __restrict__ hist) {
  extern __shared__ int sm[];
  int* big_idx = sm;             // [big_cap]: the ranked big triangles
  int* seg = sm + big_cap;       // [big_cap]: where each one's keys start
  int* counts = seg + big_cap;   // [n_tiles + 1]: the chunk's histogram
  __shared__ int warp_tot[32];
  const int n_words = (T + 31) / 32;
  int running = 0;  // big triangles in the words before this step
  for (int base = 0; base < n_words && running < big_cap; base += kChunk) {
    const int w = base + threadIdx.x;
    unsigned word = w < n_words ? mask[w] : 0u;
    int total;
    const int incl = block_scan(__popc(word), warp_tot, total);
    int r = running + incl - __popc(word);
    while (word && r < big_cap) {  // the word's big triangles in id order
      big_idx[r++] = w * 32 + (__ffs(word) - 1);
      word &= word - 1;
    }
    running += total;
  }
  const int n_ranked = min(running, big_cap);
  for (int g = threadIdx.x; g <= n_tiles; g += kChunk) counts[g] = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < n_ranked; b += kChunk)
    seg[b] = S * (big_idx[b] + 1) + n_tiles * b;
  __syncthreads();
  const int p = blockIdx.x * kChunk + threadIdx.x;
  if (p < P) {
    // big segments complete before p (seg increases with b)
    int lo = 0, hi = n_ranked;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (seg[mid] + n_tiles <= p)
        lo = mid + 1;
      else
        hi = mid;
    }
    int key;
    if (lo < n_ranked && seg[lo] <= p) {  // big triangle lo's key
      const int bi = big_idx[lo], tile = p - seg[lo];
      const int4 s = span[bi];  // tx0, tx1, ty0, ty1
      const int gy = tile / tiles_x, gx = tile % tiles_x;
      const bool hit = gx >= s.x && gx <= s.y && gy >= s.z && gy <= s.w;
      key = ((hit ? tile : n_tiles) << kTriBits) | bi;
    } else {
      const long long q = p - (long long)n_tiles * lo;
      key = q < (long long)S * T
                ? (tiles[q] << kTriBits) | (int)(q / S)  // a small key
                : (n_tiles << kTriBits) | (T - 1);       // a fill rank's
    }
    seq[p] = key;
    atomicAdd(&counts[key >> kTriBits], 1);
  }
  __syncthreads();
  for (int g = threadIdx.x; g <= n_tiles; g += kChunk)
    hist[(long long)g * n_chunks + blockIdx.x] = counts[g];
}

__global__ void __launch_bounds__(kThreadsS)
bin_scan_kernel(int* __restrict__ hist, long long n_hist, int n_chunks,
                int n_tiles, int* __restrict__ offsets,
                float* __restrict__ data, int P, int n_rows, int mm) {
  __shared__ int warp_tot[32];
  int running = 0;
  for (long long base = 0; base < n_hist; base += 4LL * kThreadsS) {
    const long long i0 = base + 4LL * threadIdx.x;
    int v[4], s = 0;
    for (int k = 0; k < 4; ++k) {
      v[k] = i0 + k < n_hist ? hist[i0 + k] : 0;
      s += v[k];
    }
    int total;
    int ex = running + block_scan(s, warp_tot, total) - s;
    for (int k = 0; k < 4; ++k) {
      if (i0 + k < n_hist) hist[i0 + k] = ex;
      ex += v[k];
    }
    running += total;
  }
  __syncthreads();
  for (int g = threadIdx.x; g <= n_tiles; g += kThreadsS)
    offsets[g] = hist[(long long)g * n_chunks];
  // the inert tail: rows P .. n_rows of the layout
  const long long lo = mm ? (long long)(P / 128) * 128 * kChan
                          : (long long)P * kChan;
  for (long long e = lo + threadIdx.x; e < (long long)n_rows * kChan;
       e += kThreadsS) {
    const long long row =
        mm ? (e / (kChan * 128)) * 128 + e % 128 : e / kChan;
    if (row >= P) data[e] = 0.0f;
  }
}

__global__ void __launch_bounds__(kChunk)
bin_scatter_kernel(const int* __restrict__ seq,
                   const int* __restrict__ base, int P, int n_chunks,
                   int n_tiles, const float* __restrict__ src,
                   float* __restrict__ data, int mm) {
  extern __shared__ int run[];  // [n_tiles + 1]: the next place of a tile
  const int c = blockIdx.x;
  for (int g = threadIdx.x; g <= n_tiles; g += kChunk)
    run[g] = base[(long long)g * n_chunks + c];
  __syncthreads();
  const int p = c * kChunk + threadIdx.x;
  const bool live = p < P;
  const int key = live ? seq[p] : 0;
  const int tile = live ? key >> kTriBits : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, tile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int before = __popc(peers & ((1u << lane) - 1u));
  int pos = 0;
  for (int w = 0; w < kChunk / 32; ++w) {  // the warps in sequence order
    if (warp == w) {
      if (live) pos = run[tile] + before;
      __syncwarp();
      if (live && before == 0) run[tile] += __popc(peers);
    }
    __syncthreads();
  }
  if (!live) return;
  const float4* s = reinterpret_cast<const float4*>(
      src + (long long)(key & ((1 << kTriBits) - 1)) * kChan);
  if (mm) {  // [P/128, 16, 128]: chunk, channel, entry
    float* d = data + (long long)(pos >> 7) * (kChan * 128) + (pos & 127);
    for (int q = 0; q < kChan / 4; ++q) {
      const float4 v = s[q];
      d[(4 * q) * 128] = v.x;
      d[(4 * q + 1) * 128] = v.y;
      d[(4 * q + 2) * 128] = v.z;
      d[(4 * q + 3) * 128] = v.w;
    }
  } else {
    float4* d = reinterpret_cast<float4*>(data + (long long)pos * kChan);
    for (int q = 0; q < kChan / 4; ++q) d[q] = s[q];
  }
}

}  // namespace

// screen20: the 9 screen channels' and the valid flag's pointers, then
// their element strides (ops/bin_entries.KEYS order); tiles: int32
// [T, tw^2]; span: int32 [T, 4]; mask: uint32 [ceil(T / 32)]; src: float
// [(T + 1) 16]; seq: int32 [P] (P = tw^2 T + big_cap n_tiles); hist:
// int32 [(n_tiles + 1) n_chunks] (n_chunks = ceil(P / 1024)); offsets:
// int32 [n_tiles + 1]; data: float [n_rows 16] (mm: [n_rows / 128, 16,
// 128]). Four launches.
extern "C" int bin_entries_launch(const long long* screen20, int T, int rows,
                                  int cols, int tw, int big_cap, int* tiles,
                                  int* span, int* mask, float* src, int* seq,
                                  int* hist, int* offsets, float* data,
                                  int n_rows, int mm, void* stream) {
  const int tiles_y = (rows + kTileH - 1) / kTileH;
  const int tiles_x = (cols + kTileW - 1) / kTileW;
  const int n_tiles = tiles_x * tiles_y;
  const long long P = (long long)tw * tw * T + (long long)big_cap * n_tiles;
  if (T < 1 || T >= (1 << kTriBits) || rows < 1 || cols < 1 || tw < 1 ||
      n_tiles >= (1 << 12) || big_cap < 1 || big_cap > kMaxBigCap ||
      P >= INT_MAX || n_rows < P || (mm && n_rows % 128))
    return (int)cudaErrorInvalidValue;
  Tris tr;
  for (int k = 0; k < 9; ++k) {
    tr.p[k] = reinterpret_cast<const float*>(screen20[k]);
    tr.st[k] = screen20[10 + k];
  }
  tr.valid = reinterpret_cast<const bool*>(screen20[9]);
  tr.vst = screen20[19];
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = (int)((P + kChunk - 1) / kChunk);
  bin_tris_kernel<<<(T + 1 + kThreadsA - 1) / kThreadsA, kThreadsA, 0, s>>>(
      tr, T, rows, cols, tw, tiles_x, tiles_y, tiles,
      reinterpret_cast<int4*>(span), reinterpret_cast<unsigned*>(mask), src);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = sizeof(int) * (2 * (size_t)big_cap + n_tiles + 1);
  err = (int)cudaFuncSetAttribute(bin_seq_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  bin_seq_kernel<<<n_chunks, kChunk, smem, s>>>(
      tiles, tw * tw, reinterpret_cast<const unsigned*>(mask),
      reinterpret_cast<const int4*>(span), T, tiles_x, n_tiles, big_cap,
      (int)P, n_chunks, seq, hist);
  err = (int)cudaGetLastError();
  if (err) return err;
  bin_scan_kernel<<<1, kThreadsS, 0, s>>>(hist,
                                          (long long)(n_tiles + 1) * n_chunks,
                                          n_chunks, n_tiles, offsets, data,
                                          (int)P, n_rows, mm);
  err = (int)cudaGetLastError();
  if (err) return err;
  bin_scatter_kernel<<<n_chunks, kChunk, sizeof(int) * (n_tiles + 1), s>>>(
      seq, hist, (int)P, n_chunks, n_tiles, src, data, mm);
  return (int)cudaGetLastError();
}
