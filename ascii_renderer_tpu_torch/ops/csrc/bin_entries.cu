// The raster's pair keys and their counting sort (X9), in two key layouts
// from one source (the template flag kBin):
//   tile keys (tile << 19) | tri, the small and mid paths' bin walk B6 /
//     B6': from the clipped triangles' screen channels, S = tw^2 small keys
//     a triangle over TILE_W x TILE_H tiles; the output is each sorted key's
//     source row (the 12 plane channels, 1.0, the id as float, two zeros) in
//     walk "mm"'s channel-major [P/128, 16, 128] chunks or row-major [P, 16];
//   bin keys (bin << 18) | tri, the grouped generations' raster.keys: from
//     the setup's bbox channels bx0 bx1 by0 by1 and valid, S = 4 small keys
//     a triangle in a 2 x 2 window of tile rows x 16-pixel sub-columns, a
//     tile-row band [ty_lo, ty_lo + tiles_y_band) with band-local bins over
//     global tile rows; the output is the sorted keys themselves.
// Both take the first big_cap big triangles in id order, each with its
// [n_bins] overlap keys, and put every unemitted pair in the fill bin n_bins.
// The offsets [n_bins + 1] (the reference's searchsorted) and the counts
// (n_small, n_big, n_pairs, n_valid) come out beside them.
//
// The multi-block form is four launches:
//   bin_tris_kernel    a thread a triangle: its span, small / big / valid
//                      flags, its S small keys' bins, its bit of the big
//                      mask, (tile keys) its source row; the last block to
//                      finish (a ticket) ranks the first big_cap big
//                      triangles once, from the blocks' counts, and sums the
//                      counts (a small call's sequence blocks rank for
//                      themselves instead, cheaper than that tail);
//   bin_seq_kernel     a chunk of 32 W J keys a block, a warp J steps of 32
//                      keys: the keys in SEQUENCE order (triangle t's S
//                      small keys, then, where t is the b-th ranked big
//                      triangle, its n_bins overlap keys, last the fill
//                      ranks'), which puts every bin's keys in ascending
//                      triangle order; a key's stable rank among its
//                      chunk's keys of the same bin from a match in the warp
//                      and per-warp bin counts in shared memory (16-bit),
//                      scanned across the warps at the end; the chunk's
//                      histogram stored chunk-major, coalesced;
//   bin_scan_kernel    8 lanes a bin, each a run of chunks: the exclusive
//                      scan of the bin's column of histograms (its place in
//                      each chunk), its total, its place among the block's
//                      32 bins; the last block scans the blocks' totals (a
//                      histogram of at most 2,048 ints is scanned by every
//                      block of the scatter instead: three launches);
//   bin_scatter_kernel a thread a key: offset + column prefix + rank is its
//                      place in the sorted keys, where it writes its key or
//                      its source row (and the tile layout's inert zero
//                      tail); its first threads write the offsets.
// The forms differ in the sequence pass's chunk (32 W J keys: (4, 8),
// (8, 8), (8, 16)); the wrapper (ops/bin_entries) picks one by size. A
// form of one block running every phase lost at every size
// (tools/bin_variants) and is gone.
// The counting sort is stable and every bin's keys come in ascending
// triangle order, so its order is the sorted keys' (equal keys, in the fill
// bin, are equal values and equal rows).
//
// ops/bin_entries holds the plain versions: binned_entries_ref (tile_pairs,
// plane_entries and the gather) and pair_keys_ref (_pair_keys_core); their
// fused chains are fmaf here, in their order (core/fp.py gives the rules):
//   gamma_k  fma(y2 - y1, x1, -((x2 - x1) * y1))   (the left product fuses)
//   area     fma(xb - xa, yc - ya, -((yb - ya) * (xc - xa)))
//   z_x      fma(a2, zc, fma(a1, zb, a0 * za)) * inv_area
//   z_y, z_c fma(c2, zc, fma(c0, za, c1 * zb)) * inv_area
// with inv_area the IEEE reciprocal (__frcp_rn) of the area guarded at
// 1e-12. Min and max keep a NaN as torch's do; int32 sums wrap as torch's.
//
// Stands for XLA code, not a Pallas kernel: the front of
// visibility_binned_ch in ascii_renderer_tpu/backends/raster_channels.py
// (:546) and _subtile_pair_keys_bbox with its lax.sort in
// ascii_renderer_tpu/backends/raster.py (:249, :345), which XLA compiles
// into each frame's program. The torch chains are some 250 and 137 launches.
//
// What bounds it on the H100: bytes and launches. A triangle reads its
// channels and writes S bins; a key is written, read and placed (a 64-byte
// row gathered in the tile layout); the histograms are (n_bins + 1) ints a
// chunk. At the small calls the launches and each pass's round trips to
// memory are most of the time: there a tiny histogram is scanned by each
// scatter block (three launches) and the sequence blocks rank for
// themselves, sparing the triangles' pass its serial tail.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kChan = 16;  // raster_bins.N_CHAN
constexpr int kTileW = 128, kTileH = 8;
constexpr float kSubW = 16.0f;  // raster_subtile.SUB_W
constexpr int kThreadsA = 128;   // the triangles' pass
constexpr int kThreadsC = 256;   // the column scan
constexpr int kPartsC = 8;       // lanes a bin's column
constexpr int kBinsC = kThreadsC / kPartsC;  // bins a block of the scan
constexpr int kThreadsD = 256;   // the scatter
constexpr int kStageBig = 2048;   // ranked big triangles staged in smem
constexpr int kRankHereMax = 4096;  // chunks x triangle blocks up to which
                                    // each sequence block ranks itself
constexpr int kTinyHistMax = 2048;  // histogram ints each scatter block
                                    // scans itself (ops/bin_entries)
// where the scatter finds a key's place (bin_scatter_kernel's mode)
constexpr int kSplit = 1, kTiny = 2;
constexpr unsigned kFull = 0xffffffffu;

// tile keys: sx a b c, sy a b c, sz a b c (ops/bin_entries.KEYS); bin keys:
// bx0 bx1 by0 by1 in p[0..3]; the valid flag; element strides
struct Tris {
  const float* p[9];
  const bool* valid;
  long long st[9];
  long long vst;
};

// a call's grid, as both layouts read it
struct Call {
  int T, S, nb;      // triangle slots, small keys a triangle, real bins
  int gx;            // bins a row of the grid: tiles_x / 8 tiles_x
  int ty_off;        // a bin row's global tile row less its local one
  int big_cap;       // ranks of big triangles (bin keys: at most T)
  long long P;       // keys: S T + big_cap nb
  int rows, cols, tw, tiles_y;  // tiles_y: the frame's tile rows
  int tiles_y_eff;   // bin keys: the band's tile rows
  float y_lo_px, y_hi_px;  // bin keys: the band's pixel rows
};

// the workspace (ops/bin_entries._workspace)
struct Work {
  int* tiles;      // [T S] small keys' bins (nb where not emitted)
  int4* span;      // [T] tile span (tile keys) / clamped bin span
  unsigned* mask;  // [ceil(T / 32)] the big triangles
  int* bpart;      // [4 blocks of the triangles' pass] big, small, valid
  int* big_idx;    // [big_cap] the ranked big triangles
  int* seg;        // [big_cap] where each one's overlap keys start
  int4* rspan;     // [big_cap] each one's span
  int* meta;       // [4] n_ranked
  int* seq;        // [P] keys in sequence order
  int* lrank;      // [P] a key's rank in its chunk's bin
  int* hist;       // [n_chunks, nb + 1] chunk-major; then column prefixes
  int* tot;        // [nb + 1] a bin's place among its scan block's
  int* bsum;       // [ceil((nb + 1) / 32)] the scan blocks' totals, then
                   // their offsets
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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The inclusive sum of v over a block of kThreads: each thread gets its
// own prefix and the block's total.
template <int kThreads>
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_tot[w] : 0;
    total += warp_tot[w];
  }
  __syncthreads();  // warp_tot is written again
  return before + v;
}

// Whether this block is the grid's last to get here. The block's writes
// before the call are visible to the last block's reads after it (a
// barrier, then one thread's fence and ticket; the last block's thread
// fences again before the barrier its readers wait on).
__device__ __forceinline__ bool last_block(unsigned* ticket, bool* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (*flag) __threadfence();
  }
  __syncthreads();
  return *flag;
}

// Triangle t: its small keys' bins, its span, its flags and (tile keys)
// its source row.
template <bool kBin>
__device__ __forceinline__ void tri_pass(const Tris& tr, const Call& c, int t,
                                         const Work& w, float* row,
                                         bool& small, bool& big,
                                         bool& valid) {
  valid = tr.valid[t * tr.vst];
  if (kBin) {
    // _bin_span and _pair_keys_core (ops/bin_entries)
    const float xmin = tr.p[0][t * tr.st[0]], xmax = tr.p[1][t * tr.st[1]];
    const float ymin = tr.p[2][t * tr.st[2]], ymax = tr.p[3][t * tr.st[3]];
    const int sc0 = tile_of(xmin, kSubW), sc1 = tile_of(xmax, kSubW);
    const int ty0 = tile_of(ymin, (float)kTileH);
    const int ty1 = tile_of(ymax, (float)kTileH);
    const bool on = xmax > 0.0f && xmin < (float)c.cols &&
                    ymax > c.y_lo_px && ymin < c.y_hi_px;
    const bool fits = wrap_sub(sc1, sc0) < 2 && wrap_sub(ty1, ty0) < 2;
    small = valid && on && fits;
    big = valid && on && !fits;
    for (int k = 0; k < 4; ++k) {
      const int ty = wrap_add(ty0, k >> 1), sc = wrap_add(sc0, k & 1);
      const int tyl = wrap_sub(ty, c.ty_off);
      const bool ok = small && tyl >= 0 && tyl < c.tiles_y_eff && sc >= 0 &&
                      sc < c.gx && ty <= ty1 && sc <= sc1;
      w.tiles[(long long)t * 4 + k] = ok ? tyl * c.gx + sc : c.nb;
    }
    // clamped before the overlap test: a near-plane triangle is big but
    // indexes sanely
    w.span[t] = make_int4(clampi(sc0, 0, c.gx - 1), clampi(sc1, 0, c.gx - 1),
                          clampi(ty0, 0, c.tiles_y - 1),
                          clampi(ty1, 0, c.tiles_y - 1));
    return;
  }
  float v[9];
  for (int k = 0; k < 9; ++k) v[k] = tr.p[k][t * tr.st[k]];
  const float xa = v[0], xb = v[1], xc = v[2];
  const float ya = v[3], yb = v[4], yc = v[5];
  const float za = v[6], zb = v[7], zc = v[8];
  const float xmin = nmin(nmin(xa, xb), xc), xmax = nmax(nmax(xa, xb), xc);
  const float ymin = nmin(nmin(ya, yb), yc), ymax = nmax(nmax(ya, yb), yc);
  const int tx0 = tile_of(xmin, (float)kTileW);
  const int ty0 = tile_of(ymin, (float)kTileH);
  const int tx1 = tile_of(xmax, (float)kTileW);
  const int ty1 = tile_of(ymax, (float)kTileH);
  const bool onscreen = xmax > 0.0f && xmin < (float)c.cols &&
                        ymax > 0.0f && ymin < (float)c.rows;
  const bool fits = wrap_sub(tx1, tx0) < c.tw && wrap_sub(ty1, ty0) < c.tw;
  small = valid && onscreen && fits;
  big = valid && onscreen && !fits;
  const int tw = c.tw;
  for (int k = 0; k < tw * tw; ++k) {
    const int ty = wrap_add(ty0, k / tw), tx = wrap_add(tx0, k % tw);
    const bool ok = small && ty >= 0 && ty < c.tiles_y && tx >= 0 &&
                    tx < c.gx && ty <= ty1 && tx <= tx1;
    w.tiles[(long long)t * tw * tw + k] = ok ? ty * c.gx + tx : c.nb;
  }
  w.span[t] = make_int4(tx0, tx1, ty0, ty1);
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
}

// The ranked big triangles: their segment starts seg_b = S (big_idx[b] +
// 1) + nb b, ids and spans, staged in shared memory where they fit (span
// null: read from w.span by id).
struct Ranked {
  const int* seg;
  const int* idx;
  const int4* span;
};

// shared memory the staging takes for a cap of big triangles
__host__ __device__ __forceinline__ int ranked_bytes(int big_cap) {
  return big_cap <= kStageBig ? 24 * big_cap : 0;
}

// Every rank below the cap is staged (the ones past n_ranked unread), so
// the loads need not wait for n_ranked.
__device__ __forceinline__ Ranked stage_ranked(const Work& w, int big_cap,
                                               unsigned char* smem) {
  if (big_cap > kStageBig) return Ranked{w.seg, w.big_idx, nullptr};
  int4* span = reinterpret_cast<int4*>(smem);
  int* seg = reinterpret_cast<int*>(span + big_cap);
  int* idx = seg + big_cap;
  for (int b = threadIdx.x; b < big_cap; b += blockDim.x) {
    idx[b] = w.big_idx[b];
    seg[b] = w.seg[b];
    span[b] = w.rspan[b];
  }
  return Ranked{seg, idx, span};  // the caller's barrier makes them visible
}

// The big segments complete before position p: a search over their
// starts.
__device__ __forceinline__ int segs_before(const int* __restrict__ seg,
                                           int n_ranked, long long nb,
                                           long long p) {
  int lo = 0, hi = n_ranked;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] + nb <= p)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The key at sequence position p, ``lo`` the big segments complete before
// an earlier position (advanced here to p's): inside a segment an overlap
// key, else a small key or a fill rank's.
template <bool kBin>
__device__ __forceinline__ int key_at(const Call& c, const Work& w,
                                      const Ranked& rk, int n_ranked,
                                      long long p, int& lo) {
  constexpr int kShift = kBin ? 18 : 19;
  const long long S = c.S, nb = c.nb;
  while (lo < n_ranked && rk.seg[lo] + nb <= p) ++lo;
  if (lo < n_ranked && rk.seg[lo] <= p) {  // big triangle lo's overlap key
    const int bi = rk.idx[lo];
    const int b = (int)(p - rk.seg[lo]);
    const int4 s = rk.span ? rk.span[lo] : w.span[bi];  // x0, x1, y0, y1
    const int gy = b / c.gx + c.ty_off, gx = b % c.gx;
    const bool hit = gx >= s.x && gx <= s.y && gy >= s.z && gy <= s.w;
    return ((hit ? b : c.nb) << kShift) | bi;
  }
  const long long q = p - nb * lo;
  if (q < S * c.T) return (w.tiles[q] << kShift) | (int)(q / S);
  return (c.nb << kShift) | (c.T - 1);  // a fill rank's
}

// the source row of triangle tri at sorted place pos
__device__ __forceinline__ void write_row(const float* __restrict__ src,
                                          int tri, float* __restrict__ data,
                                          long long pos, int mm) {
  const float4* s = reinterpret_cast<const float4*>(src + (long long)tri *
                                                              kChan);
  if (mm) {  // [P/128, 16, 128]: chunk, channel, entry
    float* d = data + (pos >> 7) * (kChan * 128) + (pos & 127);
    for (int q = 0; q < kChan / 4; ++q) {
      const float4 v = s[q];
      d[(4 * q) * 128] = v.x;
      d[(4 * q + 1) * 128] = v.y;
      d[(4 * q + 2) * 128] = v.z;
      d[(4 * q + 3) * 128] = v.w;
    }
  } else {
    float4* d = reinterpret_cast<float4*>(data + pos * kChan);
    for (int q = 0; q < kChan / 4; ++q) d[q] = s[q];
  }
}

__device__ __forceinline__ void zero_row(float* __restrict__ data,
                                         long long pos, int mm) {
  if (mm) {
    float* d = data + (pos >> 7) * (kChan * 128) + (pos & 127);
    for (int q = 0; q < kChan; ++q) d[q * 128] = 0.0f;
  } else {
    float4* d = reinterpret_cast<float4*>(data + pos * kChan);
    for (int q = 0; q < kChan / 4; ++q) d[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The last block of the triangles' pass: the first big_cap big triangles
// in id order from the blocks' counts (an exclusive scan; a block's
// triangles are its 4 mask words), and the counts' sums.
__device__ void rank_big(const Call& c, const Work& w, int nblk,
                         int* __restrict__ counts, int* warp_tot) {
  constexpr int kWords = kThreadsA / 32;
  const int nwords = (c.T + 31) / 32;
  // a thread sums a run of blocks' counts, their loads in flight together
  const int per = (nblk + kThreadsA - 1) / kThreadsA;
  const int j0 = min((int)threadIdx.x * per, nblk), j1 = min(j0 + per, nblk);
  int big = 0, small = 0, valid = 0;
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    big += __ldcg(&w.bpart[4 * j]);
    small += __ldcg(&w.bpart[4 * j + 1]);
    valid += __ldcg(&w.bpart[4 * j + 2]);
  }
  int n_big, n_small, n_valid;
  int r = block_scan<kThreadsA>(big, warp_tot, n_big) - big;
  block_scan<kThreadsA>(small, warp_tot, n_small);
  block_scan<kThreadsA>(valid, warp_tot, n_valid);
  // the run's big triangles take ranks r.. in id order
  const int w1 = min(j1 * kWords, nwords);
  for (int w0 = j0 * kWords; big && w0 < w1 && r < c.big_cap; w0 += 8) {
    unsigned words[8];  // 8 words' loads in flight together
#pragma unroll
    for (int u = 0; u < 8; ++u)
      words[u] = w0 + u < w1 ? __ldcg(&w.mask[w0 + u]) : 0u;
    for (int u = 0; u < 8 && r < c.big_cap; ++u) {
      unsigned word = words[u];
      while (word && r < c.big_cap) {
        const int bi = (w0 + u) * 32 + (__ffs(word) - 1);
        w.big_idx[r] = bi;
        w.seg[r] = c.S * (bi + 1) + c.nb * r;
        ++r;
        word &= word - 1;
      }
    }
  }
  __syncthreads();  // the ranked triangles' spans, their loads in parallel
  const int n_ranked = min(n_big, c.big_cap);
  for (int b = threadIdx.x; b < n_ranked; b += kThreadsA)
    w.rspan[b] = __ldcg(&w.span[w.big_idx[b]]);
  if (threadIdx.x == 0) {
    w.meta[0] = n_ranked;
    counts[0] = n_small;
    counts[1] = n_big;
    counts[3] = n_valid;
  }
}

template <bool kBin>
__global__ void __launch_bounds__(kThreadsA)
bin_tris_kernel(Tris tr, Call c, Work w, float* __restrict__ src,
                int* __restrict__ counts, unsigned* __restrict__ ticket,
                int rank) {
  constexpr int kPitch = kChan + 1;
  __shared__ float rowbuf[kBin ? 1 : kThreadsA * kPitch];
  __shared__ int red[3];
  __shared__ int warp_tot[kThreadsA / 32];
  __shared__ bool last;
  const int t = blockIdx.x * kThreadsA + threadIdx.x;
  if (threadIdx.x < 3) red[threadIdx.x] = 0;
  __syncthreads();
  float* row = rowbuf + (kBin ? 0 : threadIdx.x * kPitch);
  bool small = false, big = false, valid = false;
  if (t < c.T) {
    tri_pass<kBin>(tr, c, t, w, row, small, big, valid);
  } else if (!kBin && t == c.T) {
    for (int k = 0; k < kChan; ++k) row[k] = 0.0f;  // the tail's row
  }
  const unsigned bb = __ballot_sync(kFull, big);
  const unsigned bs = __ballot_sync(kFull, small);
  const unsigned bv = __ballot_sync(kFull, valid);
  if ((threadIdx.x & 31) == 0) {
    if (t < c.T) w.mask[t >> 5] = bb;
    atomicAdd(&red[0], __popc(bb));
    atomicAdd(&red[1], __popc(bs));
    atomicAdd(&red[2], __popc(bv));
  }
  __syncthreads();
  if (!kBin) {  // the rows staged, stored as one span
    const int first = blockIdx.x * kThreadsA;
    const int n_rows = min(kThreadsA, c.T + 1 - first);
    float* out = src + (long long)first * kChan;
    for (int f = threadIdx.x; f < n_rows * kChan; f += kThreadsA)
      out[f] = rowbuf[(f / kChan) * kPitch + f % kChan];
  }
  if (threadIdx.x == 0) {
    w.bpart[4 * blockIdx.x] = red[0];
    w.bpart[4 * blockIdx.x + 1] = red[1];
    w.bpart[4 * blockIdx.x + 2] = red[2];
  }
  if (!rank) return;  // the sequence pass's blocks rank for themselves
  if (!last_block(ticket, &last)) return;
  rank_big(c, w, gridDim.x, counts, warp_tot);
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next call
}

// A block's own rank of the first big_cap big triangles, from the
// triangles' pass's block counts and mask words: the counts summed (n: big,
// small, valid), the words' counts scanned, the ranks staged in shared
// memory where they fit (else written to w.big_idx / w.seg). Every block
// of a small call's sequence pass ranks so, where that costs less than a
// tail on the triangles' pass.
template <int kThreads>
__device__ Ranked rank_here(const Call& c, const Work& w, int nblk,
                            unsigned char* smem, int* warp_tot, int* n) {
  int big = 0, small = 0, valid = 0;
  for (int j = threadIdx.x; j < nblk; j += kThreads) {
    big += w.bpart[4 * j];
    small += w.bpart[4 * j + 1];
    valid += w.bpart[4 * j + 2];
  }
  block_scan<kThreads>(big, warp_tot, n[0]);
  block_scan<kThreads>(small, warp_tot, n[1]);
  block_scan<kThreads>(valid, warp_tot, n[2]);
  const int n_ranked = min(n[0], c.big_cap);
  const bool staged = c.big_cap <= kStageBig;
  const int cap = min(c.big_cap, kStageBig);
  int4* span_s = reinterpret_cast<int4*>(smem);
  int* seg_s = reinterpret_cast<int*>(span_s + cap);
  int* idx_s = seg_s + cap;
  const int nwords = (c.T + 31) / 32;
  int running = 0;
  for (int base = 0; base < nwords && running < c.big_cap;
       base += kThreads) {
    const int wd = base + threadIdx.x;
    unsigned word = wd < nwords ? w.mask[wd] : 0u;
    int total;
    int r = running + block_scan<kThreads>(__popc(word), warp_tot, total) -
            __popc(word);
    while (word && r < c.big_cap) {
      const int bi = wd * 32 + (__ffs(word) - 1);
      const int sg = c.S * (bi + 1) + c.nb * r;
      if (staged) {
        idx_s[r] = bi;
        seg_s[r] = sg;
      } else {
        w.big_idx[r] = bi;
        w.seg[r] = sg;
      }
      ++r;
      word &= word - 1;
    }
    running += total;
  }
  __syncthreads();
  if (!staged) return Ranked{w.seg, w.big_idx, nullptr};
  for (int b = threadIdx.x; b < n_ranked; b += kThreads)
    span_s[b] = w.span[idx_s[b]];  // their loads in parallel
  __syncthreads();
  return Ranked{seg_s, idx_s, span_s};
}

template <int kW, int kJ, bool kBin>
__global__ void __launch_bounds__(32 * kW)
bin_seq_kernel(Call c, Work w, int rank_nblk, int* __restrict__ counts) {
  constexpr int kShift = kBin ? 18 : 19;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_tot[kW];
  unsigned short* cnt = reinterpret_cast<unsigned short*>(
      smem_raw + ranked_bytes(c.big_cap));
  const int nb1 = c.nb + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kW * nb1; i += 32 * kW) cnt[i] = 0;
  // rank_nblk: the triangles' pass left the rank to this pass's blocks
  int n_ranked;
  Ranked ranked;
  if (rank_nblk) {
    int n[3];
    ranked = rank_here<32 * kW>(c, w, rank_nblk, smem_raw, warp_tot, n);
    n_ranked = min(n[0], c.big_cap);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      counts[0] = n[1];
      counts[1] = n[0];
      counts[3] = n[2];
    }
  } else {
    n_ranked = w.meta[0];
    ranked = stage_ranked(w, c.big_cap, smem_raw);
    __syncthreads();
  }
  unsigned short* mine = cnt + warp * nb1;
  const long long base = (long long)blockIdx.x * (32 * kW * kJ) +
                         (long long)warp * (32 * kJ) + lane;
  const unsigned lt = (1u << lane) - 1u;
  int keys[kJ], rk[kJ];
  int lo = segs_before(ranked.seg, n_ranked, c.nb, base);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {  // every step's loads in flight at once
    const long long p = base + 32LL * j;
    keys[j] = p < c.P ? key_at<kBin>(c, w, ranked, n_ranked, p, lo) : -1;
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {  // the warp's ranks, step by step
    const bool live = keys[j] >= 0;
    const int bin = live ? keys[j] >> kShift : -1;
    const unsigned peers = __match_any_sync(kFull, bin);
    int r = 0;
    if (live) r = mine[bin] + __popc(peers & lt);
    __syncwarp();
    if (live && (peers & lt) == 0u)
      mine[bin] = (unsigned short)(mine[bin] + __popc(peers));
    __syncwarp();
    rk[j] = r;
  }
  __syncthreads();
  // per bin: the warps' exclusive prefix and the chunk's count
  for (int g = threadIdx.x; g < nb1; g += 32 * kW) {
    int run = 0;
    for (int q = 0; q < kW; ++q) {
      const int v = cnt[q * nb1 + g];
      cnt[q * nb1 + g] = (unsigned short)run;
      run += v;
    }
    w.hist[(long long)blockIdx.x * nb1 + g] = run;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const long long p = base + 32LL * j;
    if (p < c.P) {
      w.seq[p] = keys[j];
      w.lrank[p] = rk[j] + mine[keys[j] >> kShift];
    }
  }
}

__global__ void __launch_bounds__(kThreadsC)
bin_scan_kernel(Call c, Work w, int n_chunks,
                unsigned* __restrict__ ticket) {
  __shared__ int warp_tot[kThreadsC / 32];
  __shared__ int btot[kBinsC];
  __shared__ bool last;
  const int nb1 = c.nb + 1;
  const int part = threadIdx.x % kPartsC;
  const int g = blockIdx.x * kBinsC + threadIdx.x / kPartsC;
  // the bin's column of chunk counts, kPartsC lanes a run of chunks each
  const int per = (n_chunks + kPartsC - 1) / kPartsC;
  const int c0 = min(part * per, n_chunks), c1 = min(c0 + per, n_chunks);
  int sum = 0;
  if (g < nb1) {
#pragma unroll 8
    for (int ch = c0; ch < c1; ++ch) sum += w.hist[(long long)ch * nb1 + g];
  }
  int incl = sum;
  for (int d = 1; d < kPartsC; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d, kPartsC);
    if (part >= d) incl += u;
  }
  if (g < nb1) {  // each chunk's first place in the bin
    int run = incl - sum;
#pragma unroll 8
    for (int ch = c0; ch < c1; ++ch) {
      const int v = w.hist[(long long)ch * nb1 + g];
      w.hist[(long long)ch * nb1 + g] = run;
      run += v;
    }
  }
  const int total = __shfl_sync(kFull, incl, kPartsC - 1, kPartsC);
  if (part == 0) btot[threadIdx.x / kPartsC] = g < nb1 ? total : 0;
  __syncthreads();
  if (threadIdx.x < kBinsC) {  // the block's bins: their prefix, its sum
    const int v = btot[threadIdx.x];
    int x = v;
    for (int d = 1; d < kBinsC; d <<= 1) {
      const int u = __shfl_up_sync(kFull, x, d);
      if ((int)threadIdx.x >= d) x += u;
    }
    const int gb = blockIdx.x * kBinsC + threadIdx.x;
    if (gb < nb1) w.tot[gb] = x - v;
    if (threadIdx.x == kBinsC - 1) w.bsum[blockIdx.x] = x;
  }
  if (!last_block(ticket, &last)) return;
  // the last block: the blocks' offsets, in place (the scatter adds a
  // bin's place in its block and writes the offsets)
  const bool mine = (int)threadIdx.x < (int)gridDim.x;
  const int v = mine ? __ldcg(&w.bsum[threadIdx.x]) : 0;
  int n_all;
  const int ex = block_scan<kThreadsC>(v, warp_tot, n_all) - v;
  if (mine) w.bsum[threadIdx.x] = ex;
  if (threadIdx.x == 0) *ticket = 0u;
}

template <bool kBin>
__global__ void __launch_bounds__(kThreadsD)
bin_scatter_kernel(Call c, Work w, int chunk, int mode,
                   int* __restrict__ offsets, int* __restrict__ counts,
                   const float* __restrict__ src, float* __restrict__ data,
                   int* __restrict__ keys_out, long long n_out, int mm) {
  constexpr int kShift = kBin ? 18 : 19;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_tot[kThreadsD / 32];
  const int nb1 = c.nb + 1;
  const long long p = (long long)blockIdx.x * kThreadsD + threadIdx.x;
  int key = 0, rank = 0;
  if (p < c.P) {  // in flight while a tiny histogram loads
    key = w.seq[p];
    rank = w.lrank[p];
  }
  int* hist = w.hist;
  if (mode == kTiny) {  // every block scans the whole histogram itself
    const int n_chunks = (int)((c.P + chunk - 1) / chunk);
    hist = reinterpret_cast<int*>(smem_raw);  // [n_chunks][nb1], offsets
    int* offs = hist + n_chunks * nb1;
    for (int i = threadIdx.x; i < n_chunks * nb1; i += kThreadsD)
      hist[i] = w.hist[i];
    __syncthreads();
    int tot = 0;
    for (int g = threadIdx.x; g < nb1; g += kThreadsD) {  // the columns
      int run = 0;
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int v = hist[ch * nb1 + g];
        hist[ch * nb1 + g] = run;
        run += v;
      }
      offs[g] = run;
    }
    __syncthreads();
    // the bins' offsets: an exclusive scan of the totals, a run a thread
    const int per = (nb1 + kThreadsD - 1) / kThreadsD;
    const int g0 = min((int)threadIdx.x * per, nb1), g1 = min(g0 + per, nb1);
    for (int g = g0; g < g1; ++g) tot += offs[g];
    int total;
    int ex = block_scan<kThreadsD>(tot, warp_tot, total) - tot;
    for (int g = g0; g < g1; ++g) {
      const int v = offs[g];
      offs[g] = ex;
      if (blockIdx.x == 0) {
        offsets[g] = ex;
        if (g == c.nb) counts[2] = ex;  // n_pairs: the keys in real bins
      }
      ex += v;
    }
    __syncthreads();
    offsets = offs;
  } else if (mode == kSplit && p < nb1) {  // the scan kernel's last step
    const int o = w.bsum[p / kBinsC] + w.tot[p];
    offsets[p] = o;
    if (p == c.nb) counts[2] = o;  // n_pairs: the keys in real bins
  }
  if (p < c.P) {
    const int g = key >> kShift;
    const long long pos =
        (long long)(mode == kSplit ? w.bsum[g / kBinsC] + w.tot[g]
                                   : offsets[g]) +
        hist[(p / chunk) * nb1 + g] + rank;
    if (kBin)
      keys_out[pos] = key;
    else
      write_row(src, key & ((1 << kShift) - 1), data, pos, mm);
  } else if (!kBin && p < n_out) {
    zero_row(data, p, mm);  // the inert tail
  }
}

template <bool kBin>
int launch_scatter(const Call& c, const Work& w, int chunk, int mode,
                   int* offsets, int* counts, float* src, float* data,
                   int* keys_out, long long n_out, int mm, cudaStream_t s) {
  long long n_all = c.P > n_out ? c.P : n_out;
  if (n_all < c.nb + 1) n_all = c.nb + 1;
  const int smem = mode == kTiny
                       ? (int)sizeof(int) * (kTinyHistMax + c.nb + 1) : 0;
  bin_scatter_kernel<kBin>
      <<<(unsigned)((n_all + kThreadsD - 1) / kThreadsD), kThreadsD, smem,
         s>>>(c, w, chunk, mode, offsets, counts, src, data, keys_out, n_out,
              mm);
  return (int)cudaGetLastError();
}

// the forms: warps a block and steps a warp of the sequence pass
// (ops/bin_entries.FORMS)
template <int kW, int kJ, bool kBin>
int launch_multi(const Tris& tr, const Call& c, const Work& w, float* src,
                 int* offsets, int* counts, float* data, int* keys_out,
                 long long n_out, int mm, unsigned* tickets,
                 cudaStream_t s) {
  const int gridA = (c.T + 1 + kThreadsA - 1) / kThreadsA;
  const int chunk = 32 * kW * kJ;
  const long long n_chunks = (c.P + chunk - 1) / chunk;
  // a small call: each block of the sequence pass ranks for itself
  const bool here = c.big_cap <= kStageBig &&
                    n_chunks * gridA <= kRankHereMax;
  bin_tris_kernel<kBin><<<gridA, kThreadsA, 0, s>>>(tr, c, w, src, counts,
                                                    tickets, !here);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int smem = ranked_bytes(c.big_cap) +
                   (int)sizeof(unsigned short) * kW * (c.nb + 1);
  const bool tiny = n_chunks * (c.nb + 1) <= kTinyHistMax;
  err = (int)cudaFuncSetAttribute(bin_seq_kernel<kW, kJ, kBin>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  bin_seq_kernel<kW, kJ, kBin><<<(unsigned)n_chunks, 32 * kW, smem, s>>>(
      c, w, here ? gridA : 0, counts);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (!tiny) {
    bin_scan_kernel<<<(c.nb + 1 + kBinsC - 1) / kBinsC, kThreadsC, 0, s>>>(
        c, w, (int)n_chunks, tickets + 1);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return launch_scatter<kBin>(c, w, chunk, tiny ? kTiny : kSplit, offsets,
                              counts, src, data, keys_out, n_out, mm, s);
}

template <bool kBin>
int launch_form(int form, const Tris& tr, const Call& c, const Work& w,
                float* src, int* offsets, int* counts, float* data,
                int* keys_out, long long n_out, int mm, unsigned* tickets,
                cudaStream_t s) {
  switch (form) {
    case 1:
      return launch_multi<4, 8, kBin>(tr, c, w, src, offsets, counts, data,
                                      keys_out, n_out, mm, tickets, s);
    case 2:
      return launch_multi<8, 8, kBin>(tr, c, w, src, offsets, counts, data,
                                      keys_out, n_out, mm, tickets, s);
    case 3:
      return launch_multi<8, 16, kBin>(tr, c, w, src, offsets, counts, data,
                                       keys_out, n_out, mm, tickets, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// screen20: the channels' and the valid flag's pointers (tile keys: sx a b
// c, sy a b c, sz a b c; bin keys: bx0 bx1 by0 by1 first), then their
// element strides; ws13: the workspace's pieces (tiles, span, mask, bpart,
// big_idx, seg, meta, seq, lrank, hist, tot, bsum, rspan;
// ops/bin_entries._workspace);
// layout
// 0: tile keys over tw x tw windows, src f32 [(T + 1) 16], data f32
// [n_out 16] (mm: [n_out / 128, 16, 128]); layout 1: bin keys of the band
// [ty_lo, ty_lo + band) (band 0: the frame), keys_out i32 [P] (n_out = P);
// offsets i32 [n_bins + 1]; counts i32 [4] (n_small, n_big, n_pairs,
// n_valid); form 1-3: four launches (three where the histogram is tiny);
// tickets: two uint32 zeros that the last blocks leave zero.
extern "C" int bin_entries_launch(const long long* screen20,
                                  const long long* ws13, int layout, int T,
                                  int rows, int cols, int tw, int big_cap,
                                  int ty_lo, int band, float* src,
                                  int* offsets, int* counts, float* data,
                                  int* keys_out, long long n_out, int mm,
                                  int form, unsigned* tickets, void* stream) {
  const bool bin = layout == 1;
  Call c;
  c.T = T;
  c.rows = rows;
  c.cols = cols;
  c.tw = tw;
  c.tiles_y = (rows + kTileH - 1) / kTileH;
  const int tiles_x = (cols + kTileW - 1) / kTileW;
  if (T < 1 || rows < 1 || cols < 1 || (layout != 0 && layout != 1))
    return (int)cudaErrorInvalidValue;
  if (bin) {
    c.S = 4;
    c.gx = tiles_x * 8;
    c.tiles_y_eff = band > 0 ? band : c.tiles_y;
    c.ty_off = ty_lo;
    c.nb = c.tiles_y_eff * c.gx;
    c.big_cap = big_cap < T ? big_cap : T;
    c.y_lo_px = band > 0 ? (float)(ty_lo * kTileH) : 0.0f;
    const int hi_px = (ty_lo + band) * kTileH;
    c.y_hi_px = (float)(band > 0 && hi_px < rows ? hi_px : rows);
    if (T >= (1 << 18) || c.nb >= (1 << 13) || big_cap < 0 || ty_lo < 0 ||
        band < 0)
      return (int)cudaErrorInvalidValue;
  } else {
    c.S = tw * tw;
    c.gx = tiles_x;
    c.tiles_y_eff = c.tiles_y;
    c.ty_off = 0;
    c.nb = tiles_x * c.tiles_y;
    c.big_cap = big_cap;
    c.y_lo_px = 0.0f;
    c.y_hi_px = (float)rows;
    if (T >= (1 << 19) || tw < 1 || c.nb >= (1 << 12) || big_cap < 1)
      return (int)cudaErrorInvalidValue;
  }
  c.P = (long long)c.S * T + (long long)c.big_cap * c.nb;
  if (c.P >= INT_MAX || n_out < c.P || (mm && n_out % 128))
    return (int)cudaErrorInvalidValue;
  Tris tr;
  for (int k = 0; k < 9; ++k) {
    tr.p[k] = reinterpret_cast<const float*>(screen20[k]);
    tr.st[k] = screen20[10 + k];
  }
  tr.valid = reinterpret_cast<const bool*>(screen20[9]);
  tr.vst = screen20[19];
  Work w;
  w.tiles = reinterpret_cast<int*>(ws13[0]);
  w.span = reinterpret_cast<int4*>(ws13[1]);
  w.mask = reinterpret_cast<unsigned*>(ws13[2]);
  w.bpart = reinterpret_cast<int*>(ws13[3]);
  w.big_idx = reinterpret_cast<int*>(ws13[4]);
  w.seg = reinterpret_cast<int*>(ws13[5]);
  w.meta = reinterpret_cast<int*>(ws13[6]);
  w.seq = reinterpret_cast<int*>(ws13[7]);
  w.lrank = reinterpret_cast<int*>(ws13[8]);
  w.hist = reinterpret_cast<int*>(ws13[9]);
  w.tot = reinterpret_cast<int*>(ws13[10]);
  w.bsum = reinterpret_cast<int*>(ws13[11]);
  w.rspan = reinterpret_cast<int4*>(ws13[12]);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bin)
    return launch_form<true>(form, tr, c, w, src, offsets, counts, data,
                             keys_out, n_out, mm, tickets, s);
  return launch_form<false>(form, tr, c, w, src, offsets, counts, data,
                            keys_out, n_out, mm, tickets, s);
}
