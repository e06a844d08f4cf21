// The grouped layout build (X10): from the sorted pair keys
// (bin << 18) | tri and their bins' offsets, every output of the grouped
// generations' layout builds, bit for bit with ops/group_build's plain
// versions (the torch chains _group_bins, depth_group_order, _slot_gather,
// _pixel_origins and the K-row relayout):
//   group_build_offsets_kernel  (only when the caller has no offsets) a
//                      thread a bin: its first key, a binary search;
//   group_build_layout_kernel   one block: the bins' depths over the
//                      first p_eff = min(pair_cap, P) keys staged in shared
//                      memory; the nonempty ones compacted and put in depth
//                      order (descending, ascending bin id among equal
//                      depths: a stable sort) by a bitonic sort of (depth,
//                      id) keys, the empty ones after them by id; each group
//                      slot's bin (sentinel n_bins, depth 0 past the bins),
//                      depth, skip, K-aligned K-row start; each group's rows
//                      (its deepest slot rounded to CHUNK_RG); their scan,
//                      the row pointers (clamped to r_cap, halved for
//                      rows256); n_rows, n_pairs, n_used;
//   group_build_gather_kernel   a thread a (layout row, slot): its group by
//                      a search of the row pointers, its K-row, the pair
//                      index clamped into the zero-padded pair table, the
//                      16 channels of that pair's triangle (zero past
//                      p_eff) stored at the layout's place, the K-row -> row
//                      transpose folded into the address; the first
//                      grp_cap x 128 threads also write the lanes' pixel
//                      origins xl, yl.
// One template of addresses serves rows128 (subtile3: K = 1; subtile7 /
// subtile8: K = 4 / 8) and rows256 (subtile5 / subtile6: K = 2 / 4).
//
// Stands for XLA code, not a Pallas kernel: the layout builds of
// ascii_renderer_tpu/ops/raster_group.py (build_packed_rows_grouped_kgather
// :1109 and its kin, _group_bins :418, :1066), which XLA compiles into each
// frame's program; the torch chain is 87 launches at the headline, this is
// two (three without offsets).
//
// What bounds it on the H100: bytes. The layout's rows are written once
// (r_cap x 512 bytes) and their pairs' 64-byte rows read once; the sort's
// operations are few beside them. A thread writes one 64-byte
// slot as four 16-byte stores, neighbouring threads neighbouring slots.
#include <cuda_runtime.h>

namespace {

constexpr int kShift = 18;       // raster_subtile.SUB_SHIFT
constexpr int kTriMask = (1 << kShift) - 1;
constexpr int kChan = 16;        // raster_subtile.N_CHAN
constexpr int kNSub = 8;         // slots a group (bins a tile)
constexpr int kChunkRG = 32;     // raster_group.CHUNK_RG
constexpr int kTileW = 128, kTileH = 8, kSubW = 16;
constexpr int kThreads = 256;
constexpr int kThreadsL = 1024;  // the layout's one block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
group_build_offsets_kernel(const int* __restrict__ keys, long long P,
                           int n_bins, int* __restrict__ off) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q > n_bins) return;
  const int target = q << kShift;
  long long lo = 0, hi = P;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  off[q] = (int)lo;
}

// the least power of two at least n (1 for n <= 1)
__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// the depth of bin g over the first p_eff keys
__device__ __forceinline__ int depth_of(const int* __restrict__ off, int g,
                                        int p_eff) {
  return min(off[g + 1], p_eff) - min(off[g], p_eff);
}

// The inclusive sum of v over the layout's block: each thread gets its
// own prefix and the block's total.
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kThreadsL / 32; ++w) {
    before += w < warp ? warp_tot[w] : 0;
    total += warp_tot[w];
  }
  __syncthreads();
  return before + v;
}

__global__ void __launch_bounds__(kThreadsL)
group_build_layout_kernel(const int* __restrict__ off, int n_bins, int p_eff,
                          int k, int rows256, int r_cap, int grp_cap,
                          int* __restrict__ gbins, int* __restrict__ gdepth,
                          int* __restrict__ gskip, int* __restrict__ offk,
                          int* __restrict__ rowptr_u, int* __restrict__ rowptr,
                          int* __restrict__ counts) {
  // the nonempty bins' sort keys (depth descending, then bin id: the
  // depth order), a power of two of them; then the depths, each empty
  // bin's count of nonempty bins before it, the depth order
  extern __shared__ unsigned long long key[];
  const int n_keys = pow2_at_least(n_bins);
  int* dep = reinterpret_cast<int*>(key + n_keys);  // [n_bins]
  int* nz_before = dep + n_bins;                    // [n_bins]
  int* perm = nz_before + n_bins;                   // [n_bins]
  __shared__ int warp_tot[kThreadsL / 32];
  for (int g = threadIdx.x; g < n_bins; g += kThreadsL)
    dep[g] = depth_of(off, g, p_eff);
  __syncthreads();
  // the nonempty bins compacted in bin order; an empty bin's place in the
  // depth order is after them all, by its rank among the empty ones
  int n_used = 0;
  for (int base = 0; base < n_bins; base += kThreadsL) {
    const int g = base + threadIdx.x;
    const int f = g < n_bins && dep[g] > 0;
    int total;
    const int incl = n_used + block_scan(f, warp_tot, total);
    if (f)
      key[incl - 1] = ((unsigned long long)(0x7fffffff - dep[g]) << 13) | g;
    else if (g < n_bins)
      nz_before[g] = incl;
    n_used += total;
  }
  const int n_sort = pow2_at_least(n_used);
  for (int i = n_used + threadIdx.x; i < n_sort; i += kThreadsL)
    key[i] = ~0ull;  // padding sorts last
  __syncthreads();
  for (int g = threadIdx.x; g < n_bins; g += kThreadsL)
    if (dep[g] == 0) perm[n_used + g - nz_before[g]] = g;
  // a bitonic sort of the nonempty bins' keys (ids are distinct: stable)
  for (int kk = 2; kk <= n_sort; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_sort; i += kThreadsL) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long x = key[i], y = key[ixj];
          if ((x > y) == ((i & kk) == 0)) {
            key[i] = y;
            key[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int u = threadIdx.x; u < n_used; u += kThreadsL)
    perm[u] = (int)(key[u] & 8191u);
  __syncthreads();
  // a sentinel slot (depth 0) reads bin n_bins's offset; the single-entry
  // layout's reference gathers from offsets[:n_bins], which clamps it
  const int last = k == 1 ? n_bins - 1 : n_bins;
  int carry = 0;
  for (int base = 0; base < grp_cap; base += kThreadsL) {
    const int t = base + threadIdx.x;
    int dpad = 0;
    if (t < grp_cap) {
      int most = 0;
      for (int s = 0; s < kNSub; ++s) {
        const int i = t * kNSub + s;
        const int b = i < n_bins ? perm[i] : n_bins;
        const int d = b < n_bins ? dep[b] : 0;
        const int og = min(off[min(b, last)], p_eff);
        const int sk = d > 0 ? og % k : 0;
        const int rbk = (d + sk + k - 1) / k;  // K-rows the bin needs
        gbins[i] = b;
        gdepth[i] = d;
        gskip[i] = sk;
        offk[i] = (og - sk) / k;
        most = max(most, rbk);
      }
      dpad = (most * k + kChunkRG - 1) / kChunkRG * kChunkRG;
    }
    int total;
    const int incl = block_scan(dpad, warp_tot, total);
    if (t < grp_cap) {
      const int r = carry + incl;
      rowptr_u[t + 1] = r;
      rowptr[t + 1] = min(r, r_cap) >> rows256;
    }
    carry += total;
  }
  if (threadIdx.x == 0) {
    rowptr_u[0] = 0;
    rowptr[0] = 0;
    counts[0] = carry;        // n_rows, unclamped
    counts[1] = off[n_bins];  // n_pairs: every key in a real bin
    counts[2] = n_used;
  }
}

__global__ void __launch_bounds__(kThreads)
group_build_gather_kernel(const float* __restrict__ src, long long stride,
                          const int* __restrict__ keys, int p_eff, int k,
                          int rows256, int r_cap, int grp_cap,
                          const int* __restrict__ rowptr_u,
                          const int* __restrict__ offk,
                          const int* __restrict__ gbins, int n_bins,
                          int tiles_x, float y_off, float* __restrict__ rows,
                          float* __restrict__ xl, float* __restrict__ yl) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < (long long)grp_cap * kTileW) {  // the lanes' pixel origins
    const int t = (int)(i >> 7), l = (int)(i & 127);
    const int b = min(gbins[t * kNSub + (l >> 4)], n_bins - 1);
    const int tile = b / kNSub, sub = b % kNSub;
    const int x0 = (tile % tiles_x) * kTileW + sub * kSubW;
    const int y0 = (tile / tiles_x) * kTileH;
    xl[i] = (float)x0 + ((float)(l & 15) + 0.5f);
    yl[i] = (float)y0 + y_off;
  }
  if (i >= (long long)r_cap * kNSub) return;
  // layout row r, slot s and the slot's place
  int r, s;
  long long at;
  if (rows256) {  // [r_cap / 2, 256]: row r / 2, lanes 32 s + 16 (r % 2)
    const long long r2 = i >> 4;
    s = (int)((i >> 1) & 7);
    r = (int)(2 * r2 + (i & 1));
    at = r2 * 256 + s * 32 + (i & 1) * kChan;
  } else {  // [r_cap, 128]: lanes 16 s
    r = (int)(i >> 3);
    s = (int)(i & 7);
    at = (long long)r * kTileW + s * kChan;
  }
  const int q = r / k;  // the K-row
  // its group: the row pointers' count at or below it, clamped
  int lo = 0, hi = grp_cap;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rowptr_u[mid + 1] / k <= q)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int t = min(lo, grp_cap - 1);
  const int pek = (p_eff + k - 1) / k * k;
  int pidx = offk[t * kNSub + s] + (q - rowptr_u[t] / k);
  pidx = max(0, min(pidx, pek / k - 1));
  const int pe = pidx * k + r % k;
  float4 v[4];
  if (pe < p_eff) {
    const float4* row = reinterpret_cast<const float4*>(
        src + (long long)(keys[pe] & kTriMask) * stride);
    for (int c = 0; c < 4; ++c) v[c] = row[c];
  } else {
    for (int c = 0; c < 4; ++c) v[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4* out = reinterpret_cast<float4*>(rows + at);
  for (int c = 0; c < 4; ++c) out[c] = v[c];
}

}  // namespace

// src32: f32 rows of stride src_stride (16-byte aligned), channels 0-15
// read; keys: i32 [P] sorted; offsets: i32 [n_bins + 1] over all P keys
// (null: computed into ws); ws: i32 [(n_bins + 1) + 8 grp_cap + grp_cap +
// 1] (offsets, offk, unclamped row pointers); rows: f32
// rows128 [r_cap, 128] or rows256 [r_cap / 2, 256]; rowptr: i32
// [grp_cap + 1]; gdepth, gskip, gbins: i32 [8 grp_cap]; xl, yl: f32
// [grp_cap, 128]; counts: i32 [3] n_rows, n_pairs, n_used. Two launches
// (three without offsets).
extern "C" int group_build_launch(const float* src32, long long src_stride,
                                  const int* keys, long long P,
                                  const int* offsets, int p_eff, int n_bins,
                                  int tiles_x, int k, int rows256, int r_cap,
                                  int grp_cap, float y_off, int* ws,
                                  float* rows, int* rowptr, int* gdepth,
                                  int* gskip, float* xl, float* yl,
                                  int* gbins, int* counts, void* stream) {
  if (P < 1 || p_eff < 1 || p_eff > P || n_bins < 1 ||
      n_bins >= (1 << 13) || grp_cap < 1 || r_cap < kChunkRG ||
      r_cap % kChunkRG || (k != 1 && k != 2 && k != 4 && k != 8) ||
      (rows256 && k == 1) || src_stride < kChan || src_stride % 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* off = ws;
  int* offk = off + n_bins + 1;
  int* rowptr_u = offk + kNSub * grp_cap;
  int err;
  if (offsets == nullptr) {
    const int grid = (n_bins + 1 + kThreads - 1) / kThreads;
    group_build_offsets_kernel<<<grid, kThreads, 0, s>>>(keys, P, n_bins,
                                                         off);
    err = (int)cudaGetLastError();
    if (err) return err;
    offsets = off;
  }
  const int smem = (int)sizeof(unsigned long long) * pow2_at_least(n_bins) +
                   (int)sizeof(int) * 3 * n_bins;
  err = (int)cudaFuncSetAttribute(group_build_layout_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  group_build_layout_kernel<<<1, kThreadsL, smem, s>>>(
      offsets, n_bins, p_eff, k, rows256, r_cap, grp_cap, gbins, gdepth,
      gskip, offk, rowptr_u, rowptr, counts);
  err = (int)cudaGetLastError();
  if (err) return err;
  long long n = (long long)r_cap * kNSub;
  if ((long long)grp_cap * kTileW > n) n = (long long)grp_cap * kTileW;
  group_build_gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                              kThreads, 0, s>>>(
      src32, src_stride, keys, p_eff, k, rows256, r_cap, grp_cap, rowptr_u,
      offk, gbins, n_bins, tiles_x, y_off, rows, xl, yl);
  return (int)cudaGetLastError();
}
