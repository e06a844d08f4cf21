// The grouped layout build (X10): from the sorted pair keys
// (bin << 18) | tri and their bins' offsets, every output of the grouped
// generations' layout builds, bit for bit with ops/group_build's plain
// versions (the torch chains _group_bins, depth_group_order, _slot_gather,
// _pixel_origins and the K-row relayout):
//   group_build_offsets_kernel  (only when the caller has no offsets) a
//                      thread a bin: its first key, a binary search;
//   group_build_layout_kernel<K, rows256>   one block, in phases:
//                      depths: the offsets of the first p_eff = min(pair_cap,
//                      P) keys staged in shared memory, a ballot over each
//                      32 bins, each nonempty bin counted in its depth's
//                      bucket (1,024 buckets, one a depth, the last for
//                      depths >= 1023) by its warp, whose chunks of 32
//                      bins are contiguous (16-bit counts, one add a
//                      bucket of a chunk: __match_any_sync), each bin's
//                      place among its warp's bins of its bucket kept;
//                      compaction: a thread a bucket scans its warps'
//                      counts (a padded row); the 32-bin counts and
//                      the buckets' counts in one packed scan;
//                      order: a stable sort of the depths, descending: a
//                      nonempty bin's place is its bucket's start (the
//                      nonempty bins in deeper buckets), its warp's first
//                      place in the bucket and its kept place, with no
//                      compare;
//                      only the last bucket's bins are ranked by depth
//                      among themselves; each empty bin is placed after
//                      them all by its rank among the empty ones; each
//                      bin's place is also stored, ginv[b] (the inverse
//                      of the order over every bin, the places from 8
//                      grp_cap on, whose bins are dropped, included: K2's
//                      image form reads it);
//                      slots: a thread a group slot, its bin (sentinel
//                      n_bins, depth 0 past the bins), depth, skip and
//                      K-aligned K-row start; its group's rows (the deepest
//                      of 8 slots, 8 lanes, rounded to CHUNK_RG); their scan,
//                      the row pointers (clamped to r_cap, halved for
//                      rows256); n_rows, n_pairs, n_used; then each used
//                      K-row's group, written once (a warp a group's
//                      K-rows);
//   group_build_gather_kernel<K, rows256>   four lanes a (layout row,
//                      slot), one float4 each, two float4 a thread
//                      (GB_ITEMS): the K-row's group (the last
//                      group past the used K-rows) and the slot's start
//                      from the layout, the pair index clamped into the
//                      zero-padded pair table, 16 channels of that pair's
//                      triangle (zero past p_eff) stored at the layout's
//                      place (the K-row -> row transpose makes item j's 64
//                      bytes the layout's 64 j to 64 j + 63, so a warp
//                      stores 512 contiguous bytes); the first grp_cap x
//                      128 threads also write the lanes' pixel origins xl,
//                      yl.
// K and rows256 are template parameters: every division by K is a shift.
// One template of addresses serves rows128 (subtile3: K = 1; subtile7 /
// subtile8: K = 4 / 8) and rows256 (subtile5 / subtile6: K = 2 / 4).
//
// Stands for XLA code, not a Pallas kernel: the layout builds of
// ascii_renderer_tpu/ops/raster_group.py (build_packed_rows_grouped_kgather
// :418, _k2 :882, _k4 :969, depth_group_order :1066, _bin_offsets :1109,
// build_packed_rows_grouped :1193), which XLA compiles into each frame's
// program; the torch chain is 87 launches at the headline, this is two
// (three without offsets).
//
// What bounds it on the H100: bytes (the layout's rows written once, r_cap
// x 512 bytes, and their pairs' 64-byte rows read once). The layout block
// is a chain of phases on one SM; it keeps every phase in shared memory
// with no global load after the offsets and as few barriers as the phases
// need. Built by tools/build_variants.py with tools/csrc/stamps.cuh
// prepended, thread 0 of the layout block writes clock64() after each
// phase.
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
constexpr int kWarpsL = kThreadsL / 32;
constexpr unsigned kFull = 0xffffffffu;

// the layout block's phase stamps: nothing, unless tools/build_variants.py
// builds this source with tools/csrc/stamps.cuh prepended
#ifndef STAMP
#define STAMP(i)
#define STAMP_NS(i)
#endif

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

__host__ __device__ constexpr int log2_of(int k) {
  return k == 1 ? 0 : 1 + log2_of(k >> 1);
}

constexpr int kBuckets = 1024;  // depth buckets of the order, one a depth
                                // (the last holds every depth from 1023 on)
constexpr int kChunksW = 256 / kWarpsL;  // 32-bin chunks a warp at most
                                         // (n_bins < 8192)
// the warps' 16-bit counts of a bucket, a row padded to 80 bytes (a
// quarter warp's 16-byte loads of 8 rows hit 32 distinct banks)
constexpr int kRow = kWarpsL + 8;
constexpr int kCntInts = kRow * kBuckets / 2;
static_assert(kThreadsL == kBuckets, "a thread a bucket");

// the shared-memory ints of the layout block for n_bins bins
__host__ __device__ __forceinline__ int layout_smem_ints(int n_bins) {
  const int n_chunks = (n_bins + 31) / 32;
  // each warp's bin count a bucket (16 bits); offsets; 32-bin ballots and
  // their prefix; the depth order's first n_bins entries; the last
  // bucket's bins and depths; the buckets' starts
  return kCntInts + (n_bins + 1) + 2 * (n_chunks + 1) + n_bins +
         2 * n_chunks * 32 + kBuckets;
}

// The inclusive sum over the block of one value a thread (in thread
// order), and the block's total: a warp's scan, then warp 0's scan of the
// warps' sums (wsum: 2 kWarpsL + 1 ints); two barriers.
__device__ __forceinline__ int block_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int dd = 1; dd < 32; dd <<= 1) {
    const int x = __shfl_up_sync(kFull, v, dd);
    if (lane >= dd) v += x;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int x = wsum[lane];
    int w = x;
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int y = __shfl_up_sync(kFull, w, dd);
      if (lane >= dd) w += y;
    }
    wsum[kWarpsL + lane] = w - x;
    if (lane == 31) wsum[2 * kWarpsL] = w;
  }
  __syncthreads();
  total = wsum[2 * kWarpsL];
  return wsum[kWarpsL + warp] + v;
}

template <int K, bool kRows256>
__global__ void __launch_bounds__(kThreadsL)
group_build_layout_kernel(const int* __restrict__ off, int n_bins, int p_eff,
                          int r_cap, int grp_cap, int* __restrict__ gbins,
                          int* __restrict__ gdepth, int* __restrict__ gskip,
                          int* __restrict__ offr, int* __restrict__ rowptr_u,
                          int* __restrict__ rowptr, int* __restrict__ kgrp,
                          int* __restrict__ counts, int* __restrict__ ginv) {
  constexpr int kLog = log2_of(K);
  extern __shared__ __align__(16) int sm[];
  const int n_chunks = (n_bins + 31) / 32;
  // [kBuckets][kRow] each warp's nonempty bins a bucket, then (scanned
  // over the warps) the warp's first place in the bucket
  unsigned short* cnt = reinterpret_cast<unsigned short*>(sm);
  int* offs = sm + kCntInts;          // [n_bins + 1] offsets, clamped
  int* mask = offs + n_bins + 1;      // [n_chunks + 1] 32-bin ballots
  int* pre = mask + n_chunks + 1;     // [n_chunks + 1] their prefix
  int* perm = pre + n_chunks + 1;     // [n_bins] the depth order
  int* big = perm + n_bins;           // [32 n_chunks] the last bucket's bins
  int* bigd = big + n_chunks * 32;    // [32 n_chunks] and their depths
  int* start = bigd + n_chunks * 32;  // [kBuckets] deeper buckets' bins
  __shared__ int wsum[2 * kWarpsL + 1];
  __shared__ int n_big;                    // the last bucket's bins
  __shared__ unsigned used[kBuckets / 32];  // a bit a bucket used
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int n_slots = kNSub * grp_cap;
  const int n_perm = min(n_bins, n_slots);  // the order's entries read
  // a warp's chunks are contiguous, so its bins are in bin order
  const int cpw = (n_chunks + kWarpsL - 1) / kWarpsL;
  STAMP_NS(6);
  STAMP(0);
  // depths: the offsets of the first p_eff keys (a warp's loads all issued
  // first), a ballot a 32 bins, each nonempty bin counted in its depth's
  // bucket by its warp (one add a bucket of a chunk's 32 bins, a match);
  // each bin keeps its bucket and its place among the warp's bins of the
  // bucket (its earlier chunks' and lanes')
  for (int q = tid; q < kCntInts / 4; q += kThreadsL)
    reinterpret_cast<int4*>(sm)[q] = make_int4(0, 0, 0, 0);
  if (tid < kBuckets / 32) used[tid] = 0u;
  int o0[kChunksW], o1[kChunksW];
#pragma unroll
  for (int it = 0; it < kChunksW; ++it) {
    const int g = (warp * cpw + it) * 32 + lane;
    const bool in = it < cpw && g < n_bins;
    o0[it] = in ? off[g] : 0;
    o1[it] = in ? off[g + 1] : 0;
  }
  __syncthreads();  // the counts cleared (the loads in flight)
  // a bin's bucket + 1 (0: empty) in the low 11 bits, its place among its
  // warp's bins of the bucket above them
  int bk[kChunksW];
#pragma unroll
  for (int it = 0; it < kChunksW; ++it) {
    const int c = warp * cpw + it, g = c * 32 + lane;
    bk[it] = 0;
    if (it >= cpw || c >= n_chunks) continue;
    const int a = min(o0[it], p_eff), d = min(o1[it], p_eff) - a;
    if (g < n_bins) offs[g] = a;
    if (g == n_bins - 1) offs[n_bins] = a + d;
    const unsigned m = __ballot_sync(kFull, d > 0);
    if (lane == 0) mask[c] = (int)m;
    if (m == 0) continue;  // 32 empty bins
    const int b = d > 0 ? min(d, kBuckets - 1) : -1;
    const unsigned peers = __match_any_sync(kFull, b);
    unsigned short* mine = cnt + max(b, 0) * kRow + warp;
    const int first = d > 0 ? *mine : 0;
    bk[it] = (b + 1) | ((first + __popc(peers & below)) << 11);
    __syncwarp();
    if (d > 0 && (peers & below) == 0) {
      *mine = first + __popc(peers);
      if (first == 0) atomicOr(&used[b >> 5], 1u << (b & 31));
    }
    __syncwarp();
  }
  __syncthreads();
  STAMP(1);
  // compaction: a thread a bucket (deepest first) scans its warps' counts,
  // 64 bytes of its row (each warp's first place in the bucket; only the
  // buckets used); then one scan of the 32-bin counts (a thread a 32 bins,
  // low 16 bits) and the buckets' counts (high 16 bits): a bucket's start
  // is the count of nonempty bins in deeper buckets
  int n_used;
  {
    const int bb = kBuckets - 1 - tid;
    int h = 0;
    if ((used[bb >> 5] >> (bb & 31)) & 1u) {
      uint4* row = reinterpret_cast<uint4*>(cnt + bb * kRow);
      unsigned w[kWarpsL / 2];  // two warps' counts a word
#pragma unroll
      for (int j = 0; j < kWarpsL / 8; ++j) {
        const uint4 x = row[j];
        w[4 * j] = x.x;
        w[4 * j + 1] = x.y;
        w[4 * j + 2] = x.z;
        w[4 * j + 3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < kWarpsL / 2; ++j) {
        const int lo = w[j] & 0xffff, hi = w[j] >> 16;
        w[j] = (unsigned)h | ((unsigned)(h + lo) << 16);
        h += lo + hi;
      }
#pragma unroll
      for (int j = 0; j < kWarpsL / 8; ++j)
        row[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2],
                            w[4 * j + 3]);
    }
    if (tid == 0) n_big = h;
    const int v = tid < n_chunks ? __popc((unsigned)mask[tid]) : 0;
    int tot;
    const int inc = block_scan(v | (h << 16), wsum, tot);
    if (tid < n_chunks) pre[tid] = (inc & 0xffff) - v;
    start[bb] = (inc >> 16) - h;
    n_used = tot & 0xffff;
  }
  __syncthreads();
  STAMP(2);
  // order: a stable sort of the depths, descending. A nonempty bin's place
  // is its bucket's start, its warp's first place in the bucket and its
  // place among the warp's bins of the bucket, with no compare; the last
  // bucket's bins are listed so (in bin order) and ranked by depth among
  // themselves. An empty bin's place is after the nonempty ones, by its
  // rank among the empty ones.
#pragma unroll
  for (int it = 0; it < kChunksW; ++it) {
    const int c = warp * cpw + it, g = c * 32 + lane;
    if (it >= cpw || c >= n_chunks) break;
    const int b = (bk[it] & 2047) - 1;
    if (b >= 0) {
      const int u = start[b] + cnt[b * kRow + warp] + (bk[it] >> 11);
      if (b < kBuckets - 1) {
        if (u < n_perm) perm[u] = g;
        ginv[g] = u;
      } else {  // the last bucket starts at 0
        big[u] = g;
        bigd[u] = offs[g + 1] - offs[g];
      }
    } else if (g < n_bins) {
      const int e =
          n_used + g - pre[c] - __popc((unsigned)mask[c] & below);
      if (e < n_perm) perm[e] = g;
      ginv[g] = e;
    }
  }
  __syncthreads();
  if (n_big > 0) {  // depths from 1023 on: deeper, or as deep and before;
                    // a warp a bin, its lanes over the others
    for (int u = warp; u < n_big; u += kWarpsL) {
      const int d = bigd[u];
      int r = 0;
      for (int q = lane; q < n_big; q += 32) {
        const int dq = bigd[q];
        r += dq > d || (dq == d && q < u);
      }
      r = __reduce_add_sync(kFull, r);
      if (lane == 0) {
        if (r < n_perm) perm[r] = big[u];
        ginv[big[u]] = r;
      }
    }
    __syncthreads();
  }
  STAMP(3);
  // slots: a thread a group slot, 8 lanes a group; a sentinel slot (depth
  // 0) reads bin n_bins's offset; the single-entry layout's reference
  // gathers from offsets[:n_bins], which clamps it. The row pointers are
  // also kept in shared memory where they fit (over the warps' counts,
  // read no more)
  int* rp = grp_cap + 1 <= kCntInts ? sm : nullptr;
  const int last = K == 1 ? n_bins - 1 : n_bins;
  int carry = 0;
  if (tid == 0) {
    rowptr_u[0] = 0;
    rowptr[0] = 0;
    if (rp) rp[0] = 0;
  }
  for (int base = 0; base < n_slots; base += kThreadsL) {
    const int i = base + tid;
    int b = n_bins, d = 0, sk = 0, og = 0;
    if (i < n_slots) {
      if (i < n_bins) b = perm[i];
      if (b < n_bins) d = offs[b + 1] - offs[b];
      og = offs[min(b, last)];
      sk = d > 0 ? og & (K - 1) : 0;
      gbins[i] = b;
      gdepth[i] = d;
      gskip[i] = sk;
    }
    int most = (d + sk + K - 1) >> kLog;  // K-rows the bin needs
    most = max(most, __shfl_xor_sync(kFull, most, 1));
    most = max(most, __shfl_xor_sync(kFull, most, 2));
    most = max(most, __shfl_xor_sync(kFull, most, 4));
    const int dpad = ((most << kLog) + kChunkRG - 1) & ~(kChunkRG - 1);
    // the groups' rows scanned: a group's leader lane holds its dpad
    int total;
    const int end =
        carry + block_scan((lane & 7) == 0 ? dpad : 0, wsum, total);
    if (i < n_slots) {
      offr[i] = ((og - sk) >> kLog) - ((end - dpad) >> kLog);
      if ((i & 7) == 0) {
        const int t = i >> 3;
        rowptr_u[t + 1] = end;
        rowptr[t + 1] = min(end, r_cap) >> (kRows256 ? 1 : 0);
        if (rp) rp[t + 1] = end;
      }
    }
    carry += total;
  }
  if (tid == 0) {
    counts[0] = carry;        // n_rows, unclamped
    counts[1] = off[n_bins];  // n_pairs: every key in a real bin
    counts[2] = n_used;
  }
  __syncthreads();
  // each used K-row's group, a warp a group's K-rows (the gather takes the
  // last group past them: the reference's clamped search)
  const int rk_cap = r_cap >> kLog;
  const int* rpu = rp ? rp : rowptr_u;
  for (int t = warp; t < grp_cap; t += kWarpsL) {
    const int a = min(rpu[t] >> kLog, rk_cap);
    const int b = min(rpu[t + 1] >> kLog, rk_cap);
    for (int q = a + lane; q < b; q += 32) kgrp[q] = t;
  }
  STAMP(4);
  STAMP_NS(7);
}

// the gather's float4 a thread (tools/build_variants.py also builds 1)
#ifndef GB_ITEMS
#define GB_ITEMS 2
#endif
constexpr int kItems = GB_ITEMS;

// Four lanes a (layout row, slot), one float4 each, kItems float4 a
// thread (blockDim apart). Item j's 64 bytes are the layout's floats 16 j
// to 16 j + 15 in both layouts.
template <int K, bool kRows256>
__global__ void __launch_bounds__(kThreads)
group_build_gather_kernel(const float* __restrict__ src, long long stride,
                          const int* __restrict__ keys, int p_eff, int r_cap,
                          int grp_cap, const int* __restrict__ kgrp,
                          const int* __restrict__ offr,
                          const int* __restrict__ rowptr_u,
                          const int* __restrict__ gbins, int n_bins,
                          int tiles_x, float y_off, float* __restrict__ rows,
                          float* __restrict__ xl, float* __restrict__ yl) {
  constexpr int kLog = log2_of(K);
  const long long i0 =
      (long long)blockIdx.x * kThreads * kItems + threadIdx.x;
  for (int m = 0; m < kItems; ++m) {  // the lanes' pixel origins
    const long long i = i0 + (long long)m * kThreads;
    if (i >= (long long)grp_cap * kTileW) break;
    const int t = (int)(i >> 7), l = (int)(i & 127);
    const int b = min(gbins[t * kNSub + (l >> 4)], n_bins - 1);
    const int tile = b >> 3, sub = b & 7;
    const int x0 = (tile % tiles_x) * kTileW + sub * kSubW;
    const int y0 = (tile / tiles_x) * kTileH;
    xl[i] = (float)x0 + ((float)(l & 15) + 0.5f);
    yl[i] = (float)y0 + y_off;
  }
  const long long n = (long long)r_cap * kNSub * 4;  // float4 of the rows
  if (i0 >= n) return;
  const int rk_end = min(rowptr_u[grp_cap] >> kLog, r_cap >> kLog);
  const int hi = ((p_eff + K - 1) >> kLog) - 1;
  int tri[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int j = (int)(min(i0 + (long long)m * kThreads, n - 1) >> 2);
    int r, s;  // item j's layout row and slot
    if (kRows256) {  // [r_cap / 2, 256]: row r / 2, lanes 32 s + 16 (r % 2)
      s = (j >> 1) & 7;
      r = ((j >> 4) << 1) | (j & 1);
    } else {         // [r_cap, 128]: lanes 16 s
      r = j >> 3;
      s = j & 7;
    }
    const int q = r >> kLog;  // the K-row, and its group (the last past
    const int g = kgrp[q];    // the used K-rows, whose groups are unset)
    const int t = q < rk_end ? g : grp_cap - 1;
    const int pidx = max(0, min(offr[t * kNSub + s] + q, hi));
    const int pe = (pidx << kLog) | (r & (K - 1));
    tri[m] = pe < p_eff ? keys[pe] & kTriMask : -1;
  }
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const long long i = i0 + (long long)m * kThreads;
    if (i >= n) break;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tri[m] >= 0)
      v = reinterpret_cast<const float4*>(src + (long long)tri[m] *
                                                    stride)[i & 3];
    reinterpret_cast<float4*>(rows)[i] = v;
  }
}

template <int K, bool kRows256>
int launch_layout_gather(const float* src32, long long src_stride,
                         const int* keys, const int* off, int p_eff,
                         int n_bins, int tiles_x, int r_cap, int grp_cap,
                         float y_off, int* offr, int* rowptr_u,
                         int* kgrp, float* rows, int* rowptr, int* gdepth,
                         int* gskip, float* xl, float* yl, int* gbins,
                         int* counts, int* ginv, cudaStream_t s) {
  const int smem = (int)sizeof(int) * layout_smem_ints(n_bins);
  static int smem_set = 0;  // the largest dynamic smem asked for so far
  if (smem > 48 * 1024 && smem > smem_set) {
    const int err = (int)cudaFuncSetAttribute(
        group_build_layout_kernel<K, kRows256>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    smem_set = smem;
  }
  group_build_layout_kernel<K, kRows256><<<1, kThreadsL, smem, s>>>(
      off, n_bins, p_eff, r_cap, grp_cap, gbins, gdepth, gskip, offr,
      rowptr_u, rowptr, kgrp, counts, ginv);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  long long n = (long long)r_cap * kNSub * 4;
  if ((long long)grp_cap * kTileW > n) n = (long long)grp_cap * kTileW;
  const long long per = (long long)kThreads * kItems;
  group_build_gather_kernel<K, kRows256>
      <<<(unsigned)((n + per - 1) / per), kThreads, 0, s>>>(
          src32, src_stride, keys, p_eff, r_cap, grp_cap, kgrp, offr,
          rowptr_u, gbins, n_bins, tiles_x, y_off, rows, xl, yl);
  return (int)cudaGetLastError();
}

}  // namespace

// src32: f32 rows of stride src_stride (16-byte aligned), channels 0-15
// read; keys: i32 [P] sorted; offsets: i32 [n_bins + 1] over all P keys
// (null: computed into ws); ws: i32 [(n_bins + 1) + 8 grp_cap + (grp_cap
// + 1) + r_cap / k] (offsets, each slot's K-row start less its group's,
// the unclamped row pointers, each K-row's group); rows: f32 rows128 [r_cap,
// 128] or rows256 [r_cap / 2, 256] (16-byte aligned); rowptr: i32
// [grp_cap + 1]; gdepth, gskip, gbins: i32 [8 grp_cap]; xl, yl: f32
// [grp_cap, 128]; counts: i32 [3] n_rows, n_pairs, n_used; ginv: i32
// [n_bins] each bin's place in the depth order. Two launches (three without
// offsets).
extern "C" int group_build_launch(const float* src32, long long src_stride,
                                  const int* keys, long long P,
                                  const int* offsets, int p_eff, int n_bins,
                                  int tiles_x, int k, int rows256, int r_cap,
                                  int grp_cap, float y_off, int* ws,
                                  float* rows, int* rowptr, int* gdepth,
                                  int* gskip, float* xl, float* yl,
                                  int* gbins, int* counts, int* ginv,
                                  void* stream) {
  if (P < 1 || p_eff < 1 || p_eff > P || n_bins < 1 ||
      n_bins >= (1 << 13) || grp_cap < 1 || r_cap < kChunkRG ||
      r_cap % kChunkRG ||
      (rows256 ? k != 2 && k != 4 : k != 1 && k != 4 && k != 8) ||
      src_stride < kChan || src_stride % 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* off = ws;
  int* offr = off + n_bins + 1;
  int* rowptr_u = offr + kNSub * grp_cap;
  int* kgrp = rowptr_u + grp_cap + 1;
  if (offsets == nullptr) {
    const int grid = (n_bins + 1 + kThreads - 1) / kThreads;
    group_build_offsets_kernel<<<grid, kThreads, 0, s>>>(keys, P, n_bins,
                                                         off);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    offsets = off;
  }
#define GB_LAUNCH(KK, R256)                                                  \
  return launch_layout_gather<KK, R256>(                                     \
      src32, src_stride, keys, offsets, p_eff, n_bins, tiles_x, r_cap,       \
      grp_cap, y_off, offr, rowptr_u, kgrp, rows, rowptr, gdepth, gskip, xl, \
      yl, gbins, counts, ginv, s)
  if (rows256) {
    if (k == 2) GB_LAUNCH(2, true);
    GB_LAUNCH(4, true);
  }
  if (k == 1) GB_LAUNCH(1, false);
  if (k == 4) GB_LAUNCH(4, false);
  GB_LAUNCH(8, false);
#undef GB_LAUNCH
}
