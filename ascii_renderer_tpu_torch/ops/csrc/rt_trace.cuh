// The ray tracer's frame kernel K3: its device code and launch templates,
// shared by rt_trace.cu (the C entry; the rd3 and grid forms' instances)
// and rt_trace_trig.cu (the grid form's trig form's instances, kTrig).
// rt_trace.cu's opening comment gives the design.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

#include "ray_dir.cuh"

namespace cg = cooperative_groups;

namespace rt_trace_k {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-4f;  // raytrace.EPS
constexpr float kBig = 1e30f;  // pt_core.BIG: no hit
constexpr int kNone = INT_MAX;  // a lane's nearest hit before any slot
constexpr int kBlockViews = 4;  // views a block forms in shared memory
// shared memory a block may stage (dynamic; under the 48 KB that needs no
// opt-in): above it the launch reads the global arrays
constexpr size_t kStageBudget = 32 * 1024;
// threads the launch aims for when it picks the lanes a ray: 132 SMs of
// 1,024 (half their 2,048)
constexpr long long kFillThreads = 132LL * 1024;

struct V {
  float x, y, z;
};

struct Scene {
  const float* sph_pos;  // [S, 3]
  const float* sph_rad;  // [S]
  const bool* sph_valid;
  const int* sph_mat;
  const float* pln_n;  // [P, 3]
  const float* pln_d;  // [P]
  const bool* pln_valid;
  const int* pln_mat;
  const float* tri_a;   // [T, 3], quads split after the triangles
  const float* tri_e1;  // b - a
  const float* tri_e2;  // c - a
  const bool* tri_valid;
  const int* tri_mat;
  const float* mat_albedo;  // [M, 3]
  const bool* mat_reflective;
  const float* dl_dir;  // [DL, 3], the direction light travels
  const float* dl_col;
  const float* pt_pos;  // [PL, 3]
  const float* pt_col;
  const float* env_color;      // [3]
  const float* env_intensity;  // 0-d
  int n_sph, n_pln, n_tri;     // slots
  int n_dl, n_pt;              // the set lights (the first n_dl, n_pt slots)
  int pair;  // the first two set light slots are 0 and 1 (their terms meet
             // in one add, the left product fused)
};

// The primary rays: read from rd3 (with their views' origins cam), or,
// where rd3 is null, computed from the jitted grid of the row band
// [row_lo, row_lo + rays / cols) of a rows x cols grid, each view's 12
// floats (origin, uu, vv, focal * ww) read from views ([V, 12] on the
// device) or, for one view, taken from one (a launch argument); or, with
// trig 1, formed from the view's 8 trig floats (views [V, 8]).
struct Rays {
  const float* cam;  // [V, 3]
  const float* rd3;  // [V, R, 3]
  const float* views;
  float one[12];
  int trig;  // 0: 12 floats a view; 1: 8 (the trig form)
  int rows, cols, row_lo;
  float sx, sy, aspect;  // float32 2 / cols, 2 / rows, the aspect
};

// The block's staged scene: each kind's valid slots in slot order (rows
// in dynamic shared memory, sized from the slot counts), their original
// indices, their counts, and whether a sphere or triangle slot is padding.
struct Staged {
  const float4* sph;  // [ns]: x, y, z, r
  const float4* pln;  // [np]: nx, ny, nz, d
  const float4* tri;  // [3 nt]: ax ay az e1x, e1y e1z e2x e2y, e2z - - -
  const int* sph_i;
  const int* pln_i;
  const int* tri_i;
  int ns, np, nt;
  bool pad_occludes;  // an invalid sphere or triangle slot exists
};

__device__ __forceinline__ V ld3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ V sub(V a, V b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ float dot(V a, V b) {
  return fmaf(a.z, b.z, fmaf(a.x, b.x, a.y * b.y));
}

__device__ __forceinline__ float rdot(V a, V b) {
  return fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x + 0.0f));
}

__device__ __forceinline__ V cross(V a, V b) {
  return {fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
          fmaf(a.x, b.y, -(a.y * b.x))};
}

// fma(t, d, o): the hit point; also pos + n * EPS, the offset origin
__device__ __forceinline__ V mul_add(float t, V d, V o) {
  return {fmaf(t, d.x, o.x), fmaf(t, d.y, o.y), fmaf(t, d.z, o.z)};
}

__device__ __forceinline__ V offset(V n, V p) {
  return {fmaf(n.x, kEps, p.x), fmaf(n.y, kEps, p.y), fmaf(n.z, kEps, p.z)};
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// rt_core.spheres_t of a valid slot: the near root if > EPS, else the far
// one. kFuseC: c = fma(-r, r, dot(oc, oc)), else dot(oc, oc) - r*r
// rounded apart.
template <bool kFuseC>
__device__ __forceinline__ float sphere_t(V ro, V rd, V c, float r) {
  const V oc = sub(ro, c);
  const float b = dot(oc, rd);
  const float cc = dot(oc, oc);
  const float cq = kFuseC ? fmaf(-r, r, cc) : cc - r * r;
  const float h = fmaf(b, b, -cq);
  const float s = sqrtf(clamp_min(h, 0.0f));
  const float t1 = -b - s, t2 = -b + s;
  const float t = t1 > kEps ? t1 : (t2 > kEps ? t2 : kBig);
  return h >= 0.0f ? t : kBig;
}

// rt_core.planes_t of a valid slot: n . x + d = 0
__device__ __forceinline__ float plane_t(V ro, V rd, V n, float d) {
  const float denom = dot(n, rd);
  const float num = -d - dot(n, ro);
  const bool flat = fabsf(denom) < 1e-6f;
  const float t = num / (flat ? 1.0f : denom);
  return (flat || t <= kEps) ? kBig : t;
}

// rt_core.tris_t of a valid slot: Moller-Trumbore, t only
__device__ __forceinline__ float tri_t(V ro, V rd, V a, V e1, V e2) {
  const V p = cross(rd, e2);
  const float det = dot(e1, p);
  const bool bad = fabsf(det) < 1e-6f;
  const float inv = 1.0f / (bad ? 1.0f : det);
  const V tv = sub(ro, a);
  const float u = dot(tv, p) * inv;
  const V q = cross(tv, e1);
  const float v = dot(rd, q) * inv;
  const float tt = dot(e2, q) * inv;
  const bool miss = bad || u < 0.0f || u > 1.0f || v < 0.0f ||
                    u + v > 1.0f || tt <= kEps;
  return miss ? kBig : tt;
}

// The primitives as a ray's loops read them: from the staged rows, or
// (kStage false) from the global arrays.
template <bool kStage>
struct Prims;

template <>
struct Prims<true> {
  const Staged& st;
  __device__ int n_sph() const { return st.ns; }
  __device__ int n_pln() const { return st.np; }
  __device__ int n_tri() const { return st.nt; }
  __device__ bool sph_ok(int) const { return true; }
  __device__ bool pln_ok(int) const { return true; }
  __device__ bool tri_ok(int) const { return true; }
  __device__ int sph_slot(int i) const { return st.sph_i[i]; }
  __device__ int pln_slot(int i) const { return st.pln_i[i]; }
  __device__ int tri_slot(int i) const { return st.tri_i[i]; }
  template <bool kFuseC>
  __device__ float sphere(V ro, V rd, int i) const {
    const float4 c = st.sph[i];
    return sphere_t<kFuseC>(ro, rd, {c.x, c.y, c.z}, c.w);
  }
  __device__ float plane(V ro, V rd, int i) const {
    const float4 p = st.pln[i];
    return plane_t(ro, rd, {p.x, p.y, p.z}, p.w);
  }
  __device__ float tri(V ro, V rd, int i) const {
    const float4 r0 = st.tri[3 * i], r1 = st.tri[3 * i + 1],
                 r2 = st.tri[3 * i + 2];
    return tri_t(ro, rd, {r0.x, r0.y, r0.z}, {r0.w, r1.x, r1.y},
                 {r1.z, r1.w, r2.x});
  }
  // a padding slot's kBig is below tmax
  __device__ bool pad_occludes(float tmax) const {
    return st.pad_occludes && kBig < tmax;
  }
};

template <>
struct Prims<false> {
  const Scene& s;
  __device__ int n_sph() const { return s.n_sph; }
  __device__ int n_pln() const { return s.n_pln; }
  __device__ int n_tri() const { return s.n_tri; }
  __device__ bool sph_ok(int i) const { return s.sph_valid[i]; }
  __device__ bool pln_ok(int i) const { return s.pln_valid[i]; }
  __device__ bool tri_ok(int i) const { return s.tri_valid[i]; }
  __device__ int sph_slot(int i) const { return i; }
  __device__ int pln_slot(int i) const { return i; }
  __device__ int tri_slot(int i) const { return i; }
  template <bool kFuseC>
  __device__ float sphere(V ro, V rd, int i) const {
    return sphere_t<kFuseC>(ro, rd, ld3(s.sph_pos, i), s.sph_rad[i]);
  }
  __device__ float plane(V ro, V rd, int i) const {
    return plane_t(ro, rd, ld3(s.pln_n, i), s.pln_d[i]);
  }
  __device__ float tri(V ro, V rd, int i) const {
    return tri_t(ro, rd, ld3(s.tri_a, i), ld3(s.tri_e1, i),
                 ld3(s.tri_e2, i));
  }
  // occluded tests an invalid slot as its kBig (sph_ok / tri_ok false)
  __device__ bool pad_occludes(float) const { return false; }
};

// (t, slot) of a candidate: a NaN first, then the lesser t (-0 == +0),
// then the lesser slot; kNone is no candidate
__device__ __forceinline__ bool before(float ta, int ka, float tb, int kb) {
  if (kb == kNone) return ka != kNone;
  if (ka == kNone) return false;
  const bool na = isnan(ta), nb = isnan(tb);
  if (na != nb) return na;
  if (!na && ta != tb) return ta < tb;
  return ka < kb;
}

template <int L>
__device__ __forceinline__ void reduce_first_min(
    const cg::thread_block_tile<L>& g, float& t, int& k) {
  if constexpr (L > 1) {
#pragma unroll
    for (int m = L / 2; m > 0; m >>= 1) {
      const float to = g.shfl_xor(t, m);
      const int ko = g.shfl_xor(k, m);
      if (before(to, ko, t, k)) {
        t = to;
        k = ko;
      }
    }
  }
}

template <int L>
__device__ __forceinline__ bool group_any(const cg::thread_block_tile<L>& g,
                                          bool p) {
  if constexpr (L > 1) {
    return g.any(p);
  } else {
    return p;
  }
}

struct Hit {
  bool hit;
  float t;
  V pos, n;
  int mat;
};

// raytrace.closest_hit: the first minimum over spheres, planes, triangles
// (slots numbered in that order); lane r of the tile takes items r,
// r + L, ... of each list, then the tile reduces
template <bool kFuseC, int L, bool kStage>
__device__ Hit closest_hit(V ro, V rd, const Scene& s, const Prims<kStage>& P,
                           const cg::thread_block_tile<L>& g) {
  float best = 0.0f;
  int k = kNone;
  auto take = [&](float t, int j) {
    if (k == kNone || t < best || (isnan(t) && !isnan(best))) {
      best = t;
      k = j;
    }
  };
  const int lane = g.thread_rank();
  for (int i = lane; i < P.n_sph(); i += L)
    if (P.sph_ok(i)) take(P.template sphere<kFuseC>(ro, rd, i), P.sph_slot(i));
  for (int i = lane; i < P.n_pln(); i += L)
    if (P.pln_ok(i)) take(P.plane(ro, rd, i), s.n_sph + P.pln_slot(i));
  for (int i = lane; i < P.n_tri(); i += L)
    if (P.tri_ok(i))
      take(P.tri(ro, rd, i), s.n_sph + s.n_pln + P.tri_slot(i));
  reduce_first_min<L>(g, best, k);
  Hit h;
  h.t = best;
  h.hit = k != kNone && best < 5e29f;  // BIG * 0.5
  h.pos = mul_add(best, rd, ro);
  h.n = {0.0f, 0.0f, 0.0f};
  h.mat = 0;
  if (!h.hit) return h;  // neither normal nor material is read
  if (k < s.n_sph) {
    const V c = ld3(s.sph_pos, k);
    const float rsel = clamp_min(s.sph_rad[k], 1e-6f);
    h.n = {(h.pos.x - c.x) / rsel, (h.pos.y - c.y) / rsel,
           (h.pos.z - c.z) / rsel};
    h.mat = s.sph_mat[k];
  } else if (k < s.n_sph + s.n_pln) {
    h.n = ld3(s.pln_n, k - s.n_sph);
    h.mat = s.pln_mat[k - s.n_sph];
  } else {
    // rt_core.tri_hit_info's normal: cross(e1, e2) over its correctly
    // rounded length, flipped against rd
    const int kt = k - s.n_sph - s.n_pln;
    const V c = cross(ld3(s.tri_e1, kt), ld3(s.tri_e2, kt));
    const float inv =
        (float)(1.0 / sqrt((double)clamp_min(dot(c, c), 1e-20f)));
    V n = {c.x * inv, c.y * inv, c.z * inv};
    if (dot(n, rd) > 0.0f) n = {-n.x, -n.y, -n.z};
    h.n = n;
    h.mat = s.tri_mat[kt];
  }
  return h;
}

// raytrace.occluded: any sphere or triangle slot hit closer than tmax
// (planes cast no shadow), the tile's any-hit
template <bool kFuseC, int L, bool kStage>
__device__ bool occluded(V ro, V rd, float tmax, const Prims<kStage>& P,
                         const cg::thread_block_tile<L>& g) {
  const int lane = g.thread_rank();
  bool occ = lane == 0 && P.pad_occludes(tmax);
  for (int i = lane; i < P.n_sph() && !occ; i += L)
    occ = (P.sph_ok(i) ? P.template sphere<kFuseC>(ro, rd, i) : kBig) < tmax;
  for (int i = lane; i < P.n_tri() && !occ; i += L)
    occ = (P.tri_ok(i) ? P.tri(ro, rd, i) : kBig) < tmax;
  return group_any<L>(g, occ);
}

// raytrace.shade_diffuse: each set light adds (albedo * colour) * w, in
// slot order; with s.pair the first two terms meet in one add
// (fma(a0, w0, a1 * w1)), every later one fuses into the sum.
template <bool kFuseC, int L, bool kStage>
__device__ V shade_diffuse(V pos, V n, int mat, const Scene& s,
                           const Prims<kStage>& P,
                           const cg::thread_block_tile<L>& g) {
  const V alb = ld3(s.mat_albedo, mat);
  const V sro = offset(n, pos);  // shadow rays leave from pos + n * EPS
  float lo[3] = {0.0f, 0.0f, 0.0f};
  float a0[3], w0 = 0.0f;
  int terms = 0;
  auto add = [&](V col, float w) {
    const float a[3] = {alb.x * col.x, alb.y * col.y, alb.z * col.z};
    if (s.pair && terms == 0) {
      for (int c = 0; c < 3; ++c) a0[c] = a[c];
      w0 = w;
    } else if (s.pair && terms == 1) {
      for (int c = 0; c < 3; ++c) lo[c] = fmaf(a0[c], w0, a[c] * w);
    } else {
      for (int c = 0; c < 3; ++c) lo[c] = fmaf(a[c], w, lo[c]);
    }
    ++terms;
  };
  for (int i = 0; i < s.n_dl; ++i) {
    const V d = ld3(s.dl_dir, i);
    const float nd = clamp_min(sqrtf(rdot(d, d)), 1e-20f);
    const V L_ = {-d.x / nd, -d.y / nd, -d.z / nd};
    const float ndl = clamp_min(rdot(n, L_), 0.0f);
    const bool occ = occluded<kFuseC, L, kStage>(sro, L_, 1e5f, P, g);
    add(ld3(s.dl_col, i), (ndl > 0.0f && !occ) ? ndl : 0.0f);
  }
  for (int i = 0; i < s.n_pt; ++i) {
    const V lvec = sub(ld3(s.pt_pos, i), pos);
    const float d2 = clamp_min(rdot(lvec, lvec), 1e-6f);
    const float dist = sqrtf(d2);
    const V L_ = {lvec.x / dist, lvec.y / dist, lvec.z / dist};
    const float ndl = clamp_min(rdot(n, L_), 0.0f);
    const bool occ =
        occluded<kFuseC, L, kStage>(sro, L_, dist - 2.0f * kEps, P, g);
    const float att = 1.0f / fmaf(d2, 0.05f, 1.0f);  // 1 + d2 * 0.05
    add(ld3(s.pt_col, i), (ndl > 0.0f && !occ) ? ndl * att : 0.0f);
  }
  return {lo[0], lo[1], lo[2]};
}

// The barrier of the block's warps kW0..kWarps-1: the whole block's, or
// named barrier 1 where warp 0 does other work meanwhile.
template <int kW0>
__device__ __forceinline__ void stage_sync() {
  if constexpr (kW0 == 0)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;" ::"n"(kThreads - 32 * kW0) : "memory");
}

// Compact the valid slots of one kind (n slots, flags ok) in slot order:
// row j of the output is emit(j, slot). A ballot a warp, the warps'
// counts prefixed in shared memory. Returns the count; every thread of
// warps kW0..kWarps-1 calls it (the block's warps but warp 0 where kW0 is
// 1: it forms the trig form's bases meanwhile).
template <int kW0, typename Emit>
__device__ int compact(const bool* ok, int n, int* warp_tot, Emit emit) {
  constexpr int kP = kThreads - 32 * kW0;  // the threads that compact
  const int tid = threadIdx.x - 32 * kW0, lane = tid & 31, warp = tid >> 5;
  int total = 0;
  for (int base = 0; base < n; base += kP) {
    const int i = base + tid;
    const bool v = i < n && ok[i];
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    stage_sync<kW0>();
    int before_w = 0, chunk = 0;
    for (int w = 0; w < kWarps - kW0; ++w) {
      before_w += w < warp ? warp_tot[w] : 0;
      chunk += warp_tot[w];
    }
    if (v) emit(total + before_w + __popc(bal & ((1u << lane) - 1u)), i);
    total += chunk;
    stage_sync<kW0>();  // warp_tot is written again
  }
  return total;
}

// the staged rows' layout in dynamic shared memory (float4 units, then
// the indices) for ns, np, nt slots
__host__ __device__ inline size_t stage_bytes(int ns, int np, int nt) {
  return 16 * (size_t)(ns + np + 3 * nt) + 4 * (size_t)(ns + np + nt);
}

// The trig form's views of this block: the first view of its rays and how
// many they span (v0 -1 where it spans more than kBlockViews: its rays
// form their own). Thread t < nv (in warp 0) loads view v0 + t's 8 floats into tv
// here and forms its basis while the other warps stage the scene.
struct BlockViews {
  int v0, nv;
};

template <int L>
__device__ __forceinline__ BlockViews block_views(const Rays& p, int rays,
                                                  unsigned n, float* tv) {
  const unsigned first = blockIdx.x * (kThreads / L);
  const unsigned last = min(first + kThreads / L, n) - 1;
  const int v0 = first / (unsigned)rays;
  const int nv = (int)(last / (unsigned)rays) - v0 + 1;
  if (nv > kBlockViews) return {-1, 0};
  if ((int)threadIdx.x < nv) {
#pragma unroll
    for (int k = 0; k < 8; ++k) tv[k] = p.views[8 * (v0 + threadIdx.x) + k];
  }
  return {v0, nv};
}

// Ray i's origin and direction (i = view * rays + its ray in the view);
// kTrig: the trig form, vb / v0 the block's bases (block_views), v0 -1
// where it has none
template <bool kTrig>
__device__ __forceinline__ void primary_ray(const Rays& p, int rays,
                                           unsigned i, const float* vb,
                                           int v0, V& ro, V& rd) {
  const int view = i / (unsigned)rays;
  if (p.rd3 != nullptr) {
    ro = ld3(p.cam, view);
    rd = ld3(p.rd3, i);
    return;
  }
  float b[12];
  if constexpr (kTrig) {
    if (v0 >= 0) {
#pragma unroll
      for (int k = 0; k < 12; ++k) b[k] = vb[12 * (view - v0) + k];
    } else {  // a block of more than kBlockViews views
      ray_dir::view_basis(p.views + 8 * view, b);
    }
  } else if (p.views != nullptr) {
#pragma unroll
    for (int k = 0; k < 12; ++k) b[k] = p.views[12 * view + k];
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) b[k] = p.one[k];
  }
  const int j = (int)(i - (unsigned)view * rays);
  const int r = j / p.cols, col = j - r * p.cols;
  float x, y, d[3];
  ray_dir::jit_centre(p.rows, p.row_lo + r, col, p.sx, p.sy, p.aspect, x, y);
  ray_dir::direction<true>(x, y, b + 3, b + 6, b + 9, d);
  ro = {b[0], b[1], b[2]};
  rd = {d[0], d[1], d[2]};
}

// One ray's colour, every lane of its tile alike; lane 0 stores it.
template <bool kFuseP, bool kFuseS, int L, bool kStage, bool kTrig>
__device__ void trace_ray(const Prims<kStage>& P, const Rays& p, float* out,
                          int rays, unsigned i, const Scene& s,
                          const float* vb, int v0) {
  const cg::thread_block_tile<L> g =
      cg::tiled_partition<L>(cg::this_thread_block());
  V ro, rd;
  primary_ray<kTrig>(p, rays, i, vb, v0, ro, rd);
  const float inten = *s.env_intensity;
  const V env_raw = {s.env_color[0] * inten, s.env_color[1] * inten,
                     s.env_color[2] * inten};
  V col = {clamp01(env_raw.x), clamp01(env_raw.y), clamp01(env_raw.z)};
  const Hit h = closest_hit<kFuseP, L, kStage>(ro, rd, s, P, g);
  if (h.hit) {
    if (s.mat_reflective[h.mat]) {
      // one deterministic mirror bounce: rd - 2 (rd . n) n, x and y fused
      const float d2 = 2.0f * rdot(rd, h.n);
      const V rdir = {fmaf(-d2, h.n.x, rd.x), fmaf(-d2, h.n.y, rd.y),
                      rd.z - d2 * h.n.z};
      const Hit h2 =
          closest_hit<kFuseS, L, kStage>(offset(h.n, h.pos), rdir, s, P, g);
      col = h2.hit ? shade_diffuse<kFuseS, L, kStage>(h2.pos, h2.n, h2.mat,
                                                      s, P, g)
                   : env_raw;
    } else {
      col = shade_diffuse<kFuseS, L, kStage>(h.pos, h.n, h.mat, s, P, g);
    }
  }
  if (g.thread_rank() == 0) {
    float* o = out + 3 * (size_t)i;
    o[0] = clamp01(col.x);
    o[1] = clamp01(col.y);
    o[2] = clamp01(col.z);
  }
}

// kFuseP: the primary rays' sphere decision; kFuseS: the bounce and
// shadow rays'; L: lanes a ray; kStage: valid slots staged in shared
// memory; kTrig: the grid form's trig form (the views' bases formed here)
template <bool kFuseP, bool kFuseS, int L, bool kStage, bool kTrig>
__global__ void __launch_bounds__(kThreads)
rt_trace_kernel(const Rays p, float* __restrict__ out, int rays, unsigned n,
                Scene s) {
  extern __shared__ float4 smem[];
  __shared__ int warp_tot[kWarps];
  __shared__ float vb[kTrig ? 12 * kBlockViews : 1];
  __shared__ int counts[kTrig ? 3 : 1];  // the staged counts, for warp 0
  float tv[8];
  BlockViews bv{-1, 0};
  if constexpr (kTrig) bv = block_views<L>(p, rays, n, tv);
  Staged st{};
  if constexpr (kStage) {
    // a trig block's warp 0 forms its bases while warps 1-3 stage
    constexpr int kW0 = kTrig ? 1 : 0;
    float4* sph = smem;
    float4* pln = sph + s.n_sph;
    float4* tri = pln + s.n_pln;
    int* sph_i = reinterpret_cast<int*>(tri + 3 * s.n_tri);
    int* pln_i = sph_i + s.n_sph;
    int* tri_i = pln_i + s.n_pln;
    if ((int)threadIdx.x >= 32 * kW0) {
      st.ns = compact<kW0>(s.sph_valid, s.n_sph, warp_tot, [&](int j, int i) {
        sph[j] = make_float4(s.sph_pos[3 * i], s.sph_pos[3 * i + 1],
                             s.sph_pos[3 * i + 2], s.sph_rad[i]);
        sph_i[j] = i;
      });
      st.np = compact<kW0>(s.pln_valid, s.n_pln, warp_tot, [&](int j, int i) {
        pln[j] = make_float4(s.pln_n[3 * i], s.pln_n[3 * i + 1],
                             s.pln_n[3 * i + 2], s.pln_d[i]);
        pln_i[j] = i;
      });
      st.nt = compact<kW0>(s.tri_valid, s.n_tri, warp_tot, [&](int j, int i) {
        const float* a = s.tri_a + 3 * i;
        const float* e1 = s.tri_e1 + 3 * i;
        const float* e2 = s.tri_e2 + 3 * i;
        tri[3 * j] = make_float4(a[0], a[1], a[2], e1[0]);
        tri[3 * j + 1] = make_float4(e1[1], e1[2], e2[0], e2[1]);
        tri[3 * j + 2] = make_float4(e2[2], 0.0f, 0.0f, 0.0f);
        tri_i[j] = i;
      });
      if constexpr (kTrig) {
        if (threadIdx.x == 32) {
          counts[0] = st.ns;
          counts[1] = st.np;
          counts[2] = st.nt;
        }
      }
    } else if ((int)threadIdx.x < bv.nv) {
      ray_dir::view_basis(tv, vb + 12 * threadIdx.x);
    }
    __syncthreads();  // the staged scene (and the block's bases)
    if constexpr (kTrig) {
      st.ns = counts[0];
      st.np = counts[1];
      st.nt = counts[2];
    }
    st.sph = sph;
    st.pln = pln;
    st.tri = tri;
    st.sph_i = sph_i;
    st.pln_i = pln_i;
    st.tri_i = tri_i;
    st.pad_occludes = st.ns < s.n_sph || st.nt < s.n_tri;
  } else if constexpr (kTrig) {
    if (bv.v0 >= 0) {  // block-uniform
      if ((int)threadIdx.x < bv.nv)
        ray_dir::view_basis(tv, vb + 12 * threadIdx.x);
      __syncthreads();
    }
  }
  const int v0 = bv.v0;
  const unsigned i = (blockIdx.x * kThreads + threadIdx.x) / L;
  if (i >= n) return;  // the tile's lanes leave together
  if constexpr (kStage)
    trace_ray<kFuseP, kFuseS, L, true, kTrig>(Prims<true>{st}, p, out, rays,
                                              i, s, vb, v0);
  else
    trace_ray<kFuseP, kFuseS, L, false, kTrig>(Prims<false>{s}, p, out,
                                               rays, i, s, vb, v0);
}

template <bool kFuseP, bool kFuseS, int L, bool kStage, bool kTrig>
int launch(const Rays& p, float* out, int rays, unsigned n, const Scene& s,
           cudaStream_t stream) {
  const size_t smem = kStage ? stage_bytes(s.n_sph, s.n_pln, s.n_tri) : 0;
  const unsigned long long threads = (unsigned long long)n * L;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  rt_trace_kernel<kFuseP, kFuseS, L, kStage, kTrig>
      <<<blocks, kThreads, smem, stream>>>(p, out, rays, n, s);
  return (int)cudaGetLastError();
}

template <bool kFuseP, bool kFuseS, bool kStage, bool kTrig>
int launch_lanes(int lanes, const Rays& p, float* out, int rays, unsigned n,
                 const Scene& s, cudaStream_t st) {
  switch (lanes) {
    case 1:
      return launch<kFuseP, kFuseS, 1, kStage, kTrig>(p, out, rays, n, s, st);
    case 2:
      return launch<kFuseP, kFuseS, 2, kStage, kTrig>(p, out, rays, n, s, st);
    case 4:
      return launch<kFuseP, kFuseS, 4, kStage, kTrig>(p, out, rays, n, s, st);
    case 8:
      return launch<kFuseP, kFuseS, 8, kStage, kTrig>(p, out, rays, n, s, st);
    case 16:
      return launch<kFuseP, kFuseS, 16, kStage, kTrig>(p, out, rays, n, s,
                                                       st);
    case 32:
      return launch<kFuseP, kFuseS, 32, kStage, kTrig>(p, out, rays, n, s,
                                                       st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool kFuseP, bool kFuseS, bool kTrig>
int launch_form(int lanes, bool staged, const Rays& p, float* out, int rays,
                unsigned n, const Scene& s, cudaStream_t st) {
  return staged ? launch_lanes<kFuseP, kFuseS, true, kTrig>(lanes, p, out,
                                                            rays, n, s, st)
                : launch_lanes<kFuseP, kFuseS, false, kTrig>(lanes, p, out,
                                                             rays, n, s, st);
}

// launch_form by the sphere decisions (runtime values)
template <bool kTrig>
int launch_fused(int fuse_p, int fuse_s, int lanes, bool staged,
                 const Rays& p, float* out, int rays, unsigned n,
                 const Scene& s, cudaStream_t st) {
  if (fuse_p && !fuse_s)
    return launch_form<true, false, kTrig>(lanes, staged, p, out, rays, n, s,
                                           st);
  if (fuse_p && fuse_s)
    return launch_form<true, true, kTrig>(lanes, staged, p, out, rays, n, s,
                                          st);
  if (!fuse_p && !fuse_s)
    return launch_form<false, false, kTrig>(lanes, staged, p, out, rays, n,
                                            s, st);
  return launch_form<false, true, kTrig>(lanes, staged, p, out, rays, n, s,
                                         st);
}

// Whether a scene of these slot counts fits the staging budget.
inline bool stage_fits(int n_sph, int n_pln, int n_tri) {
  return stage_bytes(n_sph, n_pln, n_tri) <= kStageBudget;
}

// The trig form's launch (rt_trace_trig.cu): launch_form's instances of
// kTrig, in a source of their own so that both halves build in parallel.
int launch_trig(int fuse_p, int fuse_s, int lanes, bool staged,
                const Rays& p, float* out, int rays, unsigned n,
                const Scene& s, cudaStream_t st);

}  // namespace rt_trace_k
