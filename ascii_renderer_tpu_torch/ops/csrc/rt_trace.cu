// The ray tracer's frame after its primary grid, one thread a ray, every
// view of a batch in one launch: the nearest hit over spheres, planes and
// triangles (quads split), the hit's normal and material, direct light
// with hard shadows, one mirror bounce and its shade, the environment
// where a ray misses, the clamp. backends/raytrace.trace_rgb is the plain
// version (closest_hit, occluded, shade_diffuse); it rounds as the
// reference's jitted program, the products fused by backends/rt_core's
// rules, and this kernel rounds each chain the same way with fmaf:
//   dot     (ax*bx + ay*by) + az*bz  -> fma(az, bz, fma(ax, bx, ay*by))
//   rdot    sum of a*b from 0        -> fma(az, bz, fma(ay, by, ax*bx + 0))
//   cross   a1*b2 - a2*b1            -> fma(a1, b2, -(a2*b1))
//   reflect rd - 2 (rd . n) n        -> x, y fma(-2d, n, rd); z rounded apart
// Every such site fuses in every case but one: a sphere's
// c = dot(oc, oc) - r*r, whose product fuses only where r*r is formed in
// the loop of dot(oc, oc) (rt_core._sub_mul). That is so for primary rays
// (one origin a view) and not for bounce and shadow rays; the wrapper
// passes each case's decision (ops/rt_trace.FUSE, from the shapes), and
// the sphere test takes it as a template flag. Roots are IEEE sqrtf (the
// correctly rounded root of core/fp.sqrt32), 1 / sqrt is taken in double
// and rounded once (core/fp.rsqrt32), divisions are IEEE, clamps are
// torch's on CUDA (NaN kept, else fmaxf / fminf), and the nearest hit is
// the first minimum, a NaN first (torch.argmin), so a sphere wins a tie
// over a plane and a plane over a triangle.
//
// Stands for XLA code, not a Pallas kernel: render_rgb's closest_hit,
// occluded, shade_diffuse and the bounce in
// ascii_renderer_tpu/backends/raytrace.py:68, :115, :136 and :166, which
// the reference runs under jax.jit. On CUDA tensors the plain version is
// hundreds of torch launches a frame over [V, P, R] candidate matrices;
// this is one launch.
//
// What bounds it on the H100: operations. A ray tests every primitive
// (a sphere ~27 float operations, a plane ~17, a triangle ~60, a fused
// product-add counted as two: chip_smoke.RT_OPS_*), for its
// primary ray, its shadow rays (spheres and triangles) and, on a mirror,
// its bounce; bytes are 12 in and 12 out a ray (the scene, a few KB,
// stays in L1). Primitives are read in the same order by every thread of
// a warp, so their loads are broadcasts.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-4f;  // raytrace.EPS
constexpr float kBig = 1e30f;  // pt_core.BIG: no hit

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

// rt_core.spheres_t: the near root if > EPS, else the far one. kFuseC:
// c = fma(-r, r, dot(oc, oc)), else dot(oc, oc) - r*r rounded apart.
template <bool kFuseC>
__device__ __forceinline__ float sphere_t(V ro, V rd, V c, float r,
                                          bool valid) {
  const V oc = sub(ro, c);
  const float b = dot(oc, rd);
  const float cc = dot(oc, oc);
  const float cq = kFuseC ? fmaf(-r, r, cc) : cc - r * r;
  const float h = fmaf(b, b, -cq);
  const float s = sqrtf(clamp_min(h, 0.0f));
  const float t1 = -b - s, t2 = -b + s;
  const float t = t1 > kEps ? t1 : (t2 > kEps ? t2 : kBig);
  return (h >= 0.0f && valid) ? t : kBig;
}

// rt_core.planes_t: n . x + d = 0
__device__ __forceinline__ float plane_t(V ro, V rd, V n, float d,
                                         bool valid) {
  const float denom = dot(n, rd);
  const float num = -d - dot(n, ro);
  const bool flat = fabsf(denom) < 1e-6f;
  const float t = num / (flat ? 1.0f : denom);
  return (flat || t <= kEps || !valid) ? kBig : t;
}

// rt_core.tris_t: Moller-Trumbore, t only
__device__ __forceinline__ float tri_t(V ro, V rd, V a, V e1, V e2,
                                       bool valid) {
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
                    u + v > 1.0f || tt <= kEps || !valid;
  return miss ? kBig : tt;
}

struct Hit {
  bool hit;
  float t;
  V pos, n;
  int mat;
};

// raytrace.closest_hit: the first minimum over spheres, planes, triangles
template <bool kFuseC>
__device__ Hit closest_hit(V ro, V rd, const Scene& s) {
  float best = 0.0f;
  int k = -1;
  auto take = [&](float t, int j) {
    if (k < 0 || t < best || (isnan(t) && !isnan(best))) {
      best = t;
      k = j;
    }
  };
  for (int i = 0; i < s.n_sph; ++i)
    take(sphere_t<kFuseC>(ro, rd, ld3(s.sph_pos, i), s.sph_rad[i],
                          s.sph_valid[i]),
         i);
  for (int i = 0; i < s.n_pln; ++i)
    take(plane_t(ro, rd, ld3(s.pln_n, i), s.pln_d[i], s.pln_valid[i]),
         s.n_sph + i);
  for (int i = 0; i < s.n_tri; ++i)
    take(tri_t(ro, rd, ld3(s.tri_a, i), ld3(s.tri_e1, i), ld3(s.tri_e2, i),
               s.tri_valid[i]),
         s.n_sph + s.n_pln + i);
  Hit h;
  h.t = best;
  h.hit = best < 5e29f;  // BIG * 0.5
  h.pos = mul_add(best, rd, ro);
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

// raytrace.occluded: any sphere or triangle hit closer than tmax (planes
// cast no shadow)
template <bool kFuseC>
__device__ bool occluded(V ro, V rd, float tmax, const Scene& s) {
  for (int i = 0; i < s.n_sph; ++i)
    if (sphere_t<kFuseC>(ro, rd, ld3(s.sph_pos, i), s.sph_rad[i],
                         s.sph_valid[i]) < tmax)
      return true;
  for (int i = 0; i < s.n_tri; ++i)
    if (tri_t(ro, rd, ld3(s.tri_a, i), ld3(s.tri_e1, i), ld3(s.tri_e2, i),
              s.tri_valid[i]) < tmax)
      return true;
  return false;
}

// raytrace.shade_diffuse: each set light adds (albedo * colour) * w, in
// slot order; with s.pair the first two terms meet in one add
// (fma(a0, w0, a1 * w1)), every later one fuses into the sum.
template <bool kFuseC>
__device__ V shade_diffuse(V pos, V n, int mat, const Scene& s) {
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
    const V L = {-d.x / nd, -d.y / nd, -d.z / nd};
    const float ndl = clamp_min(rdot(n, L), 0.0f);
    const bool occ = occluded<kFuseC>(sro, L, 1e5f, s);
    add(ld3(s.dl_col, i), (ndl > 0.0f && !occ) ? ndl : 0.0f);
  }
  for (int i = 0; i < s.n_pt; ++i) {
    const V lvec = sub(ld3(s.pt_pos, i), pos);
    const float d2 = clamp_min(rdot(lvec, lvec), 1e-6f);
    const float dist = sqrtf(d2);
    const V L = {lvec.x / dist, lvec.y / dist, lvec.z / dist};
    const float ndl = clamp_min(rdot(n, L), 0.0f);
    const bool occ = occluded<kFuseC>(sro, L, dist - 2.0f * kEps, s);
    const float att = 1.0f / fmaf(d2, 0.05f, 1.0f);  // 1 + d2 * 0.05
    add(ld3(s.pt_col, i), (ndl > 0.0f && !occ) ? ndl * att : 0.0f);
  }
  return {lo[0], lo[1], lo[2]};
}

// kFuseP: the primary rays' sphere decision; kFuseS: the bounce and
// shadow rays'
template <bool kFuseP, bool kFuseS>
__global__ void __launch_bounds__(kThreads)
rt_trace_kernel(const float* __restrict__ cam, const float* __restrict__ rd3,
                float* __restrict__ out, int rays, unsigned n, Scene s) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int view = i / (unsigned)rays;
  const V ro = ld3(cam, view);
  const V rd = ld3(rd3, i);
  const float inten = *s.env_intensity;
  const V env_raw = {s.env_color[0] * inten, s.env_color[1] * inten,
                     s.env_color[2] * inten};
  V col = {clamp01(env_raw.x), clamp01(env_raw.y), clamp01(env_raw.z)};
  const Hit h = closest_hit<kFuseP>(ro, rd, s);
  if (h.hit) {
    if (s.mat_reflective[h.mat]) {
      // one deterministic mirror bounce: rd - 2 (rd . n) n, x and y fused
      const float d2 = 2.0f * rdot(rd, h.n);
      const V rdir = {fmaf(-d2, h.n.x, rd.x), fmaf(-d2, h.n.y, rd.y),
                      rd.z - d2 * h.n.z};
      const Hit h2 = closest_hit<kFuseS>(offset(h.n, h.pos), rdir, s);
      col = h2.hit ? shade_diffuse<kFuseS>(h2.pos, h2.n, h2.mat, s)
                   : env_raw;
    } else {
      col = shade_diffuse<kFuseS>(h.pos, h.n, h.mat, s);
    }
  }
  float* o = out + 3 * (size_t)i;
  o[0] = clamp01(col.x);
  o[1] = clamp01(col.y);
  o[2] = clamp01(col.z);
}

template <bool kFuseP, bool kFuseS>
void launch(const float* cam, const float* rd3, float* out, int rays,
            unsigned n, const Scene& s, cudaStream_t stream) {
  rt_trace_kernel<kFuseP, kFuseS>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          cam, rd3, out, rays, n, s);
}

}  // namespace

// cam: device floats [views, 3] (the views' origins); rd3: device floats
// [views, rays, 3] (the primary directions); out: device floats
// [views, rays, 3]; scene: device pointers, slot counts and the set
// lights; fuse_p / fuse_s: the sphere decision of primary / bounce and
// shadow rays (ops/rt_trace.FUSE)
extern "C" int rt_trace_launch(
    const float* cam, const float* rd3, float* out, int views, int rays,
    const float* sph_pos, const float* sph_rad, const bool* sph_valid,
    const int* sph_mat, int n_sph, const float* pln_n, const float* pln_d,
    const bool* pln_valid, const int* pln_mat, int n_pln, const float* tri_a,
    const float* tri_e1, const float* tri_e2, const bool* tri_valid,
    const int* tri_mat, int n_tri, const float* mat_albedo,
    const bool* mat_reflective, const float* dl_dir, const float* dl_col,
    int n_dl, const float* pt_pos, const float* pt_col, int n_pt, int pair,
    const float* env_color, const float* env_intensity, int fuse_p,
    int fuse_s, void* stream) {
  const long long n = (long long)views * rays;
  if (views < 0 || rays < 0 || n >= (1LL << 31) || n_sph < 1 || n_pln < 1 ||
      n_tri < 1 || n_dl < 0 || n_pt < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Scene s{sph_pos,   sph_rad,   sph_valid,      sph_mat, pln_n,     pln_d,
          pln_valid, pln_mat,   tri_a,          tri_e1,  tri_e2,    tri_valid,
          tri_mat,   mat_albedo, mat_reflective, dl_dir, dl_col,    pt_pos,
          pt_col,    env_color, env_intensity,  n_sph,   n_pln,     n_tri,
          n_dl,      n_pt,      pair};
  const cudaStream_t st = (cudaStream_t)stream;
  if (fuse_p && !fuse_s)
    launch<true, false>(cam, rd3, out, rays, (unsigned)n, s, st);
  else if (fuse_p && fuse_s)
    launch<true, true>(cam, rd3, out, rays, (unsigned)n, s, st);
  else if (!fuse_p && !fuse_s)
    launch<false, false>(cam, rd3, out, rays, (unsigned)n, s, st);
  else
    launch<false, true>(cam, rd3, out, rays, (unsigned)n, s, st);
  return (int)cudaGetLastError();
}
