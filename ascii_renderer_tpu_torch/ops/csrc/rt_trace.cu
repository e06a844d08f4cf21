// The ray tracer's frame, every view of a batch in one launch: its primary
// rays (read from rd3, or computed from the jitted grid: the grid form),
// the nearest hit over spheres, planes and triangles (quads split), the
// hit's normal and material, direct light with hard shadows, one mirror
// bounce and its shade, the environment where a ray misses, the clamp.
// backends/raytrace.trace_rgb is the plain version (closest_hit,
// occluded, shade_diffuse; of the plain grid in the grid form, whose rays
// are ops/rt_trace.grid_rays); it rounds as the reference's
// jitted program, the products fused by backends/rt_core's rules, and
// this kernel rounds each chain the same way with fmaf:
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
// What bounds it on the H100: operations. A ray tests every valid
// primitive (a sphere ~27 float operations, a plane ~17, a triangle ~60,
// a fused product-add counted as two: chip_smoke.RT_OPS_*) for its primary
// ray, its shadow rays (spheres and triangles) and, on a mirror, its
// bounce; bytes are 12 out a ray, and 12 in where rd3 holds the rays.
// Padding slots are no work of the function: an invalid slot's t is kBig,
// never NaN, so it wins the nearest hit only where nothing is hit (and
// then the hit's normal and material are not read), and it occludes only
// where tmax > kBig.
//
// The design: a 96x36 frame is 3,456 rays, 27 blocks of 128 threads at
// one thread a ray, and a padded scene's slots are mostly padding (the
// rt_demo golden's: 4 valid of 40). So:
// - Valid slots staged in shared memory (kStage). Each block reads the
//   scene once and keeps each kind's valid slots in slot order, compacted
//   with a ballot and a block prefix, as packed rows (a sphere float4
//   {x, y, z, r}, a plane {nx, ny, nz, d}, a triangle three float4s) with
//   the original slot index. Rays loop over these lists only; the index
//   that breaks ties is the original one. Without kStage (a scene whose
//   slots exceed the shared-memory budget, or a launch of 4 or more lanes
//   a ray) the same order is read from the global arrays, an invalid slot
//   skipped.
// - L lanes a ray (a tile of L threads, L in 1..32). The lanes split each
//   loop over primitives; the nearest hit is reduced across the tile by a
//   total order on (NaN first, t, slot index), which gives the serial
//   first minimum (a +0 / -0 tie to the lower index), and occluded is the tile's
//   any-hit. Everything else (the hit's shading, the light sum in slot
//   order, the bounce) every lane computes alike, so the tile's control
//   flow stays uniform; lane 0 stores the colour.
// - The grid form (rd3 null): each tile computes its ray's direction from
//   its view's 12 floats (origin, uu, vv, focal * ww) and its (row, col),
//   with the jitted grid's rounding (ray_dir.cuh, shared with
//   ray_grid.cu's ray_grid_jit_kernel), ~22 operations a ray. The render
//   path's rays then make no round trip through device memory (12 bytes
//   written by a grid launch and read back here), and a frame is one
//   launch. One view's floats come as launch arguments, a batch's as one
//   device array. A runtime branch, not a template flag: every lane of a
//   tile takes it alike.
// - Its trig form (trig 1): a batch's views come as 8 floats each
//   (origin, cos and sin of pitch and yaw, tan(fov_y / 2); libm on the
//   host) and the launch forms each view's uu, vv and focal * ww itself
//   (ray_dir.cuh's view_basis, the host chain's rounding): the first
//   lanes of warp 0 form the bases of the (at most kBlockViews) views the
//   block's rays belong to into shared memory while warps 1-3 stage the
//   scene (a named barrier of their own), under the staging's final
//   barrier, and the rays read them there; a block spanning more views
//   forms them a ray (~70 operations, 9 IEEE divisions and 3 roots a ray;
//   at the farm that form was 8-16% slower, PERF.md). The chain formed by
//   the block's first threads before the staging took the farm from the
//   12 floats' 0.155 ms to 0.186 (tools/kernel_ab, NVIDIA H100 80GB HBM3
//   at 700 W); beside the staging most of it is hidden. A
//   template flag (kTrig), so that the other forms' code is as it was (a
//   runtime branch for it cost every form 3-4%, PERF.md); its 48
//   instances are rt_trace_trig.cu's, built beside this source's 48 (~55 s
//   of nvcc each). The device code of both is rt_trace.cuh.
// The launch's own form, from timed variants of every form at the driven
// paths' five launch sizes (tools/rt_variants.py; PERF.md): L from the
// ray count, so that a small frame fills the card (all 32 lanes at 256 to
// 3,456 rays, one at the farm's 3,538,944), and the slots staged only
// where a ray has fewer than 4 lanes: with 4 or more the block's staging
// (a compaction a kind, six barriers) cost more than the few global reads
// each lane makes (rt_trace_lanes, rt_trace_staged).
#include "rt_trace.cuh"

using namespace rt_trace_k;

// The lanes a ray the launch takes for n rays: the least power of two
// (at most 32) whose threads reach kFillThreads, so that a 96x36 frame
// fills the card and the farm keeps one thread a ray.
extern "C" int rt_trace_lanes(long long n) {
  int lanes = 1;
  while (lanes < 32 && n * lanes < kFillThreads) lanes *= 2;
  return lanes;
}

// Whether a launch of this many lanes a ray stages the valid slots of a
// scene of these slot counts in shared memory (stage == 0: its own
// choice): where they fit and a ray has fewer than 4 lanes.
extern "C" int rt_trace_staged(int lanes, int n_sph, int n_pln, int n_tri) {
  return lanes < 4 && stage_fits(n_sph, n_pln, n_tri);
}

// cam: device floats [views, 3] (the views' origins); rd3: device floats
// [views, rays, 3] (the primary directions), or null for the grid form:
// grid_views device floats [views, 12] (a view's origin, uu, vv and
// focal * ww), or null for one view whose 12 floats grid_one holds (host
// memory, passed by value); trig 1: grid_views holds 8 floats a view
// (origin and trig), the bases formed on the card; the rays are the row band [row_lo, row_lo +
// rays / cols) of the rows x cols grid, sx = 2 / cols, sy = 2 / rows and
// aspect float32 as the host rounds them; out: device floats
// [views, rays, 3]; scene: device pointers, slot counts and the set
// lights; fuse_p / fuse_s: the sphere decision of primary / bounce and
// shadow rays (ops/rt_trace.FUSE); lanes: the lanes a ray (1, 2, 4, 8,
// 16 or 32; 0: rt_trace_lanes); stage: 1 stages the valid slots in shared
// memory, 2 reads them from the global arrays, 0 lets rt_trace_staged
// choose.
extern "C" int rt_trace_launch(
    const float* cam, const float* rd3, const float* grid_views,
    const float* grid_one, int trig, int rows, int cols, int row_lo,
    float sx, float sy, float aspect, float* out, int views, int rays,
    const float* sph_pos, const float* sph_rad, const bool* sph_valid,
    const int* sph_mat, int n_sph, const float* pln_n, const float* pln_d,
    const bool* pln_valid, const int* pln_mat, int n_pln, const float* tri_a,
    const float* tri_e1, const float* tri_e2, const bool* tri_valid,
    const int* tri_mat, int n_tri, const float* mat_albedo,
    const bool* mat_reflective, const float* dl_dir, const float* dl_col,
    int n_dl, const float* pt_pos, const float* pt_col, int n_pt, int pair,
    const float* env_color, const float* env_intensity, int fuse_p,
    int fuse_s, int lanes, int stage, void* stream) {
  const long long n = (long long)views * rays;
  if (views < 0 || rays < 0 || n >= (1LL << 31) || n_sph < 1 || n_pln < 1 ||
      n_tri < 1 || n_dl < 0 || n_pt < 0 || lanes < 0 || stage < 0 ||
      stage > 2)
    return (int)cudaErrorInvalidValue;
  Rays p{cam, rd3, grid_views, {}, trig, rows, cols, row_lo, sx, sy,
         aspect};
  if (trig < 0 || trig > 1 || (trig && rd3 != nullptr))
    return (int)cudaErrorInvalidValue;
  if (rd3 == nullptr) {  // the grid form
    if (rows < 1 || cols < 1 || row_lo < 0 || rays % cols != 0 ||
        row_lo + rays / cols > rows ||
        (grid_views == nullptr && (views != 1 || grid_one == nullptr ||
                                   trig)))
      return (int)cudaErrorInvalidValue;
    if (grid_views == nullptr)
      for (int k = 0; k < 12; ++k) p.one[k] = grid_one[k];
  }
  if (n == 0) return 0;
  if (stage == 1 && !stage_fits(n_sph, n_pln, n_tri))
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) lanes = rt_trace_lanes(n);
  const bool staged =
      stage == 0 ? rt_trace_staged(lanes, n_sph, n_pln, n_tri) : stage == 1;
  Scene s{sph_pos,   sph_rad,   sph_valid,      sph_mat, pln_n,     pln_d,
          pln_valid, pln_mat,   tri_a,          tri_e1,  tri_e2,    tri_valid,
          tri_mat,   mat_albedo, mat_reflective, dl_dir, dl_col,    pt_pos,
          pt_col,    env_color, env_intensity,  n_sph,   n_pln,     n_tri,
          n_dl,      n_pt,      pair};
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned un = (unsigned)n;
  if (trig)
    return launch_trig(fuse_p, fuse_s, lanes, staged, p, out, rays, un, s,
                       st);
  return launch_fused<false>(fuse_p, fuse_s, lanes, staged, p, out, rays, un,
                             s, st);
}
