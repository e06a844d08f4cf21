// The raster's deferred shade: per pixel, the winning triangle's row of
// the shade table, its screen-space planes evaluated at the pixel centre,
// and the reference's fragment lighting (ambient, one directional light,
// the scene's point lights, unshadowed), one thread a pixel.
// backends/raster_common._shade_rows is the plain version; each of its
// fused chains is an fmaf here, in its order (core/fp.py gives the rules):
//   plane value      fma(a, px, b * py) + c    (the left product fuses)
//   _dot3            fma(a2, b2, fma(a0, b0, a1 * b1))
//   lit              fma(dcol, ndl, ambient)
//   first point      fma(c, lit, (c * col) * w), later fma(c * col, w, out)
// 1 / sqrt is taken in double and rounded once (core/fp.rsqrt32); clamps
// are torch's on CUDA (NaN kept, else fmaxf / fminf).
//
// Stands for XLA code, not a Pallas kernel: the deferred-shade gather and
// lighting of ascii_renderer_tpu/backends/raster_common.py:73
// (_shade_rows), which XLA fuses into the frame's program. On CUDA tensors
// the plain version is ~17 fma32 launches and ~60 other elementwise
// launches over every pixel; this is one launch. Every caller goes through
// it: the headline's grouped tiles (raster.shade_groups), the mid-scale
// plane table (raster_common.shade_from_table) and the retired generations'
// compacted tiles (raster_oracles.shade_tiles_compact).
//
// What bounds it on the H100: operations at the headline (~120 float
// operations and two double-precision roots a lit pixel against 4 bytes
// of id, 8 of pixel centre and 12 of colour; the gathered row, 3 * A + 3
// floats, comes from a table that stays in L2). The scene's lights and
// counts are read on the device, so the frame takes no host sync here.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDims = 3;

struct Geom {
  int size[kDims];               // the pixel grid S, leading dims padded
  long long st[3][kDims];        // strides of ids, px, py over S
};

struct Scene {
  const float* env_color;  // [3]
  const float* env_intensity;  // 0-d
  const int* n_dl;         // 0-d
  const float* dl_dir;     // [DL, 3] (DL >= 1)
  const float* dl_col;     // [DL, 3]
  const int* n_pt;         // 0-d
  const float* pt_pos;     // [PL, 3]
  const float* pt_col;     // [PL, 3]
  int n_pl;                // PL, the point-light slots
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float rsqrt32(float x) {
  return (float)(1.0 / sqrt((double)x));
}

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return fmaf(a2, b2, fmaf(a0, b0, a1 * b1));
}

// kF32Ids: ids are float32 winner ids (hit where id >= 0.0); else int32
// (hit where id >= 0). The row read is the id, truncated.
template <bool kF32Ids>
__global__ void __launch_bounds__(kThreads)
raster_shade_kernel(const float* __restrict__ table, long long row_stride,
                    int table_rows, const void* __restrict__ ids,
                    const float* __restrict__ px_p,
                    const float* __restrict__ py_p, Geom g, int n_attrs,
                    Scene sc, float* __restrict__ out, unsigned n) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  long long off[3] = {0, 0, 0};
  unsigned rest = i;
#pragma unroll
  for (int d = kDims - 1; d >= 0; --d) {
    const unsigned q = rest / (unsigned)g.size[d];
    const long long idx = rest - q * (unsigned)g.size[d];
    rest = q;
#pragma unroll
    for (int k = 0; k < 3; ++k) off[k] += idx * g.st[k][d];
  }
  float* o = out + 3 * (size_t)i;
  long long row;
  bool hit;
  if (kF32Ids) {
    const float e = static_cast<const float*>(ids)[off[0]];
    hit = e >= 0.0f;
    row = hit ? (long long)e : 0;
  } else {
    const int e = static_cast<const int*>(ids)[off[0]];
    hit = e >= 0;
    row = e;
  }
  if (!hit) {
    o[0] = o[1] = o[2] = 0.0f;
    return;
  }
  if (row >= table_rows) {  // an id past the table: no colour to give
    o[0] = o[1] = o[2] = __int_as_float(0x7fffffff);
    return;
  }
  const float* gr = table + row * row_stride;
  const float px = px_p[off[1]], py = py_p[off[2]];
  const int dn = 3 * n_attrs;
  // (a*px + b*py) + c: the left product fuses
  const float d = fmaf(gr[dn], px, gr[dn + 1] * py) + gr[dn + 2];
  const float inv_d = 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
  float a[9];
#pragma unroll
  for (int j = 0; j < 9; ++j)
    a[j] = j < n_attrs
               ? (fmaf(gr[3 * j], px, gr[3 * j + 1] * py) + gr[3 * j + 2]) *
                     inv_d
               : 0.0f;
  const float inv_nl =
      rsqrt32(clamp_min(dot3(a[0], a[0], a[1], a[1], a[2], a[2]), 1e-24f));
  const float nx = a[0] * inv_nl, ny = a[1] * inv_nl, nz = a[2] * inv_nl;
  const float c[3] = {a[3], a[4], a[5]};
  const float wx = a[6], wy = a[7], wz = a[8];

  const float inten = *sc.env_intensity;
  const bool have_dl = *sc.n_dl > 0;
  const float ddir[3] = {have_dl ? sc.dl_dir[0] : 0.25f,
                         have_dl ? sc.dl_dir[1] : -1.0f,
                         have_dl ? sc.dl_dir[2] : 0.15f};
  const float dcol[3] = {have_dl ? sc.dl_col[0] : 1.2f,
                         have_dl ? sc.dl_col[1] : 1.15f,
                         have_dl ? sc.dl_col[2] : 1.1f};
  const float ndl =
      clamp_min(-dot3(nx, ddir[0], ny, ddir[1], nz, ddir[2]), 0.0f);
  float lit[3], acc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // c * (ambient + dcol * ndl): the ambient product is formed apart
    lit[k] = fmaf(dcol[k], ndl, sc.env_color[k] * inten);
    acc[k] = c[k] * lit[k];
  }
  const int n_pt = *sc.n_pt;
  for (int l = 0; l < sc.n_pl; ++l) {
    const float* lp = sc.pt_pos + 3 * l;
    const float* lc = sc.pt_col + 3 * l;
    float w = 0.0f;
    if (l < n_pt) {
      const float lx = lp[0] - wx, ly = lp[1] - wy, lz = lp[2] - wz;
      const float d2 = clamp_min(dot3(lx, lx, ly, ly, lz, lz), 1e-4f);
      const float inv_dd = rsqrt32(d2);
      const float ndlp =
          clamp_min(dot3(nx, lx, ny, ly, nz, lz) * inv_dd, 0.0f);
      const float att = 1.0f / fmaf(d2, 0.05f, 1.0f);
      w = ndlp * att;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      // out + (c * col) * w: the first light's add sees two products and
      // fuses the left one, c * lit
      acc[k] = l == 0 ? fmaf(c[k], lit[k], (c[k] * lc[k]) * w)
                      : fmaf(c[k] * lc[k], w, acc[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = clamp01(acc[k]);
}

}  // namespace

// table: device floats, rows of row_stride (>= 3 * n_attrs + 3 used);
// ids: device f32 (ids_f32 = 1) or i32 winner ids, -1 = background;
// px, py: device floats; geom (host): S's 3 sizes, then 3 strides each of
// ids, px and py; scene: device pointers; out: device floats [n, 3]
extern "C" int raster_shade_launch(
    const float* table, long long row_stride, int table_rows,
    const void* ids, int ids_f32, const float* px, const float* py,
    const long long* geom, int n_attrs, const float* env_color,
    const float* env_intensity, const int* n_dl, const float* dl_dir,
    const float* dl_col, const int* n_pt, const float* pt_pos,
    const float* pt_col, int n_pl, float* out, long long n, void* stream) {
  if (n < 0 || n >= (1LL << 31) || (n_attrs != 6 && n_attrs != 9) ||
      n_pl < 0 || (n_attrs == 6 && n_pl > 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Geom g;
  for (int d = 0; d < kDims; ++d) {
    if (geom[d] < 1) return (int)cudaErrorInvalidValue;
    g.size[d] = (int)geom[d];
    for (int k = 0; k < 3; ++k) g.st[k][d] = geom[kDims * (k + 1) + d];
  }
  Scene sc{env_color, env_intensity, n_dl, dl_dir, dl_col, n_pt,
           pt_pos, pt_col, n_pl};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (ids_f32)
    raster_shade_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        table, row_stride, table_rows, ids, px, py, g, n_attrs, sc, out,
        (unsigned)n);
  else
    raster_shade_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        table, row_stride, table_rows, ids, px, py, g, n_attrs, sc, out,
        (unsigned)n);
  return (int)cudaGetLastError();
}
