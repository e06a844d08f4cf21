// The raster's deferred shade: per pixel, the winning triangle's row of
// the shade table, its screen-space planes evaluated at the pixel centre,
// and the reference's fragment lighting (ambient, one directional light,
// the scene's point lights, unshadowed).
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
// launches over every pixel; this is one launch. It takes the grouped
// tiles (raster.shade_groups), the mid-scale plane table
// (raster_common.shade_from_table) and the retired generations' compacted
// tiles (raster_oracles.shade_tiles_compact).
//
// Its image form (raster_shade_image_kernel) also stands for the assembly
// of the grouped tiles into the image (ascii_renderer_tpu/ops/
// raster_group.py:1284, assemble_group_image, with the lane centres of
// backends/raster.py:624-646): a thread a pixel of the image, its bin's
// place in the depth order read from X10's inverse (ginv), the walk's
// winner id at that place, the same per-pixel chain at the pixel's centre.
// The grouped render paths' shade and assembly are then one launch, where
// the grouped form and the torch assembly were 13 at the headline.
//
// What bounds it on the H100: bytes at the roofline (ids, centres, the
// rows the lit pixels pick, rgb); in practice the latency of each lit
// pixel's chain (its id, then its row, ~150 dependent float operations
// and a double-precision root, then the store) on a frame that fills one
// wave. The design shortens that chain and spreads it: the pixel grid's
// indices come from multiply-high divisions by the grid's sizes (no
// integer division), the row is read as float4 where the table's stride
// and base allow it, the attribute count is a template parameter (the
// row's width is known), and a pixel without a row (no hit, or an id past
// the table) skips the work. Blocks of 128 threads, a thread a pixel
// (RS_THREADS; tools/build_variants.py also builds 64 and 256 threads, and
// timed two pixels a thread and rgb staged as float4: none was faster at
// every caller). The scene's lights and counts are read on the device, so
// the frame takes no host sync here.
#include <cuda_runtime.h>

namespace {

// threads a block (tools/build_variants.py builds other sizes)
#ifndef RS_THREADS
#define RS_THREADS 128
#endif
constexpr int kThreads = RS_THREADS;
constexpr int kDims = 3;

// n / d for n < 2^31 as (umulhi(n, magic) + n) >> shift
struct Div {
  unsigned magic;
  int shift;
};

Div make_div(unsigned d) {
  int s = 0;
  while ((1u << s) < d) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return Div{(unsigned)m, s};
}

__device__ __forceinline__ unsigned divq(unsigned n, Div v) {
  return (__umulhi(n, v.magic) + n) >> v.shift;
}

struct Geom {
  int size[kDims];               // the pixel grid S, leading dims padded
  Div div[2];                    // by size[2], by size[1]
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

// the scene's lights, read once a thread
struct Lights {
  float amb[3], ddir[3], dcol[3];
  int n_pt;
};

__device__ __forceinline__ Lights load_lights(const Scene& sc) {
  Lights L;
  const float inten = *sc.env_intensity;
  const bool have_dl = *sc.n_dl > 0;
  const float dd[3] = {0.25f, -1.0f, 0.15f}, dc[3] = {1.2f, 1.15f, 1.1f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    L.amb[k] = sc.env_color[k] * inten;  // the ambient product, formed apart
    L.ddir[k] = have_dl ? sc.dl_dir[k] : dd[k];
    L.dcol[k] = have_dl ? sc.dl_col[k] : dc[k];
  }
  L.n_pt = *sc.n_pt;
  return L;
}

// pixel i's grid offsets into ids, px and py
__device__ __forceinline__ void offsets(const Geom& g, unsigned i,
                                        long long off[3]) {
  const unsigned q2 = divq(i, g.div[0]);
  const unsigned i2 = i - q2 * (unsigned)g.size[2];
  const unsigned i0 = divq(q2, g.div[1]);
  const unsigned i1 = q2 - i0 * (unsigned)g.size[1];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    off[k] = (long long)i0 * g.st[k][0] + (long long)i1 * g.st[k][1] +
             (long long)i2 * g.st[k][2];
}

// One lit pixel's rgb: the row's A planes at (px, py), then the lighting.
template <int A, bool kVec>
__device__ __forceinline__ void shade_row(const float* __restrict__ gr,
                                          float px, float py,
                                          const Lights& L, const Scene& sc,
                                          float rgb[3]) {
  constexpr int kW = 3 * A + 3;          // the floats a row uses
  constexpr int kW4 = (kW + 3) / 4;
  float r[4 * kW4];
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kW4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(gr) + q);
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kW; ++q) r[q] = __ldg(gr + q);
  }
  constexpr int dn = 3 * A;
  // (a*px + b*py) + c: the left product fuses
  const float d = fmaf(r[dn], px, r[dn + 1] * py) + r[dn + 2];
  const float inv_d = 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d);
  float a[9];
#pragma unroll
  for (int j = 0; j < 9; ++j)
    a[j] = j < A ? (fmaf(r[3 * j], px, r[3 * j + 1] * py) + r[3 * j + 2]) *
                       inv_d
                 : 0.0f;
  const float inv_nl =
      rsqrt32(clamp_min(dot3(a[0], a[0], a[1], a[1], a[2], a[2]), 1e-24f));
  const float nx = a[0] * inv_nl, ny = a[1] * inv_nl, nz = a[2] * inv_nl;
  const float c[3] = {a[3], a[4], a[5]};
  const float ndl =
      clamp_min(-dot3(nx, L.ddir[0], ny, L.ddir[1], nz, L.ddir[2]), 0.0f);
  float lit[3], acc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // c * (ambient + dcol * ndl)
    lit[k] = fmaf(L.dcol[k], ndl, L.amb[k]);
    acc[k] = c[k] * lit[k];
  }
  if (A == 9) {
    const float wx = a[6], wy = a[7], wz = a[8];
    for (int l = 0; l < sc.n_pl; ++l) {
      const float* lp = sc.pt_pos + 3 * l;
      const float* lc = sc.pt_col + 3 * l;
      float w = 0.0f;
      if (l < L.n_pt) {
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
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) rgb[k] = clamp01(acc[k]);
}

// kF32Ids: ids are float32 winner ids (hit where id >= 0.0); else int32
// (hit where id >= 0). The row read is the id, truncated. A thread a
// pixel.
template <bool kF32Ids, int A, bool kVec>
__global__ void __launch_bounds__(kThreads)
raster_shade_kernel(const float* __restrict__ table, long long row_stride,
                    int table_rows, const void* __restrict__ ids,
                    const float* __restrict__ px_p,
                    const float* __restrict__ py_p, Geom g, Scene sc,
                    float* __restrict__ out, unsigned n) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  long long off[3];
  offsets(g, i, off);
  long long row;
  bool hit;
  if (kF32Ids) {
    const float e = __ldg(static_cast<const float*>(ids) + off[0]);
    hit = e >= 0.0f;
    row = hit ? (long long)e : 0;
  } else {
    const int e = __ldg(static_cast<const int*>(ids) + off[0]);
    hit = e >= 0;
    row = e;
  }
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (hit && row >= table_rows)  // an id past the table: no colour to give
    rgb[0] = rgb[1] = rgb[2] = __int_as_float(0x7fffffff);
  else if (hit)
    shade_row<A, kVec>(table + row * row_stride, __ldg(px_p + off[1]),
                       __ldg(py_p + off[2]), load_lights(sc), sc, rgb);
  float* o = out + 3ull * i;
  o[0] = rgb[0];
  o[1] = rgb[1];
  o[2] = rgb[2];
}

// K2's image form: a thread a pixel (r, c) of the image [rows, cols, 3].
// Its bin is tile (r / 8) * tiles_x + c / 128, sub-bin (c % 128) / 16 (the
// band's rows: r is band-local); ginv[bin] its place among the grouped walk's
// slots; a place from n_slots on (a bin no group covers) is the fill, 0;
// else the winner id is e[place / 8, r % 8, (place % 8) * 16 + c % 16] and
// the pixel is shaded at (c + 0.5, y_off + r + 0.5), the values the lane
// origins xl and yl + s + 0.5 hold (small integers and halves: exact in
// float32).
template <int A, bool kVec>
__global__ void __launch_bounds__(kThreads)
raster_shade_image_kernel(const float* __restrict__ table,
                          long long row_stride, int table_rows,
                          const float* __restrict__ e,
                          const int* __restrict__ ginv, int n_slots,
                          int tiles_x, int y_off, Div div_cols, int cols,
                          Scene sc, float* __restrict__ out, unsigned n) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned r = divq(i, div_cols);
  const unsigned c = i - r * (unsigned)cols;
  const int bin = (int)(((r >> 3) * (unsigned)tiles_x + (c >> 7)) * 8u +
                        ((c & 127u) >> 4));
  const int place = __ldg(ginv + bin);
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (place < n_slots) {
    const float id = __ldg(e + ((long long)(place >> 3) << 10) +
                           ((r & 7u) << 7) + ((place & 7) << 4) + (c & 15u));
    if (id >= 0.0f) {
      const long long row = (long long)id;
      if (row >= table_rows)  // an id past the table: no colour to give
        rgb[0] = rgb[1] = rgb[2] = __int_as_float(0x7fffffff);
      else
        shade_row<A, kVec>(table + row * row_stride, (float)c + 0.5f,
                           (float)((int)r + y_off) + 0.5f, load_lights(sc),
                           sc, rgb);
    }
  }
  float* o = out + 3ull * i;
  o[0] = rgb[0];
  o[1] = rgb[1];
  o[2] = rgb[2];
}

template <bool kF32Ids, int A, bool kVec>
int launch(const float* table, long long row_stride, int table_rows,
           const void* ids, const float* px, const float* py, const Geom& g,
           const Scene& sc, float* out, long long n, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  raster_shade_kernel<kF32Ids, A, kVec><<<blocks, kThreads, 0, s>>>(
      table, row_stride, table_rows, ids, px, py, g, sc, out, (unsigned)n);
  return (int)cudaGetLastError();
}

}  // namespace

// table: device floats, rows of row_stride (>= 3 * n_attrs + 3 used);
// vec: the table's rows may be read as float4 (16-byte aligned base and
// stride, 4 * ceil((3 * n_attrs + 3) / 4) floats inside each row);
// ids: device f32 (ids_f32 = 1) or i32 winner ids, -1 = background;
// px, py: device floats; geom (host): S's 3 sizes, then 3 strides each of
// ids, px and py; scene: device pointers; out: device floats [n, 3].
extern "C" int raster_shade_launch(
    const float* table, long long row_stride, int table_rows, int vec,
    const void* ids, int ids_f32, const float* px, const float* py,
    const long long* geom, int n_attrs, const float* env_color,
    const float* env_intensity, const int* n_dl, const float* dl_dir,
    const float* dl_col, const int* n_pt, const float* pt_pos,
    const float* pt_col, int n_pl, float* out, long long n, void* stream) {
  if (n < 0 || n >= (1LL << 31) || (n_attrs != 6 && n_attrs != 9) ||
      n_pl < 0 || (n_attrs == 6 && n_pl > 0) || table_rows < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Geom g;
  for (int d = 0; d < kDims; ++d) {
    if (geom[d] < 1) return (int)cudaErrorInvalidValue;
    g.size[d] = (int)geom[d];
    for (int k = 0; k < 3; ++k) g.st[k][d] = geom[kDims * (k + 1) + d];
  }
  g.div[0] = make_div((unsigned)g.size[2]);
  g.div[1] = make_div((unsigned)g.size[1]);
  const Scene sc{env_color, env_intensity, n_dl, dl_dir, dl_col, n_pt,
                 pt_pos, pt_col, n_pl};
  const cudaStream_t s = (cudaStream_t)stream;
#define RS_LAUNCH(F32, A, V)                                                \
  return launch<F32, A, V>(table, row_stride, table_rows, ids, px, py, g,  \
                           sc, out, n, s)
  if (ids_f32) {
    if (n_attrs == 6) {
      if (vec) RS_LAUNCH(true, 6, true);
      RS_LAUNCH(true, 6, false);
    }
    if (vec) RS_LAUNCH(true, 9, true);
    RS_LAUNCH(true, 9, false);
  }
  if (n_attrs == 6) {
    if (vec) RS_LAUNCH(false, 6, true);
    RS_LAUNCH(false, 6, false);
  }
  if (vec) RS_LAUNCH(false, 9, true);
  RS_LAUNCH(false, 9, false);
#undef RS_LAUNCH
}

// K2's image form. table, vec, the scene: as raster_shade_launch; e: device
// f32 [n_slots / 8, 8, 128] the grouped walk's winner ids; ginv: device i32
// [n_bins] each bin's place (X10's); out: device floats [rows, cols, 3];
// rows x cols inside the n_bins / 8 tiles, tiles_x a row; y_off: the band's
// first pixel row.
extern "C" int raster_shade_image_launch(
    const float* table, long long row_stride, int table_rows, int vec,
    const float* e, const int* ginv, int n_slots, int n_bins, int tiles_x,
    int y_off, int rows, int cols, int n_attrs, const float* env_color,
    const float* env_intensity, const int* n_dl, const float* dl_dir,
    const float* dl_col, const int* n_pt, const float* pt_pos,
    const float* pt_col, int n_pl, float* out, void* stream) {
  if (rows < 1 || cols < 1 || (long long)rows * cols >= (1LL << 31) ||
      tiles_x < 1 || n_bins < 8 || n_bins % (8 * tiles_x) ||
      (long long)tiles_x * 128 < cols ||
      (long long)(n_bins / (8 * tiles_x)) * 8 < rows || n_slots < 8 ||
      n_slots % 8 || (n_attrs != 6 && n_attrs != 9) || n_pl < 0 ||
      (n_attrs == 6 && n_pl > 0) || table_rows < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned n = (unsigned)rows * (unsigned)cols;
  const Div dc = make_div((unsigned)cols);
  const Scene sc{env_color, env_intensity, n_dl, dl_dir, dl_col, n_pt,
                 pt_pos, pt_col, n_pl};
  const unsigned blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
#define RSI_LAUNCH(A, V)                                                     \
  raster_shade_image_kernel<A, V><<<blocks, kThreads, 0, s>>>(              \
      table, row_stride, table_rows, e, ginv, n_slots, tiles_x, y_off, dc, \
      cols, sc, out, n);                                                    \
  return (int)cudaGetLastError()
  if (n_attrs == 6) {
    if (vec) { RSI_LAUNCH(6, true); }
    RSI_LAUNCH(6, false);
  }
  if (vec) { RSI_LAUNCH(9, true); }
  RSI_LAUNCH(9, false);
#undef RSI_LAUNCH
}
