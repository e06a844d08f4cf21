// The small and mid raster paths' near-plane clip and screen setup (X4),
// one thread an output triangle: thread t of a block's first half takes
// output slot t, its twin in the second half output slot T + t of the
// same source slot. Each transforms its source slot's three vertices and
// clips them (the few operations this repeats for slot T + t are cheaper
// than one thread's serial chain twice as long), then sets up its own
// output triangle (w reciprocals, screen x / y / z, the edge terms,
// area2, the facing and degenerate cull).
//
// The table form (raster_clip_table_kernel) also writes the plane table of
// the [2T] slots, X3's work, in the same launch: a block of 16 source
// slots stages their normals, colors and positions in shared memory while
// its first phase clips and sets up, then each output triangle's thread
// forms its table row's own values (plane_row.cuh) and stages them; after
// one barrier a thread an (row, attribute) item forms that attribute's
// three plane coefficients (plane_attr) and stores them into the block's
// two row spans (rows t and T + t of its slots, each contiguous in the
// row-major [2T + 1, 32] table); the block holding row 2T writes the zero
// background row. plane_table.cu's standalone form shares that arithmetic.
//
// The slots form (raster_clip_slots_kernel) is the standalone form whose
// output triangle threads also write their slot's attribute values, the
// normals, colors and positions rotated and lerped as the clip moved the
// vertices (plane_row.cuh's attr_slots), channel-major into rows 25 +
// 9 s + j of one [25 + 27, 2T] buffer (vertex slot s, attribute j): the
// inputs of the fused-shading walk's entries, with no plane table. A
// thread reads its slot's normals and colors itself, before the clip's
// arithmetic (a block's copy staged in shared memory measured slower on
// the H100, PERF.md); the positions are the coordinates it clips.
//
// ops/raster_clip.clip_screen_ref is the plain version (and
// clip_screen_table_ref, with ops/plane_table.plane_table_ref, the table
// form's); each of its fused chains is an fmaf here, in its order
// (core/fp.py gives the rules):
//   vertex (positions)  (x m0 + y m1) + (z m2 + m3)      (nothing fuses)
//   vertex (pos9)       fma(m2, z, fma(m0, x, m1 * y)) + m3
//   lerp                fma(t, c1 - c0, c0)   (the attributes' too)
//   screen x / y / z    fma(x, iw, 1) * hx, fma(-y, iw, 1) * hy,
//                       fma(z, iw, 1) * 0.5
//   edges               fma(ux_b, hx, -sx_a), ...     (a's product shared)
//   area2               fma(e0x, e1y, -(e0y * e1x))   (the left fuses)
// Divisions and reciprocals are IEEE (__fdiv_rn, __frcp_rn), as torch's
// tensor / tensor and reciprocal are.
//
// Stands for XLA code, not a Pallas kernel: transform_clip_channels(9),
// _clip_channels_core and setup_screen_channels of
// ascii_renderer_tpu/backends/raster_channels.py (:31, :63, :76, :139)
// and, in the table form, clip_attrs_channel_lists and build_plane_table
// (:426, :481), which XLA fuses into each frame's program.
//
// What bounds it on the H100: bytes. A slot reads 36 bytes and writes 25
// floats of each of its two output slots (channel-major [25, 2T], so the
// stores of neighbouring threads are neighbouring addresses), 2 valid
// bytes and 20 bytes of records; the table form also reads 72 bytes of
// normals and colors and writes two 128-byte rows, the slots form reads
// those 72 bytes and writes 27 floats of each output slot.
#include <cuda_runtime.h>

#include "plane_row.cuh"

#ifndef RC_THREADS
#define RC_THREADS 128  // threads a block of the standalone form
#endif
#ifndef RC_TABLE_SLOTS
#define RC_TABLE_SLOTS 16  // source slots a block of the table form
#endif
#ifndef RC_TABLE_THREADS
#define RC_TABLE_THREADS 256  // threads a block of the table form
#endif

namespace {

constexpr int kSlots = RC_THREADS / 2;
constexpr int kTableSlots = RC_TABLE_SLOTS;
constexpr int kTableThreads = RC_TABLE_THREADS;
static_assert(kTableThreads >= 2 * kTableSlots, "a thread an output slot");
constexpr int kTableA = 9;  // normals, colors, positions
constexpr int kTableW = PlaneWidth<kTableA>::kW;

// rows of the float output [kChannels, 2T] (ops/raster_clip.FLOAT_KEYS):
// x / y / z / w of vertex slots a, b, c, then sx, sy, sz, iw of a, b, c,
// then area2
constexpr int kClip = 0;
constexpr int kScreen = 12;
constexpr int kArea = 24;
constexpr int kSlotRows = 25;  // the slots form's attribute rows start here
constexpr int kSlotAttrs = 9;  // normals, colors, positions

struct Mvp {
  float m[16];  // row-major 4 x 4
};

__device__ __forceinline__ float recip_guard(float x, float eps) {
  // 1 / where(|x| < eps, eps, x): NaN stays NaN
  return __frcp_rn(fabsf(x) < eps ? eps : x);
}

__device__ __forceinline__ float ratio(float p, float q) {
  return __fdiv_rn(p, p == q ? 1.0f : p - q);
}

__device__ __forceinline__ float lerp(float c0, float c1, float t) {
  return fmaf(t, c1 - c0, c0);
}

// Source slot t's 9 coordinates (xa ya za xb yb zb xc yc zc): pos9 rows
// or its positions row.
template <bool kPos9>
__device__ __forceinline__ void load_slot(const float* __restrict__ src,
                                          int T, int t, float (&p)[9]) {
  for (int i = 0; i < 9; ++i)
    p[i] = kPos9 ? src[(long long)i * T + t] : src[9LL * t + i];
}

// The clip of source slot t (its coordinates p) and the setup of one of
// its output triangles (the second, o = T + t, or the first, o = t) into
// column o of ch, valid[o] and the records (the first output writes
// t_ab, t_ac and rot, the second t_bc and n_in). Returns the row's screen
// values and the slot's records for the table.
template <bool kPos9>
__device__ __forceinline__ void clip_one(const float (&p)[9], const Mvp& mv,
                                         float hx, float hy,
                                         float* __restrict__ ch,
                                         bool* __restrict__ valid,
                                         float* __restrict__ t_rec,
                                         int* __restrict__ i_rec, int T,
                                         int t, bool second,
                                         PlaneScreen& scr, PlaneRecord& rec) {
  const long long n2 = 2LL * T;
  const long long o = second ? (long long)T + t : t;
  float c[3][4];  // clip coordinates of the input vertices
  float d[3];
  bool in[3];
  for (int v = 0; v < 3; ++v) {
    const float px = p[3 * v], py = p[3 * v + 1], pz = p[3 * v + 2];
    for (int j = 0; j < 4; ++j) {
      const float* m = mv.m + 4 * j;
      c[v][j] = kPos9 ? fmaf(m[2], pz, fmaf(m[0], px, m[1] * py)) + m[3]
                      : (px * m[0] + py * m[1]) + (pz * m[2] + m[3]);
    }
    d[v] = c[v][2] + c[v][3];
    in[v] = d[v] >= 0.0f;  // z + w >= 0 is inside the near plane
  }
  const int n_in = (int)in[0] + (int)in[1] + (int)in[2];
  // 1-in: the inside vertex first; 2-in: the outside vertex last
  const int first_in = in[0] ? 0 : (in[1] ? 1 : 2);
  const int first_out = !in[0] ? 0 : (!in[1] ? 1 : 2);
  const int rot = n_in == 1 ? first_in
                            : (n_in == 2 ? (first_out + 1) % 3 : 0);
  // rotated slot k takes original (rot + k) % 3, by selects (an index
  // known only at run time would put c in local memory)
  float r[3][4], rd[3];
  for (int k = 0; k < 3; ++k) {
    for (int j = 0; j < 4; ++j)
      r[k][j] = rot == 0 ? c[k][j]
                         : (rot == 1 ? c[(k + 1) % 3][j] : c[(k + 2) % 3][j]);
    rd[k] = rot == 0 ? d[k] : (rot == 1 ? d[(k + 1) % 3] : d[(k + 2) % 3]);
  }
  const float ta = ratio(rd[0], rd[1]);  // a -> b
  const float tc = ratio(rd[0], rd[2]);  // a -> c
  const float tb = ratio(rd[1], rd[2]);  // b -> c
  const bool one_in = n_in == 1, two_in = n_in == 2;
  // the first output: 3-in (a, b, c); 1-in (a, ab, ac); 2-in (a, b, bc).
  // the second (only 2-in): (a, bc, ac)
  float v[3][4];
  for (int j = 0; j < 4; ++j) {
    const float a0 = r[0][j], b0 = r[1][j], c0 = r[2][j];
    const float ab = lerp(a0, b0, ta);
    const float ac = lerp(a0, c0, tc);
    const float bc = lerp(b0, c0, tb);
    v[0][j] = a0;
    v[1][j] = second ? bc : (one_in ? ab : b0);
    v[2][j] = second ? ac : (one_in ? ac : (two_in ? bc : c0));
    for (int k = 0; k < 3; ++k) ch[(kClip + 3 * j + k) * n2 + o] = v[k][j];
  }
  // the screen setup
  float ux[3], uy[3], sx[3], sy[3];
  for (int k = 0; k < 3; ++k) {
    const float iw = recip_guard(v[k][3], 1e-9f);
    ux[k] = fmaf(v[k][0], iw, 1.0f);
    uy[k] = fmaf(-v[k][1], iw, 1.0f);
    sx[k] = ux[k] * hx;
    sy[k] = uy[k] * hy;
    float* s = ch + (kScreen + 4 * k) * n2 + o;
    s[0] = sx[k];
    s[n2] = sy[k];
    s[2 * n2] = fmaf(v[k][2], iw, 1.0f) * 0.5f;
    s[3 * n2] = iw;
    scr.v[k] = sx[k];
    scr.v[3 + k] = sy[k];
    scr.v[6 + k] = iw;
  }
  const float e0x = fmaf(ux[1], hx, -sx[0]);
  const float e0y = fmaf(uy[1], hy, -sy[0]);
  const float e1x = fmaf(ux[2], hx, -sx[0]);
  const float e1y = fmaf(uy[2], hy, -sy[0]);
  const float area2 = fmaf(e0x, e1y, -(e0y * e1x));
  ch[kArea * n2 + o] = area2;
  scr.v[9] = area2;
  const bool ok = area2 < 0.0f && fabsf(area2) > 1e-12f;
  valid[o] = (second ? two_in : n_in >= 1) && ok;
  if (second) {
    t_rec[2LL * T + t] = tb;
    i_rec[T + t] = n_in;
  } else {
    t_rec[t] = ta;
    t_rec[T + t] = tc;
    i_rec[t] = rot;
  }
  rec = PlaneRecord{rot, n_in, ta, tc, tb, second};
}

// kPos9: src is pos9 [9, T] (rows xa ya za xb yb zb xc yc zc) and the
// vertex transform fuses; else positions [3T, 3], summed pairwise.
template <bool kPos9>
__global__ void __launch_bounds__(RC_THREADS)
raster_clip_kernel(const float* __restrict__ src, Mvp mv, float hx, float hy,
                   float* __restrict__ ch, bool* __restrict__ valid,
                   float* __restrict__ t_rec, int* __restrict__ i_rec,
                   int T) {
  const int t = blockIdx.x * kSlots + threadIdx.x % kSlots;
  if (t >= T) return;
  float p[9];
  load_slot<kPos9>(src, T, t, p);
  PlaneScreen scr;
  PlaneRecord rec;
  clip_one<kPos9>(p, mv, hx, hy, ch, valid, t_rec, i_rec, T, t,
                  threadIdx.x >= kSlots, scr, rec);
}

// The slots form: X4's thread, then its output slot's 27 attribute values
// (vertex slot s, attribute j into row kSlotRows + 9 s + j).
template <bool kPos9>
__global__ void __launch_bounds__(RC_THREADS)
raster_clip_slots_kernel(const float* __restrict__ src, Mvp mv, float hx,
                         float hy, const float* __restrict__ normals,
                         const float* __restrict__ colors,
                         float* __restrict__ ch, bool* __restrict__ valid,
                         float* __restrict__ t_rec, int* __restrict__ i_rec,
                         int T) {
  const int t = blockIdx.x * kSlots + threadIdx.x % kSlots;
  if (t >= T) return;
  float p[9];
  load_slot<kPos9>(src, T, t, p);
  // the slot's normals then colors (vertex v's component d at [3 v + d] and
  // [9 + 3 v + d]), loaded before the clip's arithmetic
  float nc[18];
#pragma unroll
  for (int k = 0; k < 18; ++k)
    nc[k] = (k < 9 ? normals : colors)[9LL * t + k % 9];
  PlaneScreen scr;
  PlaneRecord rec;
  const bool second = threadIdx.x >= kSlots;
  clip_one<kPos9>(p, mv, hx, hy, ch, valid, t_rec, i_rec, T, t, second, scr,
                  rec);
  const long long n2 = 2LL * T;
  float* out = ch + kSlotRows * n2 + (second ? (long long)T + t : t);
#pragma unroll
  for (int j = 0; j < kSlotAttrs; ++j) {
    // attribute j at the source's vertices: a normal or color component,
    // or a coordinate
    const float* a = j < 6 ? nc + 9 * (j / 3) + j % 3 : p + j - 6;
    float vs[3];
    attr_slots(a[0], a[3], a[6], rec, vs);
#pragma unroll
    for (int s = 0; s < 3; ++s) out[(s * kSlotAttrs + j) * n2] = vs[s];
  }
}

template <bool kPos9>
__global__ void __launch_bounds__(kTableThreads)
raster_clip_table_kernel(const float* __restrict__ src, Mvp mv, float hx,
                         float hy, const float* __restrict__ normals,
                         const float* __restrict__ colors,
                         float* __restrict__ ch, bool* __restrict__ valid,
                         float* __restrict__ t_rec, int* __restrict__ i_rec,
                         float* __restrict__ table, int T) {
  // a slot's attributes, vertex v's at [9 v + j]: normals, colors, positions
  __shared__ float attr_s[kTableSlots][3 * kTableA + 1];
  __shared__ float vals_s[kPlaneRowVals][2 * kTableSlots];  // rows' own
  __shared__ float trec_s[3][kTableSlots];  // t_ab t_ac t_bc of a slot
  __shared__ int irec_s[2][kTableSlots];    // rot n_in of a slot
  const int base = blockIdx.x * kTableSlots;
  const int n = min(kTableSlots, T - base);  // the block's source slots
  for (int f = threadIdx.x; f < 9 * n; f += kTableThreads) {
    // element f of the slots' [n, 3, 3] rows: slot f / 9, vertex, component
    const int i = f / 9, v = f % 9 / 3, d = f % 3;
    attr_s[i][9 * v + d] = normals[9LL * base + f];
    attr_s[i][9 * v + 3 + d] = colors[9LL * base + f];
    if (kPos9) {  // pos9 row f / n (vertex, component), slot f % n
      const int row = f / n, si = f % n;
      attr_s[si][9 * (row / 3) + 6 + row % 3] =
          src[(long long)row * T + base + si];
    } else {
      attr_s[i][9 * v + 6 + d] = src[9LL * base + f];
    }
  }
  const int row = threadIdx.x;  // first-phase row: its output slot
  const int i = row % kTableSlots;
  if (row < 2 * kTableSlots && i < n) {
    const int t = base + i;
    float p[9];
    load_slot<kPos9>(src, T, t, p);
    PlaneScreen scr;
    PlaneRecord rec;
    clip_one<kPos9>(p, mv, hx, hy, ch, valid, t_rec, i_rec, T, t,
                    row >= kTableSlots, scr, rec);
    const PlaneRow w = plane_row(scr);
    for (int k = 0; k < 9; ++k) vals_s[k][row] = w.p[k];
    vals_s[9][row] = w.inv;
    for (int k = 0; k < 3; ++k) vals_s[10 + k][row] = w.den[k];
    if (row < kTableSlots) {
      trec_s[0][i] = rec.ta;
      trec_s[1][i] = rec.tc;
      trec_s[2][i] = rec.tb;
      irec_s[0][i] = rec.rot;
      irec_s[1][i] = rec.n_in;
    }
  }
  __syncthreads();
  // the table: rows base .. base + n - 1, then T + base .. T + base + n - 1;
  // item e is attribute (or the denominator) e % 10 of the e / 10-th row
  for (int e = threadIdx.x; e < 2 * n * (kTableA + 1); e += kTableThreads) {
    const int rs = e / (kTableA + 1), j = e % (kTableA + 1);
    const bool second = rs >= n;
    const int si = second ? rs - n : rs;  // the row's slot in the block
    const int r = second ? kTableSlots + si : si;  // its first-phase row
    float* out = table + ((second ? (long long)T : 0LL) + base + si) *
                             kTableW + 3 * j;
    float c[3];
    if (j < kTableA) {
      float p[9];
      for (int k = 0; k < 9; ++k) p[k] = vals_s[k][r];
      const PlaneRecord rec{irec_s[0][si], irec_s[1][si], trec_s[0][si],
                            trec_s[1][si], trec_s[2][si], second};
      plane_attr(p, vals_s[9][r], attr_s[si][j], attr_s[si][9 + j],
                 attr_s[si][18 + j], rec, c);
    } else {
      for (int k = 0; k < 3; ++k) c[k] = vals_s[10 + k][r];
    }
    for (int k = 0; k < 3; ++k) out[k] = c[k];
    if (j == kTableA)  // the padding
      for (int k = 3; k < kTableW - 3 * kTableA; ++k) out[k] = 0.0f;
  }
  if (base + kTableSlots >= T)  // the last block: the background row
    for (int c = threadIdx.x; c < kTableW; c += kTableThreads)
      table[2LL * T * kTableW + c] = 0.0f;
}

void make_mvp(const float* mvp16, Mvp& mv) {
  for (int i = 0; i < 16; ++i) mv.m[i] = mvp16[i];
}

}  // namespace

extern "C" int raster_clip_launch(const float* src, int pos9,
                                  const float* mvp16, float hx, float hy,
                                  float* ch, bool* valid, float* t_rec,
                                  int* i_rec, int T, void* stream) {
  if (T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  Mvp mv;
  make_mvp(mvp16, mv);
  const unsigned blocks = (unsigned)((T + kSlots - 1) / kSlots);
  const cudaStream_t s = (cudaStream_t)stream;
  if (pos9)
    raster_clip_kernel<true><<<blocks, RC_THREADS, 0, s>>>(
        src, mv, hx, hy, ch, valid, t_rec, i_rec, T);
  else
    raster_clip_kernel<false><<<blocks, RC_THREADS, 0, s>>>(
        src, mv, hx, hy, ch, valid, t_rec, i_rec, T);
  return (int)cudaGetLastError();
}

extern "C" int raster_clip_slots_launch(const float* src, int pos9,
                                        const float* mvp16, float hx,
                                        float hy, const float* normals,
                                        const float* colors, float* ch,
                                        bool* valid, float* t_rec,
                                        int* i_rec, int T, void* stream) {
  if (T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  Mvp mv;
  make_mvp(mvp16, mv);
  const unsigned blocks = (unsigned)((T + kSlots - 1) / kSlots);
  const cudaStream_t s = (cudaStream_t)stream;
  if (pos9)
    raster_clip_slots_kernel<true><<<blocks, RC_THREADS, 0, s>>>(
        src, mv, hx, hy, normals, colors, ch, valid, t_rec, i_rec, T);
  else
    raster_clip_slots_kernel<false><<<blocks, RC_THREADS, 0, s>>>(
        src, mv, hx, hy, normals, colors, ch, valid, t_rec, i_rec, T);
  return (int)cudaGetLastError();
}

extern "C" int raster_clip_table_launch(const float* src, int pos9,
                                        const float* mvp16, float hx,
                                        float hy, const float* normals,
                                        const float* colors, float* ch,
                                        bool* valid, float* t_rec,
                                        int* i_rec, float* table, int T,
                                        void* stream) {
  if (T < 0) return (int)cudaErrorInvalidValue;
  Mvp mv;
  make_mvp(mvp16, mv);
  // at T = 0 one block writes the background row
  const unsigned blocks =
      (unsigned)(T == 0 ? 1 : (T + kTableSlots - 1) / kTableSlots);
  const cudaStream_t s = (cudaStream_t)stream;
  if (pos9)
    raster_clip_table_kernel<true><<<blocks, kTableThreads, 0, s>>>(
        src, mv, hx, hy, normals, colors, ch, valid, t_rec, i_rec, table, T);
  else
    raster_clip_table_kernel<false><<<blocks, kTableThreads, 0, s>>>(
        src, mv, hx, hy, normals, colors, ch, valid, t_rec, i_rec, table, T);
  return (int)cudaGetLastError();
}
