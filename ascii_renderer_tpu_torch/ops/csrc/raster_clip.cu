// The small and mid raster paths' near-plane clip and screen setup (X4),
// one thread a triangle slot t < T: the MVP transform of its three
// vertices, the clip into up to two triangles (output slots t and T + t),
// and the screen setup of both (w reciprocals, screen x / y / z, the edge
// terms, area2, the facing and degenerate cull).
// ops/raster_clip.clip_screen_ref is the plain version; each of its fused
// chains is an fmaf here, in its order (core/fp.py gives the rules):
//   vertex (positions)  (x m0 + y m1) + (z m2 + m3)      (nothing fuses)
//   vertex (pos9)       fma(m2, z, fma(m0, x, m1 * y)) + m3
//   lerp                fma(t, c1 - c0, c0)
//   screen x / y / z    fma(x, iw, 1) * hx, fma(-y, iw, 1) * hy,
//                       fma(z, iw, 1) * 0.5
//   edges               fma(ux_b, hx, -sx_a), ...     (a's product shared)
//   area2               fma(e0x, e1y, -(e0y * e1x))   (the left fuses)
// Divisions and reciprocals are IEEE (__fdiv_rn, __frcp_rn), as torch's
// tensor / tensor and reciprocal are.
//
// Stands for XLA code, not a Pallas kernel: transform_clip_channels(9),
// _clip_channels_core and setup_screen_channels of
// ascii_renderer_tpu/backends/raster_channels.py (:31, :63, :76, :139),
// which XLA fuses into each frame's program. The plain version on CUDA
// tensors is some 235 launches; this is one.
//
// What bounds it on the H100: bytes. A slot reads 36 bytes and writes 25
// floats of each of its two output slots (channel-major [25, 2T], so the
// stores of neighbouring threads are neighbouring addresses), 2 valid
// bytes and 20 bytes of records, against ~200 float operations. It keeps
// everything in registers and needs no shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// rows of the float output [kChannels, 2T] (ops/raster_clip.FLOAT_KEYS):
// x / y / z / w of vertex slots a, b, c, then sx, sy, sz, iw of a, b, c,
// then area2
constexpr int kClip = 0;
constexpr int kScreen = 12;
constexpr int kArea = 24;
constexpr int kChannels = 25;

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

// The screen setup of one output triangle (x / y / z / w of its vertices
// a, b, c) into column o of the output; returns its cull.
__device__ __forceinline__ bool setup(const float (&v)[3][4], float hx,
                                      float hy, float* __restrict__ ch,
                                      long long n2, long long o) {
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
  }
  const float e0x = fmaf(ux[1], hx, -sx[0]);
  const float e0y = fmaf(uy[1], hy, -sy[0]);
  const float e1x = fmaf(ux[2], hx, -sx[0]);
  const float e1y = fmaf(uy[2], hy, -sy[0]);
  const float area2 = fmaf(e0x, e1y, -(e0y * e1x));
  ch[kArea * n2 + o] = area2;
  return area2 < 0.0f && fabsf(area2) > 1e-12f;
}

// kPos9: src is pos9 [9, T] (rows xa ya za xb yb zb xc yc zc) and the
// vertex transform fuses; else positions [3T, 3], summed pairwise.
template <bool kPos9>
__global__ void __launch_bounds__(kThreads)
raster_clip_kernel(const float* __restrict__ src, Mvp mv, float hx, float hy,
                   float* __restrict__ ch, bool* __restrict__ valid,
                   float* __restrict__ t_rec, int* __restrict__ i_rec,
                   int T) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const long long n2 = 2LL * T;
  float c[3][4];  // clip coordinates of the input vertices
  float d[3];
  bool in[3];
  for (int v = 0; v < 3; ++v) {
    float px, py, pz;
    if (kPos9) {
      px = src[(long long)(3 * v) * T + t];
      py = src[(long long)(3 * v + 1) * T + t];
      pz = src[(long long)(3 * v + 2) * T + t];
    } else {
      const float* p = src + 9LL * t + 3 * v;
      px = p[0];
      py = p[1];
      pz = p[2];
    }
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
  float r[3][4], rd[3];  // rotated slot k takes original (rot + k) % 3
  for (int k = 0; k < 3; ++k) {
    const int q = (rot + k) % 3;
    for (int j = 0; j < 4; ++j) r[k][j] = c[q][j];
    rd[k] = d[q];
  }
  const float ta = ratio(rd[0], rd[1]);  // a -> b
  const float tc = ratio(rd[0], rd[2]);  // a -> c
  const float tb = ratio(rd[1], rd[2]);  // b -> c
  const bool one_in = n_in == 1, two_in = n_in == 2;
  // tri1: 3-in (a, b, c); 1-in (a, ab, ac); 2-in (a, b, bc).
  // tri2 (only 2-in): (a, bc, ac)
  float v1[3][4], v2[3][4];
  for (int j = 0; j < 4; ++j) {
    const float a0 = r[0][j], b0 = r[1][j], c0 = r[2][j];
    const float ab = lerp(a0, b0, ta);
    const float ac = lerp(a0, c0, tc);
    const float bc = lerp(b0, c0, tb);
    v1[0][j] = a0;
    v1[1][j] = one_in ? ab : b0;
    v1[2][j] = one_in ? ac : (two_in ? bc : c0);
    v2[0][j] = a0;
    v2[1][j] = bc;
    v2[2][j] = ac;
    for (int k = 0; k < 3; ++k) {
      float* o = ch + (kClip + 3 * j + k) * n2 + t;
      o[0] = v1[k][j];
      o[T] = v2[k][j];
    }
  }
  const bool ok1 = setup(v1, hx, hy, ch, n2, t);
  const bool ok2 = setup(v2, hx, hy, ch, n2, (long long)T + t);
  valid[t] = n_in >= 1 && ok1;
  valid[T + t] = two_in && ok2;
  t_rec[t] = ta;
  t_rec[T + t] = tc;
  t_rec[2LL * T + t] = tb;
  i_rec[t] = rot;
  i_rec[T + t] = n_in;
}

}  // namespace

extern "C" int raster_clip_launch(const float* src, int pos9,
                                  const float* mvp16, float hx, float hy,
                                  float* ch, bool* valid, float* t_rec,
                                  int* i_rec, int T, void* stream) {
  if (T < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  Mvp mv;
  for (int i = 0; i < 16; ++i) mv.m[i] = mvp16[i];
  const unsigned blocks = (unsigned)((T + kThreads - 1) / kThreads);
  if (pos9)
    raster_clip_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, mv, hx, hy, ch, valid, t_rec, i_rec, T);
  else
    raster_clip_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, mv, hx, hy, ch, valid, t_rec, i_rec, T);
  return (int)cudaGetLastError();
}
