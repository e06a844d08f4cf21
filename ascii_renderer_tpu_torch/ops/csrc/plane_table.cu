// The small and mid raster paths' shading-plane table (X3), one thread a
// table row n < N: the source slot's attributes under the clip's rotation
// and lerps, the edge coefficients, the guarded 1 / area2 and the 3 (A + 1)
// planes, written as row n of the row-major table [N + 1, W]
// (W = 3 (A + 1) padded to 8; row N is the all-zero background row).
// ops/plane_table.plane_table_ref is the plain version; each of its fused
// chains is an fmaf here, in its order (core/fp.py gives the rules):
//   lerp               fma(t, c1 - c0, c0)
//   gamma_k            fma(y2 - y1, x1, -((x2 - x1) * y1))  (the left fuses)
//   attribute plane    fma(p2, q2, fma(p0, q0, p1 * q1)) * inv_area
//   denominator plane  fma(alpha2, iw2, fma(alpha1, iw1, alpha0 * iw0)),
//                      for beta / gamma fma(c2, iw2, fma(c0, iw0, c1 * iw1)),
//                      each * inv_area
// The reciprocal is IEEE (__frcp_rn), as torch's reciprocal is.
//
// Row n's source: slot n of the [2T] clip output (cidx == NULL), or
// cidx[n], where o >= T is the second clip output of slot o - T and the
// fill id 2T reads slot 0 (ops/plane_table.clip_attrs_compact_lists).
//
// Stands for XLA code, not a Pallas kernel: clip_attrs_channel_lists,
// clip_attrs_compact_lists and build_plane_table of
// ascii_renderer_tpu/backends/raster_channels.py (:426, :364, :481), which
// XLA fuses into each frame's program (and, at a length that is a multiple
// of 512, B7's pack). The plain version on CUDA tensors is some 180
// launches; this is one.
//
// What bounds it on the H100: bytes. A row reads 10 screen floats, its
// source's 5 records and 3A attributes (row-major: the 3A floats of a
// source are neighbours) and writes W floats, against ~43 + 27 A float
// operations. A thread's row-major row is W floats apart from its
// neighbour's, so stores straight from the threads would not coalesce
// (ROADMAP, B10's lesson): the block stages its 128 rows in shared memory
// (a row padded by one float against bank conflicts), then writes them as
// one contiguous span, neighbouring threads on neighbouring addresses.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// the screen channels a row reads (ops/plane_table.SCREEN_KEYS): pointers
// and element strides of sx a b c, sy a b c, iw a b c, area2
struct Screen {
  const float* p[10];
  long long st[10];
};

struct Records {
  const int* rot;
  const int* n_in;
  const float* t_ab;
  const float* t_ac;
  const float* t_bc;
};

template <int A>
struct Width {
  static constexpr int kW = (3 * (A + 1) + 7) / 8 * 8;
};

__device__ __forceinline__ float lerp(float c0, float c1, float t) {
  return fmaf(t, c1 - c0, c0);
}

__device__ __forceinline__ float sum3(const float (&p)[3], float q0,
                                      float q1, float q2) {
  return fmaf(p[2], q2, fmaf(p[0], q0, p[1] * q1));
}

template <int A>
__global__ void __launch_bounds__(kThreads)
plane_table_kernel(Screen sc, const int* __restrict__ cidx, Records rc,
                   const float* __restrict__ attrs, float* __restrict__ table,
                   int N, int T) {
  constexpr int kW = Width<A>::kW;
  constexpr int kPitch = kW + 1;
  __shared__ float rows[kThreads * kPitch];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  float* row = rows + threadIdx.x * kPitch;
  if (n < N) {
    const int o = cidx ? cidx[n] : n;
    const int src = o < 2 * T ? o % T : 0;
    const bool second = o >= T;
    const int rot = rc.rot[src], n_in = rc.n_in[src];
    const float ta = rc.t_ab[src], tc = rc.t_ac[src], tb = rc.t_bc[src];
    const bool one_in = n_in == 1, two_in = n_in == 2;
    float s[10];
    for (int k = 0; k < 10; ++k) s[k] = sc.p[k][n * sc.st[k]];
    const float* sx = s;
    const float* sy = s + 3;
    const float* iw = s + 6;
    float alpha[3], beta[3], gamma[3];
    for (int k = 0; k < 3; ++k) {
      const float x1 = sx[(k + 1) % 3], y1 = sy[(k + 1) % 3];
      const float x2 = sx[(k + 2) % 3], y2 = sy[(k + 2) % 3];
      alpha[k] = -(y2 - y1);
      beta[k] = x2 - x1;
      gamma[k] = fmaf(y2 - y1, x1, -((x2 - x1) * y1));
    }
    const float area2 = s[9];
    const float inv_area = __frcp_rn(fabsf(area2) < 1e-12f ? 1e-12f : area2);
    float ai[3], bi[3], gi[3];
    for (int k = 0; k < 3; ++k) {
      ai[k] = alpha[k] * iw[k];
      bi[k] = beta[k] * iw[k];
      gi[k] = gamma[k] * iw[k];
    }
    const float* av = attrs + (long long)src * 3 * A;  // vertex k: av[k A + j]
    // rotated vertex k takes original vertex (rot + k) % 3 (any rot but 0
    // and 1 selecting as 2 does, as the plain version's selects do)
    const int q = rot == 0 ? 0 : (rot == 1 ? 1 : 2);
    for (int j = 0; j < A; ++j) {
      const float r0 = av[q * A + j];
      const float r1 = av[((q + 1) % 3) * A + j];
      const float r2 = av[((q + 2) % 3) * A + j];
      const float ab = lerp(r0, r1, ta);
      const float ac = lerp(r0, r2, tc);
      const float bc = lerp(r1, r2, tb);
      const float t1b = one_in ? ab : r1;
      const float t1c = one_in ? ac : (two_in ? bc : r2);
      const float v1 = second ? bc : t1b;  // tri2 is (a, bc, ac)
      const float v2 = second ? ac : t1c;
      row[3 * j] = sum3(ai, r0, v1, v2) * inv_area;
      row[3 * j + 1] = sum3(bi, r0, v1, v2) * inv_area;
      row[3 * j + 2] = sum3(gi, r0, v1, v2) * inv_area;
    }
    // the denominator: for alpha the second product fuses first
    row[3 * A] = fmaf(alpha[2], iw[2], fmaf(alpha[1], iw[1], ai[0])) *
                 inv_area;
    row[3 * A + 1] = fmaf(beta[2], iw[2], fmaf(beta[0], iw[0], bi[1])) *
                     inv_area;
    row[3 * A + 2] = fmaf(gamma[2], iw[2], fmaf(gamma[0], iw[0], gi[1])) *
                     inv_area;
    for (int c = 3 * (A + 1); c < kW; ++c) row[c] = 0.0f;
  } else if (n == N) {
    for (int c = 0; c < kW; ++c) row[c] = 0.0f;  // the background row
  }
  __syncthreads();
  const int first = blockIdx.x * kThreads;
  const int n_rows = min(kThreads, N + 1 - first);
  float* out = table + (long long)first * kW;
  for (int f = threadIdx.x; f < n_rows * kW; f += kThreads)
    out[f] = rows[(f / kW) * kPitch + f % kW];
}

template <int A>
void launch(const Screen& sc, const int* cidx, const Records& rc,
            const float* attrs, float* table, int N, int T,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((N + 1 + kThreads - 1) / kThreads);
  plane_table_kernel<A><<<blocks, kThreads, 0, stream>>>(sc, cidx, rc, attrs,
                                                        table, N, T);
}

}  // namespace

extern "C" int plane_table_launch(const long long* screen20, const int* cidx,
                                  const int* rot, const int* n_in,
                                  const float* t_ab, const float* t_ac,
                                  const float* t_bc, const float* attrs,
                                  float* table, int N, int T, int A,
                                  void* stream) {
  if (N < 0 || T < 0) return (int)cudaErrorInvalidValue;
  Screen sc;
  for (int k = 0; k < 10; ++k) {
    sc.p[k] = reinterpret_cast<const float*>(screen20[k]);
    sc.st[k] = screen20[10 + k];
  }
  const Records rc{rot, n_in, t_ab, t_ac, t_bc};
  const cudaStream_t s = (cudaStream_t)stream;
  if (A == 6)
    launch<6>(sc, cidx, rc, attrs, table, N, T, s);
  else if (A == 9)
    launch<9>(sc, cidx, rc, attrs, table, N, T, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
