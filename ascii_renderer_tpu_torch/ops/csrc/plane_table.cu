// The small and mid raster paths' shading-plane table (X3) of the
// compacted callers, one thread a row: the row's screen channels, its
// source slot's clip records and the source's 3A vertex attributes, all
// loaded into registers before any arithmetic (so a row's gathers are in
// flight together), then the row's own values (plane_row: the edge
// coefficients times iw, the guarded reciprocal, the denominator plane)
// and each attribute's three plane coefficients (plane_attr: the clip's
// rotation and lerps, then the planes), written as row n of the
// row-major table [N + 1, W] (W = 3 (A + 1) padded to 8; row N is the
// all-zero background row). A thread's row is W floats from its
// neighbour's, so stores straight from the threads would not coalesce:
// the block stages its rows in shared memory (a row padded by one float
// against bank conflicts), then writes them as one contiguous span.
// plane_row.cuh holds the arithmetic, and its fused chains, which X4's
// table form shares.
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
// launches; this is one. Its uncompacted caller, render_soup's binned
// walk, takes X4's table form instead (raster_clip.cu).
//
// What bounds it on the H100: bytes. A row reads 10 screen floats, its
// source's 5 records and 3A attributes (row-major: the 3A floats of a
// source are neighbours) and writes W floats.
#include <cuda_runtime.h>

#include "plane_row.cuh"

#ifndef PT_THREADS
#define PT_THREADS 128  // threads (and rows) a block
#endif

namespace {

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
__global__ void __launch_bounds__(PT_THREADS)
plane_table_kernel(Screen sc, const int* __restrict__ cidx, Records rc,
                   const float* __restrict__ attrs, float* __restrict__ table,
                   int N, int T) {
  constexpr int kW = PlaneWidth<A>::kW;
  constexpr int kPitch = kW + 1;
  __shared__ float rows_s[PT_THREADS * kPitch];
  const int first = blockIdx.x * PT_THREADS;
  const int n = first + threadIdx.x;
  float* row = rows_s + threadIdx.x * kPitch;
  if (n < N) {
    const int o = cidx ? cidx[n] : n;
    const int src = o < 2 * T ? o % T : 0;
    PlaneScreen s;
    for (int k = 0; k < 10; ++k) s.v[k] = sc.p[k][n * sc.st[k]];
    const PlaneRecord r{rc.rot[src], rc.n_in[src], rc.t_ab[src],
                        rc.t_ac[src], rc.t_bc[src], o >= T};
    const float* av = attrs + (long long)src * 3 * A;  // vertex v: [v A + j]
    float a[3 * A];
    for (int f = 0; f < 3 * A; ++f) a[f] = av[f];
    const PlaneRow w = plane_row(s);
    for (int j = 0; j < A; ++j) {
      float c[3];
      plane_attr(w.p, w.inv, a[j], a[A + j], a[2 * A + j], r, c);
      for (int k = 0; k < 3; ++k) row[3 * j + k] = c[k];
    }
    for (int k = 0; k < 3; ++k) row[3 * A + k] = w.den[k];
    for (int c = 3 * (A + 1); c < kW; ++c) row[c] = 0.0f;
  } else if (n == N) {
    for (int c = 0; c < kW; ++c) row[c] = 0.0f;  // the background row
  }
  __syncthreads();
  const int n_rows = min(PT_THREADS, N + 1 - first);
  float* out = table + (long long)first * kW;
  for (int f = threadIdx.x; f < n_rows * kW; f += PT_THREADS)
    out[f] = rows_s[(f / kW) * kPitch + f % kW];
}

template <int A>
void launch(const Screen& sc, const int* cidx, const Records& rc,
            const float* attrs, float* table, int N, int T,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((N + 1 + PT_THREADS - 1) / PT_THREADS);
  plane_table_kernel<A><<<blocks, PT_THREADS, 0, stream>>>(sc, cidx, rc,
                                                          attrs, table, N, T);
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
