// The span pack of ops/csrc/pack.cu in a second design, for measurement
// only (tools/pack_probe.py); no path of the package launches it.
//
// A block takes R consecutive rows n0 .. n0 + R - 1 of a span (a, b): it
// stages their R x (b - a) output values in shared memory from loads
// coalesced along n (consecutive threads read consecutive n of one
// channel; channels past C stage zeros), then writes the block's output,
// one contiguous stretch of out, with 16-byte stores and scalar stores for
// the stretch's last (len % 4) floats. The shared tile has an odd row
// stride, so the staging stores are free of bank conflicts.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int R>
__global__ void __launch_bounds__(kThreads)
pack_staged_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int C, int N, int a, int sw) {
  extern __shared__ float tile[];  // R rows x ld floats
  const int ld = sw | 1;
  const int n0 = blockIdx.x * R;
  const int rows = min(R, N - n0);
  for (int i = threadIdx.x; i < R * sw; i += kThreads) {
    const int c = i / R, r = i - c * R;  // R a power of two: shifts
    float v = 0.0f;
    if (r < rows && a + c < C) v = in[(size_t)(a + c) * N + n0 + r];
    tile[r * ld + c] = v;
  }
  __syncthreads();
  // out + n0 * sw is 16-byte aligned: R % 4 == 0 and out is
  float* dst = out + (size_t)n0 * sw;
  const int len = rows * sw, quads = len >> 2;
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    int r = (q << 2) / sw, c = (q << 2) - r * sw;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = tile[r * ld + c];
      if (++c == sw) {
        c = 0;
        ++r;
      }
    }
    reinterpret_cast<float4*>(dst)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int f = (quads << 2) + threadIdx.x; f < len; f += kThreads) {
    const int r = f / sw;
    dst[f] = tile[r * ld + f - r * sw];
  }
}

template <int R>
int launch(const float* in, float* out, int C, int N, int a, int sw,
           cudaStream_t stream) {
  const int blocks = (N + R - 1) / R;
  const size_t smem = sizeof(float) * R * (sw | 1);
  if (blocks == 0) return 0;
  pack_staged_kernel<R><<<blocks, kThreads, smem, stream>>>(in, out, C, N, a,
                                                            sw);
  return (int)cudaGetLastError();
}

}  // namespace

// (in, out, C, N, a, b, rows R of a block: 32, 64 or 128, stream); out
// 16-byte aligned
extern "C" int pack_staged_launch(const float* in, float* out, int C, int N,
                                  int a, int b, int rows, void* stream) {
  const int sw = b - a;
  if (sw <= 0 || sw > 64 || N < 0 || (long long)N * sw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 32: return launch<32>(in, out, C, N, a, sw, s);
    case 64: return launch<64>(in, out, C, N, a, sw, s);
    case 128: return launch<128>(in, out, C, N, a, sw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
