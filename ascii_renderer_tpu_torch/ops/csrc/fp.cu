// The correctly rounded float32 a * b + c of core/fp.fma32 on CUDA tensors:
// one thread an element, one __fmaf_rn each. Operands broadcast to the
// output's shape (up to 6 dims: the plain versions of the grouped and
// subtile walks fuse over 5) through their strides (0 along a broadcast
// dimension), so no operand is expanded into memory first; an operand that
// is a scalar (a Python float, a 0-d CPU tensor) comes as a float argument.
//
// Stands for XLA code, not a Pallas kernel: the reference is compiled by
// XLA, which contracts a product into the add it feeds (core/fp.py gives
// the rules), and the port writes each such contraction as an fma32.
// The plain version, core/fp.fma32_f64, emulates the fused product-add in
// float64 (the product exact, the add's error by TwoSum deciding float32
// midpoints) with ~25 torch launches over the operands; both are correctly
// rounded, so they agree bit for bit (NaN payloads aside).
//
// What bounds it on the H100: memory, each operand read once and the
// result written once (16 bytes an element where all three vary); one FMA
// an element is far below the FP32 rate. Built with -fmad=false and
// without fast math: denormals are kept (no flush to zero).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDims = 6;

struct Operands {
  const float* p[3];     // device pointers; unused where the operand is a scalar
  float s[3];            // the scalars
  long long st[3][kDims];  // element strides over the output's dims
  int size[kDims];        // the output's shape, leading dims padded with 1
  int scalar_mask;        // bit k: operand k is s[k]
};

__device__ __forceinline__ float operand(const Operands& o, int k,
                                         long long off) {
  return (o.scalar_mask >> k) & 1 ? o.s[k] : o.p[k][off];
}

// kFlat: every tensor operand is contiguous in the output's shape, so its
// element i is at offset i.
template <bool kFlat>
__global__ void __launch_bounds__(kThreads)
fma32_kernel(Operands o, float* __restrict__ out, unsigned n) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  long long off[3] = {i, i, i};
  if (!kFlat) {
    unsigned rest = i;
    off[0] = off[1] = off[2] = 0;
#pragma unroll
    for (int d = kDims - 1; d >= 0; --d) {
      const unsigned q = rest / (unsigned)o.size[d];
      const long long idx = rest - q * (unsigned)o.size[d];
      rest = q;
#pragma unroll
      for (int k = 0; k < 3; ++k) off[k] += idx * o.st[k][d];
    }
  }
  out[i] = __fmaf_rn(operand(o, 0, off[0]), operand(o, 1, off[1]),
                     operand(o, 2, off[2]));
}

}  // namespace

// a, b, c: device pointers (ignored where scalar_mask has the operand's
// bit); sa, sb, sc: the scalars; geom (host): the output's 6 sizes, then 6
// strides of a, of b and of c; flat: every tensor operand is contiguous
// in the output's shape; out: n floats
extern "C" int fma32_launch(const float* a, const float* b, const float* c,
                            float sa, float sb, float sc, int scalar_mask,
                            const long long* geom, int flat, float* out,
                            long long n, void* stream) {
  if (n < 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Operands o;
  o.p[0] = a;
  o.p[1] = b;
  o.p[2] = c;
  o.s[0] = sa;
  o.s[1] = sb;
  o.s[2] = sc;
  o.scalar_mask = scalar_mask;
  for (int d = 0; d < kDims; ++d) {
    if (geom[d] < 1) return (int)cudaErrorInvalidValue;
    o.size[d] = (int)geom[d];
    for (int k = 0; k < 3; ++k) o.st[k][d] = geom[kDims * (k + 1) + d];
  }
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (flat)
    fma32_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        o, out, (unsigned)n);
  else
    fma32_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        o, out, (unsigned)n);
  return (int)cudaGetLastError();
}
