// Exact channel-major -> row-major transpose of one channel span:
// in [C, N] (the setup kernel's output; channel c starts at c * ld, ld >=
// N, so the first N columns of a wider block are read in place), out
// [N, b - a] with out[n, c - a] = in[c, n] for a <= c < b, and 0 for
// c >= C.
//
// Replaces: ascii_renderer_tpu/ops/pack.py:_pack_split_kernel_blk (B3),
// _pack_kernel (B7) and _pack_split_kernel (B7') (Pallas, TPU), called
// through pack_channels_split_blocked, pack_channels and
// pack_channels_split. The TPU kernels needed an MXU identity dot over a
// 3-way bf16 split because the TPU has no plain transpose; on the H100 a
// transpose is a copy, so none of that carries over and the result is
// bit-exact by construction (no arithmetic at all).
//
// What bounds it on the H100: device memory traffic, one read and one write
// of every float (a [21, 16384] -> [16384, 24] pack is ~0.9 us at
// 3.35 TB/s), and at these sizes the latency of one round trip to memory.
// Design: the output span is one contiguous array, written as 16-byte
// quads, one a thread: the thread gathers its quad's four floats (four
// consecutive channels of one row n, or of two rows where a quad crosses a
// row end) with four independent loads, all in flight at once, and stores
// the quad. A warp's loads touch a few channels over a short run of n; the
// L1 and L2 caches serve the rest of each 32-byte sector to the
// neighbouring warps, so memory still sees each input byte about once. No
// shared memory and no barrier: on the H100 a block that stages 32 to 128
// rows in a shared tile from loads coalesced along n, then writes its
// stretch, was slower than this at every driven shape (PERF.md, B7).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_span_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int C, int N, long long ld, int a, int sw) {
  const int total = N * sw;  // < 2^31, checked by the launcher
  const int quads = total >> 2;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q < quads) {
    int n = (q << 2) / sw, c = (q << 2) - n * sw;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = a + c < C ? in[(a + c) * ld + n] : 0.0f;
      if (++c == sw) {
        c = 0;
        ++n;
      }
    }
    reinterpret_cast<float4*>(out)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
  // the last total % 4 floats, one a thread of the first block
  const int f = (quads << 2) + q;
  if (q < 4 && f < total) {
    const int n = f / sw, c = f - n * sw;
    out[f] = a + c < C ? in[(a + c) * ld + n] : 0.0f;
  }
}

}  // namespace

// out must be 16-byte aligned (a fresh torch allocation is); in may sit at
// any float boundary
extern "C" int pack_span_launch(const float* in, float* out, int C, int N,
                                long long ld, int a, int b, void* stream) {
  const int sw = b - a;
  if (sw <= 0 || N < 0 || ld < N || (long long)N * sw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int quads = (N * sw) >> 2;
  const int blocks = quads / kThreads + 1;
  pack_span_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, out, C, N, ld, a, sw);
  return (int)cudaGetLastError();
}
