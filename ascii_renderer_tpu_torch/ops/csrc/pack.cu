// Exact channel-major -> row-major transpose of one channel span:
// in [C, N] (the setup kernel's output), out [N, b - a] with
// out[n, c - a] = in[c, n] for a <= c < b, and 0 for c >= C.
//
// Replaces: ascii_renderer_tpu/ops/pack.py:_pack_split_kernel_blk (Pallas,
// TPU), called through pack_channels_split_blocked. The TPU kernel needed an
// MXU identity dot over a 3-way bf16 split because the TPU has no plain
// transpose; on the H100 a transpose is a copy, so none of that carries over
// and the result is bit-exact by construction (no arithmetic at all).
//
// What bounds it on the H100: device memory traffic, one read and one write
// of every float. Design: 32 x 32 tiles staged through shared memory with a
// +1 pad column (no bank conflicts on the transposed read), so the global
// loads run along n and the global stores along the output row. Output rows
// are narrow (16 or 24 floats), so the stores are only partly coalesced; a
// later PR can fuse this into the setup kernel (ROADMAP B10).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;

__global__ void pack_span_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int C, int N, int a,
                                 int sw) {
  __shared__ float tile[kTile][kTile + 1];
  const int n0 = blockIdx.x * kTile;
  const int c0 = blockIdx.y * kTile;  // column offset inside the span
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = 0; j < kTile; j += kRowsPerPass) {
    const int cl = ty + j;
    const int c = a + c0 + cl;  // input channel
    const int n = n0 + tx;
    float v = 0.0f;
    if (c0 + cl < sw && c < C && n < N) v = in[(size_t)c * N + n];
    tile[cl][tx] = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTile; j += kRowsPerPass) {
    const int nl = ty + j;
    const int n = n0 + nl;
    const int col = c0 + tx;
    if (n < N && col < sw) out[(size_t)n * sw + col] = tile[tx][nl];
  }
}

}  // namespace

extern "C" int pack_span_launch(const float* in, float* out, int C, int N,
                                int a, int b, void* stream) {
  const int sw = b - a;
  dim3 block(kTile, kRowsPerPass);
  dim3 grid((N + kTile - 1) / kTile, (sw + kTile - 1) / kTile);
  pack_span_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, out, C, N, a,
                                                             sw);
  return (int)cudaGetLastError();
}
