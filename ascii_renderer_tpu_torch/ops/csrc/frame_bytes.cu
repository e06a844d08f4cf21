// X12a: a frame's bytes from its float colours, in one launch
// (core/frame.Frame.from_float, with the UI plane of Frame.with_overrides
// where the frame step has one).
//
// Stands for XLA code: the reference's frame program converts its float
// image to UNORM bytes (core/frame.py from_float, core/quantize.py
// float_rgb_to_u8) and burns the UI char plane into the alpha byte
// (with_overrides) inside its one compiled frame; the port's plain version
// is that torch chain (core/frame.py). A thread a cell:
//   rgb byte = floor(clamp(v, 0, 1) * 255 + 0.5), the product and the sum
//              each rounded on its own (no fused multiply-add; the clamp
//              keeps NaN, as torch.clamp does);
//   alpha    = the given alpha plane's byte, or 1 where there is none;
//   UI cell  = where ui_mask is set: rgb 0, alpha the UI char.
// Any leading shape works: a frame [H, W, 3] or a batch of views
// [V, H, W, 3] is n cells, rows of W cells; the float rows may lie
// row_stride floats apart (the raster's images are views of their padded
// tile grids), the bytes are written contiguous. Byte-bound: 12 bytes in,
// 4 out a cell (2 more in with a UI plane, 1 with an alpha plane).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t unorm_byte(float v) {
  const float c = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
  return (uint8_t)(int)floorf(__fadd_rn(__fmul_rn(c, 255.0f), 0.5f));
}

__global__ void __launch_bounds__(kThreads)
frame_bytes_kernel(const float* __restrict__ rgb,
                   const uint8_t* __restrict__ alpha,
                   const uint8_t* __restrict__ ui_chars,
                   const uint8_t* __restrict__ ui_mask,
                   uint8_t* __restrict__ rgb_out, uint8_t* __restrict__ a_out,
                   long long n, long long W, long long row_stride) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long row = n <= 0xffffffffLL ? (long long)((unsigned)i /
                                                        (unsigned)W)
                                          : i / W;
  const float* px = rgb + row * row_stride + 3 * (i - row * W);
  uint8_t r = unorm_byte(px[0]);
  uint8_t g = unorm_byte(px[1]);
  uint8_t b = unorm_byte(px[2]);
  uint8_t a = alpha != nullptr ? alpha[i] : (uint8_t)1;
  if (ui_mask != nullptr && ui_mask[i] != 0) {
    r = g = b = 0;
    a = ui_chars[i];
  }
  rgb_out[3 * i] = r;
  rgb_out[3 * i + 1] = g;
  rgb_out[3 * i + 2] = b;
  a_out[i] = a;
}

}  // namespace

// n cells in rows of W, the float rows row_stride floats apart (3 W:
// contiguous); alpha, ui_chars and ui_mask may be null (no alpha plane: 1;
// no UI plane), ui_chars and ui_mask are both given or both null
extern "C" int frame_bytes_launch(const float* rgb, const uint8_t* alpha,
                                  const uint8_t* ui_chars,
                                  const uint8_t* ui_mask, uint8_t* rgb_out,
                                  uint8_t* a_out, long long n, long long W,
                                  long long row_stride, void* stream) {
  if (n <= 0) return 0;
  if (W <= 0 || n % W != 0 || row_stride < 3 * W)
    return (int)cudaErrorInvalidValue;
  if ((ui_chars == nullptr) != (ui_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  frame_bytes_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(rgb, alpha, ui_chars, ui_mask,
                                               rgb_out, a_out, n, W,
                                               row_stride);
  return (int)cudaGetLastError();
}
