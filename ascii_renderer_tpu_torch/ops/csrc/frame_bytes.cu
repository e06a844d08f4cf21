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
//
// The UI form (X16) draws the frame step's UI layer in the same launch from
// values the host passes (sim/ui.ui_params; the reference's sim/ui.py:157
// ui_char_plane inside its jitted frame step), in the reference's order of
// precedence, ripples over the FPS readout over the border:
//   border  x == 0 or x == cols - 1: pi[y % n]; else y == 0 or y == rows - 1:
//           pi[x % n] (the loop over rows writes last, so a corner takes
//           pi[y % n]); the digits a device copy made once;
//   FPS     row rows - 1, columns [fps_x, fps_x + fps_n): the digits' codes;
//   ripple  '*' where the midpoint march of a live ripple (cx, cy, r)
//           emits the cell (sim/ui._bresenham_np: the JS err rule, 8
//           octants, at most 128 steps). A cell at (dx, dy) from the centre,
//           a = max(|dx|, |dy|), b = min(|dx|, |dy|), can only be emitted as
//           the state (x, y) = (a, b); every emitted state has r^2 - 3 r - 1
//           <= x^2 + y^2 <= r^2, so the cells outside that ring are passed
//           over. Inside it, the march's rows in closed form: its err is
//           g(x, y) = x^2 + (y + 1)^2 - r^2 - 1, y grows where g <= 0 and x
//           falls where g > 0 after it, so at row y the march holds x from
//           M(y) = isqrt(r^2 + 1 - (y + 1)^2) up to max(M(y), M(y - 1) -
//           1), at row 0 x = r only; with d = a^2 + b^2 that is
//           r^2 - 2 (a + b) <= d <= r^2 - 2 b (no root taken), and state
//           (a, b) comes at most b + r - a steps in. Where that bound
//           reaches 128 steps (radius > 127) the march is replayed until y
//           reaches b and x falls to a (x never grows, y never falls).
//           tests/test_torch_ui_form.py proves the rule (sim/ui.ripple_cells,
//           the same in numpy) against the march for every radius 0-200
//           over every offset of the ring's box, and
//           tests/test_torch_build_glyph.py this kernel against the march
//           for every radius 0-200 on the card. Replaying the march for
//           every ring cell, and a block marching each live ripple's 8
//           octants into a shared mask of its cells, were measured slower
//           and removed.
// The UI source is a template flag (none, planes, values): no runtime
// branch on it in the byte path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRipples = 16;     // sim/ui.MAX_RIPPLES
constexpr int kFpsDigits = 7;       // sim/ui.FPS_MAX_DIGITS
constexpr int kMarchSteps = 128;    // sim/ui._MAX_BRESENHAM_STEPS
enum UiSource { kNoUi = 0, kPlanes = 1, kValues = 2 };

// the UI layer by value
struct Ui {
  const uint8_t* pi;  // the pi digits' codes, a device copy
  int n_pi;
  int rows, cols;
  int fps_x, fps_n;   // the readout's first column and its digits
  int n_rip;          // live ripples
  int fps[kFpsDigits];
  int cx[kMaxRipples], cy[kMaxRipples], r[kMaxRipples];
};

// a cell at (dx, dy) from a ripple's centre: does its march of radius r
// emit it? (sim/ui.ripple_cells is the same rule in numpy)
__device__ __forceinline__ bool ripple_cell(long long dx, long long dy,
                                            int r) {
  const long long ax = dx < 0 ? -dx : dx, ay = dy < 0 ? -dy : dy;
  if (ax > r || ay > r) return false;
  const int a = (int)(ax > ay ? ax : ay), b = (int)(ax > ay ? ay : ax);
  const long long d = (long long)a * a + (long long)b * b;
  const long long rr = (long long)r * r;
  if (d > rr || d < rr - 3LL * r - 1) return false;
  if (b + r - a < kMarchSteps)  // within the march's 128 steps
    return d >= rr - 2LL * (a + b) && d <= rr - 2LL * b;
  int x = r, y = 0, err = 0;
  for (int i = 0; i < kMarchSteps; ++i) {
    if (x < y) return false;  // the march has ended
    if (y >= b && x <= a) return x == a && y == b;
    // if (err <= 0) { y++; err += 2*y+1; } if (err > 0) { x--; err -= 2*x+1; }
    if (err <= 0) {
      ++y;
      err += 2 * y + 1;
    }
    if (err > 0) {
      --x;
      err -= 2 * x + 1;
    }
  }
  return false;
}

// cell (y, x)'s UI char, 0 where the layer leaves it
__device__ __forceinline__ int ui_char(const Ui& u, int y, int x,
                                       bool ripple) {
  if (ripple) return '*';
  if (y == u.rows - 1 && x >= u.fps_x && x < u.fps_x + u.fps_n)
    return u.fps[x - u.fps_x];
  if (x == 0 || x == u.cols - 1) return u.pi[y % u.n_pi];
  if (y == 0 || y == u.rows - 1) return u.pi[x % u.n_pi];
  return 0;
}

__device__ __forceinline__ uint8_t unorm_byte(float v) {
  const float c = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
  return (uint8_t)(int)floorf(__fadd_rn(__fmul_rn(c, 255.0f), 0.5f));
}

template <int kUi>
__global__ void __launch_bounds__(kThreads)
frame_bytes_kernel(const float* __restrict__ rgb,
                   const uint8_t* __restrict__ alpha,
                   const uint8_t* __restrict__ ui_chars,
                   const uint8_t* __restrict__ ui_mask,
                   uint8_t* __restrict__ rgb_out, uint8_t* __restrict__ a_out,
                   long long n, long long W, long long row_stride, Ui ui) {
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
  if (kUi == kPlanes && ui_mask[i] != 0) {
    r = g = b = 0;
    a = ui_chars[i];
  }
  if (kUi == kValues) {
    const int y = (int)row, x = (int)(i - row * W);
    bool rip = false;
    for (int k = 0; k < ui.n_rip && !rip; ++k)
      rip = ripple_cell((long long)x - ui.cx[k], (long long)y - ui.cy[k],
                        ui.r[k]);
    const int c = ui_char(ui, y, x, rip);
    if (c != 0) {
      r = g = b = 0;
      a = (uint8_t)c;
    }
  }
  rgb_out[3 * i] = r;
  rgb_out[3 * i + 1] = g;
  rgb_out[3 * i + 2] = b;
  a_out[i] = a;
}

}  // namespace

// n cells in rows of W, the float rows row_stride floats apart (3 W:
// contiguous); alpha, ui_chars and ui_mask may be null (no alpha plane: 1;
// no UI plane), ui_chars and ui_mask are both given or both null; ui_vals
// (host ints, or null) the UI layer by value, in place of a UI plane:
// rows, cols, n_pi, fps_x, fps_n, n_rip, the FPS_MAX_DIGITS digit codes,
// then cx, cy and r of MAX_RIPPLES ripples (the first n_rip live); pi: the
// n_pi digit codes on the device. With ui_vals the frame is one [rows,
// cols] grid.
extern "C" int frame_bytes_launch(const float* rgb, const uint8_t* alpha,
                                  const uint8_t* ui_chars,
                                  const uint8_t* ui_mask, uint8_t* rgb_out,
                                  uint8_t* a_out, long long n, long long W,
                                  long long row_stride, const int* ui_vals,
                                  const uint8_t* pi, void* stream) {
  if (n <= 0) return 0;
  if (W <= 0 || n % W != 0 || row_stride < 3 * W)
    return (int)cudaErrorInvalidValue;
  if ((ui_chars == nullptr) != (ui_mask == nullptr) ||
      (ui_vals != nullptr && (ui_chars != nullptr || pi == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Ui u{};
  if (ui_vals != nullptr) {
    u.pi = pi;
    u.rows = ui_vals[0];
    u.cols = ui_vals[1];
    u.n_pi = ui_vals[2];
    u.fps_x = ui_vals[3];
    u.fps_n = ui_vals[4];
    u.n_rip = ui_vals[5];
    if (u.rows < 1 || u.cols != W || (long long)u.rows * u.cols != n ||
        u.n_pi < 1 || u.fps_n < 0 || u.fps_n > kFpsDigits || u.n_rip < 0 ||
        u.n_rip > kMaxRipples)
      return (int)cudaErrorInvalidValue;
    const int* v = ui_vals + 6;
    for (int k = 0; k < kFpsDigits; ++k) u.fps[k] = v[k];
    v += kFpsDigits;
    for (int k = 0; k < kMaxRipples; ++k) {
      u.cx[k] = v[k];
      u.cy[k] = v[kMaxRipples + k];
      u.r[k] = v[2 * kMaxRipples + k];
      if (k < u.n_rip && u.r[k] < 0) return (int)cudaErrorInvalidValue;
    }
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (ui_vals != nullptr)
    frame_bytes_kernel<kValues><<<(unsigned)blocks, kThreads, 0, s>>>(
        rgb, alpha, nullptr, nullptr, rgb_out, a_out, n, W, row_stride, u);
  else if (ui_mask != nullptr)
    frame_bytes_kernel<kPlanes><<<(unsigned)blocks, kThreads, 0, s>>>(
        rgb, alpha, ui_chars, ui_mask, rgb_out, a_out, n, W, row_stride, u);
  else
    frame_bytes_kernel<kNoUi><<<(unsigned)blocks, kThreads, 0, s>>>(
        rgb, alpha, nullptr, nullptr, rgb_out, a_out, n, W, row_stride, u);
  return (int)cudaGetLastError();
}
