// X5: the soft rasterizer's forward and backward, one launch each, and
// X5b: the train step's glyph loss with its gradient, one launch.
//
// Stand for XLA code, not a Pallas kernel: the reference differentiates
// soft_render and soft_luminance_loss (ascii_renderer_tpu/diff/
// soft_raster.py:30, :118) with jax.value_and_grad inside its jitted train
// step (ascii_renderer_tpu/parallel/train.py:61-84). The plain versions
// are ops/soft_raster.py's soft_raster_fwd_ref (the torch chain of
// diff/soft_raster.soft_render_mvp after its gather), soft_raster_bwd_ref
// (its backward written out from the saved statistics) and soft_loss_ref.
//
// Forward (soft_raster_fwd_kernel): a pixel's 8 lanes split the
// triangles (lane l takes t = l, l + 8, ...), so that a pixel's serial
// chain is T / 8 terms; the block's triangles are staged in shared memory
// 256 at a time. Two passes: the largest of the T + 1 logits (the
// background's is 0), then the sum of the exponentials and the weighted
// colour; the lanes' parts are folded by an xor butterfly (every lane ends
// with the same bits). Out: rgb [V, H, W, 3] and the softmax statistics
// (max, sum) [V, H, W, 2] for the backward.
//
// Backward (soft_raster_bwd_kernel): a block a triangle loops over every
// view and pixel, recomputes the (triangle, pixel) terms and the
// triangle's softmax weight from the saved statistics (no [V, T, H, W]
// tensor is stored), and folds its 9 vertex-coordinate sums a view and 9
// colour sums over the views in a fixed order: no atomics, the same bits
// from call to call.
//
// Loss (soft_loss_kernel): a block a view; a thread a pixel of the view's
// row band writes d loss / d rgb (zero outside the band) and adds to the
// squared error and the log-probability of the target's glyph, folded in
// a fixed order into the view's loss.
//
// Rounding is the chain's, site by site, built with -fmad=false (no
// contraction), IEEE division: each edge (bx - ax) * (py - ay) - (by - ay)
// * (px - ax); the |area| < 1e-9 select; min(min(b0, b1), b2) with NaN
// kept; sigmoid(sign(m) * m^2 / sigma) as 1 / (1 + exp(-x)); the simplex
// clamp and its max(., 1e-6) renormalisation; zinv / gamma + log(clamp(cov,
// 1e-12, 1)); the pixel centres (c + 0.5) / cols * 2 - 1. Sums over the
// triangles and the pixels run in another order than torch's. The
// backward follows the chain's autograd rules: clamp passes the gradient
// at its bounds, minimum splits a tie in halves, sign has none, where
// sends it to the branch it took.
//
// At config 5 (36 x 96, 192 triangles, 1 or 4 views) all three are far
// below the launch floor by their bounds (operations: ~90 FP32 a
// (triangle, pixel) term forward, ~250 backward; chip_smoke.py counts
// them).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 8;          // a pixel's lanes in the forward pass
constexpr int kFwdThreads = 128;   // 16 pixels a block
constexpr int kTile = 256;         // triangles staged a round: 18 KB
constexpr int kBwdThreads = 256;   // a block a triangle
constexpr int kLossThreads = 1024; // a block a view

// torch.clamp: a NaN stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.minimum / torch.max: a NaN wins
__device__ __forceinline__ float tmin(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float sgnf(float m) {
  return m > 0.0f ? 1.0f : (m < 0.0f ? -1.0f : 0.0f);
}

// the pixel centres in NDC, as (arange + 0.5) / n * 2 - 1 rounds them
__device__ __forceinline__ float centre_x(int j, int cols) {
  return ((float)j + 0.5f) / (float)cols * 2.0f - 1.0f;
}
__device__ __forceinline__ float centre_y(int i, int rows) {
  return 1.0f - ((float)i + 0.5f) / (float)rows * 2.0f;
}

// one triangle's terms at one pixel; v: its vertices' (x, y, z), 9 floats
struct Terms {
  float w[3], area, as, b[3], m, cov, covc, nsum, norm, c[3], zpix, l;
};

__device__ __forceinline__ float edge(const float* v, int a, int b, float px,
                                      float py) {
  const float ax = v[3 * a], ay = v[3 * a + 1];
  const float bx = v[3 * b], by = v[3 * b + 1];
  return (bx - ax) * (py - ay) - (by - ay) * (px - ax);
}

__device__ __forceinline__ void terms(const float* v, float px, float py,
                                      float sigma, float gamma, Terms& t) {
  t.w[0] = edge(v, 1, 2, px, py);
  t.w[1] = edge(v, 2, 0, px, py);
  t.w[2] = edge(v, 0, 1, px, py);
  t.area = (t.w[0] + t.w[1]) + t.w[2];
  t.as = fabsf(t.area) < 1e-9f ? 1e-9f : t.area;
#pragma unroll
  for (int k = 0; k < 3; ++k) t.b[k] = t.w[k] / t.as;
  t.m = tmin(tmin(t.b[0], t.b[1]), t.b[2]);
  const float q = sgnf(t.m) * (t.m * t.m) / sigma;
  t.cov = 1.0f / (1.0f + expf(-q));
  float cl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) cl[k] = clampf(t.b[k], 0.0f, 1.0f);
  t.nsum = (cl[0] + cl[1]) + cl[2];
  t.norm = isnan(t.nsum) ? t.nsum : fmaxf(t.nsum, 1e-6f);
#pragma unroll
  for (int k = 0; k < 3; ++k) t.c[k] = cl[k] / t.norm;
  t.zpix = (t.c[0] * v[2] + t.c[1] * v[5]) + t.c[2] * v[8];
  const float zinv = (1.0f - clampf(t.zpix, -1.0f, 1.0f)) * 0.5f;
  t.covc = clampf(t.cov, 1e-12f, 1.0f);
  t.l = zinv / gamma + logf(t.covc);
}

// the interpolated colour channel ch; col: the vertices' colours
__device__ __forceinline__ float colour(const Terms& t, const float* col,
                                        int ch) {
  return (t.c[0] * col[ch] + t.c[1] * col[3 + ch]) + t.c[2] * col[6 + ch];
}

__global__ void __launch_bounds__(kFwdThreads)
soft_raster_fwd_kernel(const float* __restrict__ tv,
                       const float* __restrict__ tc, float* __restrict__ rgb,
                       float* __restrict__ stats, int T, int rows, int cols,
                       int blocks_per_view, float sigma, float gamma,
                       float bg0, float bg1, float bg2) {
  __shared__ float s_v[kTile * 9];
  __shared__ float s_c[kTile * 9];
  constexpr int kPix = kFwdThreads / kLanes;
  const int view = blockIdx.x / blocks_per_view;
  const int npix = rows * cols;
  const int lane = threadIdx.x % kLanes;
  const int p = (blockIdx.x - view * blocks_per_view) * kPix +
                threadIdx.x / kLanes;
  const bool live = p < npix;
  const int pc = live ? p : 0;
  const int i = pc / cols;
  const float px = centre_x(pc - i * cols, cols);
  const float py = centre_y(i, rows);
  const float* vv = tv + (size_t)view * T * 9;

  // pass 1: the largest logit
  float mx = 0.0f;  // the background's
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < n * 9; e += kFwdThreads)
      s_v[e] = vv[(size_t)t0 * 9 + e];
    __syncthreads();
    for (int t = lane; t < n; t += kLanes) {
      Terms tm;
      terms(s_v + 9 * t, px, py, sigma, gamma, tm);
      mx = tmax(mx, tm.l);
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    mx = tmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));

  // pass 2: the sum of the exponentials and the weighted colour
  float s = 0.0f, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int n = min(kTile, T - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < n * 9; e += kFwdThreads) {
      s_v[e] = vv[(size_t)t0 * 9 + e];
      s_c[e] = tc[(size_t)t0 * 9 + e];
    }
    __syncthreads();
    for (int t = lane; t < n; t += kLanes) {
      Terms tm;
      terms(s_v + 9 * t, px, py, sigma, gamma, tm);
      const float e = expf(tm.l - mx);
      const float* col = s_c + 9 * t;
      s += e;
      a0 += e * colour(tm, col, 0);
      a1 += e * colour(tm, col, 1);
      a2 += e * colour(tm, col, 2);
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    a0 += __shfl_xor_sync(0xffffffffu, a0, o);
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    a2 += __shfl_xor_sync(0xffffffffu, a2, o);
  }
  if (live && lane == 0) {
    const float eb = expf(0.0f - mx);
    s += eb;
    a0 += eb * bg0;
    a1 += eb * bg1;
    a2 += eb * bg2;
    const size_t q = (size_t)view * npix + p;
    rgb[3 * q] = a0 / s;
    rgb[3 * q + 1] = a1 / s;
    rgb[3 * q + 2] = a2 / s;
    stats[2 * q] = mx;
    stats[2 * q + 1] = s;
  }
}

// the sum of 9 values over the block, in a fixed order (a warp's tree,
// then the warps in turn); out[e] written by thread e
__device__ __forceinline__ void block_sum9(const float (&a)[9],
                                           float (*red)[9], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    float x = a[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp][e] = x;
  }
  __syncthreads();
  if (threadIdx.x < 9) {
    float x = 0.0f;
    for (int w = 0; w < kBwdThreads / 32; ++w) x += red[w][threadIdx.x];
    out[threadIdx.x] = x;
  }
  __syncthreads();
}

// torch.minimum(a, b)'s gradient g to a: all of it where a is the
// smaller, half on a tie
__device__ __forceinline__ float min_grad(float g, float a, float b) {
  return a < b ? g : (a == b ? g * 0.5f : 0.0f);
}

__global__ void __launch_bounds__(kBwdThreads)
soft_raster_bwd_kernel(const float* __restrict__ tv,
                       const float* __restrict__ tc,
                       const float* __restrict__ rgb,
                       const float* __restrict__ stats,
                       const float* __restrict__ grad,
                       float* __restrict__ g_tv, float* __restrict__ g_tc,
                       int V, int T, int rows, int cols, float sigma,
                       float gamma) {
  __shared__ float red[kBwdThreads / 32][9];
  const int t = blockIdx.x;
  const int npix = rows * cols;
  float col[9], acc_c[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    col[e] = tc[(size_t)t * 9 + e];
    acc_c[e] = 0.0f;
  }
  for (int view = 0; view < V; ++view) {
    float v[9], acc[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      v[e] = tv[((size_t)view * T + t) * 9 + e];
      acc[e] = 0.0f;
    }
    for (int p = threadIdx.x; p < npix; p += kBwdThreads) {
      const int i = p / cols;
      const float px = centre_x(p - i * cols, cols);
      const float py = centre_y(i, rows);
      const size_t q = (size_t)view * npix + p;
      const float g0 = grad[3 * q], g1 = grad[3 * q + 1],
                  g2 = grad[3 * q + 2];
      const float r0 = rgb[3 * q], r1 = rgb[3 * q + 1], r2 = rgb[3 * q + 2];
      const float mx = stats[2 * q], s = stats[2 * q + 1];
      Terms tm;
      terms(v, px, py, sigma, gamma, tm);
      const float cp0 = colour(tm, col, 0), cp1 = colour(tm, col, 1),
                  cp2 = colour(tm, col, 2);
      // the softmax and the weighted sum
      const float wt = expf(tm.l - mx) / s;
      const float gdot = (g0 * r0 + g1 * r1) + g2 * r2;
      const float gcol = (g0 * cp0 + g1 * cp1) + g2 * cp2;
      const float gl = wt * (gcol - gdot);
      const float gc0 = wt * g0, gc1 = wt * g1, gc2 = wt * g2;
      // the coverage: log(clamp(cov, 1e-12, 1)), sigmoid, sign(m) m^2
      const float gcov =
          (tm.cov >= 1e-12f && tm.cov <= 1.0f) ? gl / tm.covc : 0.0f;
      const float gq = gcov * ((1.0f - tm.cov) * tm.cov);
      const float gm = gq / sigma * sgnf(tm.m) * (2.0f * tm.m);
      // the depth: (1 - clamp(zpix, -1, 1)) * 0.5 / gamma
      const float gz =
          (tm.zpix >= -1.0f && tm.zpix <= 1.0f) ? -(gl / gamma * 0.5f) : 0.0f;
      // the renormalised barycentrics
      float gc[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gc[k] = gz * v[3 * k + 2] +
                ((gc0 * col[3 * k] + gc1 * col[3 * k + 1]) +
                 gc2 * col[3 * k + 2]);
        acc[3 * k + 2] += gz * tm.c[k];
        acc_c[3 * k] += gc0 * tm.c[k];
        acc_c[3 * k + 1] += gc1 * tm.c[k];
        acc_c[3 * k + 2] += gc2 * tm.c[k];
      }
      const float gnorm =
          -(((gc[0] * tm.c[0] + gc[1] * tm.c[1]) + gc[2] * tm.c[2]) /
            tm.norm);
      const float gnsum = tm.nsum >= 1e-6f ? gnorm : 0.0f;
      float gb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gb[k] = (tm.b[k] >= 0.0f && tm.b[k] <= 1.0f) ? gc[k] / tm.norm + gnsum
                                                     : 0.0f;
      // the margin min(min(b0, b1), b2)
      const float m01 = tmin(tm.b[0], tm.b[1]);
      const float gm01 = min_grad(gm, m01, tm.b[2]);
      gb[0] = gb[0] + min_grad(gm01, tm.b[0], tm.b[1]);
      gb[1] = gb[1] + min_grad(gm01, tm.b[1], tm.b[0]);
      gb[2] = gb[2] + min_grad(gm, tm.b[2], m01);
      // b_k = w_k / area_safe
      const float gas =
          -(((gb[0] * tm.b[0] + gb[1] * tm.b[1]) + gb[2] * tm.b[2]) / tm.as);
      const float garea = fabsf(tm.area) < 1e-9f ? 0.0f : gas;
      // the edges w_e = (xb - xa) (py - ya) - (yb - ya) (px - xa), e = 0,
      // 1, 2 with (a, b) = (1, 2), (2, 0), (0, 1)
      float gxa[3], gya[3], gxb[3], gyb[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int a = (e + 1) % 3, b = (e + 2) % 3;
        const float G = gb[e] / tm.as + garea;
        const float A = v[3 * b] - v[3 * a], B = py - v[3 * a + 1];
        const float C = v[3 * b + 1] - v[3 * a + 1], D = px - v[3 * a];
        const float GB = G * B;
        gxa[e] = G * C - GB;
        gya[e] = G * D - G * A;
        gxb[e] = GB;
        gyb[e] = -(G * D);
      }
      // vertex k is a of edge k + 2 and b of edge k + 1 (mod 3)
      acc[0] += gxb[1] + gxa[2];
      acc[1] += gyb[1] + gya[2];
      acc[3] += gxa[0] + gxb[2];
      acc[4] += gya[0] + gyb[2];
      acc[6] += gxb[0] + gxa[1];
      acc[7] += gyb[0] + gya[1];
    }
    block_sum9(acc, red, g_tv + ((size_t)view * T + t) * 9);
  }
  block_sum9(acc_c, red, g_tc + (size_t)t * 9);
}

__global__ void __launch_bounds__(kLossThreads)
soft_loss_kernel(const float* __restrict__ rgb,
                 const float* __restrict__ target, float* __restrict__ grad,
                 float* __restrict__ losses, int hw, int p0, int np, int L,
                 float tau, float gw, float third, float hi) {
  __shared__ float red[kLossThreads / 32][2];
  const int view = blockIdx.x;
  const float* x = rgb + (size_t)view * hw * 3;
  const float* tg = target + (size_t)view * np * 3;
  float* g = grad + (size_t)view * hw * 3;
  const float n3 = (float)np * 3.0f, n1 = (float)np;
  const float lm1 = (float)(L - 1);
  const float gwn = -(gw / n1);  // d loss / d log p of the target's glyph
  float sq = 0.0f, lp = 0.0f;
  for (int p = threadIdx.x; p < hw; p += kLossThreads) {
    float* go = g + 3 * (size_t)p;
    const int b = p - p0;
    if (b < 0 || b >= np) {
      go[0] = 0.0f;
      go[1] = 0.0f;
      go[2] = 0.0f;
      continue;
    }
    const float r0 = x[3 * (size_t)p], r1 = x[3 * (size_t)p + 1],
                r2 = x[3 * (size_t)p + 2];
    const float t0 = tg[3 * (size_t)b], t1 = tg[3 * (size_t)b + 1],
                t2 = tg[3 * (size_t)b + 2];
    const float d0 = r0 - t0, d1 = r1 - t1, d2 = r2 - t2;
    sq += (d0 * d0 + d1 * d1) + d2 * d2;
    // the target's hard glyph index
    const float tx = clampf(((t0 + t1) + t2) * third, 0.0f, hi) * lm1;
    const int tidx = (int)clampf(floorf(tx + 0.5f), 0.0f, lm1);
    // softmax over the ramp of -(x - k)^2 / tau
    const float lum = ((r0 + r1) + r2) * third;
    const float xv = clampf(lum, 0.0f, hi) * lm1;
    float mx = -INFINITY;
    for (int k = 0; k < L; ++k) {
      const float dk = xv - (float)k;
      mx = tmax(mx, -(dk * dk) / tau);
    }
    float sum = 0.0f, st = 0.0f;
    for (int k = 0; k < L; ++k) {
      const float dk = xv - (float)k;
      const float sk = -(dk * dk) / tau;
      sum += expf(sk - mx);
      if (k == tidx) st = sk;
    }
    const float pt = expf(st - mx) / sum;
    const float ptc = clampf(pt, 1e-12f, 1.0f);
    lp += logf(ptc);
    // d loss / d rgb: the MSE's, and the cross-entropy's through the
    // softmax, the clamp and the channel mean
    const float gpt = (pt >= 1e-12f && pt <= 1.0f) ? gwn / ptc : 0.0f;
    float gx = 0.0f;
    for (int k = 0; k < L; ++k) {
      const float dk = xv - (float)k;
      const float pk = expf(-(dk * dk) / tau - mx) / sum;
      const float gs = pk * ((k == tidx ? gpt : 0.0f) - gpt * pt);
      gx += -(gs / tau) * (2.0f * dk);
    }
    const float glum = (lum >= 0.0f && lum <= hi) ? gx * lm1 : 0.0f;
    const float gch = glum * third;
    go[0] = 2.0f * d0 / n3 + gch;
    go[1] = 2.0f * d1 / n3 + gch;
    go[2] = 2.0f * d2 / n3 + gch;
  }
  // the view's sums in a fixed order: a warp's tree, then the warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_down_sync(0xffffffffu, sq, o);
    lp += __shfl_down_sync(0xffffffffu, lp, o);
  }
  if (lane == 0) {
    red[warp][0] = sq;
    red[warp][1] = lp;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, c = 0.0f;
    for (int w = 0; w < kLossThreads / 32; ++w) {
      a += red[w][0];
      c += red[w][1];
    }
    losses[view] = a / n3 + gw * -(c / n1);
  }
}

}  // namespace

extern "C" int soft_raster_fwd_launch(const float* tv, const float* tc,
                                      float* rgb, float* stats, int V, int T,
                                      int rows, int cols, float sigma,
                                      float gamma, float bg0, float bg1,
                                      float bg2, void* stream) {
  if (V < 0 || T < 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  const int per_block = kFwdThreads / kLanes;
  const int blocks_per_view = (rows * cols + per_block - 1) / per_block;
  if (V > 0)
    soft_raster_fwd_kernel<<<V * blocks_per_view, kFwdThreads, 0,
                             (cudaStream_t)stream>>>(
        tv, tc, rgb, stats, T, rows, cols, blocks_per_view, sigma, gamma, bg0,
        bg1, bg2);
  return (int)cudaGetLastError();
}

extern "C" int soft_raster_bwd_launch(const float* tv, const float* tc,
                                      const float* rgb, const float* stats,
                                      const float* grad, float* g_tv,
                                      float* g_tc, int V, int T, int rows,
                                      int cols, float sigma, float gamma,
                                      void* stream) {
  if (V < 0 || T < 0 || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  if (T > 0)
    soft_raster_bwd_kernel<<<T, kBwdThreads, 0, (cudaStream_t)stream>>>(
        tv, tc, rgb, stats, grad, g_tv, g_tc, V, T, rows, cols, sigma, gamma);
  return (int)cudaGetLastError();
}

extern "C" int soft_loss_launch(const float* rgb, const float* target,
                                float* grad, float* losses, int V, int hw,
                                int p0, int np, int L, float tau, float gw,
                                float third, float hi, void* stream) {
  if (V < 0 || p0 < 0 || np < 0 || p0 + np > hw || L < 1)
    return (int)cudaErrorInvalidValue;
  if (V > 0)
    soft_loss_kernel<<<V, kLossThreads, 0, (cudaStream_t)stream>>>(
        rgb, target, grad, losses, hw, p0, np, L, tau, gw, third, hi);
  return (int)cudaGetLastError();
}
