// X14: the path tracer's batch fold and frame resolve, one launch a batch.
//
// Stands for XLA code, not a Pallas kernel: the reference's batch_step
// (ascii_renderer_tpu/backends/pathtrace.py:611-641: the masked sums of a
// batch's radiance, the first overriding sample, its one-hot select and
// merge) and the frame's end (:657-678: the probe's precedence, the
// clamp and select, alpha, the unpack from compacted order). The plain
// version is ops/pt_reduce.fold_ref, whose order of the sum this kernel
// keeps, so the two agree bit for bit.
//
// Thread p is stream slot p of pc. It reads the megakernel's flat outputs
// cr, cg, cb, ovf at rays s * pc + p (coalesced for each s) for the
// batch's valid samples s < n_valid:
//   acc_c = acc_c + c[s] in order of s from 0, then t_c = t_c + acc_c;
//   the first s with rint(ovf) > 0 gives (ov, cr, cg, cb), stored as the
//   override where the running override is still 0.
// The running state is t (3 channels) and the override colour (3) in
// tf [6, pc], the override in tov [pc]. kFirst: the frame's first batch,
// whose state is zero: it is not read (0 + acc_c is still added, as the
// plain version adds it to its zeros). kResolve: the frame's last batch,
// which writes no state but resolves each pixel:
//   the probe's override (rint(ov0f) > 0, colour lor0 / log0 / lob0)
//   takes precedence; rgb = has ? clamp(oc, 0, 1) : clamp(t * inv_spp,
//   0, 1), clamped as torch.clamp does (NaN kept); a = has ? override :
//   255 as a byte; both written at slot[p] (compacted order back to pixel
//   order), or at p.
// Built with -fmad=false: every add and product rounds on its own.
// Bytes-bound: 16 bytes read a ray, 28 read and 28 written a pixel of
// state between batches; the resolve reads 16 and writes 13 a pixel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// torch.clamp(v, 0, 1) as its CUDA kernel computes it: NaN passes
// through, else min(max(v, 0), 1)
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

template <bool kFirst, bool kResolve>
__global__ void __launch_bounds__(kThreads)
pt_reduce_kernel(const float* __restrict__ cr, const float* __restrict__ cg,
                 const float* __restrict__ cb, const float* __restrict__ ovf,
                 float* __restrict__ tf, int* __restrict__ tov, int pc,
                 int n_valid, const float* __restrict__ lor0,
                 const float* __restrict__ log0,
                 const float* __restrict__ lob0,
                 const float* __restrict__ ov0f, float inv_spp,
                 const int* __restrict__ slot, float* __restrict__ rgb,
                 uint8_t* __restrict__ a) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= pc) return;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  int fo = 0;  // the first override of the batch; > 0 once found
  float fr = 0.0f, fg = 0.0f, fb = 0.0f;
  size_t idx = p;
  for (int s = 0; s < n_valid; ++s, idx += pc) {
    const float r = cr[idx], g = cg[idx], b = cb[idx];
    ar = ar + r;
    ag = ag + g;
    ab = ab + b;
    if (fo == 0) {
      const int o = (int)rintf(ovf[idx]);
      if (o > 0) {
        fo = o;
        fr = r;
        fg = g;
        fb = b;
      }
    }
  }
  float tr, tg, tb, o_r, o_g, o_b;
  int ov;
  if (kFirst) {
    tr = 0.0f + ar;
    tg = 0.0f + ag;
    tb = 0.0f + ab;
    ov = fo;
    o_r = fr;
    o_g = fg;
    o_b = fb;
  } else {
    tr = tf[p] + ar;
    tg = tf[pc + p] + ag;
    tb = tf[2 * pc + p] + ab;
    ov = tov[p];
    o_r = tf[3 * pc + p];
    o_g = tf[4 * pc + p];
    o_b = tf[5 * pc + p];
    if (fo > 0 && ov == 0) {
      ov = fo;
      o_r = fr;
      o_g = fg;
      o_b = fb;
    }
  }
  if (!kResolve) {
    tf[p] = tr;
    tf[pc + p] = tg;
    tf[2 * pc + p] = tb;
    tf[3 * pc + p] = o_r;
    tf[4 * pc + p] = o_g;
    tf[5 * pc + p] = o_b;
    tov[p] = ov;
    return;
  }
  const int o0 = (int)rintf(ov0f[p]);
  if (o0 > 0) {
    ov = o0;
    o_r = lor0[p];
    o_g = log0[p];
    o_b = lob0[p];
  }
  const bool has = ov > 0;
  const int dst = slot != nullptr ? slot[p] : p;
  float* out = rgb + 3 * (size_t)dst;
  out[0] = has ? clamp01(o_r) : clamp01(tr * inv_spp);
  out[1] = has ? clamp01(o_g) : clamp01(tg * inv_spp);
  out[2] = has ? clamp01(o_b) : clamp01(tb * inv_spp);
  a[dst] = has ? (uint8_t)ov : (uint8_t)255;
}

template <bool kFirst, bool kResolve>
void launch(const float* cr, const float* cg, const float* cb,
            const float* ovf, float* tf, int* tov, int pc, int n_valid,
            const float* lor0, const float* log0, const float* lob0,
            const float* ov0f, float inv_spp, const int* slot, float* rgb,
            uint8_t* a, cudaStream_t stream) {
  pt_reduce_kernel<kFirst, kResolve>
      <<<(pc + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          cr, cg, cb, ovf, tf, tov, pc, n_valid, lor0, log0, lob0, ov0f,
          inv_spp, slot, rgb, a);
}

}  // namespace

// cr, cg, cb, ovf: the batch's megakernel outputs, flat (ray s * pc + p);
// tf: device floats [6, pc], tov: device ints [pc] (read unless first,
// written unless resolve); resolve: lor0, log0, lob0, ov0f the probe's
// outputs (pc floats each), inv_spp the float32 1 / spp, slot null or the
// pixel of each stream slot (pc ints), rgb floats [pc, 3], a bytes [pc]
extern "C" int pt_reduce_launch(const float* cr, const float* cg,
                                const float* cb, const float* ovf, float* tf,
                                int* tov, int pc, int n_valid, int first,
                                int resolve, const float* lor0,
                                const float* log0, const float* lob0,
                                const float* ov0f, float inv_spp,
                                const int* slot, float* rgb, uint8_t* a,
                                void* stream) {
  if (pc < 0 || n_valid < 1) return (int)cudaErrorInvalidValue;
  if (resolve && (lor0 == nullptr || log0 == nullptr || lob0 == nullptr ||
                  ov0f == nullptr || rgb == nullptr || a == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!(first && resolve) && (tf == nullptr || tov == nullptr))
    return (int)cudaErrorInvalidValue;
  if (pc == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (first && resolve)
    launch<true, true>(cr, cg, cb, ovf, tf, tov, pc, n_valid, lor0, log0,
                       lob0, ov0f, inv_spp, slot, rgb, a, s);
  else if (first)
    launch<true, false>(cr, cg, cb, ovf, tf, tov, pc, n_valid, lor0, log0,
                        lob0, ov0f, inv_spp, slot, rgb, a, s);
  else if (resolve)
    launch<false, true>(cr, cg, cb, ovf, tf, tov, pc, n_valid, lor0, log0,
                        lob0, ov0f, inv_spp, slot, rgb, a, s);
  else
    launch<false, false>(cr, cg, cb, ovf, tf, tov, pc, n_valid, lor0, log0,
                         lob0, ov0f, inv_spp, slot, rgb, a, s);
  return (int)cudaGetLastError();
}
