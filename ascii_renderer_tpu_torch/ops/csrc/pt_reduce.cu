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
// Stream slot p's fold reads the megakernel's flat outputs cr, cg, cb,
// ovf at rays s * pc + p for the batch's valid samples s < n_valid:
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
// Two forms, a template flag chosen by the launch's size
// (ops/pt_reduce.TILE_BELOW, 32,768 slots, where the two measured even):
// - kTile false, a thread a slot, looping over the samples: many slots
//   keep many loads in flight (the HD arm's one batch of 8 over 518,400
//   slots);
// - kTile true, a block a tile of 32 slots: its 8 warps load the tile's
//   samples of all four planes (32 x 32 x 4 floats, 16 KB; each warp one
//   sample row of 32 slots, coalesced, up to 16 loads a thread in flight
//   at once) into shared memory, then the first warp folds each slot's
//   column in the order above, 32 samples a round. At 96x36's 3,456
//   slots that is 108 blocks and one round of loads, where a thread a
//   slot gave 14 blocks whose threads each waited on 32 rounds of loads.
// Built with -fmad=false: every add and product rounds on its own.
// Bytes-bound: 16 bytes read a ray, 28 read and 28 written a pixel of
// state between batches; the resolve reads 16 and writes 13 a pixel. At
// 96x36 the bytes take ~0.0006 ms, below a launch's floor (~0.002 ms).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 32;  // slots a tile (a warp's lanes)
constexpr int kTileS = 32;  // samples a round of the tile's loads

// torch.clamp(v, 0, 1) as its CUDA kernel computes it: NaN passes
// through, else min(max(v, 0), 1)
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// A slot's batch sums and first override, carried across rounds.
struct Fold {
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  int fo = 0;  // the first override of the batch; > 0 once found
  float fr = 0.0f, fg = 0.0f, fb = 0.0f;

  __device__ __forceinline__ void add(float r, float g, float b, float ov) {
    ar = ar + r;
    ag = ag + g;
    ab = ab + b;
    if (fo == 0) {
      const int o = (int)rintf(ov);
      if (o > 0) {
        fo = o;
        fr = r;
        fg = g;
        fb = b;
      }
    }
  }
};

struct Args {
  const float *cr, *cg, *cb, *ovf;
  float* tf;
  int* tov;
  int pc, n_valid;
  const float *lor0, *log0, *lob0, *ov0f;
  float inv_spp;
  const int* slot;
  float* rgb;
  uint8_t* a;
};

// Slot p's batch fold f into the running state, or the frame's resolve.
template <bool kFirst, bool kResolve>
__device__ __forceinline__ void finish(const Args& x, int p, const Fold& f) {
  const int pc = x.pc;
  float tr, tg, tb, o_r, o_g, o_b;
  int ov;
  if (kFirst) {
    tr = 0.0f + f.ar;
    tg = 0.0f + f.ag;
    tb = 0.0f + f.ab;
    ov = f.fo;
    o_r = f.fr;
    o_g = f.fg;
    o_b = f.fb;
  } else {
    tr = x.tf[p] + f.ar;
    tg = x.tf[pc + p] + f.ag;
    tb = x.tf[2 * pc + p] + f.ab;
    ov = x.tov[p];
    o_r = x.tf[3 * pc + p];
    o_g = x.tf[4 * pc + p];
    o_b = x.tf[5 * pc + p];
    if (f.fo > 0 && ov == 0) {
      ov = f.fo;
      o_r = f.fr;
      o_g = f.fg;
      o_b = f.fb;
    }
  }
  if (!kResolve) {
    x.tf[p] = tr;
    x.tf[pc + p] = tg;
    x.tf[2 * pc + p] = tb;
    x.tf[3 * pc + p] = o_r;
    x.tf[4 * pc + p] = o_g;
    x.tf[5 * pc + p] = o_b;
    x.tov[p] = ov;
    return;
  }
  const int o0 = (int)rintf(x.ov0f[p]);
  if (o0 > 0) {
    ov = o0;
    o_r = x.lor0[p];
    o_g = x.log0[p];
    o_b = x.lob0[p];
  }
  const bool has = ov > 0;
  const int dst = x.slot != nullptr ? x.slot[p] : p;
  float* out = x.rgb + 3 * (size_t)dst;
  out[0] = has ? clamp01(o_r) : clamp01(tr * x.inv_spp);
  out[1] = has ? clamp01(o_g) : clamp01(tg * x.inv_spp);
  out[2] = has ? clamp01(o_b) : clamp01(tb * x.inv_spp);
  x.a[dst] = has ? (uint8_t)ov : (uint8_t)255;
}

template <bool kFirst, bool kResolve, bool kTile>
__global__ void __launch_bounds__(kThreads) pt_reduce_kernel(const Args x) {
  Fold f;
  if constexpr (!kTile) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= x.pc) return;
    size_t idx = p;
    for (int s = 0; s < x.n_valid; ++s, idx += x.pc)
      f.add(x.cr[idx], x.cg[idx], x.cb[idx], x.ovf[idx]);
    finish<kFirst, kResolve>(x, p, f);
  } else {
    __shared__ float sh[4][kTileS][kTileP];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int p = blockIdx.x * kTileP + lane;
    const bool live = p < x.pc;
    for (int c0 = 0; c0 < x.n_valid; c0 += kTileS) {
      const int cnt = min(kTileS, x.n_valid - c0);
#pragma unroll
      for (int k = 0; k < kTileS / (kThreads / 32); ++k) {
        const int ss = w + k * (kThreads / 32);
        if (live && ss < cnt) {
          const size_t idx = (size_t)(c0 + ss) * x.pc + p;
          sh[0][ss][lane] = x.cr[idx];
          sh[1][ss][lane] = x.cg[idx];
          sh[2][ss][lane] = x.cb[idx];
          sh[3][ss][lane] = x.ovf[idx];
        }
      }
      __syncthreads();
      if (w == 0 && live)
        for (int ss = 0; ss < cnt; ++ss)
          f.add(sh[0][ss][lane], sh[1][ss][lane], sh[2][ss][lane],
                sh[3][ss][lane]);
      __syncthreads();
    }
    if (w == 0 && live) finish<kFirst, kResolve>(x, p, f);
  }
}

template <bool kFirst, bool kResolve>
void launch(const Args& x, bool tile, cudaStream_t stream) {
  if (tile)
    pt_reduce_kernel<kFirst, kResolve, true>
        <<<(x.pc + kTileP - 1) / kTileP, kThreads, 0, stream>>>(x);
  else
    pt_reduce_kernel<kFirst, kResolve, false>
        <<<(x.pc + kThreads - 1) / kThreads, kThreads, 0, stream>>>(x);
}

}  // namespace

// cr, cg, cb, ovf: the batch's megakernel outputs, flat (ray s * pc + p);
// tf: device floats [6, pc], tov: device ints [pc] (read unless first,
// written unless resolve); resolve: lor0, log0, lob0, ov0f the probe's
// outputs (pc floats each), inv_spp the float32 1 / spp, slot null or the
// pixel of each stream slot (pc ints), rgb floats [pc, 3], a bytes [pc];
// tile: the tile form (else a thread a slot)
extern "C" int pt_reduce_launch(const float* cr, const float* cg,
                                const float* cb, const float* ovf, float* tf,
                                int* tov, int pc, int n_valid, int first,
                                int resolve, int tile, const float* lor0,
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
  const Args x{cr,   cg,   cb,   ovf,  tf,      tov,  pc,  n_valid,
               lor0, log0, lob0, ov0f, inv_spp, slot, rgb, a};
  const cudaStream_t s = (cudaStream_t)stream;
  if (first && resolve)
    launch<true, true>(x, tile != 0, s);
  else if (first)
    launch<true, false>(x, tile != 0, s);
  else if (resolve)
    launch<false, true>(x, tile != 0, s);
  else
    launch<false, false>(x, tile != 0, s);
  return (int)cudaGetLastError();
}
