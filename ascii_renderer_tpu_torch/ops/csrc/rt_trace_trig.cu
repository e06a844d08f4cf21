// K3's grid form in its trig form (ops/rt_trace.trace with a trig grid):
// the kTrig instances of rt_trace.cuh's kernel, 48 as rt_trace.cu's, in a
// source of their own, so that the two build side by side (each ~55 s of
// nvcc). rt_trace.cu's C entry calls launch_trig where trig is 1.
#include "rt_trace.cuh"

namespace rt_trace_k {

int launch_trig(int fuse_p, int fuse_s, int lanes, bool staged,
                const Rays& p, float* out, int rays, unsigned n,
                const Scene& s, cudaStream_t st) {
  return launch_fused<true>(fuse_p, fuse_s, lanes, staged, p, out, rays, n,
                            s, st);
}

}  // namespace rt_trace_k
