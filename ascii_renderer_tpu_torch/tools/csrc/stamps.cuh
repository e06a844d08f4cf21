// Phase stamps for the grouped layout build's layout block (X10), for
// tools/build_variants.py, which builds ops/csrc/group_build.cu with this
// header prepended (nvcc -include): thread 0 of the block writes
// clock64() after each phase (STAMP) and the global timer at the block's
// ends (STAMP_NS), and stamps_read copies the last call's stamps to the
// host.
#include <cuda_runtime.h>

__device__ long long g_stamps[8];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define STAMP(i) \
  if (threadIdx.x == 0) g_stamps[i] = clock64();
#define STAMP_NS(i) \
  if (threadIdx.x == 0) g_stamps[i] = global_ns();

extern "C" int stamps_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
