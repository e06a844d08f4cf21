// The path-trace megakernel: each thread traces one ray's whole path and
// writes its radiance (lor, log, lob), its primary glyph override byte (ov)
// and its primary texel-fetch flag (fet). The semantics and the arithmetic
// are those of the plain-torch version, ops/pt_kernel.py:trace_blocks_raw_ref
// (spheres, then triangles, then the analytic light sphere; environment on
// a miss; light hits on specular or primary paths; the primary glyph
// short-circuit; cosine-hemisphere or Fresnel reflect/refract sampling; NEE
// toward the light sphere; Russian roulette from bounce 2).
//
// Replaces: ascii_renderer_tpu/ops/pt_kernel.py:_kernel + _kernel_body
// (Pallas, TPU), called through trace_blocks_raw. The TPU kernel kept an
// (8, 128) ray block in vector registers and streamed lane-replicated entry
// rows through VMEM; its atlas fetch was a lane gather (or a one-hot MXU
// dot). None of that carries over: here a ray is a thread, an entry is a
// broadcast read from shared memory and a texel is one 32-bit load.
//
// What bounds it on the H100: FP32 and SFU issue, not memory. Per ray and
// bounce the primary search costs ~20 operations per sphere entry and ~35
// per triangle entry (the demo room: 4 sphere slots + 24 triangle slots),
// the NEE shadow search the same again, and the shading, BRDF and NEE
// arithmetic ~250 operations plus ~12 SFU ops (sqrt, 1/x, sin, cos, pow).
// Built with -fmad=false, each is one FP32 instruction: 33.5 T/s on the
// card, not the 67 TFLOP/s that counts an FMA as two. The 24 + 32 bytes a
// ray reads and 20 it writes are noise at 3.35 TB/s.
// Design:
// - Persistent warps with path regeneration. The grid is as many blocks
//   as the SMs hold at once; a lane takes a ray from a global counter (one
//   warp-aggregated atomicAdd for the lanes that need one), traces it one
//   bounce per loop iteration with its own bounce index j and static draw
//   count k, writes the ray's outputs at the ray's index when its path
//   ends, and takes the next ray. Russian roulette kills most rays from
//   bounce 2 on; one thread per ray left those lanes idle until the
//   warp's last ray died. A ray's outputs are a pure function of its
//   inputs, its uid, the seed and its draw numbers, so the order of
//   service changes no bit. A ray of a gated 1,024-ray block is never
//   traced; its outputs are 0.
// - Compact test records: the entry stream is staged in shared memory as
//   one 16-float record per entry (four float4s: a triangle's normal and
//   d0, r1 and c1, r2 and c2, kind and the degenerate threshold; a
//   sphere's centre and radius, kind), read with 128-bit broadcast loads.
//   The search keeps only t and the winner's index (strict t < best: the
//   first entry in stream order wins a tie); the winner's attributes are
//   read once from the packed stream afterwards, its u, v and normal
//   recomputed by the same expressions, so they carry the same bits as a
//   running copy would. The shadow search needs only t.
// - When the stream fits one chunk (kChunk entries) it is staged once and
//   each warp leaves on its own; otherwise chunks are staged behind block
//   barriers, which every thread reaches the same number of times, and
//   the block leaves when the counter is spent and no lane holds a ray.
// - Two forms of the ray inputs (a template flag). A kernel-path frame's
//   rays share one origin, the camera's, and their uids follow from their
//   places in X7's stream; its launches (pt_trace_frame_launch) take the
//   origin and the light's 8 parameters as launch arguments and form each
//   uid, so a frame's set-up copies nothing to the card and fills no
//   origin block (49.8 MB at 960x540 spp 8). The per-ray form
//   (pt_trace_launch: the light in device memory, an origin and a uid a
//   ray) serves trace_eye_paths_kernel_packed and the reference's tests.
//
// Exactness: built with -fmad=false, so every product and sum rounds on its
// own as in the plain version; division and sqrt are IEEE; max/clamp
// propagate NaN as torch.clamp and jnp.maximum do; x**5 is the
// multiply chain x * ((x*x) * (x*x)) of JAX's integer_pow; x**1.2 is powf;
// rsqrt is 1 / sqrtf. The RNG is integer arithmetic on uint32.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockRays = 1024;  // the TPU block: block_active granularity
constexpr int kChan = 32;
constexpr int kChunk = 64;        // entries per staged chunk (4 KB)
constexpr unsigned kFull = 0xffffffffu;

constexpr float kBig = 3e38f;
constexpr float kTwoPi = 6.2831853f;
constexpr float kInv255 = (float)(1.0 / 255.0);

// entry channels (ops/pt_kernel.py)
constexpr int C_KIND = 0, C_AX = 1, C_AY = 2, C_AZ = 3, C_E1X = 4;
constexpr int C_NX = 1, C_NY = 2, C_NZ = 3, C_D0 = 4;
constexpr int C_R1X = 5, C_R1Y = 6, C_R1Z = 7, C_C1 = 8;
constexpr int C_R2X = 9, C_R2Y = 22, C_R2Z = 23, C_C2 = 24, C_BADS = 25;
constexpr int C_SHR = 10, C_SHG = 11, C_SHB = 12;
constexpr int C_ISLIGHT = 13, C_ISSPEC = 14, C_TEXTURABLE = 15;
constexpr int C_UVAX = 16, C_UVAY = 17, C_UVBX = 18, C_UVBY = 19;
constexpr int C_UVCX = 20, C_UVCY = 21;

// NaN-propagating max / clamp (torch.clamp, jnp.maximum, jnp.clip)
__device__ __forceinline__ float maxn(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float clampn(float x, float lo, float hi) {
  if (x != x) return x;
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float rsqrt_ieee(float x) {
  return 1.0f / sqrtf(x);
}

// Draw k of a ray: lowbias32(uid ^ (seed * 0x9E3779B1 + k * 0x85EBCA6B)),
// top 23 bits as a float in [1, 2), minus 1.
__device__ __forceinline__ float draw(uint32_t uid, uint32_t seed_mix,
                                      uint32_t k) {
  uint32_t x = uid ^ (seed_mix + k * 0x85EBCA6Bu);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return __uint_as_float((x >> 9) | 0x3F800000u) - 1.0f;
}

// Stages entries [base, base + cnt) as test records: (n | centre, d0 |
// radius), (r1, c1), (r2, c2), (kind, bads, 0, 0).
__device__ __forceinline__ void stage(float4* rec,
                                      const float* __restrict__ prim,
                                      int base, int cnt) {
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const float* e = prim + (size_t)(base + i) * kChan;
    rec[4 * i] = make_float4(e[C_NX], e[C_NY], e[C_NZ], e[C_D0]);
    rec[4 * i + 1] = make_float4(e[C_R1X], e[C_R1Y], e[C_R1Z], e[C_C1]);
    rec[4 * i + 2] = make_float4(e[C_R2X], e[C_R2Y], e[C_R2Z], e[C_C2]);
    rec[4 * i + 3] = make_float4(e[C_KIND], e[C_BADS], 0.0f, 0.0f);
  }
}

// Nearest entry hit over the whole stream: t (kBig on a miss) and the
// winner's entry index in *win (-1 on a miss). `active` threads search; in
// the chunked mode every thread of the block must call this the same
// number of times (the chunk loads are behind block barriers).
__device__ __forceinline__ float search(float4* rec,
                                        const float* __restrict__ prim,
                                        int n_entries, int n_sph,
                                        bool resident, bool active, float ox,
                                        float oy, float oz, float dx,
                                        float dy, float dz, float eps,
                                        int* win) {
  float best = kBig;
  int bi = -1;
  for (int base = 0; base < n_entries; base += kChunk) {
    const int cnt = min(kChunk, n_entries - base);
    if (!resident) {
      __syncthreads();
      stage(rec, prim, base, cnt);
      __syncthreads();
    }
    if (!active) continue;
    const int ns = min(max(n_sph - base, 0), cnt);
    for (int e = 0; e < ns; ++e) {
      const float4 q0 = rec[4 * e], q3 = rec[4 * e + 3];
      const float ocx = ox - q0.x, ocy = oy - q0.y, ocz = oz - q0.z;
      const float b = ocx * dx + ocy * dy + ocz * dz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - q0.w * q0.w;
      const float hh = b * b - c;
      const float sq = sqrtf(maxn(hh, 0.0f));
      const float t1 = -b - sq;
      const float t2 = -b + sq;
      float t = t1 > eps ? t1 : (t2 > eps ? t2 : kBig);
      if (!(hh >= 0.0f && q3.x > 0.0f)) t = kBig;
      if (t < best) {
        best = t;
        bi = base + e;
      }
    }
    for (int e = ns; e < cnt; ++e) {
      const float4 q0 = rec[4 * e], q1 = rec[4 * e + 1];
      const float4 q2 = rec[4 * e + 2], q3 = rec[4 * e + 3];
      const float ndotd = q0.x * dx + q0.y * dy + q0.z * dz;
      const bool bad = fabsf(ndotd) < q3.y;
      const float inv = 1.0f / (bad ? 1.0f : ndotd);
      const float ndoto = q0.x * ox + q0.y * oy + q0.z * oz;
      float t = (q0.w - ndoto) * inv;
      const float hpx = ox + t * dx, hpy = oy + t * dy, hpz = oz + t * dz;
      const float u = q1.x * hpx + q1.y * hpy + q1.z * hpz + q1.w;
      const float v = q2.x * hpx + q2.y * hpy + q2.z * hpz + q2.w;
      const bool miss = bad || u < 0.0f || u > 1.0f || v < 0.0f ||
                        u + v > 1.0f || t <= eps || !(q3.x > 0.0f);
      if (miss) t = kBig;
      if (t < best) {
        best = t;
        bi = base + e;
      }
    }
  }
  *win = bi;
  return best;
}

struct Hit {
  float nx, ny, nz, shr, shg, shb, is_light, is_spec, texturable, uvx, uvy;
};

// The winner's attributes, read once from the packed stream: a sphere's
// normal from the hit point, a triangle's (flipped to face the ray) normal
// and uv from u, v recomputed by the search's expressions at its t.
__device__ __forceinline__ Hit attrs(const float* __restrict__ prim,
                                     int win, int n_sph, float t, float ox,
                                     float oy, float oz, float dx, float dy,
                                     float dz) {
  Hit h;
  h.nx = h.ny = h.nz = h.shr = h.shg = h.shb = 0.0f;
  h.is_light = h.is_spec = h.texturable = h.uvx = h.uvy = 0.0f;
  if (win < 0) return h;
  const float* e = prim + (size_t)win * kChan;
  if (win < n_sph) {
    const float ax = e[C_AX], ay = e[C_AY], az = e[C_AZ];
    const float inv_r = 1.0f / maxn(e[C_E1X], 1e-6f);
    h.nx = (ox + t * dx - ax) * inv_r;
    h.ny = (oy + t * dy - ay) * inv_r;
    h.nz = (oz + t * dz - az) * inv_r;
  } else {
    const float nx_ = e[C_NX], ny_ = e[C_NY], nz_ = e[C_NZ];
    const float ndotd = nx_ * dx + ny_ * dy + nz_ * dz;
    const float hpx = ox + t * dx, hpy = oy + t * dy, hpz = oz + t * dz;
    const float u = e[C_R1X] * hpx + e[C_R1Y] * hpy + e[C_R1Z] * hpz + e[C_C1];
    const float v = e[C_R2X] * hpx + e[C_R2Y] * hpy + e[C_R2Z] * hpz + e[C_C2];
    const bool flip = ndotd > 0.0f;
    h.nx = flip ? -nx_ : nx_;
    h.ny = flip ? -ny_ : ny_;
    h.nz = flip ? -nz_ : nz_;
    const float w0 = 1.0f - u - v;
    h.uvx = w0 * e[C_UVAX] + u * e[C_UVBX] + v * e[C_UVCX];
    h.uvy = w0 * e[C_UVAY] + u * e[C_UVBY] + v * e[C_UVCY];
    h.texturable = e[C_TEXTURABLE];
  }
  h.shr = e[C_SHR];
  h.shg = e[C_SHG];
  h.shb = e[C_SHB];
  h.is_light = e[C_ISLIGHT];
  h.is_spec = e[C_ISSPEC];
  return h;
}

// A frame's rays (the frame form, kFrame): one origin for every ray, and
// each ray's uid from its place in the stream, as X7 places the rays: ray
// r = s * pc + p is sample s of stream slot p, uid s * npix + pix_uid[p]
// (the compacted order), or s * npix + uid0 + p (a full frame or a row
// band: uid0 = row_lo * cols); npix = rows * cols.
struct FrameRays {
  float ox, oy, oz;
  int pc, npix, uid0;
  const int* pix_uid;
};

// The light's 8 parameters: centre xyz, radius, colour rgb, eps.
struct Light {
  float p[8];
};

// kFrame: the frame form, the light and the origin launch arguments
// (Light, FrameRays), each ray's uid formed here; else the per-ray form,
// the light read from params, an origin a ray from ro, a uid a ray from
// uid_in (or the stream position).
template <bool kFrame>
__global__ void __launch_bounds__(kThreads)
pt_trace_kernel(const float* __restrict__ params, const Light light,
                const FrameRays fr, const float* __restrict__ prim,
                int n_entries, int n_sph, const float* __restrict__ ro,
                const float* __restrict__ rd, const int* __restrict__ uid_in,
                const int* __restrict__ block_active, int seed,
                const uint32_t* __restrict__ atlas, int atlas_w, int atlas_h,
                float* __restrict__ lor, float* __restrict__ log_,
                float* __restrict__ lob, float* __restrict__ ov,
                float* __restrict__ fet, int n_rays, int bounces, int nee,
                int* __restrict__ next_ray) {
  __shared__ float4 rec[kChunk * 4];
  const bool resident = n_entries <= kChunk;
  if (resident) {
    stage(rec, prim, 0, n_entries);
    __syncthreads();
  }

  // the light, each parameter by a constant index (no local copy)
  const float lcx = kFrame ? light.p[0] : params[0];
  const float lcy = kFrame ? light.p[1] : params[1];
  const float lcz = kFrame ? light.p[2] : params[2];
  const float lrad = kFrame ? light.p[3] : params[3];
  const float lcr = kFrame ? light.p[4] : params[4];
  const float lcg = kFrame ? light.p[5] : params[5];
  const float lcb = kFrame ? light.p[6] : params[6];
  const float eps = kFrame ? light.p[7] : params[7];
  const int texels = atlas_w > 0 ? atlas_w * atlas_h : 0;
  const uint32_t seed_mix = (uint32_t)seed * 0x9E3779B1u;
  const int lane = threadIdx.x & 31;

  // the lane's ray and its path state
  bool busy = false;
  int ray = 0;
  uint32_t uid = 0;
  float rox = 0.0f, roy = 0.0f, roz = 0.0f;
  float rdx = 0.0f, rdy = 0.0f, rdz = 0.0f;
  float Lr = 0.0f, Lg = 0.0f, Lb = 0.0f;
  float Tr = 1.0f, Tg = 1.0f, Tb = 1.0f;
  bool spec = true;
  float override_ = 0.0f;
  bool fetched = false;
  int j = 0;       // the ray's bounce
  uint32_t k = 0;  // draws before this bounce (a static count)
  bool spent = false;  // warp-uniform: the counter has no ray left

  for (;;) {
    // lanes without a ray take the next ones, one atomic per warp
    unsigned need = __ballot_sync(kFull, !busy);
    while (need != 0u && !spent) {
      const int cnt = __popc(need);
      int first = 0;
      if (lane == 0) first = atomicAdd(next_ray, cnt);
      first = __shfl_sync(kFull, first, 0);
      spent = first + cnt >= n_rays;
      if (!busy) {
        const int r = first + __popc(need & ((1u << lane) - 1u));
        if (r < n_rays) {
          if (block_active != nullptr && block_active[r / kBlockRays] == 0) {
            lor[r] = log_[r] = lob[r] = ov[r] = fet[r] = 0.0f;
          } else {
            busy = true;
            ray = r;
            if (kFrame) {
              const int s = r / fr.pc, p = r - s * fr.pc;
              uid = (uint32_t)s * (uint32_t)fr.npix +
                    (uint32_t)(fr.pix_uid != nullptr ? fr.pix_uid[p]
                                                     : fr.uid0 + p);
              rox = fr.ox;
              roy = fr.oy;
              roz = fr.oz;
            } else {
              uid = (uint32_t)(uid_in != nullptr ? uid_in[r] : r);
              rox = ro[3 * r];
              roy = ro[3 * r + 1];
              roz = ro[3 * r + 2];
            }
            rdx = rd[3 * r];
            rdy = rd[3 * r + 1];
            rdz = rd[3 * r + 2];
            Lr = Lg = Lb = 0.0f;
            Tr = Tg = Tb = 1.0f;
            spec = true;
            override_ = 0.0f;
            fetched = false;
            j = 0;
            k = 0;
          }
        }
      }
      need = __ballot_sync(kFull, !busy);
    }
    if (resident) {
      if (!__any_sync(kFull, busy)) break;
    } else if (!__syncthreads_or(busy)) {
      break;
    }

    // ---- one bounce of the lane's path (a lane without a ray computes
    // nothing that it keeps) ----
    bool alive = busy;
    const bool has_nee = nee && j < bounces - 1;
    int win;
    float t = search(rec, prim, n_entries, n_sph, resident, alive, rox, roy,
                     roz, rdx, rdy, rdz, eps, &win);
    Hit h = attrs(prim, win, n_sph, t, rox, roy, roz, rdx, rdy, rdz);
    float nx = h.nx, ny = h.ny, nz = h.nz;
    float shr = h.shr, shg = h.shg, shb = h.shb;
    const bool is_spec = h.is_spec > 0.5f;
    // light sphere (analytic, not in the entry list)
    {
      const float ocx = rox - lcx, ocy = roy - lcy, ocz = roz - lcz;
      const float b = ocx * rdx + ocy * rdy + ocz * rdz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - lrad * lrad;
      const float hh = b * b - c;
      const float sq = sqrtf(maxn(hh, 0.0f));
      const float t1 = -b - sq;
      const float t2 = -b + sq;
      float t_l = t1 > eps ? t1 : (t2 > eps ? t2 : kBig);
      if (!(hh >= 0.0f)) t_l = kBig;
      const bool lwin = t_l < t;
      if (lwin) t = t_l;
      h.is_light = (h.is_light > 0.5f || lwin) ? 1.0f : 0.0f;
    }
    const bool is_light = h.is_light > 0.5f;

    const bool hit = t < 1e30f;
    if (alive && !hit) {  // env on miss (shader_utils.js:20-25)
      const float tt = powf(clampn(rdy * 0.5f + 0.5f, 0.0f, 1.0f), 1.2f);
      float s = clampn((rdy + 0.05f) / 0.1f, 0.0f, 1.0f);
      s = s * s * (3.0f - 2.0f * s);
      const float er =
          0.063f * (1.0f - s) + (0.90f * (1.0f - tt) + 0.45f * tt) * s;
      const float eg =
          0.0525f * (1.0f - s) + (0.95f * (1.0f - tt) + 0.65f * tt) * s;
      const float eb =
          0.042f * (1.0f - s) + (1.00f * (1.0f - tt) + 0.95f * tt) * s;
      Lr = Lr + Tr * er;
      Lg = Lg + Tg * eg;
      Lb = Lb + Tb * eb;
    }
    alive = alive && hit;
    if (alive && is_light && spec) {
      Lr = Lr + Tr * lcr;
      Lg = Lg + Tg * lcg;
      Lb = Lb + Tb * lcb;
    }
    alive = alive && !is_light;

    const float hx = rox + t * rdx, hy = roy + t * rdy, hz = roz + t * rdz;

    if (texels > 0) {
      const float tx = floorf(h.uvx + 0.5f), ty = floorf(h.uvy + 0.5f);
      const bool inb = tx >= 0.0f && tx < (float)atlas_w && ty >= 0.0f &&
                       ty < (float)atlas_h;
      const int lin = inb ? (int)(ty * (float)atlas_w + tx) : 0;
      const uint32_t x = atlas[lin];
      const float txr = (float)((x >> 24) & 255u) * kInv255;
      const float txg = (float)((x >> 16) & 255u) * kInv255;
      const float txb = (float)((x >> 8) & 255u) * kInv255;
      const float ab = (float)(x & 255u);
      const bool sampled = alive && h.texturable > 0.5f && inb && ab >= 0.5f;
      const bool glyph = sampled && ab >= 31.5f && ab <= 126.5f;
      bool solid;
      if (j == 0) {  // the primary glyph short-circuit
        fetched = sampled;
        if (glyph) {
          Lr = txr;
          Lg = txg;
          Lb = txb;
          override_ = ab;
        }
        alive = alive && !glyph;
        solid = sampled && ab < 1.5f;
      } else {
        solid = sampled;  // solid OR glyph-truncated-to-solid
      }
      if (solid) {
        shr = txr;
        shg = txg;
        shb = txb;
      }
    }

    // ---- next direction (BRDF) ----
    const float u1 = draw(uid, seed_mix, k + 1);
    const float u2 = draw(uid, seed_mix, k + 2);
    const float phi = kTwoPi * u1;
    const float s2 = sqrtf(1.0f - u2);
    const bool ny_ok = fabsf(ny) < 0.999f;
    const float axx = ny_ok ? 0.0f : 1.0f;
    const float axy = ny_ok ? 1.0f : 0.0f;
    float ux_ = ny * 0.0f - nz * axy;
    float uy_ = nz * axx - nx * 0.0f;
    float uz_ = nx * axy - ny * axx;
    const float uinv = rsqrt_ieee(maxn(ux_ * ux_ + uy_ * uy_ + uz_ * uz_,
                                       1e-24f));
    ux_ = ux_ * uinv;
    uy_ = uy_ * uinv;
    uz_ = uz_ * uinv;
    const float vx_ = uy_ * nz - uz_ * ny;
    const float vy_ = uz_ * nx - ux_ * nz;
    const float vz_ = ux_ * ny - uy_ * nx;
    const float cp_ = s2 * cosf(phi);
    const float sp_ = s2 * sinf(phi);
    const float sr2 = sqrtf(u2);
    float ddx = cp_ * ux_ + sp_ * vx_ + sr2 * nx;
    float ddy = cp_ * uy_ + sp_ * vy_ + sr2 * ny;
    float ddz = cp_ * uz_ + sp_ * vz_ + sr2 * nz;
    const float dinv = rsqrt_ieee(maxn(ddx * ddx + ddy * ddy + ddz * ddz,
                                       1e-24f));
    ddx = ddx * dinv;
    ddy = ddy * dinv;
    ddz = ddz * dinv;

    // specular branch (shader_utils.js:216-229)
    const float ndotr = rdx * nx + rdy * ny + rdz * nz;
    const bool flip = ndotr > 0.0f;
    const float eta = flip ? 1.5f : (float)(1.0 / 1.5);
    const float nnx = flip ? -nx : nx;
    const float nny = flip ? -ny : ny;
    const float nnz = flip ? -nz : nz;
    const float om = 1.0f - fabsf(ndotr);
    const float om2 = om * om;
    const float fres = 0.04f + 0.96f * (om * (om2 * om2));
    const float cosi = nnx * rdx + nny * rdy + nnz * rdz;
    const float kk = 1.0f - eta * eta * (1.0f - cosi * cosi);
    const bool tir = kk < 0.0f;
    const float f = eta * cosi + sqrtf(maxn(kk, 0.0f));
    const float rfx = eta * rdx - f * nnx;
    const float rfy = eta * rdy - f * nny;
    const float rfz = eta * rdz - f * nnz;
    const float u3 = draw(uid, seed_mix, k + 3);
    const bool use_reflect = tir || u3 < fres;
    const float d2 = rdx * nnx + rdy * nny + rdz * nnz;
    float sx_ = use_reflect ? rdx - 2.0f * d2 * nnx : rfx;
    float sy_ = use_reflect ? rdy - 2.0f * d2 * nny : rfy;
    float sz_ = use_reflect ? rdz - 2.0f * d2 * nnz : rfz;
    const float sinv = rsqrt_ieee(maxn(sx_ * sx_ + sy_ * sy_ + sz_ * sz_,
                                       1e-24f));
    sx_ = sx_ * sinv;
    sy_ = sy_ * sinv;
    sz_ = sz_ * sinv;

    const float ndx = is_spec ? sx_ : ddx;
    const float ndy = is_spec ? sy_ : ddy;
    const float ndz = is_spec ? sz_ : ddz;

    const float ndn = ndx * nx + ndy * ny + ndz * nz;
    if (alive && (!is_spec || ndn < 0.0f)) {
      Tr = Tr * shr;
      Tg = Tg * shg;
      Tb = Tb * shb;
    }

    // ---- NEE (pathtrace_shader.js:159-169) ----
    // chunked: every thread searches whenever NEE is on (the barriers);
    // resident: only the lanes that want the shadow ray
    const bool want = has_nee && alive && !is_spec;
    if (resident ? want : nee != 0) {
      const float h1 = draw(uid, seed_mix, k + 4) * 2.0f - 1.0f;
      const float h2 = draw(uid, seed_mix, k + 5) * kTwoPi;
      const float sl = sqrtf(maxn(1.0f - h1 * h1, 0.0f));
      const float lpx = lcx + lrad * sl * sinf(h2);
      const float lpy = lcy + lrad * sl * cosf(h2);
      const float lpz = lcz + lrad * h1;
      float ldx = lpx - hx, ldy = lpy - hy, ldz = lpz - hz;
      const float dist =
          sqrtf(maxn(ldx * ldx + ldy * ldy + ldz * ldz, 1e-24f));
      ldx = ldx / dist;
      ldy = ldy / dist;
      ldz = ldz / dist;
      int sh_win;
      const float sh_t = search(rec, prim, n_entries, n_sph, resident, want,
                                hx + nx * eps, hy + ny * eps, hz + nz * eps,
                                ldx, ldy, ldz, eps, &sh_win);
      const bool shadowed = sh_t < dist;
      const float dlx = lcx - hx, dly = lcy - hy, dlz = lcz - hz;
      const float dd2 = maxn(dlx * dlx + dly * dly + dlz * dlz, 1e-12f);
      const float cam = sqrtf(1.0f - clampn(lrad * lrad / dd2, 0.0f, 1.0f));
      const float wgt = 2.0f * (1.0f - cam);
      const float ndl = maxn(ldx * nx + ldy * ny + ldz * nz, 0.0f);
      if (want && !shadowed) {
        const float wnd = wgt * ndl;
        Lr = Lr + Tr * lcr * wnd;
        Lg = Lg + Tg * lcg * wnd;
        Lb = Lb + Tb * lcb * wnd;
      }
    }

    if (alive) {
      const float side = ndn > 0.0f ? eps : -eps;
      rox = hx + nx * side;
      roy = hy + ny * side;
      roz = hz + nz * side;
      rdx = ndx;
      rdy = ndy;
      rdz = ndz;
      spec = is_spec;
    }

    if (j >= 2) {  // Russian roulette
      const float pmax = clampn(maxn(Tr, maxn(Tg, Tb)), 0.05f, 0.95f);
      const float u4 = draw(uid, seed_mix, k + (has_nee ? 6 : 4));
      alive = alive && !(u4 > pmax);
      if (alive) {
        const float ipm = 1.0f / pmax;
        Tr = Tr * ipm;
        Tg = Tg * ipm;
        Tb = Tb * ipm;
      }
    }
    k += 3 + (has_nee ? 2 : 0) + (j >= 2 ? 1 : 0);
    ++j;

    // the path ends: write the ray's outputs, take another next round
    if (busy && (!alive || j == bounces)) {
      lor[ray] = Lr;
      log_[ray] = Lg;
      lob[ray] = Lb;
      ov[ray] = override_;
      fet[ray] = fetched ? 1.0f : 0.0f;
      busy = false;
    }
  }
}

// Blocks of the persistent grid: as many as the SMs hold at once, no more
// than the rays need.
template <bool kFrame>
int grid_blocks(int n_rays) {
  static int resident_blocks = 0;
  if (resident_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pt_trace_kernel<kFrame>, kThreads, 0);
    resident_blocks = max(sms * per_sm, 1);
  }
  return min(resident_blocks, (n_rays + kThreads - 1) / kThreads);
}

}  // namespace

// The per-ray form: params (8 device floats), ro (device floats [n_rays,
// 3]), uid (device ints [n_rays]) or null for the stream position
extern "C" int pt_trace_launch(const float* params, const float* prim,
                               int n_entries, int n_sph, const float* ro,
                               const float* rd, const int* uid,
                               const int* block_active, int seed,
                               const int* atlas, int atlas_w, int atlas_h,
                               float* lor, float* log_, float* lob, float* ov,
                               float* fet, int n_rays, int bounces, int nee,
                               int* next_ray, void* stream) {
  if (n_rays <= 0) return 0;
  pt_trace_kernel<false>
      <<<grid_blocks<false>(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          params, Light{}, FrameRays{}, prim, n_entries, n_sph, ro, rd, uid,
          block_active, seed, reinterpret_cast<const uint32_t*>(atlas),
          atlas_w, atlas_h, lor, log_, lob, ov, fet, n_rays, bounces, nee,
          next_ray);
  return (int)cudaGetLastError();
}

// The frame form: light8 (centre xyz, radius, colour rgb, eps) and
// origin3 host floats, passed by value; ray r = s * pc + p takes the uid
// s * npix + (pix_uid ? pix_uid[p] : uid0 + p), pix_uid device ints [pc]
extern "C" int pt_trace_frame_launch(const float* light8,
                                     const float* origin3, const float* prim,
                                     int n_entries, int n_sph, const float* rd,
                                     const int* pix_uid, int pc, int npix,
                                     int uid0, const int* block_active,
                                     int seed, const int* atlas, int atlas_w,
                                     int atlas_h, float* lor, float* log_,
                                     float* lob, float* ov, float* fet,
                                     int n_rays, int bounces, int nee,
                                     int* next_ray, void* stream) {
  if (pc <= 0 || npix <= 0) return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  Light light;
  for (int k = 0; k < 8; ++k) light.p[k] = light8[k];
  const FrameRays fr{origin3[0], origin3[1], origin3[2], pc, npix, uid0,
                     pix_uid};
  pt_trace_kernel<true>
      <<<grid_blocks<true>(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
          nullptr, light, fr, prim, n_entries, n_sph, nullptr, rd, nullptr,
          block_active, seed, reinterpret_cast<const uint32_t*>(atlas),
          atlas_w, atlas_h, lor, log_, lob, ov, fet, n_rays, bounces, nee,
          next_ray);
  return (int)cudaGetLastError();
}
