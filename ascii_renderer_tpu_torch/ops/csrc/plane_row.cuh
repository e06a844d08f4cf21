// The arithmetic of a shading-plane table row (X3, ops/plane_table),
// shared by its standalone kernel (plane_table.cu) and by X4's table form
// (raster_clip.cu), in two parts: ``plane_row`` the row's own values (the
// edge coefficients times iw, the guarded reciprocal of area2, the
// denominator plane), once a row, and ``plane_attr`` the three
// coefficients of one attribute's plane from them and the source's vertex
// values (the table form spreads a row's attributes over threads), from
// ``attr_slots``, the attribute's rotated and lerped vertex values, which
// X4's slots form writes as they are. A table row of A
// attributes holds W = 3 (A + 1) padded to 8 columns: column 3 j + k is
// coefficient k (alpha, beta, gamma) of attribute j's plane, 3 A + k the
// perspective denominator's, the rest zeros.
// ops/plane_table.plane_table_ref is the plain version; each of its fused
// chains is an fmaf here, in its order (core/fp.py gives the rules):
//   lerp               fma(t, c1 - c0, c0)
//   gamma_m            fma(y2 - y1, x1, -((x2 - x1) * y1))  (the left fuses)
//   attribute plane    fma(p2, q2, fma(p0, q0, p1 * q1)) * inv_area
//   denominator plane  fma(alpha2, iw2, fma(alpha1, iw1, alpha0 * iw0)),
//                      for beta / gamma fma(c2, iw2, fma(c0, iw0, c1 * iw1)),
//                      each * inv_area
// The reciprocal is IEEE (__frcp_rn), as torch's reciprocal is.
#pragma once

#include <cuda_runtime.h>

template <int A>
struct PlaneWidth {
  static constexpr int kW = (3 * (A + 1) + 7) / 8 * 8;
};

// a table row's screen values: sx a b c, sy a b c, iw a b c, area2
// (ops/plane_table.SCREEN_KEYS' order)
struct PlaneScreen {
  float v[10];
};

// the clip records of a row's source slot, and which clip output it is
struct PlaneRecord {
  int rot, n_in;
  float ta, tc, tb;
  bool second;
};

// a row's own values: p[3 k + m] coefficient k of edge m times iw_m, the
// guarded 1 / area2, the denominator plane's three coefficients
constexpr int kPlaneRowVals = 13;
struct PlaneRow {
  float p[9];
  float inv;
  float den[3];
};

__device__ __forceinline__ PlaneRow plane_row(const PlaneScreen& s) {
  const float* sx = s.v;
  const float* sy = s.v + 3;
  const float* iw = s.v + 6;
  float alpha[3], beta[3], gamma[3];
  for (int m = 0; m < 3; ++m) {
    const float x1 = sx[(m + 1) % 3], y1 = sy[(m + 1) % 3];
    const float x2 = sx[(m + 2) % 3], y2 = sy[(m + 2) % 3];
    alpha[m] = -(y2 - y1);
    beta[m] = x2 - x1;
    gamma[m] = fmaf(y2 - y1, x1, -((x2 - x1) * y1));
  }
  const float area2 = s.v[9];
  PlaneRow w;
  w.inv = __frcp_rn(fabsf(area2) < 1e-12f ? 1e-12f : area2);
  for (int m = 0; m < 3; ++m) {
    w.p[m] = alpha[m] * iw[m];
    w.p[3 + m] = beta[m] * iw[m];
    w.p[6 + m] = gamma[m] * iw[m];
  }
  // the denominator: for alpha the second product fuses first
  w.den[0] = fmaf(alpha[2], iw[2], fmaf(alpha[1], iw[1], w.p[0])) * w.inv;
  w.den[1] = fmaf(beta[2], iw[2], fmaf(beta[0], iw[0], w.p[4])) * w.inv;
  w.den[2] = fmaf(gamma[2], iw[2], fmaf(gamma[0], iw[0], w.p[7])) * w.inv;
  return w;
}

// The values of one attribute at a clip output's three vertex slots: a0,
// a1, a2 the source's original vertices' values of it; v the rotated and
// lerped values (ops/plane_table._attr_slots' order: the rotation, the
// three lerps, the n_in selects, then the second output's bc / ac).
__device__ __forceinline__ void attr_slots(float a0, float a1, float a2,
                                           const PlaneRecord& r,
                                           float (&v)[3]) {
  // rotated vertex m takes original vertex (rot + m) % 3 (any rot but 0
  // and 1 selecting as 2 does, as the plain version's selects do)
  const float r0 = r.rot == 0 ? a0 : (r.rot == 1 ? a1 : a2);
  const float r1 = r.rot == 0 ? a1 : (r.rot == 1 ? a2 : a0);
  const float r2 = r.rot == 0 ? a2 : (r.rot == 1 ? a0 : a1);
  const bool one_in = r.n_in == 1, two_in = r.n_in == 2;
  const float ab = fmaf(r.ta, r1 - r0, r0);
  const float ac = fmaf(r.tc, r2 - r0, r0);
  const float bc = fmaf(r.tb, r2 - r1, r1);
  const float t1b = one_in ? ab : r1;
  const float t1c = one_in ? ac : (two_in ? bc : r2);
  v[0] = r0;
  v[1] = r.second ? bc : t1b;  // the second output is (a, bc, ac)
  v[2] = r.second ? ac : t1c;
}

// The plane of one attribute: a0, a1, a2 the source's original vertices'
// values of it; out the coefficients alpha, beta, gamma.
__device__ __forceinline__ void plane_attr(const float (&p)[9], float inv,
                                           float a0, float a1, float a2,
                                           const PlaneRecord& r,
                                           float (&out)[3]) {
  float v[3];
  attr_slots(a0, a1, a2, r, v);
  for (int k = 0; k < 3; ++k)
    out[k] =
        fmaf(p[3 * k + 2], v[2], fmaf(p[3 * k], v[0], p[3 * k + 1] * v[1])) *
        inv;
}
