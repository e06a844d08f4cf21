"""The ray tracer's intersection helpers, rounded as the reference's jitted
program rounds them (counterparts of ``backends/pt_core``'s helpers and of
the plane test ``_planes_t`` of ``ascii_renderer_tpu/backends/raytrace.py``).

The reference renders the ray tracer under ``jax.jit``. There XLA's CPU
code generator fuses a product into the add or subtract it feeds (the
rules of ``core/fp.py``), but only where the two are computed in the same
loop: a product whose operands do not vary along the innermost loop of the
add is hoisted out of it, rounded on its own, and not fused. The loops run
over the array dimensions in order, the last one innermost. So a product
fuses into its add iff it varies along a dimension at least as far in as
the addend does (``_mul_add``). ``pt_core``'s helpers round as the eager
path tracer does; its goldens depend on that, so they stay as they are.

Shapes: a ray channel is [V, 1, R] against the primitives (views, rays), a
primitive channel [P, 1], a per-view value [V, 1, 1], a constant 0-d or of
ones. A primary ray's origin is the camera's, constant along the rays, so
its per-primitive terms are formed and fused apart from the rays'.

The triangle normal's ``1 / sqrt`` is correctly rounded here; the
reference's CPU ``rsqrt`` is an estimate refined by one Newton step, within
an ulp of it.
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.backends.pt_core import BIG, V3
from ascii_renderer_tpu_torch.core.fp import fma32, rsqrt32, sqrt32
from ascii_renderer_tpu_torch.ops.fp import broadcast_shape

_CONST = 1 << 30  # depth of a value that varies along no dimension


def _depth(x) -> int:
    """How many dimensions in from the last the innermost loop along which
    ``x`` varies sits (0: the last dimension)."""
    if not isinstance(x, torch.Tensor):
        return _CONST
    for d, s in enumerate(reversed(x.shape)):
        if s != 1:
            return d
    return _CONST


def _pdepth(a, b) -> int:
    return min(_depth(a), _depth(b))


def _mul_add(a, b, c):
    """a*b + c: fused iff the product is formed in the add's loop."""
    if _pdepth(a, b) <= _depth(c):
        return fma32(a, b, c)
    return a * b + c


def _sub_mul(x, a, b):
    """x - a*b: fused, as fma(-a, b, x), iff the product is formed in the
    subtract's loop."""
    if _pdepth(a, b) <= _depth(x):
        return fma32(-a, b, x)
    return x - a * b


def _mul_sub(a, b, x):
    """a*b - x: fused, as fma(a, b, -x), iff the product is formed in the
    subtract's loop."""
    if _pdepth(a, b) <= _depth(x):
        return fma32(a, b, -x)
    return a * b - x


def _diff(a, b, c, d):
    """a*b - c*d: the left product fuses, fma(a, b, -(c*d)), unless only
    the right one is formed in the subtract's loop, fma(-c, d, a*b)."""
    if _pdepth(a, b) <= _pdepth(c, d):
        return fma32(a, b, -(c * d))
    return fma32(-c, d, a * b)


def dot(a: V3, b: V3):
    """pt_core's dot, (ax*bx + ay*by) + az*bz: the left product of the
    first add fuses (a*b + c*d -> fma(a, b, c*d)), then the third product
    into that sum ((a*b + c*d) + e*f -> fma(e, f, fma(a, b, c*d))), each
    where it is formed in its add's loop."""
    if _pdepth(a.x, b.x) <= _pdepth(a.y, b.y):
        s = fma32(a.x, b.x, a.y * b.y)
    else:
        s = fma32(a.y, b.y, a.x * b.x)
    return _mul_add(a.z, b.z, s)


def rdot(a: V3, b: V3):
    """``jnp.sum(a * b, axis=-1)`` over the three components: a reduction
    from 0 whose adds each fuse the next product
    (fma(z, z', fma(y, y', x*x' + 0)))."""
    return _mul_add(a.z, b.z, _mul_add(a.y, b.y, a.x * b.x + 0.0))


def norm(a: V3):
    """``jnp.linalg.norm`` over the three components (the root correctly
    rounded)."""
    return sqrt32(rdot(a, a))


def cross(a: V3, b: V3) -> V3:
    """Each component a1*b2 - a2*b1 -> fma(a1, b2, -(a2*b1))."""
    return V3(_diff(a.y, b.z, a.z, b.y), _diff(a.z, b.x, a.x, b.z),
              _diff(a.x, b.y, a.y, b.x))


def spheres_t(ro: V3, rd: V3, center: V3, radius, valid, eps):
    """pt_core.spheres_t as the jitted reference rounds it: -> t [..., S, R]
    (the near root if > eps, else the far one)."""
    oc = ro - center
    b = dot(oc, rd)
    c = _sub_mul(dot(oc, oc), radius, radius)   # dot - r*r
    h = _mul_sub(b, b, c)                       # b*b - c
    s = sqrt32(torch.clamp(h, min=0.0))
    t1 = -b - s
    t2 = -b + s
    t = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, BIG))
    return torch.where((h >= 0.0) & valid, t, BIG)


def sphere_c_fused(ro_shape, n_sph: int) -> bool:
    """Whether ``spheres_t`` fuses c = dot(oc, oc) - r*r for rays whose
    origins have shape ``ro_shape`` against the primitives ([V, 1, 1]
    primary, [V, 1, R] the others) and ``n_sph`` sphere slots:
    ``_sub_mul``'s rule on those shapes."""
    one = torch.empty(())
    oc = one.expand(broadcast_shape(ro_shape, (n_sph, 1)))
    r = one.expand(n_sph, 1)
    return _pdepth(r, r) <= _depth(oc)


def planes_t(ro: V3, rd: V3, normal: V3, ds, valid, eps):
    """The plane test of the reference's ray tracer (``_planes_t``;
    raytrace_shader.js:104-109): n.x + d = 0 -> t [..., P, R]."""
    denom = dot(normal, rd)
    num = -ds - dot(normal, ro)
    flat = denom.abs() < 1e-6
    t = num / torch.where(flat, 1.0, denom)
    miss = flat | (t <= eps) | ~valid
    return torch.where(miss, BIG, t)


def tris_t(ro: V3, rd: V3, a: V3, e1: V3, e2: V3, valid, eps):
    """pt_core.tris_t (Moller-Trumbore, t only) as the jitted reference
    rounds it: -> t [..., T, R]."""
    p = cross(rd, e2)
    det = dot(e1, p)
    bad = det.abs() < 1e-6
    inv = torch.reciprocal(torch.where(bad, 1.0, det))
    tv = ro - a
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(rd, q) * inv
    tt = dot(e2, q) * inv
    miss = (bad | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
            | (tt <= eps) | ~valid)
    return torch.where(miss, BIG, tt)


def tri_hit_info(ro: V3, rd: V3, a: V3, e1: V3, e2: V3):
    """pt_core.tri_hit_info as the jitted reference rounds it: for one
    selected triangle per ray, (n: unit normal flipped against rd, bc0,
    bc1, bc2)."""
    p = cross(rd, e2)
    det = dot(e1, p)
    inv = torch.reciprocal(torch.where(det.abs() < 1e-12, 1e-12, det))
    tv = ro - a
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(rd, q) * inv
    c = cross(e1, e2)
    n = c * rsqrt32(torch.clamp(dot(c, c), min=1e-20))
    flip = dot(n, rd) > 0.0
    n = V3(torch.where(flip, -n.x, n.x), torch.where(flip, -n.y, n.y),
           torch.where(flip, -n.z, n.z))
    return n, 1.0 - u - v, u, v


def reflect(rd: V3, n: V3) -> V3:
    """``geom.intersect.reflect``, rd - 2 (rd . n) n, with the reduction's
    dot. The [..., 3] result is vectorised as three interleaved lanes, and
    the third lane's product reaches its subtract through a shuffle, so
    only x and y fuse: fma(-(2 d), n, rd) for x, y; rd - (2 d) n for z."""
    d2 = 2.0 * rdot(rd, n)
    return V3(_sub_mul(rd.x, d2, n.x), _sub_mul(rd.y, d2, n.y),
              rd.z - d2 * n.z)
