"""Vectorised ray-primitive intersections (torch port of
``ascii_renderer_tpu/geom/intersect.py``; ref: shader_utils.js:28-58,
raytrace_shader.js:89-125), on [..., 3] arrays.

Conventions (the GLSL's):
  - rays: ro [..., 3] origin, rd [..., 3] unit direction;
  - primitives: struct-of-arrays, padded; ``valid`` disables padding slots;
  - a miss is t = BIG (composes with argmin as the GLSL's guards do);
  - sphere hit: the near root if > eps, else the far root;
  - triangle: Moller-Trumbore with |det| < 1e-6 rejected, the normal
    flipped to face the ray's origin side.

Rounding follows the reference called under ``jax.jit``: the size-3 dot
products are reductions from 0 that fuse each product into the running sum
(``backends/rt_core.rdot``), and a product fuses into the add or subtract
it feeds where both are formed in one loop (``rt_core._mul_add``). Where
the reference vectorises a [..., 3] result as three interleaved lanes, the
third lane's product reaches its add through a shuffle and is rounded on
its own (``reflect``). Roots are correctly rounded (``core/fp.sqrt32``).
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.backends import rt_core as RC
from ascii_renderer_tpu_torch.backends.pt_core import V3
from ascii_renderer_tpu_torch.core.fp import fma32, sqrt32

BIG = 1e30  # "no hit" (compares like the GLSL's 1e20 init)


def _v(a) -> V3:
    return V3.of(a)


def _dot(a, b):
    """jnp.sum(a * b, axis=-1) over [..., 3]."""
    return RC.rdot(_v(a), _v(b))


def _cross(a, b):
    """jnp.cross over [..., 3]: a1*b2 - a2*b1 -> fma(a1, b2, -(a2*b1))."""
    return RC.cross(_v(a), _v(b)).stack()


def ray_spheres(ro, rd, centers, radii, valid, eps):
    """ro, rd [..., 3]; centers [S, 3]; radii [S]; valid [S] -> t [..., S]."""
    oc = ro[..., None, :] - centers                 # [..., S, 3]
    b = _dot(oc, rd[..., None, :])
    c = RC._sub_mul(_dot(oc, oc), radii, radii)    # dot - r*r
    h = RC._mul_sub(b, b, c)                       # b*b - c
    s = sqrt32(torch.clamp(h, min=0.0))
    t1 = -b - s
    t2 = -b + s
    t = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, BIG))
    return torch.where((h >= 0.0) & valid, t, BIG)


def sphere_normal(pos, center, radius):
    """(pos - center) / max(r, 1e-6) (shader_utils.js:41)."""
    return (pos - center) / torch.clamp(radius, min=1e-6)[..., None]


def ray_planes(ro, rd, normals, ds, valid, eps):
    """Plane n.x + d = 0 (raytrace_shader.js:104-109): -> t [..., P]."""
    denom = _dot(normals, rd[..., None, :])
    flat = denom.abs() < 1e-6
    t = (-ds - _dot(normals, ro[..., None, :])) / torch.where(flat, 1.0,
                                                              denom)
    miss = flat | (t <= eps) | ~valid
    return torch.where(miss, BIG, t)


def ray_triangles(ro, rd, va, vb, vc, valid, eps):
    """Moller-Trumbore. va / vb / vc [T, 3] -> (t [..., T], n [..., T, 3],
    bc [..., T, 3]); n unit length, flipped so that dot(n, rd) <= 0
    (shader_utils.js:54-56)."""
    e1 = vb - va
    e2 = vc - va
    rdx = rd[..., None, :]
    p = _cross(rdx, e2)
    det = _dot(e1, p)
    bad = det.abs() < 1e-6
    inv_det = torch.reciprocal(torch.where(bad, 1.0, det))
    tv = ro[..., None, :] - va
    u = _dot(tv, p) * inv_det
    q = _cross(tv, e1)
    v = _dot(rdx, q) * inv_det
    tt = _dot(e2, q) * inv_det
    miss = (bad | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
            | (tt <= eps) | ~valid)
    t = torch.where(miss, BIG, tt)

    n = _cross(e1, e2)
    n = n / torch.clamp(sqrt32(_dot(n, n)), min=1e-20)[..., None]
    n = torch.broadcast_to(n, t.shape + (3,))
    flip = _dot(n, rdx) > 0.0
    n = torch.where(flip[..., None], -n, n)
    bc = torch.stack([1.0 - u - v, u, v], dim=-1)
    return t, n, bc


def reflect(rd, n):
    """rd - 2 dot(rd, n) n (``rt_core.reflect``: x and y fused, z not)."""
    return RC.reflect(_v(rd), _v(n)).stack()


def refract(rd, n, eta):
    """GLSL refract(): the zero vector on total internal reflection.
    ``eta`` a scalar or an array batched like the rays. Returns (dir, tir)."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=rd.device)
    cosi = _dot(n, rd)
    k = RC._sub_mul(1.0, eta * eta, RC._sub_mul(1.0, cosi, cosi))
    tir = k < 0.0
    f = fma32(eta, cosi, sqrt32(torch.clamp(k, min=0.0)))
    out = RC._diff(eta[..., None], rd, f[..., None], n)
    return torch.where(tir[..., None], 0.0, out), tir
