"""The path tracer's XLA core in channel form (torch port of
``ascii_renderer_tpu/backends/pt_core.py`` and of the per-trace helpers of
``ascii_renderer_tpu/backends/pathtrace.py``: ``_ScenePack``,
``environment_ch``, ``_intersect``, ``_shadow`` and ``_sample_atlas``).

Rays are a flat [R] axis, primitives lead the candidate matrices ([P, R]),
and vectors are triples of scalar channels (``V3``), as in the reference.

Rounding follows the reference called eagerly (``render_pt`` without
``jax.jit``, as its goldens were rendered): each operation rounds on its
own, in the reference's order, except inside JAX's own jitted helpers,
where its compiler fuses products into adds (the ray grid's
``jnp.linalg.norm``: ``core/camera._norm3``). ``sqrt`` and ``1/sqrt``
are taken in float64 and rounded once (``core/fp.sqrt32``, ``rsqrt32``),
and so are ``sin``, ``cos`` and ``pow``, so the CPU and CUDA tensors of
the port agree.
Divisions are tensor by tensor (``quantize.fdiv``: a CUDA tensor divided
by a Python float is not IEEE).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ascii_renderer_tpu_torch.core import quantize
from ascii_renderer_tpu_torch.core.fp import rsqrt32, sqrt32
from ascii_renderer_tpu_torch.core.quantize import fdiv

BIG = 1e30
EPS = 1e-3  # shader_utils.js:5
KIND_NONE, KIND_SPHERE, KIND_TRI, KIND_LIGHT = 0, 1, 3, 5


def f64_fn(fn, x: torch.Tensor) -> torch.Tensor:
    """A float64 function of float32 ``x``, rounded once to float32."""
    return fn(x.double()).float()


class V3(NamedTuple):
    """A vector field as three scalar channels (any broadcastable shape)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def of(arr):  # arr [..., 3]
        return V3(arr[..., 0], arr[..., 1], arr[..., 2])

    def stack(self):
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s):
        if isinstance(s, V3):
            return V3(self.x * s.x, self.y * s.y, self.z * s.z)
        return V3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def where(self, mask, other):
        return V3(torch.where(mask, self.x, other.x),
                  torch.where(mask, self.y, other.y),
                  torch.where(mask, self.z, other.z))


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def normalize(a: V3, eps=1e-20) -> V3:
    return a * rsqrt32(torch.clamp(dot(a, a), min=eps))


def norm(a: V3):
    return sqrt32(torch.clamp(dot(a, a), min=0.0))


def gather(v: V3, idx) -> V3:
    return V3(v.x[idx], v.y[idx], v.z[idx])


# --------------------------------------------------------------------------
# Candidate-t computations: prims lead, rays follow
# --------------------------------------------------------------------------
def spheres_t(ro: V3, rd: V3, center: V3, radius, valid, eps):
    """ro/rd channels [R]; center channels [S] -> t [S, R]
    (shader_utils.js:28-40: the near root if > eps, else the far one)."""
    oc = V3(ro.x[None, :] - center.x[:, None],
            ro.y[None, :] - center.y[:, None],
            ro.z[None, :] - center.z[:, None])
    rdb = V3(rd.x[None, :], rd.y[None, :], rd.z[None, :])
    b = dot(oc, rdb)
    c = dot(oc, oc) - (radius * radius)[:, None]
    h = b * b - c
    s = sqrt32(torch.clamp(h, min=0.0))
    t1 = -b - s
    t2 = -b + s
    t = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, BIG))
    return torch.where((h >= 0.0) & valid[:, None], t, BIG)


class TriPack(NamedTuple):
    """Per-triangle constants, f32 [T, 3] each, and the valid mask [T]."""

    a: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def build(va, vb, vc, valid) -> "TriPack":
        return TriPack(va, vb - va, vc - va, valid)


def tris_t(ro: V3, rd: V3, pack: TriPack, eps):
    """Moller-Trumbore t only: -> t [T, R]."""
    def b(ch):  # tri channel [T] -> [T, 1]
        return ch[:, None]

    def r(ch):  # ray channel [R] -> [1, R]
        return ch[None, :]

    e1 = V3(b(pack.e1[:, 0]), b(pack.e1[:, 1]), b(pack.e1[:, 2]))
    e2 = V3(b(pack.e2[:, 0]), b(pack.e2[:, 1]), b(pack.e2[:, 2]))
    av = V3(b(pack.a[:, 0]), b(pack.a[:, 1]), b(pack.a[:, 2]))
    rdb = V3(r(rd.x), r(rd.y), r(rd.z))
    rob = V3(r(ro.x), r(ro.y), r(ro.z))

    p = cross(rdb, e2)
    det = dot(e1, p)
    bad = det.abs() < 1e-6
    inv = torch.reciprocal(torch.where(bad, 1.0, det))
    tv = rob - av
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(rdb, q) * inv
    tt = dot(e2, q) * inv
    miss = (bad | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
            | (tt <= eps) | ~pack.valid[:, None])
    return torch.where(miss, BIG, tt)


def tri_hit_info(ro: V3, rd: V3, a: V3, e1: V3, e2: V3):
    """Hit info of one (already selected) triangle per ray, channels [R]:
    (n: unit normal flipped against rd, bc0, bc1, bc2)."""
    p = cross(rd, e2)
    det = dot(e1, p)
    inv = torch.reciprocal(torch.where(det.abs() < 1e-12, 1e-12, det))
    tv = ro - a
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(rd, q) * inv
    n = normalize(cross(e1, e2))
    flip = dot(n, rd) > 0.0
    n = V3(torch.where(flip, -n.x, n.x), torch.where(flip, -n.y, n.y),
           torch.where(flip, -n.z, n.z))
    return n, 1.0 - u - v, u, v


def reflect(rd: V3, n: V3) -> V3:
    d = dot(rd, n)
    return V3(rd.x - 2.0 * d * n.x, rd.y - 2.0 * d * n.y,
              rd.z - 2.0 * d * n.z)


def refract(rd: V3, n: V3, eta):
    """GLSL refract: the zero vector on total internal reflection."""
    cosi = dot(n, rd)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    f = eta * cosi + sqrt32(torch.clamp(k, min=0.0))
    out = V3(eta * rd.x - f * n.x, eta * rd.y - f * n.y,
             eta * rd.z - f * n.z)
    zero = V3(torch.zeros_like(out.x), torch.zeros_like(out.y),
              torch.zeros_like(out.z))
    return out.where(~tir, zero), tir


# --------------------------------------------------------------------------
# Scene pack and the per-bounce helpers of trace_eye_paths
# --------------------------------------------------------------------------
def environment_ch(rd: V3) -> V3:
    """Sky / ground gradient on a miss (shader_utils.js:20-25)."""
    t = f64_fn(lambda x: torch.pow(x, 1.2000000476837158),  # f32(1.2)
               torch.clamp(rd.y * 0.5 + 0.5, 0.0, 1.0))
    sky = V3(0.90 * (1 - t) + 0.45 * t, 0.95 * (1 - t) + 0.65 * t,
             1.00 * (1 - t) + 0.95 * t)
    s = torch.clamp(fdiv(rd.y + 0.05, 0.1), 0.0, 1.0)
    s = s * s * (3.0 - 2.0 * s)  # smoothstep
    grd = (0.18 * 0.35, 0.15 * 0.35, 0.12 * 0.35)
    return V3(grd[0] * (1 - s) + sky.x * s, grd[1] * (1 - s) + sky.y * s,
              grd[2] * (1 - s) + sky.z * s)


def _mat_flags(scene):
    """Generalized LUT semantics: is_light <- emissive, is_specular <-
    reflective; shading albedo = reflective ? 1 : albedo * 0.7."""
    is_light = scene.mat_emissive
    is_spec = scene.mat_reflective
    shade = torch.where(is_spec[:, None], 1.0, scene.mat_albedo * 0.7)
    return is_light, is_spec, shade


class _ScenePack:
    """Per-scene precomputation: the spheres, and all triangles (scene
    tris, quad tri1 (a, b, c), quad tri2 (a, c, d)) with materials, UVs
    and flags."""

    def __init__(self, scene):
        self.scene = scene
        self.sph_c = V3.of(scene.sph_pos)
        self.sph_r = scene.sph_rad
        self.sph_valid = scene.sph_valid()
        self.n_sph = scene.sph_pos.shape[0]
        va = torch.cat([scene.tri_a, scene.quad_a, scene.quad_a])
        vb = torch.cat([scene.tri_b, scene.quad_b, scene.quad_c])
        vc = torch.cat([scene.tri_c, scene.quad_c, scene.quad_d])
        tvalid = torch.cat([scene.tri_valid(), scene.quad_valid(),
                            scene.quad_valid()])
        self.tri = TriPack.build(va, vb, vc, tvalid)
        self.n_tris = va.shape[0]
        self.tri_mat = torch.cat([scene.tri_mat, scene.quad_mat,
                                  scene.quad_mat])
        self.uva = torch.cat([scene.tri_uva, scene.quad_uv0, scene.quad_uv0])
        self.uvb = torch.cat([scene.tri_uvb, scene.quad_uv1, scene.quad_uv2])
        self.uvc = torch.cat([scene.tri_uvc, scene.quad_uv2, scene.quad_uv3])
        nq = scene.quad_a.shape[0]
        nt = scene.tri_a.shape[0]
        is_quad_row = torch.cat([
            torch.zeros(nt, dtype=torch.bool, device=va.device),
            torch.ones(2 * nq, dtype=torch.bool, device=va.device)])
        quad_zero = ((self.uva == 0).all(-1) & (self.uvb == 0).all(-1)
                     & (self.uvc == 0).all(-1))
        # texturable: tris always; quads only when some UV is nonzero
        self.texturable = ~(is_quad_row & quad_zero)
        self.is_light_m, self.is_spec_m, self.shade_m = _mat_flags(scene)


def _intersect(ro: V3, rd: V3, pk: _ScenePack, light_center, light_radius):
    """Nearest hit over spheres < triangles < the light sphere (the first
    of equal t wins). Returns a dict of per-ray channels."""
    scene = pk.scene
    t_s = spheres_t(ro, rd, pk.sph_c, pk.sph_r, pk.sph_valid, EPS)
    t_t = tris_t(ro, rd, pk.tri, EPS)
    lc = V3(light_center[0:1], light_center[1:2], light_center[2:3])
    t_l = spheres_t(ro, rd, lc, light_radius.reshape(1),
                    torch.ones(1, dtype=torch.bool, device=ro.x.device), EPS)
    t_all = torch.cat([t_s, t_t, t_l], dim=0)  # [P, R]
    k = torch.argmin(t_all, dim=0)  # the first minimum: shader order
    t = t_all.gather(0, k[None])[0]
    hit = t < BIG * 0.5

    S, T = pk.n_sph, pk.n_tris
    is_s = k < S
    is_t = (k >= S) & (k < S + T)
    is_l = k >= S + T
    ks = torch.clamp(k, 0, S - 1)
    kt = torch.clamp(k - S, 0, T - 1)

    pos = V3(ro.x + t * rd.x, ro.y + t * rd.y, ro.z + t * rd.z)

    csel = gather(pk.sph_c, ks)
    rsel = torch.clamp(pk.sph_r[ks], min=1e-6)
    n_sph = V3((pos.x - csel.x) / rsel, (pos.y - csel.y) / rsel,
               (pos.z - csel.z) / rsel)
    lr = torch.clamp(light_radius, min=1e-6)
    n_lgt = V3((pos.x - light_center[0]) / lr, (pos.y - light_center[1]) / lr,
               (pos.z - light_center[2]) / lr)
    a_t = V3.of(pk.tri.a[kt])
    e1_t = V3.of(pk.tri.e1[kt])
    e2_t = V3.of(pk.tri.e2[kt])
    n_tri, b0, b1, b2 = tri_hit_info(ro, rd, a_t, e1_t, e2_t)

    n = n_tri.where(is_t, n_sph.where(is_s, n_lgt))
    mat = torch.where(is_s, scene.sph_mat[ks],
                      torch.where(is_t, pk.tri_mat[kt], 0))
    kind = torch.where(is_s, KIND_SPHERE,
                       torch.where(is_t, KIND_TRI,
                                   torch.where(is_l, KIND_LIGHT, KIND_NONE)))
    kind = torch.where(hit, kind, KIND_NONE)
    return dict(t=t, hit=hit, kind=kind, mat=mat, n=n, pos=pos,
                tri_idx=kt, bc=(b0, b1, b2))


def _shadow(ro: V3, rd: V3, dist, pk: _ScenePack):
    """Any hit closer than dist over the spheres and all triangles (not
    the light sphere)."""
    t_s = spheres_t(ro, rd, pk.sph_c, pk.sph_r, pk.sph_valid, EPS)
    t_t = tris_t(ro, rd, pk.tri, EPS)
    return (t_s < dist[None]).any(0) | (t_t < dist[None]).any(0)


def _sample_atlas(pk: _ScenePack, hinfo):
    """Atlas fetch for the winning triangle row (shader_utils.js:100-132):
    (rgb V3 [R] in 0..1, alpha byte int32 [R], sampled bool [R])."""
    scene = pk.scene
    ah, aw = scene.atlas_a.shape
    if not (ah > 1 and aw > 1):  # atlasEnabled
        z = torch.zeros_like(hinfo["t"])
        return V3(z, z, z), z.to(torch.int32), z.to(torch.bool)

    kt = hinfo["tri_idx"]
    b0, b1, b2 = hinfo["bc"]
    uva, uvb, uvc = pk.uva[kt], pk.uvb[kt], pk.uvc[kt]
    u = b0 * uva[:, 0] + b1 * uvb[:, 0] + b2 * uvc[:, 0]
    v = b0 * uva[:, 1] + b1 * uvb[:, 1] + b2 * uvc[:, 1]
    tx = torch.floor(u + 0.5).to(torch.int32)
    ty = torch.floor(v + 0.5).to(torch.int32)
    inb = (tx >= 0) & (tx < aw) & (ty >= 0) & (ty < ah)
    lin = (torch.clamp(ty, 0, ah - 1) * aw
           + torch.clamp(tx, 0, aw - 1)).long()
    flat_rgb = fdiv(scene.atlas_rgb.reshape(-1, 3).to(torch.float32), 255.0)
    flat_a = scene.atlas_a.reshape(-1).to(torch.int32)
    rgb = V3(flat_rgb[:, 0][lin], flat_rgb[:, 1][lin], flat_rgb[:, 2][lin])
    ab = flat_a[lin]
    sampled = ((hinfo["kind"] == KIND_TRI) & pk.texturable[kt] & inb
               & (ab != quantize.ATLAS_CLEAR))
    return rgb, torch.where(sampled, ab, 0), sampled
