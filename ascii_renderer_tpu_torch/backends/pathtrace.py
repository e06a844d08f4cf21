"""Monte-Carlo path tracer (torch port of
``ascii_renderer_tpu/backends/pathtrace.py``; ref: pathtrace.js +
pathtrace_shader.js + shader_utils.js) — the reference's default backend.

Two paths trace the rays, as in the reference:
- the kernel path (``render_pt(use_kernel=True)``, the default here, the
  reference's choice on its accelerator): every ray through the megakernel
  (``ops/pt_kernel``: the CUDA kernel for CUDA tensors, its plain-torch
  version for CPU tensors). RNG: the kernel's lowbias32 hash of (ray uid,
  seed, draw index), the anti-aliasing jitter from the same hash with
  counters 0x40000001 and 0x40000002; the frame seed is the int32 view of
  the last word of the frame's key (frame ``i`` of a backend: ``i``);
- the XLA core (``trace_eye_paths``, ``render_pt(use_kernel=False)``, the
  reference's default): vectorised torch over [primitives, rays]
  candidate matrices (``backends/pt_core``), drawing from ``jax.random``'s
  threefry stream (``core/threefry``) under the frame's key. It takes
  atlases above the kernel's ``MAX_ATLAS_TEXELS`` texels, on every device.
``PathtraceBackend`` and the frame step route as the reference does: the
core for such an atlas, the kernel path otherwise.

Semantics preserved (per the shader): spp x bounces with NEE toward the
(optionally animated) spherical area light and Russian roulette after
bounce 2; the glass/mirror Fresnel branch; the sky/ground environment on a
miss; ASCII-texture sampling, where a PRIMARY ray hitting a glyph texel
short-circuits (colour passes through, the glyph code rides the alpha
byte) and later hits take the glyph as a solid texel; the centre-ray /
fetched-texel anti-aliasing rule; alpha 255 for pixels without override.

``render_pt(pixel_active=)`` (the progressive tracer's adaptive path,
``sim/accum``) compacts the active pixels to the front of the kernel's ray
stream (the order, uids and block gates from ``ops/partition
.stable_order``: X13 on the card), so its block gate skips the converged
tail. ``render_pt(row_lo=,
n_rows=)`` renders a row band of the frame (``parallel.mesh
.render_rows_sharded``): on the kernel path each ray's RNG id is its
pixel's global uid, so a band equals those rows of the full frame bit for
bit; the core draws its threefry jitter over the band's shape, as the
reference's does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.profiler import record_function

from ascii_renderer_tpu_torch.backends import pt_core as PC
from ascii_renderer_tpu_torch.backends.pt_core import (  # noqa: F401
    EPS, KIND_LIGHT, V3, _ScenePack, dot, environment_ch, normalize)
from ascii_renderer_tpu_torch.core import quantize
from ascii_renderer_tpu_torch.core import threefry as TF
from ascii_renderer_tpu_torch.core.camera import (Camera, band_of,
                                                  camera_basis,
                                                  camera_basis_floats,
                                                  camera_floats, ndc_grid)
from ascii_renderer_tpu_torch.core.fp import round32, sqrt32
from ascii_renderer_tpu_torch.core.quantize import fdiv
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ops import partition as PTN
from ascii_renderer_tpu_torch.ops import pt_kernel as PK
from ascii_renderer_tpu_torch.ops import pt_reduce as PR
from ascii_renderer_tpu_torch.ops.ray_grid import pt_rays, ray_grid
from ascii_renderer_tpu_torch.scene.builder import SceneData

_GOLDEN = -1640531527  # int32 golden-ratio stride between batch seeds
_block_gate = PTN.block_gate  # the block gates' plain chain, moved to ops
# float32 constants of the light's chain (_light_center, light_floats)
_F32_0P9, _F32_0P7, _F32_2P8, _F32_1P3, _F32_EPS = (
    round32(x) for x in (0.9, 0.7, 2.8, 1.3, EPS))


def light_sphere_host(scene: SceneData):
    """The scene's fixed light-sphere values, read to the host once per
    scene: (animated, centre f32 [3], radius f32 0-d)."""
    return (bool(scene.area_auto),
            scene.area_center.detach().cpu().to(torch.float32),
            scene.area_radius.detach().cpu().to(torch.float32))


def get_light_sphere(scene: SceneData, time, host=None):
    """Animated-or-fixed light sphere (shader_utils.js:83-91), computed on
    the host in float32: (center f32 [3], radius f32 0-d), CPU tensors.
    ``host``: a precomputed light_sphere_host(scene)."""
    auto, center, radius = light_sphere_host(scene) if host is None else host
    if auto:
        center = torch.tensor(_light_center(time), dtype=torch.float32)
    return center, radius


def light_floats(scene: SceneData, time, light_color, host=None) -> list:
    """The megakernel's 8 light parameters (centre xyz, radius, colour
    rgb = light_color * 1.3, eps) as Python floats: get_light_sphere's
    centre and radius, the colour's float32 product."""
    auto, center, radius = light_sphere_host(scene) if host is None else host
    center = _light_center(time) if auto else center.tolist()
    return [*center, radius.item(),
            *(round32(round32(float(c)) * _F32_1P3) for c in light_color),
            _F32_EPS]


def _light_center(time) -> list:
    """The animated light's centre at ``time`` as 3 Python floats, in
    float32: 3 + 2 sin(t), 2.8 + 2 sin(0.9 t), 3 + 4 cos(0.7 t), the sines
    and cosine through torch's CPU float32 sin / cos, each other operation
    rounded once (``round32``)."""
    t = round32(float(time))
    s1, s2, c3 = _light_trig(t, math.copysign(1.0, t))
    return [round32(3.0 + 2.0 * s1), round32(_F32_2P8 + 2.0 * s2),
            round32(3.0 + 4.0 * c3)]


@functools.lru_cache(maxsize=64)
def _light_trig(t: float, _sign: float):
    """sin(t), sin(t * 0.9) and cos(t * 0.7) of the float32 time t, by
    torch's CPU float32 sin and cos, cached by time (and the sign of a
    zero time)."""
    s1, s2 = torch.sin(torch.tensor([t, round32(t * _F32_0P9)],
                                    dtype=torch.float32)).tolist()
    c3 = torch.cos(torch.tensor(round32(t * _F32_0P7),
                                dtype=torch.float32)).item()
    return s1, s2, c3


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def pack_scene_entries(scene: SceneData):
    """SceneData -> (prim_packed f32 [rows, 128], atlas int32 [texels]
    packed rgba, atlas_w, atlas_h, sph_rows), on the scene's device.

    Entry layout: ops/pt_kernel.py channels; spheres first (padded to a
    multiple of 4 entries), then all tris (scene tris + quad tri1 + quad
    tri2), padded likewise — the JAX packer's layout and candidate order.
    Padding entries carry C_BADS = 3e38, so the kernel's guarded
    1 / (n . d) never meets a zero (an all-zero pad would compute 0 * inf).
    An atlas above MAX_ATLAS_TEXELS is left out (atlas_w = atlas_h = 0), as
    the reference packs it: such a scene renders through the XLA core."""
    pk = _ScenePack(scene)
    dev = scene.sph_pos.device
    S, Tn = pk.n_sph, pk.n_tris
    S_pad = -(-S // PK.PACK) * PK.PACK
    n_pad = S_pad + (-(-Tn // PK.PACK) * PK.PACK)
    ent = torch.zeros((n_pad, PK.N_CHAN), dtype=torch.float32, device=dev)
    ent[:, PK.C_BADS] = 3e38

    m = torch.clamp(scene.sph_mat, min=0).long()
    sph = torch.zeros((S, PK.N_CHAN), dtype=torch.float32, device=dev)
    sph[:, PK.C_KIND] = pk.sph_valid.to(torch.float32)
    sph[:, PK.C_AX:PK.C_AZ + 1] = scene.sph_pos
    sph[:, PK.C_E1X] = scene.sph_rad
    sph[:, PK.C_SHR:PK.C_SHB + 1] = pk.shade_m[m]
    sph[:, PK.C_ISLIGHT] = pk.is_light_m[m].to(torch.float32)
    sph[:, PK.C_ISSPEC] = pk.is_spec_m[m].to(torch.float32)

    # world -> barycentric transform per tri: unit normal n = (e1 x e2) /
    # |e1 x e2|, plane offset d0 = n.a, rows r1 = (e2 x n) / |e1 x e2|
    # (u = r1.(p - a)) and r2 = (n x e1) / |e1 x e2|; bad_scale = 1e-6 /
    # |e1 x e2| reproduces Moller-Trumbore's |det| < 1e-6 cutoff;
    # degenerate / inert tris get 3e38.
    tm = torch.clamp(pk.tri_mat, min=0).long()
    a_, e1_, e2_ = pk.tri.a, pk.tri.e1, pk.tri.e2
    cn = _cross(e1_, e2_)
    area2 = sqrt32(_dot(cn, cn))
    ok = area2 > 1e-30
    inv_area = torch.where(ok, torch.reciprocal(torch.where(ok, area2, 1.0)),
                           0.0)
    n_ = cn * inv_area[:, None]
    r1 = _cross(e2_, n_) * inv_area[:, None]
    r2 = _cross(n_, e1_) * inv_area[:, None]
    tri = torch.zeros((Tn, PK.N_CHAN), dtype=torch.float32, device=dev)
    tri[:, PK.C_KIND] = torch.where(pk.tri.valid, 2.0, 0.0)
    tri[:, PK.C_NX:PK.C_NZ + 1] = n_
    tri[:, PK.C_D0] = _dot(n_, a_)
    tri[:, PK.C_R1X:PK.C_R1Z + 1] = r1
    tri[:, PK.C_C1] = -_dot(r1, a_)
    tri[:, PK.C_R2X] = r2[:, 0]
    tri[:, PK.C_R2Y] = r2[:, 1]
    tri[:, PK.C_R2Z] = r2[:, 2]
    tri[:, PK.C_C2] = -_dot(r2, a_)
    tri[:, PK.C_BADS] = torch.where(ok, 1e-6 * inv_area, 3e38)
    tri[:, PK.C_SHR:PK.C_SHB + 1] = pk.shade_m[tm]
    tri[:, PK.C_ISLIGHT] = pk.is_light_m[tm].to(torch.float32)
    tri[:, PK.C_ISSPEC] = pk.is_spec_m[tm].to(torch.float32)
    tri[:, PK.C_TEXTURABLE] = pk.texturable.to(torch.float32)
    tri[:, PK.C_UVAX:PK.C_UVAY + 1] = pk.uva
    tri[:, PK.C_UVBX:PK.C_UVBY + 1] = pk.uvb
    tri[:, PK.C_UVCX:PK.C_UVCY + 1] = pk.uvc

    ent[:S] = sph
    ent[S_pad:S_pad + Tn] = tri
    prim_packed = ent.reshape(n_pad // PK.PACK, PK.PACK * PK.N_CHAN)
    sph_rows = S_pad // PK.PACK

    ah, aw = scene.atlas_a.shape
    if not (ah > 1 and aw > 1) or ah * aw > PK.MAX_ATLAS_TEXELS:
        # no atlas, or one above the kernel's budget (which the XLA core
        # takes): the prims alone, as the reference packs them
        return (prim_packed, torch.zeros(1, dtype=torch.int32, device=dev),
                0, 0, sph_rows)
    rgb = scene.atlas_rgb.reshape(-1, 3).to(torch.int64)
    al = scene.atlas_a.reshape(-1).to(torch.int64)
    rgba = (rgb[:, 0] << 24) | (rgb[:, 1] << 16) | (rgb[:, 2] << 8) | al
    atlas = torch.where(rgba >= 2 ** 31, rgba - 2 ** 32, rgba).to(torch.int32)
    return prim_packed, atlas.contiguous(), aw, ah, sph_rows


def _light_host(light_center, light_radius, light_color):
    """The megakernel's 8 light parameters (centre xyz, radius, colour
    rgb, eps) as a float32 CPU tensor."""
    lc = torch.as_tensor(light_color, dtype=torch.float32).cpu()
    return torch.cat([light_center.reshape(3), light_radius.reshape(1), lc,
                      torch.tensor([EPS], dtype=torch.float32)])


def _params(light_center, light_radius, light_color, device):
    """The light parameters on ``device``, for the per-ray form."""
    return _light_host(light_center, light_radius, light_color).to(device)


def trace_eye_paths_kernel_packed(scene: SceneData, ro, rd, seed_base,
                                  light_center, light_radius, *,
                                  bounces: int, light_color, nee: bool,
                                  ray_active=None, ray_uid=None,
                                  packed=None):
    """Trace ro/rd f32 [..., 3] through the megakernel: (lor, log, lob, ov,
    fet), each f32 FLAT [R] in ray order. ray_active: optional flat [R]
    bool; a block of 1,024 rays none of which is active is gated (its
    outputs are zero), the reference's block gate. ray_uid: optional flat
    [R] int32 RNG ids (default: stream position). packed: a precomputed
    pack_scene_entries(scene)."""
    n = int(np.prod(rd.shape[:-1]))
    nblk = -(-n // PK.BLOCK)
    if packed is None:
        packed = pack_scene_entries(scene)
    prim, atlas, aw, ah, sph_rows = packed
    uid = None
    if ray_uid is not None:
        # pad-ray uids are arbitrary (their outputs are discarded)
        uid = ray_uid.reshape(-1).to(torch.int32)
        uid = torch.cat([uid, uid.new_zeros(nblk * PK.BLOCK - n)]).view(
            nblk, PK.BH, PK.BW)
    outs = PK.trace_blocks_raw(
        _params(light_center, light_radius, light_color, rd.device), prim,
        PK.blockify(ro, n, nblk), PK.blockify(rd, n, nblk), int(seed_base),
        atlas, bounces=bounces, nee=nee, atlas_w=aw, atlas_h=ah,
        sph_rows=sph_rows, uid=uid, block_active=None if ray_active is None
        else _block_gate(ray_active.reshape(-1)))
    return tuple(o.reshape(-1)[:n] for o in outs)


def trace_eye_paths_kernel(scene: SceneData, ro, rd, seed_base, light_center,
                           light_radius, *, bounces: int, light_color,
                           nee: bool):
    """Megakernel trace in image form: (Lo f32 [..., 3], override int32
    [...], fetched bool [...])."""
    shp = rd.shape[:-1]
    lor, log, lob, ov, fet = trace_eye_paths_kernel_packed(
        scene, ro, rd, seed_base, light_center, light_radius,
        bounces=bounces, light_color=light_color, nee=nee)
    lo = torch.stack([lor, log, lob], dim=-1).reshape(*shp, 3)
    return (lo, torch.round(ov).to(torch.int32).reshape(shp),
            (fet > 0.5).reshape(shp))


# --------------------------------------------------------------------------
# The XLA core (the reference's default path): vectorised torch, threefry
# --------------------------------------------------------------------------
def _cos_hemisphere(n: V3, key):
    """Cosine-weighted hemisphere sample (shader_utils.js:135-143)."""
    r = TF.uniform(key, tuple(n.x.shape) + (2,), n.x.device)
    phi = 2.0 * math.pi * r[..., 0]
    r2 = r[..., 1]
    s2 = sqrt32(1.0 - r2)
    ny_ok = n.y.abs() < 0.999
    axis = V3(torch.where(ny_ok, 0.0, 1.0), torch.where(ny_ok, 1.0, 0.0),
              torch.zeros_like(n.x))
    uu = normalize(PC.cross(n, axis))
    vv = PC.cross(uu, n)
    cphi = s2 * PC.f64_fn(torch.cos, phi)
    sphi = s2 * PC.f64_fn(torch.sin, phi)
    sr2 = sqrt32(r2)
    return normalize(V3(cphi * uu.x + sphi * vv.x + sr2 * n.x,
                        cphi * uu.y + sphi * vv.y + sr2 * n.y,
                        cphi * uu.z + sphi * vv.z + sr2 * n.z))


def _sample_light_point(key, center, radius, shape, device):
    """Uniform point on the light sphere (shader_utils.js:144-149)."""
    h = TF.uniform(key, tuple(shape) + (2,), device)
    hx = h[..., 0] * 2.0 - 1.0
    phi = h[..., 1] * 2.0 * math.pi
    s = sqrt32(torch.clamp(1.0 - hx * hx, min=0.0))
    return V3(center[0] + radius * s * PC.f64_fn(torch.sin, phi),
              center[1] + radius * s * PC.f64_fn(torch.cos, phi),
              center[2] + radius * hx)


def _pow5(x):
    """x ** 5 as the reference's integer power rounds it."""
    return x * ((x * x) * (x * x))


def _next_direction(n: V3, rd: V3, is_spec, key):
    """BRDF sampling (shader_utils.js:216-229): (direction, is_spec)."""
    kd, kf = TF.split(key)
    diff = _cos_hemisphere(n, kd)
    ndotr = dot(rd, n)
    flip = ndotr > 0.0
    eta = torch.where(flip, 1.5, 1.0 / 1.5)
    nn = V3(torch.where(flip, -n.x, n.x), torch.where(flip, -n.y, n.y),
            torch.where(flip, -n.z, n.z))
    r0 = ((1.0 - 1.5) / (1.0 + 1.5)) ** 2
    fres = r0 + (1.0 - r0) * _pow5(1.0 - ndotr.abs())
    ref, _tir = PC.refract(rd, nn, eta)
    use_reflect = (PC.norm(ref) < 1e-5) | (
        TF.uniform(kf, tuple(fres.shape), fres.device) < fres)
    refl = PC.reflect(rd, nn)
    spec = normalize(refl.where(use_reflect, ref))
    return spec.where(is_spec, diff), is_spec


def trace_eye_paths(scene: SceneData, ro, rd, key, light_center,
                    light_radius, *, bounces: int, light_color, nee: bool,
                    with_stats: bool = False):
    """traceEyePath (pathtrace_shader.js:107-183), vectorised over rays.

    ro/rd f32 [..., 3]; key: two uint32 words (core/threefry); light
    centre f32 [3] and radius f32 0-d. Returns (Lo f32 [..., 3], override
    int32 [...], primary_fetched bool [...]); with_stats=True appends
    {"segments", "shadow_rays"}: the rays alive at each bounce's search
    and the diffuse lanes alive at each NEE test, as floats."""
    shp = rd.shape[:-1]
    R = int(np.prod(shp))
    dev = rd.device
    ro = V3.of(ro.reshape(R, 3))
    rd = V3.of(rd.reshape(R, 3))
    pk = _ScenePack(scene)
    light_center = light_center.to(device=dev, dtype=torch.float32)
    light_radius = light_radius.to(device=dev, dtype=torch.float32)
    lcol = [float(c) for c in np.asarray(
        torch.as_tensor(light_color, dtype=torch.float32).cpu())]
    shade = pk.shade_m

    zero = torch.zeros(R, dtype=torch.float32, device=dev)
    one = torch.ones(R, dtype=torch.float32, device=dev)
    Lo = V3(zero, zero, zero)
    T = V3(one, one, one)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    specular_bounce = torch.ones(R, dtype=torch.bool, device=dev)
    override = torch.zeros(R, dtype=torch.int32, device=dev)
    primary_fetched = torch.zeros(R, dtype=torch.bool, device=dev)
    seg_count = shadow_count = 0.0

    def add(mask, L, a, b=None):
        """Lo + T * a (* b) where mask, per channel."""
        out = []
        for Lc, Tc, ac in zip(L, T, a):
            term = Tc * ac if b is None else Tc * ac * b
            out.append(torch.where(mask, Lc + term, Lc))
        return V3(*out)

    for j in range(bounces):
        kj = TF.fold_in(key, j)
        k_bounce, k_nee, k_rr = TF.split(kj, 3)
        if with_stats:
            seg_count += float(alive.sum())
        h = PC._intersect(ro, rd, pk, light_center, light_radius)
        miss = alive & ~h["hit"]
        Lo = add(miss, Lo, PC.environment_ch(rd))
        alive = alive & h["hit"]

        n = h["n"]
        m = torch.clamp(h["mat"], min=0).long()
        is_light = pk.is_light_m[m] | (h["kind"] == KIND_LIGHT)
        lt = alive & is_light & specular_bounce
        Lo = add(lt, Lo, lcol)
        alive = alive & ~is_light

        tex, abyte, sampled = PC._sample_atlas(pk, h)
        sampled = sampled & alive
        if j == 0:
            primary_fetched = sampled
        glyph = (sampled & (abyte >= quantize.ATLAS_GLYPH_MIN)
                 & (abyte <= quantize.ATLAS_GLYPH_MAX))
        if j == 0:
            # primary glyph hit: colour passes through, alpha override, stop
            Lo = tex.where(glyph, Lo)
            override = torch.where(glyph, abyte, override)
            alive = alive & ~glyph
            solid = sampled & (abyte == quantize.ATLAS_SOLID)
        else:
            solid = sampled & ((abyte == quantize.ATLAS_SOLID) | glyph)

        is_spec = pk.is_spec_m[m]
        albedo = tex.where(solid, V3(shade[m, 0], shade[m, 1], shade[m, 2]))
        ndir, spec_now = _next_direction(n, rd, is_spec, k_bounce)
        absorb = alive & (~spec_now | (dot(ndir, n) < 0.0))
        T = (T * albedo).where(absorb, T)

        hitpos = h["pos"]
        if with_stats and nee and j < bounces - 1:
            shadow_count += float((alive & ~is_spec).sum())
        if nee and j < bounces - 1:
            lpos = _sample_light_point(k_nee, light_center, light_radius,
                                       (R,), dev)
            ldir = lpos - hitpos
            dist = PC.norm(ldir)
            ldir = ldir * torch.reciprocal(torch.clamp(dist, min=1e-12))
            sro = V3(hitpos.x + n.x * EPS, hitpos.y + n.y * EPS,
                     hitpos.z + n.z * EPS)
            shadowed = PC._shadow(sro, ldir, dist, pk)
            dl = V3(light_center[0] - hitpos.x, light_center[1] - hitpos.y,
                    light_center[2] - hitpos.z)
            d2 = torch.clamp(dot(dl, dl), min=1e-12)
            cos_a_max = sqrt32(1.0 - torch.clamp(
                light_radius * light_radius / d2, 0.0, 1.0))
            weight = 2.0 * (1.0 - cos_a_max)
            ndl = torch.clamp(dot(ldir, n), min=0.0)
            contrib = alive & ~spec_now & ~shadowed
            Lo = add(contrib, Lo, lcol, weight * ndl)

        side = torch.where(dot(ndir, n) > 0.0, EPS, -EPS)
        new_ro = V3(hitpos.x + n.x * side, hitpos.y + n.y * side,
                    hitpos.z + n.z * side)
        ro = new_ro.where(alive, ro)
        rd = ndir.where(alive, rd)
        specular_bounce = torch.where(alive, spec_now, specular_bounce)

        if j >= 2:  # Russian roulette (pathtrace_shader.js:176-180)
            p = torch.clamp(torch.maximum(T.x, torch.maximum(T.y, T.z)),
                            0.05, 0.95)
            u = TF.uniform(k_rr, (R,), dev)
            alive = alive & ~(u > p)
            T = (T * torch.reciprocal(p)).where(alive, T)

    out = (Lo.stack().reshape(*shp, 3), override.reshape(shp),
           primary_fetched.reshape(shp))
    if with_stats:
        return out + ({"segments": seg_count, "shadow_rays": shadow_count},)
    return out


def atlas_ok(scene: SceneData) -> bool:
    """Whether the kernel path can take the scene's atlas (none, or at
    most MAX_ATLAS_TEXELS texels); the XLA core takes any."""
    ah, aw = scene.atlas_a.shape
    return not (ah > 1 and aw > 1) or ah * aw <= PK.MAX_ATLAS_TEXELS


def _render_core(scene, cam, rows, cols, pixel_aspect, spp, bounces, lcol,
                 nee, sample_batch, key, light_center, light_radius, dev,
                 row_lo=0, n_rows=None):
    """render_pt's XLA-core branch (pathtrace.py:558-722 of the
    reference): the centre-ray probe under fold_in(key, 0xC0FFEE), then
    batch b under the split of fold_in(key, b) into (jitter, path) keys,
    the first overriding sample of a batch kept and the valid samples
    summed; the probe's overrides take precedence. A row band draws its
    jitter and paths over the band's shape (the jitter scaled by the
    global rows), as the reference's band does."""
    basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    px, py, aspect = ndc_grid(rows, cols, pixel_aspect, dev, row_lo, n_rows)
    band = px.shape[0]
    pos = cam.pos.to(device=dev, dtype=torch.float32)

    def trace(ro, rd, k):
        return trace_eye_paths(scene, ro, rd, k, light_center, light_radius,
                               bounces=bounces, light_color=lcol, nee=nee)

    with record_function("pt.rays"):
        rd0 = ray_grid(px, py, basis)
    with record_function("pt.core"):
        col0, ov0, fetched = trace(pos.expand(band, cols, 3), rd0,
                                   TF.fold_in(key, 0xC0FFEE))

    B = max(1, min(sample_batch, spp))
    n_batches = -(-spp // B)
    tot = torch.zeros((band, cols, 3), dtype=torch.float32, device=dev)
    override = torch.zeros((band, cols), dtype=torch.int32, device=dev)
    ovcol = torch.zeros((band, cols, 3), dtype=torch.float32, device=dev)
    for b in range(n_batches):
        with record_function("pt.rays"):
            k_jit, k_path = TF.split(TF.fold_in(key, b))
            s_idx = b * B + torch.arange(B, device=dev)
            r2 = TF.uniform(k_jit, (B, band, cols, 2), dev)
            rpof = fdiv(2.0 * (r2 - 0.5), float(rows))
            use_jit = (s_idx > 0)[:, None, None] & ~fetched[None]
            jx = torch.where(use_jit, rpof[..., 0] * aspect, 0.0)
            jy = torch.where(use_jit, rpof[..., 1], 0.0)
            rd = ray_grid(px[None] + jx, py[None] + jy, basis)
        with record_function("pt.core"):
            col, ov, _pf = trace(pos.expand(B, band, cols, 3), rd, k_path)
        with record_function("pt.reduce"):
            valid_s = (s_idx < spp)[:, None, None]
            tot = tot + torch.where(valid_s[..., None], col, 0.0).sum(0)
            has_s = (ov > 0) & valid_s
            first = torch.argmax(has_s.to(torch.int32), dim=0)  # first true
            has = has_s.any(0)
            new = has & (override == 0)
            override = torch.where(new, ov.gather(0, first[None])[0],
                                   override)
            sel = col.gather(0, first[None, ..., None].expand(1, band, cols,
                                                              3))[0]
            ovcol = torch.where(new[..., None], sel, ovcol)

    with record_function("pt.reduce"):
        # phase-1 overrides (centre ray) take precedence — sample 0
        has0 = ov0 > 0
        override = torch.where(has0, ov0, override)
        ovcol = torch.where(has0[..., None], col0, ovcol)
        has_ov = override > 0
        rgb = torch.where(has_ov[..., None], torch.clamp(ovcol, 0.0, 1.0),
                          torch.clamp(fdiv(tot, float(spp)), 0.0, 1.0))
        a = torch.where(has_ov, override, 255).to(torch.uint8)
    return rgb, a


def _centre_rays(cam: Camera, rows: int, cols: int, pixel_aspect, device,
                 row_lo: int = 0, n_rows: int | None = None):
    """(basis, px, py, aspect, rd0): the host camera basis, the NDC cell
    centres and the centre-ray directions f32 [band, cols, 3] on
    ``device``, of the row band [row_lo, row_lo + n_rows) of the rows x
    cols grid (all rows by default)."""
    basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    px, py, aspect = ndc_grid(rows, cols, pixel_aspect, device, row_lo,
                              n_rows)
    return basis, px, py, aspect, ray_grid(px, py, basis)


def primary_ray_grid(cam: Camera, rows: int, cols: int, pixel_aspect,
                     row_lo=0, n_rows: int | None = None, device="cuda"):
    """Centre-ray grid (ro, rd, px, py) for the PT camera mapping
    (pathtrace_shader.js:195-201): ro/rd f32 [band, cols, 3], px/py f32
    [band, cols] on ``device``, the row band [row_lo, row_lo + n_rows) of
    the rows x cols grid (all rows by default; a band equals those rows of
    the full grid bit for bit); the basis comes from the host camera."""
    _basis, px, py, _aspect, rd0 = _centre_rays(cam, rows, cols,
                                                pixel_aspect, device, row_lo,
                                                n_rows)
    ro0 = cam.pos.to(device=device, dtype=torch.float32).expand(
        px.shape[0], cols, 3)
    return ro0, rd0, px, py


def frame_seed_of(frame_idx: int) -> int:
    """The kernel seed of frame ``frame_idx``: the int32 view of the last
    word of JAX's key data for ``jax.random.key(frame_idx)``, which is
    the index itself."""
    return PK.int32_wrap(frame_idx)


def batch_seed_of(frame_seed: int, b: int) -> int:
    """Seed of sample batch ``b``: a golden-ratio int32 stride from the
    frame seed (wraps like the reference's int32 arithmetic)."""
    return PK.int32_wrap(frame_seed + (b + 1) * _GOLDEN)


def render_pt(scene: SceneData, cam: Camera, time, frame_seed=None, *,
              rows: int, cols: int, pixel_aspect: float, spp: int,
              bounces: int, light_color, nee: bool = True,
              sample_batch: int = 32, use_kernel: bool = True, key=None,
              row_lo=0, n_rows: int | None = None, pixel_active=None,
              packed=None, light_host=None, device=None):
    """Full mainImage (pathtrace_shader.js:187-263): a centre-ray probe
    decides each pixel's fetched flag and primary glyph override; then
    ceil(spp / B) batches of B = min(sample_batch, spp) samples, where
    sample 0 re-traces the centre ray and samples > 0 jitter unless the
    pixel fetched a texel; the first overriding sample replaces the total.
    Returns (rgb f32 [rows, cols, 3] in [0, 1], alpha u8 [rows, cols]) on
    ``device`` (default: the scene's device).

    ``row_lo`` / ``n_rows`` render the row band [row_lo, row_lo + n_rows)
    of the rows x cols frame ([n_rows, cols]; the camera mapping and the
    jitter scale stay the full frame's). On the kernel path a ray's RNG id
    is its pixel's global uid (and sample s's ray s * rows * cols more), so
    a band equals those rows of the full frame bit for bit, rgb and alpha;
    the core draws its threefry jitter and paths over the band's shape, as
    the reference's band does, so its radiance differs from the full
    frame's there.

    ``pixel_active`` (bool [band, cols], kernel path only; the reference
    ignores it on the core): the active pixels go first in the ray stream
    (a stable partition of the pixel uids), each ray carries its pixel's
    uid as its RNG id, and the kernel gates every 1,024-ray block with no
    active ray; the outputs return to pixel order through the inverse
    permutation. An active pixel's values are those of the full render bit
    for bit; an inactive one's are unspecified.

    ``use_kernel``: the megakernel path (True) or the XLA core (False,
    the reference's default; it takes atlases of any size). ``key``: the
    frame's key, two uint32 words (``jax.random.key_data`` of the
    reference's key, as numpy or a tensor); with it given, ``frame_seed``
    is the int32 view of its last word, as in the reference. Without it,
    ``frame_seed`` (``frame_seed_of``) is the kernel seed, and the core
    draws under ``key_data(frame_seed)``. ``packed`` and ``light_host``:
    the scene's pack_scene_entries and light_sphere_host, if precomputed
    (the core takes no pack)."""
    band = band_of(rows, row_lo, n_rows)
    if key is not None:
        key = TF.as_key(key)
        frame_seed = key[-1]
    elif frame_seed is None:
        raise ValueError("render_pt: pass key or frame_seed")
    dev = torch.device(device) if device is not None else \
        scene.sph_pos.device
    if not use_kernel:
        light = light_floats(scene, time, light_color, light_host)
        center, radius, rgb = (torch.tensor(v, dtype=torch.float32)
                               for v in (light[:3], light[3], light[4:7]))
        return _render_core(
            scene, cam, rows, cols, pixel_aspect, spp, bounces, rgb, nee,
            sample_batch, key or TF.key_data(int(frame_seed) & TF.M32),
            center, radius, dev, row_lo, n_rows)
    if packed is None:
        packed = pack_scene_entries(scene)
    frame_seed = PK.int32_wrap(frame_seed)
    B = max(1, min(sample_batch, spp))
    n_batches = -(-spp // B)
    pc = band * cols
    with record_function("pt.setup"):
        # host floats, passed by value: the camera read once, its basis on
        # Python floats, no copy to or from the card
        pose = camera_floats(cam)
        basis = camera_basis_floats(*pose[3:])
        light = light_floats(scene, time, light_color, light_host)
        blocks = _FrameRays(light, pose[:3], rows, cols, row_lo, band, B,
                            n_batches, pixel_active, dev)
        state = PR.new_state(pc, dev)
    kw = dict(bounces=bounces, nee=nee)
    rays = dict(row_lo=row_lo, n_rows=band, pix_uid=blocks.pix_uid,
                device=dev)

    # ---- phase 1: centre-ray probe (fetched flag + primary glyph hits) ----
    with record_function("pt.rays"):
        rd0 = pt_rays(basis, rows, cols, pixel_aspect, **rays)
    with record_function("pt.trace"):
        probe = blocks.trace(packed, rd0, frame_seed, 0, 1, **kw)
    fet0 = probe[4]  # the fetch flags: X7 jitters where not fet0 > 0.5

    # ---- phase 2: batched samples, folded into the state (X14); the last
    # batch's fold resolves the frame ----
    for b in range(n_batches):
        bs = batch_seed_of(frame_seed, b)
        with record_function("pt.rays"):
            rd = pt_rays(basis, rows, cols, pixel_aspect, **rays, fet0=fet0,
                         samples=B, s0=b * B, seed=bs)
        with record_function("pt.trace"):
            cr, cg, cb, ovf, _fet = blocks.trace(packed, rd, bs, b + 1, B,
                                                 **kw)
        last = b == n_batches - 1
        with record_function("pt.reduce"):
            out = PR.fold(state, cr, cg, cb, ovf, min(B, spp - b * B),
                          first=b == 0, probe=probe[:4] if last else None,
                          spp=spp, slot=blocks.slot)
    rgb, a = out
    return rgb.reshape(band, cols, 3), a.reshape(band, cols)


class _FrameRays:
    """What a kernel-path frame's megakernel launches share besides their
    directions, made once a frame: the light's 8 parameters and the
    camera position as host floats (the kernel's frame form takes them by
    value, ``ops/pt_kernel.trace_frame``), one zeroed ray counter a launch
    (the probe's and each batch's) and, for a compacted stream, its order
    ``slot`` (the pixel of each stream slot), the slots' pixel uids
    ``pix_uid`` (X7 and the megakernel form each ray's cell and RNG id
    from them) and the block gates by launch size, all from one call of
    X13's order form (``ops/partition.stable_order``), which zeroes the
    counters in the same launch. A full frame or a band needs nothing
    else: the kernels form a ray's uid from uid0 = row_lo * cols (s * rows
    * cols + uid0 + p for sample s of slot p), so its set-up is the
    counters' one fill. ``light`` and ``origin``: light_floats' 8 and the
    camera position's 3 floats."""

    def __init__(self, light, origin, rows: int, cols: int, row_lo: int,
                 band: int, samples: int, n_batches: int, pixel_active,
                 dev):
        self.light = light
        self.origin = list(origin)
        self.pc, self.npix, self.uid0 = band * cols, rows * cols, row_lo * cols
        self.pix_uid = self.slot = None
        self._gates = {}  # a compacted launch's block gates, by samples
        if pixel_active is None:
            self.counters = torch.zeros(n_batches + 1, dtype=torch.int32,
                                        device=dev)
        else:
            # adaptive compaction: a stable partition of the band's pixels,
            # active first; X7 and the megakernel take each slot's pixel
            # uid, the gates skip the blocks past the actives
            act = pixel_active.to(device=dev)
            if act.dtype != torch.bool:
                act = act != 0
            self.counters = torch.empty(n_batches + 1, dtype=torch.int32,
                                        device=dev)
            self.slot, self.pix_uid, self._gates = PTN.stable_order(
                act, self.uid0, samples, zero=self.counters)

    def trace(self, packed, rd, seed, i: int, samples: int, *, bounces: int,
              nee: bool):
        """The megakernel's outputs (lor, log, lob, ov, fet), each f32
        [nblk, 8, 128], of ``samples`` samples' rays rd f32 [nblk, 8, 128,
        3] (X7's stream) under seed, on launch i's counter; packed:
        pack_scene_entries(scene)."""
        prim, atlas, aw, ah, sph_rows = packed
        return PK.trace_frame(
            self.light, self.origin, prim, rd, int(seed), atlas, pc=self.pc,
            npix=self.npix, uid0=self.uid0, pix_uid=self.pix_uid,
            bounces=bounces, nee=nee, atlas_w=aw, atlas_h=ah,
            sph_rows=sph_rows, block_active=self._gates.get(samples),
            counter=self.counters[i:i + 1])


class PathtraceBackend:
    """Backend-protocol wrapper (contract 5): frame ``i`` of a backend
    draws under ``jax.random.key(i)``'s data (0, i), as the JAX backend's
    frames do; a scene whose atlas is above MAX_ATLAS_TEXELS renders
    through the XLA core, any other through the megakernel."""

    name = "pathtrace"

    def __init__(self, cfg=None, device="cuda"):
        from ascii_renderer_tpu_torch.core.config import Config
        self.cfg = cfg or Config()
        self.device = torch.device(device)
        self._scene: SceneData | None = None
        self._packed = None
        self._light = None
        self._frame_idx = 0

    def set_scene(self, scene: SceneData):
        """Pack the entry stream and atlas once per scene, on the
        backend's device, and read the light sphere's fixed values. A
        device named without an index ("cuda") takes the scene's."""
        dev = scene.sph_pos.device
        if dev.type != self.device.type or self.device.index not in (
                None, dev.index):
            raise ValueError(f"PathtraceBackend on {self.device} got a scene "
                             f"on {dev}")
        self.device = dev
        self._scene = scene
        self._packed = pack_scene_entries(scene)
        self._light = light_sphere_host(scene)

    def render(self, time_sec, camera: Camera, rows: int, cols: int,
               pixel_aspect: float = 1.0) -> Frame:
        if self._scene is None:
            return Frame.blank(rows, cols, device=self.device)
        pt = self.cfg.path_tracer
        key = TF.key_data(self._frame_idx)
        self._frame_idx += 1
        # the megakernel unless the atlas is above its budget (the XLA
        # core then, on every device), as the reference routes
        rgb, a = render_pt(
            self._scene, camera, time_sec, key=key, rows=rows, cols=cols,
            pixel_aspect=pixel_aspect, spp=pt.samples_per_batch,
            bounces=pt.max_bounces, light_color=pt.light_color,
            nee=pt.direct_light_sampling, use_kernel=atlas_ok(self._scene),
            packed=self._packed, light_host=self._light, device=self.device)
        with record_function("frame.from_float"):
            return Frame.from_float(rgb, a)

    def dispose(self):
        self._scene = None
        self._packed = None
        self._light = None
