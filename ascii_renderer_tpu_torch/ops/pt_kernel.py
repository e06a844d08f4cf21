"""The path-trace megakernel: the CUDA kernel ``csrc/pt_trace.cu`` (replaces
the Pallas ``ascii_renderer_tpu/ops/pt_kernel.py:_kernel`` /
``_kernel_body``) and its plain-torch version.

Each ray runs the whole path (``bounces`` segments: nearest hit over the
primitive entries and the analytic light sphere, environment on miss,
light hits on specular-or-primary paths, the primary glyph override,
cosine / Fresnel BRDF sampling, next-event estimation toward the light
sphere, Russian roulette from bounce 2) and writes its radiance, override
byte and primary-fetch flag.

RNG: draw ``k`` of a ray is ``hash_unit(uid, seed, k)``, a lowbias32
avalanche of (ray uid, seed, k), so the noise a ray sees depends only on
its uid and the seed, never on where it sits in the stream. ``k`` counts
the draw sites in trace order (see ``draw_index``): per bounce u1, u2
(BRDF), u3 (Fresnel), then h1, h2 if NEE runs at that bounce, then u4 if
Russian roulette does. A static count, not a per-ray counter, so a ray
that leaves the loop early skips nothing.

Entry stream: 32 float32 channels per entry (spheres first, then
triangles; the layout below), four entries per 128-wide row as the JAX
packer writes them. The atlas is one packed rgba texel per int32
((r << 24) | (g << 16) | (b << 8) | a), up to ``MAX_ATLAS_TEXELS``.

Arithmetic follows the reference term by term, every product and sum
rounded on its own (the kernel is built with ``-fmad=false``), IEEE
division (``torch.reciprocal``, ``fdiv``: never ``tensor / float``) and
sqrt (``core/fp.sqrt32``: torch's CPU float32 sqrt is not correctly
rounded), ``x ** 5`` as JAX's ``integer_pow`` multiply chain
``x * ((x * x) * (x * x))``, ``x ** 1.2`` as ``pow`` and ``rsqrt`` as
``1 / sqrt``.
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core.fp import sqrt32
from ascii_renderer_tpu_torch.core.quantize import fdiv
from ascii_renderer_tpu_torch.ops import _build

launches = 0        # kernel launches by trace_blocks_raw and trace_frame
launches_gated = 0  # of those, launches with a block gate (block_active)
LAUNCHES_PER_CALL = {"trace_blocks_raw": 1, "trace_frame": 1}

BH, BW = 8, 128     # the TPU's ray block; block_active gates 1,024 rays
BLOCK = BH * BW
N_CHAN = 32
PACK = 4            # entries per 128-wide row of the packed stream
MAX_ATLAS_TEXELS = 65536

# entry channels (shared by spheres and tris; unused fields zero)
# kind: 0 = inert, 1 = sphere, 2 = triangle
C_KIND = 0
C_AX, C_AY, C_AZ = 1, 2, 3          # sphere center | tri unit normal
C_E1X = 4                           # sphere radius | tri plane offset n.a
C_NX, C_NY, C_NZ = 1, 2, 3
C_D0 = 4
C_R1X, C_R1Y, C_R1Z = 5, 6, 7       # u = r1 . p + c1
C_C1 = 8
C_R2X, C_R2Y, C_R2Z = 9, 22, 23     # v = r2 . p + c2
C_C2, C_BADS = 24, 25
C_SHR, C_SHG, C_SHB = 10, 11, 12    # shading albedo (LUT semantics)
C_ISLIGHT, C_ISSPEC, C_TEXTURABLE = 13, 14, 15
C_UVAX, C_UVAY, C_UVBX, C_UVBY, C_UVCX, C_UVCY = 16, 17, 18, 19, 20, 21

BIG = 3e38
TWO_PI = 6.2831853
INV255 = 1.0 / 255.0

_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# RNG (shared with backends/pathtrace's jitter)
# --------------------------------------------------------------------------
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): two 16-bit halves of c,
    so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_key(seed: int, ctr: int) -> int:
    """The draw's key (seed * 0x9E3779B1 + ctr * 0x85EBCA6B) mod 2**32."""
    return ((int(seed) & _M32) * 0x9E3779B1
            + (int(ctr) & _M32) * 0x85EBCA6B) & _M32


def hash_unit(uid: torch.Tensor, seed: int, ctr: int) -> torch.Tensor:
    """U[0,1) as a pure function of (ray uid, seed, counter): the lowbias32
    avalanche of uid ^ (seed * 0x9E3779B1 + ctr * 0x85EBCA6B) on uint32,
    its top 23 bits as a float in [1, 2), minus 1. Computed in int64 with
    the 32-bit wrap made explicit (torch has no uint32 arithmetic)."""
    x = (uid.to(torch.int64) & _M32) ^ hash_key(seed, ctr)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    mant = (x >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def draws_per_bounce(j: int, bounces: int, nee: bool) -> int:
    return 3 + (2 if nee and j < bounces - 1 else 0) + (1 if j >= 2 else 0)


def draw_index(j: int, site: str, bounces: int, nee: bool) -> int:
    """The static draw counter of ``site`` (u1, u2, u3, h1, h2, u4) in
    bounce ``j``: draws are numbered 1, 2, ... in trace order."""
    base = sum(draws_per_bounce(i, bounces, nee) for i in range(j))
    has_nee = nee and j < bounces - 1
    order = ["u1", "u2", "u3"] + (["h1", "h2"] if has_nee else []) + (
        ["u4"] if j >= 2 else [])
    return base + 1 + order.index(site)


def int32_wrap(x: int) -> int:
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


# --------------------------------------------------------------------------
# plain torch version
# --------------------------------------------------------------------------
def _pow5(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    return x * (x2 * x2)         # lax.integer_pow(x, 5)


def _stream(ent: torch.Tensor, n_sph: int, o, d, eps, want_attrs: bool):
    """Nearest entry hit for every ray: t f32 [N] (BIG on a miss) and, with
    want_attrs, the winner's (nx, ny, nz, shr, shg, shb, is_light,
    is_spec, texturable, uvx, uvy). ent f32 [E, N_CHAN]. The winner is the
    first entry with the smallest t < BIG, as the kernel's running strict
    minimum over the entries in stream order keeps it."""
    ox, oy, oz = o
    dx, dy, dz = d
    n = ox.shape[0]
    dev = ox.device
    E = ent.shape[0]

    def ch(c, lo, hi):
        return ent[lo:hi, c, None]          # [e, 1] against rays [N]

    ts = []
    aux = {}
    if n_sph:
        live = ch(C_KIND, 0, n_sph) > 0.0
        ax, ay, az = (ch(c, 0, n_sph) for c in (C_AX, C_AY, C_AZ))
        rad = ch(C_E1X, 0, n_sph)
        ocx, ocy, ocz = ox - ax, oy - ay, oz - az
        b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        h = b * b - c
        sq = sqrt32(torch.clamp(h, min=0.0))
        t1 = -b - sq
        t2 = -b + sq
        t = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, BIG))
        ts.append(torch.where((h >= 0.0) & live, t, BIG))
    if E > n_sph:
        live = ch(C_KIND, n_sph, E) > 0.0
        nx_, ny_, nz_ = (ch(c, n_sph, E) for c in (C_NX, C_NY, C_NZ))
        ndotd = nx_ * dx + ny_ * dy + nz_ * dz
        bad = torch.abs(ndotd) < ch(C_BADS, n_sph, E)
        inv = torch.reciprocal(torch.where(bad, 1.0, ndotd))
        ndoto = nx_ * ox + ny_ * oy + nz_ * oz
        t = (ch(C_D0, n_sph, E) - ndoto) * inv
        hpx, hpy, hpz = ox + t * dx, oy + t * dy, oz + t * dz
        u = (ch(C_R1X, n_sph, E) * hpx + ch(C_R1Y, n_sph, E) * hpy
             + ch(C_R1Z, n_sph, E) * hpz + ch(C_C1, n_sph, E))
        v = (ch(C_R2X, n_sph, E) * hpx + ch(C_R2Y, n_sph, E) * hpy
             + ch(C_R2Z, n_sph, E) * hpz + ch(C_C2, n_sph, E))
        miss = (bad | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
                | (t <= eps) | ~live)
        ts.append(torch.where(miss, BIG, t))
        aux = {"ndotd": ndotd, "u": u, "v": v}
    tall = torch.cat(ts, dim=0)                         # [E, N]
    # NaN never wins a strict t < best; BIG never beats the initial BIG
    tz = torch.where(torch.isnan(tall), BIG, tall)
    k = torch.argmin(tz, dim=0)                         # first minimum
    t = tz.gather(0, k[None])[0]
    won = t < BIG
    t = torch.where(won, t, BIG)
    if not want_attrs:
        return t, None

    def at(c):
        return ent[:, c][k]                             # winner's channel

    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    is_sph = k < n_sph
    # sphere winner: normal from the hit point
    inv_r = torch.reciprocal(torch.clamp(at(C_E1X), min=1e-6))
    s_n = [(oo + t * dd - at(c)) * inv_r
           for oo, dd, c in ((ox, dx, C_AX), (oy, dy, C_AY), (oz, dz, C_AZ))]
    if aux:
        kt = torch.clamp(k - n_sph, min=0)[None]
        ndotd_w = aux["ndotd"].gather(0, kt)[0]
        u_w = aux["u"].gather(0, kt)[0]
        v_w = aux["v"].gather(0, kt)[0]
        flip = ndotd_w > 0.0
        t_n = [torch.where(flip, -at(c), at(c)) for c in (C_NX, C_NY, C_NZ)]
        w0 = 1.0 - u_w - v_w
        uvx = w0 * at(C_UVAX) + u_w * at(C_UVBX) + v_w * at(C_UVCX)
        uvy = w0 * at(C_UVAY) + u_w * at(C_UVBY) + v_w * at(C_UVCY)
        texturable = at(C_TEXTURABLE)
    else:
        t_n = [zero, zero, zero]
        uvx = uvy = texturable = zero
    nrm = [torch.where(is_sph, a, b) for a, b in zip(s_n, t_n)]
    vals = nrm + [at(C_SHR), at(C_SHG), at(C_SHB), at(C_ISLIGHT),
                  at(C_ISSPEC), torch.where(is_sph, 0.0, texturable),
                  torch.where(is_sph, 0.0, uvx),
                  torch.where(is_sph, 0.0, uvy)]
    return t, [torch.where(won, val, zero) for val in vals]


def _atlas_fetch(atlas: torch.Tensor, uvx, uvy, aw: int, ah: int):
    """Nearest-texel fetch: (r, g, b in 0..1, alpha byte as f32, in
    bounds). Out-of-bounds rays read texel 0; no caller uses that value."""
    tx = torch.floor(uvx + 0.5)
    ty = torch.floor(uvy + 0.5)
    inb = (tx >= 0) & (tx < aw) & (ty >= 0) & (ty < ah)
    lin = torch.where(inb, ty * aw + tx, 0.0).to(torch.int64)
    x = atlas[lin].to(torch.int64) & _M32

    def byte(shift):
        return ((x >> shift) & 255).to(torch.float32)

    return (byte(24) * INV255, byte(16) * INV255, byte(8) * INV255,
            byte(0), inb)


def trace_blocks_raw_ref(params, prim, ro, rd, seed, atlas, *, bounces: int,
                         nee: bool, atlas_w: int, atlas_h: int,
                         sph_rows: int, block_active=None, uid=None,
                         stats: dict | None = None):
    """Plain-torch version of ``trace_blocks_raw``: the same per-ray
    arithmetic, vectorised over the rays and, inside each nearest-hit
    search, over the entries. ``stats``, if given, receives the work the
    kernel does on these inputs: ``segments`` (rays alive at a bounce's
    nearest-hit search), ``alive`` (the same per bounce) and
    ``shadow_rays`` (NEE shadow searches)."""
    nblk = ro.shape[0]
    n = nblk * BLOCK
    dev = ro.device
    ro = ro.reshape(n, 3)
    rd = rd.reshape(n, 3)
    ent = prim.reshape(-1, N_CHAN)
    n_sph = sph_rows * PACK
    texels = atlas_w * atlas_h if atlas_w > 0 else 0
    if uid is None:
        uid = torch.arange(n, dtype=torch.int32, device=dev)
    uid = uid.reshape(n)
    seed = int32_wrap(seed)
    lcx, lcy, lcz, lrad, lcr, lcg, lcb, eps = params.unbind(0)

    def uniform(j, site):
        return hash_unit(uid, seed, draw_index(j, site, bounces, nee))

    rox, roy, roz = ro.unbind(1)
    rdx, rdy, rdz = rd.unbind(1)
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    Lr, Lg, Lb = z, z, z
    Tr = Tg = Tb = torch.ones_like(z)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    spec = torch.ones_like(alive)
    override = z
    fetched = torch.zeros_like(alive)

    live_rays = torch.ones_like(alive)
    if block_active is not None:
        live_rays = (block_active.reshape(nblk) != 0).repeat_interleave(BLOCK)
    per_bounce = []
    shadow_rays = 0
    for j in range(bounces):
        if stats is not None:
            per_bounce.append(int((alive & live_rays).sum()))
        t, a = _stream(ent, n_sph, (rox, roy, roz), (rdx, rdy, rdz), eps,
                       True)
        nx, ny, nz, shr, shg, shb, isl_f, iss_f, tex_f, uvx, uvy = a
        is_spec = iss_f > 0.5
        # light sphere (analytic, not in the entry list)
        ocx, ocy, ocz = rox - lcx, roy - lcy, roz - lcz
        b = ocx * rdx + ocy * rdy + ocz * rdz
        c = ocx * ocx + ocy * ocy + ocz * ocz - lrad * lrad
        h = b * b - c
        sq = sqrt32(torch.clamp(h, min=0.0))
        t1 = -b - sq
        t2 = -b + sq
        t_l = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, BIG))
        t_l = torch.where(h >= 0.0, t_l, BIG)
        lwin = t_l < t
        t = torch.where(lwin, t_l, t)
        is_light = (isl_f > 0.5) | lwin

        hit = t < 1e30
        # env on miss (shader_utils.js:20-25)
        tt = torch.pow(torch.clamp(rdy * 0.5 + 0.5, 0.0, 1.0), 1.2)
        s = torch.clamp(fdiv(rdy + 0.05, 0.1), 0.0, 1.0)
        s = s * s * (3.0 - 2.0 * s)
        er = 0.063 * (1 - s) + (0.90 * (1 - tt) + 0.45 * tt) * s
        eg = 0.0525 * (1 - s) + (0.95 * (1 - tt) + 0.65 * tt) * s
        eb = 0.042 * (1 - s) + (1.00 * (1 - tt) + 0.95 * tt) * s
        miss = alive & ~hit
        Lr = torch.where(miss, Lr + Tr * er, Lr)
        Lg = torch.where(miss, Lg + Tg * eg, Lg)
        Lb = torch.where(miss, Lb + Tb * eb, Lb)
        alive = alive & hit

        lt = alive & is_light & spec
        Lr = torch.where(lt, Lr + Tr * lcr, Lr)
        Lg = torch.where(lt, Lg + Tg * lcg, Lg)
        Lb = torch.where(lt, Lb + Tb * lcb, Lb)
        alive = alive & ~is_light

        hx, hy, hz = rox + t * rdx, roy + t * rdy, roz + t * rdz

        if texels > 0:
            txr, txg, txb, ab, inb = _atlas_fetch(atlas, uvx, uvy, atlas_w,
                                                  atlas_h)
            sampled = alive & (tex_f > 0.5) & inb & (ab >= 0.5)
            glyph = sampled & (ab >= 31.5) & (ab <= 126.5)
            if j == 0:
                fetched = sampled
                Lr = torch.where(glyph, txr, Lr)
                Lg = torch.where(glyph, txg, Lg)
                Lb = torch.where(glyph, txb, Lb)
                override = torch.where(glyph, ab, override)
                alive = alive & ~glyph
                solid = sampled & (ab < 1.5)
            else:
                solid = sampled  # solid OR glyph-truncated-to-solid
            shr = torch.where(solid, txr, shr)
            shg = torch.where(solid, txg, shg)
            shb = torch.where(solid, txb, shb)

        # ---- next direction (BRDF) ----
        u1 = uniform(j, "u1")
        u2 = uniform(j, "u2")
        phi = TWO_PI * u1
        s2 = sqrt32(1.0 - u2)
        ny_ok = torch.abs(ny) < 0.999
        axx = torch.where(ny_ok, 0.0, 1.0)
        axy = torch.where(ny_ok, 1.0, 0.0)
        ux_ = ny * 0.0 - nz * axy
        uy_ = nz * axx - nx * 0.0
        uz_ = nx * axy - ny * axx
        uinv = torch.reciprocal(sqrt32(torch.clamp(
            ux_ * ux_ + uy_ * uy_ + uz_ * uz_, min=1e-24)))
        ux_, uy_, uz_ = ux_ * uinv, uy_ * uinv, uz_ * uinv
        vx_ = uy_ * nz - uz_ * ny
        vy_ = uz_ * nx - ux_ * nz
        vz_ = ux_ * ny - uy_ * nx
        cp_ = s2 * torch.cos(phi)
        sp_ = s2 * torch.sin(phi)
        sr2 = sqrt32(u2)
        ddx = cp_ * ux_ + sp_ * vx_ + sr2 * nx
        ddy = cp_ * uy_ + sp_ * vy_ + sr2 * ny
        ddz = cp_ * uz_ + sp_ * vz_ + sr2 * nz
        dinv = torch.reciprocal(sqrt32(torch.clamp(
            ddx * ddx + ddy * ddy + ddz * ddz, min=1e-24)))
        ddx, ddy, ddz = ddx * dinv, ddy * dinv, ddz * dinv

        # specular branch (shader_utils.js:216-229)
        ndotr = rdx * nx + rdy * ny + rdz * nz
        flip = ndotr > 0.0
        eta = torch.where(flip, 1.5, 1.0 / 1.5)
        nnx = torch.where(flip, -nx, nx)
        nny = torch.where(flip, -ny, ny)
        nnz = torch.where(flip, -nz, nz)
        fres = 0.04 + (1.0 - 0.04) * _pow5(1.0 - torch.abs(ndotr))
        cosi = nnx * rdx + nny * rdy + nnz * rdz
        kk = 1.0 - eta * eta * (1.0 - cosi * cosi)
        tir = kk < 0.0
        f = eta * cosi + sqrt32(torch.clamp(kk, min=0.0))
        rfx, rfy, rfz = eta * rdx - f * nnx, eta * rdy - f * nny, \
            eta * rdz - f * nnz
        u3 = uniform(j, "u3")
        use_reflect = tir | (u3 < fres)
        d2 = rdx * nnx + rdy * nny + rdz * nnz
        rlx = rdx - 2.0 * d2 * nnx
        rly = rdy - 2.0 * d2 * nny
        rlz = rdz - 2.0 * d2 * nnz
        sx_ = torch.where(use_reflect, rlx, rfx)
        sy_ = torch.where(use_reflect, rly, rfy)
        sz_ = torch.where(use_reflect, rlz, rfz)
        sinv = torch.reciprocal(sqrt32(torch.clamp(
            sx_ * sx_ + sy_ * sy_ + sz_ * sz_, min=1e-24)))
        sx_, sy_, sz_ = sx_ * sinv, sy_ * sinv, sz_ * sinv

        ndx = torch.where(is_spec, sx_, ddx)
        ndy = torch.where(is_spec, sy_, ddy)
        ndz = torch.where(is_spec, sz_, ddz)

        ndn = ndx * nx + ndy * ny + ndz * nz
        absorb = alive & (~is_spec | (ndn < 0.0))
        Tr = torch.where(absorb, Tr * shr, Tr)
        Tg = torch.where(absorb, Tg * shg, Tg)
        Tb = torch.where(absorb, Tb * shb, Tb)

        # ---- NEE (pathtrace_shader.js:159-169) ----
        if nee and j < bounces - 1:
            if stats is not None:
                shadow_rays += int((alive & ~is_spec & live_rays).sum())
            h1 = uniform(j, "h1") * 2.0 - 1.0
            h2 = uniform(j, "h2") * TWO_PI
            sl = sqrt32(torch.clamp(1.0 - h1 * h1, min=0.0))
            lpx = lcx + lrad * sl * torch.sin(h2)
            lpy = lcy + lrad * sl * torch.cos(h2)
            lpz = lcz + lrad * h1
            ldx, ldy, ldz = lpx - hx, lpy - hy, lpz - hz
            dist = sqrt32(torch.clamp(
                ldx * ldx + ldy * ldy + ldz * ldz, min=1e-24))
            ldx, ldy, ldz = ldx / dist, ldy / dist, ldz / dist
            so = (hx + nx * eps, hy + ny * eps, hz + nz * eps)
            t_sh, _ = _stream(ent, n_sph, so, (ldx, ldy, ldz), eps, False)
            shadowed = t_sh < dist
            dlx, dly, dlz = lcx - hx, lcy - hy, lcz - hz
            dd2 = torch.clamp(dlx * dlx + dly * dly + dlz * dlz, min=1e-12)
            cam = sqrt32(1.0 - torch.clamp(lrad * lrad / dd2, 0.0, 1.0))
            wgt = 2.0 * (1.0 - cam)
            ndl = torch.clamp(ldx * nx + ldy * ny + ldz * nz, min=0.0)
            contrib = alive & ~is_spec & ~shadowed
            wnd = wgt * ndl
            Lr = torch.where(contrib, Lr + Tr * lcr * wnd, Lr)
            Lg = torch.where(contrib, Lg + Tg * lcg * wnd, Lg)
            Lb = torch.where(contrib, Lb + Tb * lcb * wnd, Lb)

        side = torch.where(ndn > 0.0, eps, -eps)
        rox = torch.where(alive, hx + nx * side, rox)
        roy = torch.where(alive, hy + ny * side, roy)
        roz = torch.where(alive, hz + nz * side, roz)
        rdx = torch.where(alive, ndx, rdx)
        rdy = torch.where(alive, ndy, rdy)
        rdz = torch.where(alive, ndz, rdz)
        spec = torch.where(alive, is_spec, spec)

        if j >= 2:  # Russian roulette
            pmax = torch.clamp(torch.maximum(Tr, torch.maximum(Tg, Tb)),
                               0.05, 0.95)
            u4 = uniform(j, "u4")
            alive = alive & ~(u4 > pmax)
            ipm = torch.reciprocal(pmax)
            Tr = torch.where(alive, Tr * ipm, Tr)
            Tg = torch.where(alive, Tg * ipm, Tg)
            Tb = torch.where(alive, Tb * ipm, Tb)

    if stats is not None:
        stats.update(segments=sum(per_bounce), alive=per_bounce,
                     shadow_rays=shadow_rays)
    outs = [Lr, Lg, Lb, override, fetched.to(torch.float32)]
    if block_active is not None:
        outs = [torch.where(live_rays, o, 0.0) for o in outs]
    return tuple(o.reshape(nblk, BH, BW) for o in outs)


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------
def blockify(a: torch.Tensor, n: int, nblk: int) -> torch.Tensor:
    """The first n vectors of a [..., 3] as the kernel's ray block f32
    [nblk, BH, BW, 3], the rays past n zero."""
    flat = a.reshape(n, 3)
    pad = nblk * BLOCK - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, 3))])
    return flat.reshape(nblk, BH, BW, 3).contiguous()


def _check(prim, rd, atlas, atlas_w, atlas_h, sph_rows, block_active, uid,
           what="trace_blocks_raw"):
    nblk = rd.shape[0]
    if rd.shape != (nblk, BH, BW, 3):
        raise ValueError(f"{what}: rd must be [B, {BH}, {BW}, 3], got "
                         f"{tuple(rd.shape)}")
    if prim.dim() != 2 or prim.shape[1] != PACK * N_CHAN:
        raise ValueError(f"{what}: prim must be [rows, {PACK * N_CHAN}], "
                         f"got {tuple(prim.shape)}")
    if not 0 <= sph_rows <= prim.shape[0]:
        raise ValueError(f"{what}: sph_rows {sph_rows} out of range")
    texels = atlas_w * atlas_h if atlas_w > 0 else 0
    if texels > MAX_ATLAS_TEXELS:
        raise ValueError(
            f"{what}: a {atlas_w}x{atlas_h} atlas is above the "
            f"kernel's budget, MAX_ATLAS_TEXELS = {MAX_ATLAS_TEXELS}; the "
            f"XLA core takes it (backends/pathtrace.trace_eye_paths, "
            f"render_pt(use_kernel=False))")
    if texels and (atlas.dtype != torch.int32 or atlas.numel() < texels):
        raise ValueError(f"{what}: atlas must be int32 rgba with at least "
                         f"{texels} texels")
    if block_active is not None and block_active.numel() != nblk:
        raise ValueError(f"{what}: block_active must have B entries")
    if uid is not None and uid.numel() != nblk * BLOCK:
        raise ValueError(f"{what}: uid must have one id per ray")
    return nblk, texels


def trace_blocks_raw(params, prim, ro, rd, seed, atlas, *, bounces: int,
                     nee: bool, atlas_w: int, atlas_h: int, sph_rows: int,
                     block_active=None, uid=None, counter=None):
    """params f32 [8] (light centre xyz, radius, colour rgb, eps); prim f32
    [rows, 128], sphere rows first (``sph_rows`` of them); ro/rd f32
    [B, 8, 128, 3]; seed int (int32 value); atlas int32 [>= texels] packed
    rgba (ignored when atlas_w = 0). block_active: optional int [B], a 0
    gates the 1,024 rays of that block (outputs zero). uid: optional int32
    [B, 8, 128] RNG ids (default: the ray's stream position).

    Returns (lor, log, lob, ov, fet), each f32 [B, 8, 128]. CPU tensors run
    the plain version; CUDA tensors launch the kernel once (persistent
    warps that take rays from a counter: ``counter``, an int32 CUDA tensor
    whose first element is 0, which the launch uses up; by default the
    wrapper zeroes one, a launch of its own)."""
    if ro.shape != rd.shape or rd.shape[1:] != (BH, BW, 3):
        raise ValueError(f"trace_blocks_raw: ro/rd must be [B, {BH}, {BW}, "
                         f"3], got {tuple(ro.shape)} / {tuple(rd.shape)}")
    if params.shape != (8,):
        raise ValueError("trace_blocks_raw: params must be f32 [8]")
    nblk, texels = _check(prim, rd, atlas, atlas_w, atlas_h, sph_rows,
                          block_active, uid)
    if ro.device.type == "cpu":
        return trace_blocks_raw_ref(
            params, prim, ro, rd, seed, atlas, bounces=bounces, nee=nee,
            atlas_w=atlas_w, atlas_h=atlas_h, sph_rows=sph_rows,
            block_active=block_active, uid=uid)
    global launches, launches_gated
    tensors = [params, prim, ro, rd]
    if texels:
        tensors.append(atlas)
    if block_active is not None:
        block_active = block_active.to(torch.int32).contiguous()
        tensors.append(block_active)
    if uid is not None:
        uid = uid.to(torch.int32).contiguous()
        tensors.append(uid)
    _build.require_cuda(*tensors, what="trace_blocks_raw")
    if any(t.dtype != torch.float32 for t in (params, prim, ro, rd)):
        raise ValueError("trace_blocks_raw: params/prim/ro/rd must be float32")
    n = nblk * BLOCK
    outs = [torch.empty((nblk, BH, BW), dtype=torch.float32, device=ro.device)
            for _ in range(5)]
    if counter is None:
        next_ray = torch.zeros(1, dtype=torch.int32, device=ro.device)
    else:
        if counter.dtype != torch.int32 or counter.numel() < 1:
            raise ValueError("trace_blocks_raw: counter must be int32 with "
                             "one element at least")
        next_ray = counter
        _build.require_cuda(ro, next_ray, what="trace_blocks_raw")
    err = _build.lib().pt_trace_launch(
        params.data_ptr(), prim.data_ptr(), prim.shape[0] * PACK,
        sph_rows * PACK, ro.data_ptr(), rd.data_ptr(),
        uid.data_ptr() if uid is not None else None,
        block_active.data_ptr() if block_active is not None else None,
        int32_wrap(seed), atlas.data_ptr() if texels else None,
        atlas_w if texels else 0, atlas_h if texels else 0,
        *(o.data_ptr() for o in outs), n, int(bounces), int(bool(nee)),
        next_ray.data_ptr(), _build.stream_ptr(ro.device))
    launches += 1
    if block_active is not None:
        launches_gated += 1
    _build.check(err, "pt_trace_launch")
    return tuple(outs)


# --------------------------------------------------------------------------
# the frame form: one origin and the light by value, uids from the stream
# --------------------------------------------------------------------------
def frame_uids(nblk: int, pc: int, npix: int, uid0: int = 0, pix_uid=None,
               device="cpu") -> torch.Tensor:
    """int32 [nblk, BH, BW]: the RNG id of each ray of a frame's launch,
    ray r = s * pc + p (sample s of stream slot p) taking s * npix +
    pix_uid[p], or s * npix + uid0 + p without ``pix_uid`` (int32 [pc]),
    as the frame form of the kernel forms them (int32 wrap-around)."""
    r = torch.arange(nblk * BLOCK, dtype=torch.int64, device=device)
    s = r // pc
    p = r - s * pc
    base = pix_uid.to(torch.int64)[p] if pix_uid is not None else uid0 + p
    uid = (s * npix + base) & _M32
    return torch.where(uid >= 2 ** 31, uid - 2 ** 32, uid).to(
        torch.int32).reshape(nblk, BH, BW)


def _frame_args(light, origin, pc, npix, pix_uid, what):
    light = [float(x) for x in light]
    origin = [float(x) for x in origin]
    if len(light) != 8 or len(origin) != 3:
        raise ValueError(f"{what}: light is 8 floats (centre, radius, "
                         f"colour, eps) and origin 3")
    if pc < 1 or npix < 1:
        raise ValueError(f"{what}: pc and npix must be positive")
    if pix_uid is not None and (pix_uid.dtype != torch.int32
                                or pix_uid.numel() != pc):
        raise ValueError(f"{what}: pix_uid must be int32 [{pc}]")
    return light, origin


def trace_frame_ref(light, origin, prim, rd, seed, atlas, *, pc: int,
                    npix: int, uid0: int = 0, pix_uid=None, bounces: int,
                    nee: bool, atlas_w: int, atlas_h: int, sph_rows: int,
                    block_active=None, stats: dict | None = None):
    """Plain version of ``trace_frame``: the per-ray plain version on the
    light as a tensor, the origin expanded to every ray and the uids of
    ``frame_uids``, so the two forms give the same bits on the same
    rays."""
    light, origin = _frame_args(light, origin, pc, npix, pix_uid,
                                "trace_frame")
    dev = rd.device
    nblk = rd.shape[0]
    ro = torch.tensor(origin, dtype=torch.float32, device=dev).expand(
        nblk, BH, BW, 3)
    return trace_blocks_raw_ref(
        torch.tensor(light, dtype=torch.float32, device=dev), prim, ro, rd,
        seed, atlas, bounces=bounces, nee=nee, atlas_w=atlas_w,
        atlas_h=atlas_h, sph_rows=sph_rows, block_active=block_active,
        uid=frame_uids(nblk, pc, npix, uid0, pix_uid, dev), stats=stats)


def trace_frame(light, origin, prim, rd, seed, atlas, *, pc: int, npix: int,
                uid0: int = 0, pix_uid=None, bounces: int, nee: bool,
                atlas_w: int, atlas_h: int, sph_rows: int, block_active=None,
                counter=None):
    """The megakernel over a kernel-path frame's rays, its frame form: the
    light's 8 parameters (centre xyz, radius, colour rgb, eps) and one
    origin for every ray as host floats, passed by value; rd f32 [B, 8,
    128, 3] in X7's stream (ray s * pc + p is sample s of stream slot p,
    ``ops/ray_grid.pt_rays``), each ray's RNG id formed from its place
    (``frame_uids``: npix = rows * cols, ``uid0`` = row_lo * cols, or the
    compacted order's ``pix_uid``). seed, atlas, block_active and counter
    as ``trace_blocks_raw``. Returns (lor, log, lob, ov, fet), each f32
    [B, 8, 128]. CPU tensors run the plain version (``trace_frame_ref``);
    CUDA tensors launch the kernel once and copy nothing to the card."""
    light, origin = _frame_args(light, origin, pc, npix, pix_uid,
                                "trace_frame")
    nblk, texels = _check(prim, rd, atlas, atlas_w, atlas_h, sph_rows,
                          block_active, None, "trace_frame")
    if rd.device.type == "cpu":
        return trace_frame_ref(
            light, origin, prim, rd, seed, atlas, pc=pc, npix=npix,
            uid0=uid0, pix_uid=pix_uid, bounces=bounces, nee=nee,
            atlas_w=atlas_w, atlas_h=atlas_h, sph_rows=sph_rows,
            block_active=block_active)
    global launches, launches_gated
    tensors = [prim, rd]
    if texels:
        tensors.append(atlas)
    if block_active is not None:
        block_active = block_active.to(torch.int32).contiguous()
        tensors.append(block_active)
    if pix_uid is not None:
        tensors.append(pix_uid)
    if any(t.dtype != torch.float32 for t in (prim, rd)):
        raise ValueError("trace_frame: prim/rd must be float32")
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32, device=rd.device)
    elif counter.dtype != torch.int32 or counter.numel() < 1:
        raise ValueError("trace_frame: counter must be int32 with one "
                         "element at least")
    _build.require_cuda(*tensors, counter, what="trace_frame")
    outs = [torch.empty((nblk, BH, BW), dtype=torch.float32, device=rd.device)
            for _ in range(5)]
    err = _build.lib().pt_trace_frame_launch(
        (ctypes.c_float * 8)(*light), (ctypes.c_float * 3)(*origin),
        prim.data_ptr(), prim.shape[0] * PACK, sph_rows * PACK,
        rd.data_ptr(), pix_uid.data_ptr() if pix_uid is not None else None,
        pc, npix, uid0,
        block_active.data_ptr() if block_active is not None else None,
        int32_wrap(seed), atlas.data_ptr() if texels else None,
        atlas_w if texels else 0, atlas_h if texels else 0,
        *(o.data_ptr() for o in outs), nblk * BLOCK, int(bounces),
        int(bool(nee)), counter.data_ptr(), _build.stream_ptr(rd.device))
    launches += 1
    if block_active is not None:
        launches_gated += 1
    _build.check(err, "pt_trace_frame_launch")
    return tuple(outs)
