"""Shared raster infrastructure: tile geometry and deferred row shading
(torch port of ``ascii_renderer_tpu/backends/raster_common.py``)."""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.scene.builder import SceneData

NEAR, FAR = 0.05, 100.0
_DEFAULT_DIR = (0.25, -1.0, 0.15)
_DEFAULT_DIR_COL = (1.2, 1.15, 1.1)

TILE_H, TILE_W = 8, 128


def _round_up(x, q):
    return -(-x // q) * q


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x), rounded once from float64: the same bits on the CPU and
    on CUDA (torch's CUDA rsqrt is an approximation). The reference's
    rsqrt is a CPU-specific estimate refined by one Newton step, which
    agrees with this to 1 ulp; shading is compared at the reference's own
    tolerance, and the headline frame's bytes are unchanged by it."""
    return torch.reciprocal(torch.sqrt(x.double())).float()


def _dot3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2 as the reference fuses it (core/fp.py)."""
    return fma32(a2, b2, fma32(a0, b0, a1 * b1))


def _shade_rows(g, hit, px, py, scene: SceneData, n_attrs: int):
    """Plane evaluation + reference fragment lighting over gathered pixel
    rows: g [R, W] gathered shade-table rows (channels as columns);
    hit/px/py pixel predicates/centres of any shape S with prod(S) = R.
    Returns rgb f32 [*S, 3]. Ambient + one directional (a default one when
    the scene has none) + the scene's point lights, unshadowed, with
    attenuation 1 / (1 + d^2 * 0.05) (raster_shader.js:42-62). Products
    that feed a sum are fused as the reference fuses them (core/fp.py)."""
    W = g.shape[1]
    gT = g.t().reshape((W,) + tuple(px.shape))        # [W, *S]
    dn = 3 * n_attrs
    # (a*px + b*py) + c: the left product fuses
    d = fma32(gT[dn], px, gT[dn + 1] * py) + gT[dn + 2]
    inv_d = torch.reciprocal(torch.where(d.abs() < 1e-12, 1e-12, d))

    def attr(j):
        return (fma32(gT[3 * j], px, gT[3 * j + 1] * py)
                + gT[3 * j + 2]) * inv_d

    nx, ny, nz = attr(0), attr(1), attr(2)
    cr, cg, cb = attr(3), attr(4), attr(5)
    if n_attrs >= 9:
        wx, wy_, wz = attr(6), attr(7), attr(8)
    else:
        assert scene.pt_pos.shape[0] == 0, (
            "point lights require world-pos planes (n_attrs=9)")
        wx = wy_ = wz = torch.zeros_like(nx)
    inv_nl = _rsqrt(torch.clamp(_dot3(nx, nx, ny, ny, nz, nz), min=1e-24))
    nx, ny, nz = nx * inv_nl, ny * inv_nl, nz * inv_nl

    dev = g.device
    ambient = scene.env_color * scene.env_intensity
    have_dl = scene.n_dl > 0
    ddir = torch.where(have_dl, scene.dl_dir[0],
                       torch.tensor(_DEFAULT_DIR, dtype=torch.float32,
                                    device=dev))
    dcol = torch.where(have_dl, scene.dl_col[0],
                       torch.tensor(_DEFAULT_DIR_COL, dtype=torch.float32,
                                    device=dev))
    ndl = torch.clamp(-_dot3(nx, ddir[0], ny, ddir[1], nz, ddir[2]), min=0.0)
    # c * (ambient + dcol * ndl): the ambient product is formed apart
    lit = [fma32(dcol[k], ndl, ambient[k]) for k in range(3)]
    out = [c * lit[k] for k, c in enumerate((cr, cg, cb))]

    n_pl = scene.pt_pos.shape[0]
    pl_valid = torch.arange(n_pl, device=dev) < scene.n_pt
    for i in range(n_pl):
        lx = scene.pt_pos[i, 0] - wx
        ly = scene.pt_pos[i, 1] - wy_
        lz = scene.pt_pos[i, 2] - wz
        d2 = torch.clamp(_dot3(lx, lx, ly, ly, lz, lz), min=1e-4)
        inv_dd = _rsqrt(d2)
        ndlp = torch.clamp(_dot3(nx, lx, ny, ly, nz, lz) * inv_dd, min=0.0)
        att = torch.reciprocal(fma32(d2, 0.05, 1.0))
        w_i = torch.where(pl_valid[i], ndlp * att, 0.0)
        for k, c in enumerate((cr, cg, cb)):
            # out + (c * col) * w: the first light's add sees two
            # products and fuses the left one, c * lit
            if i == 0:
                out[k] = fma32(c, lit[k], (c * scene.pt_col[i, k]) * w_i)
            else:
                out[k] = fma32(c * scene.pt_col[i, k], w_i, out[k])
    out_r, out_g, out_b = out

    rgb = torch.stack([torch.clamp(out_r, 0.0, 1.0),
                       torch.clamp(out_g, 0.0, 1.0),
                       torch.clamp(out_b, 0.0, 1.0)], dim=-1)
    return torch.where(hit[..., None], rgb, 0.0)
