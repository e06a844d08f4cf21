"""The raster's deferred shade: the CUDA kernel of ``csrc/raster_shade.cu``
and its plain version (the shade-table gather, then ``_shade_rows``, the
port of the reference's row shading, which ``backends/raster_common``
re-exports).

Stands for XLA code, not a Pallas kernel: the deferred-shade gather and
lighting of ``ascii_renderer_tpu/backends/raster_common.py:73``
(``_shade_rows``). ``shade`` takes the grouped tiles
(``backends/raster.shade_groups``: f32 winner ids [grp_cap, 8, 128], the
lanes' centres ``group_centres``), the mid-scale plane table
(``raster_common.shade_from_table``: i32 ids [rows, cols]) and the retired
generations' compacted tiles (``raster_oracles.shade_tiles_compact``).

Its image form, ``shade_image``, also stands for the assembly of the
grouped tiles into the image (``ascii_renderer_tpu/ops/raster_group.py:1284``,
``assemble_group_image``): every grouped render path shades through it (on
a CUDA device the shade and the assembly in one launch, each pixel reading
its bin's place from X10's inverse of the depth order, ``ops/group_build``
``ginv``; on the CPU its plain version, the grouped shade over the
layout's lanes, then the assembly).
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core.fp import fma32, rsqrt32
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops.fp import broadcast_geom, broadcast_shape
from ascii_renderer_tpu_torch.ops.raster_subtile import N_SUB, TILE_H, TILE_W
from ascii_renderer_tpu_torch.scene.builder import SceneData

launches = 0  # kernel launches by shade and shade_image
launches_image = 0  # of them, by shade_image
LAUNCHES_PER_CALL = {"shade": 1, "shade_image": 1}  # kernels a call launches
MAX_DIMS = 3
_geoms = {}  # (shapes, strides) -> the kernel's geometry, a ctypes array

_DEFAULT_AMBIENT = (0.15, 0.18, 0.22)  # raster.js:66-69
_DEFAULT_DIR = (0.25, -1.0, 0.15)
_DEFAULT_DIR_COL = (1.2, 1.15, 1.1)


def shade(table, ids, px, py, scene: SceneData, n_attrs: int):
    """rgb f32 [*S, 3] of the pixels S: ``ids`` (f32 or i32, -1 = no hit)
    pick rows of ``table`` [N, W] (a row may be a strided slice of a wider
    array; W >= 3 * n_attrs + 3), ``px`` / ``py`` f32 are the pixel
    centres; each of the three broadcasts to S. No-hit pixels are zero. On
    the CPU the plain version; on a CUDA device one launch."""
    if table.device.type == "cpu":
        return shade_ref(table, ids, px, py, scene, n_attrs)
    global launches
    shape = broadcast_shape(ids.shape, px.shape, py.shape)
    if len(shape) > MAX_DIMS:
        raise ValueError(f"shade: {len(shape)} pixel dimensions, at most "
                         f"{MAX_DIMS}")
    if ids.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"shade: ids must be float32 or int32, got "
                         f"{ids.dtype}")
    if (table.dtype, px.dtype, py.dtype) != (torch.float32,) * 3:
        raise ValueError("shade: expected a float32 table and centres")
    scene_args = _scene_args(table, (ids, px, py), scene, n_attrs, "shade")
    out = torch.empty((*shape, 3), dtype=torch.float32, device=table.device)
    n = out.numel() // 3
    if n >= 2 ** 31:
        raise ValueError(f"shade: {n} pixels, at most 2^31 - 1")
    key = (shape, ids.shape, ids.stride(), px.shape, px.stride(), py.shape,
           py.stride())
    g = _geoms.get(key)
    if g is None:
        if len(_geoms) >= 64:
            _geoms.clear()
        geom = broadcast_geom((ids, px, py), shape, MAX_DIMS)
        g = _geoms[key] = (ctypes.c_longlong * len(geom))(*geom)
    err = _build.lib().raster_shade_launch(
        table.data_ptr(), table.stride(0), table.shape[0],
        _vec(table, n_attrs), ids.data_ptr(),
        int(ids.dtype == torch.float32), px.data_ptr(), py.data_ptr(), g,
        n_attrs, *scene_args, out.data_ptr(), n,
        _build.stream_ptr(table.device))
    launches += 1
    _build.check(err, "raster_shade_launch")
    return out


def _scene_args(table, tensors, scene: SceneData, n_attrs: int, what: str):
    """The launch's table and scene checks; the scene's pointers and its
    point-light slots in the entry points' order."""
    if table.dim() != 2 or table.stride(1) != 1 or table.shape[0] < 1 or \
            table.shape[1] < 3 * n_attrs + 3:
        raise ValueError(f"{what}: table {tuple(table.shape)} (stride "
                         f"{table.stride()}) holds no {n_attrs}-attribute "
                         "rows of unit column stride")
    if scene.dl_dir.shape[0] < 1:
        raise ValueError(f"{what}: the scene has no directional-light slot")
    lights = (scene.env_color, scene.env_intensity, scene.dl_dir,
              scene.dl_col, scene.pt_pos, scene.pt_col)
    counts = (scene.n_dl, scene.n_pt)
    _build.require_cuda(*lights, *counts, what=what)
    for t in (table, *tensors):
        if t.device != scene.env_color.device:
            raise ValueError(f"{what}: expected CUDA tensors on one device, "
                             f"got {t.device}")
    if any(t.dtype != torch.float32 for t in lights) or any(
            t.dtype != torch.int32 for t in counts):
        raise ValueError(f"{what}: expected float32 lights, int32 counts")
    return (*(t.data_ptr() for t in lights[:2]), scene.n_dl.data_ptr(),
            *(t.data_ptr() for t in lights[2:4]), scene.n_pt.data_ptr(),
            *(t.data_ptr() for t in lights[4:]), scene.pt_pos.shape[0])


def _vec(table, n_attrs: int) -> int:
    """1 where the table's rows may be read as float4: aligned, each row's
    used floats rounded up to a multiple of 4 inside the row."""
    return int(table.stride(0) % 4 == 0 and table.data_ptr() % 16 == 0
               and table.shape[1] >= -(-(3 * n_attrs + 3) // 4) * 4)


def group_centres(xl, yl):
    """The grouped tiles' pixel centres as ``shade`` takes them, from the
    layout's lane origins xl, yl f32 [grp_cap, 128]: (px [grp_cap, 1, 128]
    = xl, py [grp_cap, 8, 128] = yl + s + 0.5 at row s of the tile)."""
    py = (yl[:, None, :]
          + (torch.arange(TILE_H, dtype=torch.float32, device=yl.device)
             + 0.5)[None, :, None])
    return xl[:, None, :], py


def shade_image(table, e, xl, yl, gbins, ginv, scene: SceneData,
                n_attrs: int, tiles_x: int, rows: int, cols: int,
                y_off: int = 0):
    """K2's image form: rgb f32 [rows, cols, 3] of a grouped walk's image
    (a row band's where ``y_off``, its first pixel row, is given) from the
    walk's winner ids ``e`` f32 [grp_cap, 8, 128] (-1 = no hit) and the
    layout's tail (``ops/raster_group.Generation``): xl, yl f32 [grp_cap,
    128] the lanes' pixel origins (yl in the frame's rows), gbins i32
    [grp_cap * 8] each slot's bin, ginv i32 [n_bins] each bin's place
    among the slots (a place past them: no group covers the bin, its
    pixels are 0), the bins those of ``n_bins / 8`` tiles, ``tiles_x`` a
    row; ``table`` [N, W] the shade rows. Equal to ``shade`` over the
    groups at ``group_centres`` then ``assemble_group_image`` with fill 0,
    bit for bit. On the CPU that plain version, which reads xl, yl and
    gbins; on a CUDA device one launch, which reads e and ginv and forms
    each pixel's centre (c + 0.5, y_off + r + 0.5)."""
    if table.device.type == "cpu":
        return shade_image_ref(table, e, xl, yl, gbins, ginv, scene, n_attrs,
                               tiles_x, rows, cols, y_off)
    global launches, launches_image
    n_bins = ginv.shape[0] if ginv.dim() == 1 else -1
    if (e.dtype != torch.float32 or e.dim() != 3
            or tuple(e.shape[1:]) != (TILE_H, TILE_W)
            or ginv.dtype != torch.int32 or n_bins < N_SUB
            or table.dtype != torch.float32):
        raise ValueError(f"shade_image: expected f32 ids [grp_cap, {TILE_H}, "
                         f"{TILE_W}], i32 places [n_bins] and a float32 "
                         f"table, got {e.dtype} {list(e.shape)}, "
                         f"{ginv.dtype} {list(ginv.shape)}, {table.dtype}")
    tiles_y = n_bins // (N_SUB * max(tiles_x, 1))
    if (tiles_x < 1 or n_bins != tiles_y * tiles_x * N_SUB or rows < 1
            or cols < 1 or rows > tiles_y * TILE_H or cols > tiles_x * TILE_W
            or rows * cols >= 2 ** 31):
        raise ValueError(f"shade_image: a {rows} x {cols} image is not "
                         f"inside {n_bins} bins of {tiles_x} tiles a row")
    _build.require_cuda(e, ginv, what="shade_image")
    scene_args = _scene_args(table, (e, ginv), scene, n_attrs, "shade_image")
    out = torch.empty((rows, cols, 3), dtype=torch.float32,
                      device=table.device)
    err = _build.lib().raster_shade_image_launch(
        table.data_ptr(), table.stride(0), table.shape[0],
        _vec(table, n_attrs), e.data_ptr(), ginv.data_ptr(),
        e.shape[0] * N_SUB, n_bins, tiles_x, int(y_off), rows, cols, n_attrs,
        *scene_args, out.data_ptr(), _build.stream_ptr(table.device))
    launches += 1
    launches_image += 1
    _build.check(err, "raster_shade_image_launch")
    return out


def shade_image_ref(table, e, xl, yl, gbins, ginv, scene: SceneData,
                    n_attrs: int, tiles_x: int, rows: int, cols: int,
                    y_off: int = 0):
    """The plain version of ``shade_image``: the shade over the groups at
    their lanes' centres (``group_centres``; ``backends/raster.
    shade_groups``' chain), then ``assemble_group_image`` with fill 0
    (``ginv`` gives the bins' count; yl holds ``y_off`` already)."""
    from ascii_renderer_tpu_torch.ops import raster_group as RG
    rgbg = shade_ref(table, e, *group_centres(xl, yl), scene, n_attrs)
    n_tiles = ginv.shape[0] // N_SUB
    return RG.assemble_group_image(rgbg, gbins, n_tiles, n_tiles // tiles_x,
                                   tiles_x, rows, cols, 0.0)


def shade_ref(table, ids, px, py, scene: SceneData, n_attrs: int):
    """The plain version: gather each hit pixel's table row (no-hit pixels
    read the last row, never used), then ``_shade_rows``."""
    shape = broadcast_shape(ids.shape, px.shape, py.shape)
    ids = ids.expand(shape)
    idx = ids.reshape(-1).to(torch.int64)
    hit = ids >= 0
    g = table[torch.where(idx >= 0, idx, table.shape[0] - 1)]
    return _shade_rows(g, hit, px.expand(shape), py.expand(shape), scene,
                       n_attrs)


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
    # the reference's rsqrt is a CPU estimate refined by one Newton step,
    # within 1 ulp of this; shading is compared at its own tolerance
    inv_nl = rsqrt32(torch.clamp(_dot3(nx, nx, ny, ny, nz, nz), min=1e-24))
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
        inv_dd = rsqrt32(d2)
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
