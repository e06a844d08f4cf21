"""Forward rasterizer backend (torch port of
``ascii_renderer_tpu/backends/raster.py``).

Three generations run, chosen by scene size as the reference chooses
(``RasterBackend.render``):
- below 2,048 triangle slots: ``render_soup`` uncapped, the chunked scan
  (``raster_channels.visibility_scan``) up to 512 slots and the binned
  scatter walk (B6, ops/raster_bins) above;
- 2,048 to 32,767 slots: the compacted clip-expansion pipeline
  ``render_soup_diag(kernel="mm")`` (B6 walk, plane table packed by B7)
  with (v_cap, big_cap) overflow retries;
- from 32,768 slots: the headline ``subtile8`` pipeline. Per frame: the
  camera MVP (host), 2-D homogeneous triangle setup (CUDA kernel,
  ops/setup2dh), the channel pack (CUDA kernel, ops/pack), pair keys per
  8 x 16 px bin and one key sort, the depth-grouped K-gather layout
  (ops/raster_group), the grouped walk (CUDA kernel), deferred shading on
  the group layout, and one bin-gather image assembly.

Every grouped generation ``render_soup_diag(kernel=...)`` /
``render_soup(method=...)`` takes renders the same frame bit for bit; they
differ in layout and walk kernel (ops/raster_group): ``subtile3`` (single-
entry rows, B9d), ``subtile4`` (direct per-bin reads, B9e), ``subtile5`` /
``subtile6`` (two-entry rows from a K2 / K4 gather, B9f), ``subtile7`` /
``subtile8`` (K4 / K8 gather relaid to single-entry rows, B1). With
``SETUP_PACKED`` the setup and the pack are one kernel (B10) for every
generation but ``subtile4``.

The reference's retired generations render too (backends/raster_oracles):
``render_soup(method="fused")`` (binning and the fused-shading walk B8, no
visibility buffer), and with v_cap ``subtile`` (the clip-expansion
channels, the packed subtile walk B9b, the tile-compacted shade) and
``subtile2`` (the 2-D homogeneous setup, the depth-masked walk B9c).

Reference behaviours preserved (raster.js): camera mapping identical to the
tracers, near 0.05 / far 100, back-face culling, a default directional
light when the scene has none, ambient = env color * intensity, point-light
attenuation 1/(1 + d^2*0.05), no shadows.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function as stage

from ascii_renderer_tpu_torch.core import quantize as Q
from ascii_renderer_tpu_torch.core.camera import Camera, cross3, norm3
from ascii_renderer_tpu_torch.core.fp import div32, fma32_scalar, round32
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.geom.tessellate import tessellate_scene
from ascii_renderer_tpu_torch.ops import bin_entries as BE
from ascii_renderer_tpu_torch.ops import raster_clip as RCL
from ascii_renderer_tpu_torch.ops import raster_group as RG
from ascii_renderer_tpu_torch.ops import raster_shade as RSH
from ascii_renderer_tpu_torch.ops import raster_subtile as RS
from ascii_renderer_tpu_torch.ops.pack import (pack_channels,
                                               pack_channels_split_blocked)
from ascii_renderer_tpu_torch.ops.setup2dh import (
    setup_2dh_fused, setup_2dh_fused_packed, setup_channels)
from ascii_renderer_tpu_torch.ops.bin_entries import (  # noqa: F401
    _bin_span, _floor_i32, _pair_keys_core)
from ascii_renderer_tpu_torch.scene.builder import SceneData
from ascii_renderer_tpu_torch.backends.raster_common import (  # noqa: F401
    FAR, MAX_V_CAP, NEAR, TILE_H, TILE_W, _DEFAULT_AMBIENT, _DEFAULT_DIR,
    _DEFAULT_DIR_COL, _cumsum_i32, _round_up, _shade_rows, shade_from_table)
from ascii_renderer_tpu_torch.backends.raster_channels import (  # noqa: F401
    _COMPACT_KEYS, _clip_channels_core, _edge, build_plane_table,
    channels_clip_array, channels_to_setup, clip_attrs_channel_lists,
    clip_attrs_channels, clip_attrs_compact_lists, clip_screen_channels,
    clip_screen_table_channels, compact_valid_ch, count_big_small,
    render_channels_diag, setup_screen, setup_screen_channels,
    shade_planes_ch, shade_visibility, transform_clip,
    transform_clip_channels, transform_clip_channels9, visibility_binned,
    visibility_binned_ch, visibility_scan)
from ascii_renderer_tpu_torch.backends.raster_oracles import (  # noqa: F401
    _build_bins, _entry_planes_src, _subtile_pair_keys, render_fused_ch,
    render_subtile2_diag, shade_tiles_compact, suggest_caps_subtile,
    visibility_subtile, visibility_subtile_tiles)

HEADLINE_KERNEL = "subtile8"  # K8 slot gather relaid to the base walk layout
GROUPED_KERNELS = tuple(RG.GENERATIONS)  # subtile3 .. subtile8
SETUP_PACKED = False  # True: one kernel (B10) emits the bbox and both
# row-major tables; False: the setup (B2), then the pack (B3 / B7). The
# same frame either way; subtile4 always takes the two-kernel path (its
# direct walk reads 32-wide rows).
_ADAPTIVE_MIN_TRIS = 2048   # RasterBackend: compacted mid-scale path from here
_GROUPED_MIN_TRIS = 32768   # RasterBackend: headline path from here up


# --------------------------------------------------------------------------
# Matrices (semantics of raster.js:15-45), float32 on the host
# --------------------------------------------------------------------------
# Every chain below rounds as the reference's compiled camera_mvp does:
# products fused into the adds they feed (core/fp.py), a division by a
# constant taken as a product with the constant's float32 reciprocal, and
# the reductions (norm, matrix products) accumulated in index order with
# fused multiply-adds. The chains run on Python floats, each operation
# rounded to float32 where a float32 tensor operation would round it
# (``core/fp.round32``, ``fma32_scalar``); one tensor is built at the end.
_F32_1EM6 = round32(1e-6)


def _perspective_s(fovy: float, aspect: float, near: float,
                   far: float) -> list:
    """``perspective`` as rows of Python floats."""
    half = max(round32(fovy * 0.5), _F32_1EM6)  # clamp(min=1e-6): NaN stays
    f = div32(1.0, round32(math.tan(half)))
    nf = 1.0 / (near - far)  # float64: the next two round only when stored
    return [[round32(f * div32(1.0, round32(aspect))), 0.0, 0.0, 0.0],
            [0.0, f, 0.0, 0.0],
            [0.0, 0.0, round32((far + near) * nf),
             round32(2 * far * near * nf)],
            [0.0, 0.0, -1.0, 0.0]]


def perspective(fovy_rad, aspect: float, near: float = NEAR,
                far: float = FAR) -> torch.Tensor:
    return torch.tensor(_perspective_s(round32(float(fovy_rad)), aspect,
                                       near, far), dtype=torch.float32)


def _matmul(p: list, q: list) -> list:
    """p @ q (rows of Python floats) accumulated over k in order with fused
    multiply-adds."""
    out = []
    for row in p:
        acc = [round32(row[0] * x) for x in q[0]]
        for k in range(1, len(row)):
            acc = [fma32_scalar(row[k], x, a) for x, a in zip(q[k], acc)]
        out.append(acc)
    return out


def _normalize(v: list) -> list:
    """v over its norm, v . v summed as ``_matmul`` sums it."""
    n = norm3(v)
    return [div32(x, n) for x in v]


def _look_at_s(eye: list, center: list, up: list) -> list:
    f = _normalize([round32(c - e) for c, e in zip(center, eye)])
    s = _normalize(cross3(f, up))
    u = cross3(s, f)
    m = [s, u, [-x for x in f]]  # rows
    t = _matmul([[-x for x in row] for row in m], [[e] for e in eye])
    return [m[i] + t[i] for i in range(3)] + [[0.0, 0.0, 0.0, 1.0]]


def look_at(eye: torch.Tensor, center: torch.Tensor,
            up: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_look_at_s(*(x.tolist() for x in (eye, center, up))),
                        dtype=torch.float32)


def camera_mvp(cam: Camera, rows: int, cols: int,
               pixel_aspect: float) -> torch.Tensor:
    """proj @ view, f32 [4, 4] on the CPU whatever the camera's device, so
    every device renders from the same matrix."""
    pitch, yaw = float(cam.pitch), float(cam.yaw)
    cp, sp = round32(math.cos(pitch)), round32(math.sin(pitch))
    cy, sy = round32(math.cos(yaw)), round32(math.sin(yaw))
    aspect = max(1e-6, (cols / max(1, rows)) * pixel_aspect)
    proj = _perspective_s(float(cam.fov_y), aspect, NEAR, FAR)
    pos = cam.pos.tolist()
    # pos + look, look = (cp*cy, sp, cp*sy): its products fuse into the add
    center = [fma32_scalar(cp, cy, pos[0]), round32(pos[1] + sp),
              fma32_scalar(cp, sy, pos[2])]
    view = _look_at_s(pos, center, [0.0, 1.0, 0.0])
    return torch.tensor(_matmul(proj, view), dtype=torch.float32)


def positions_to_pos9(positions: torch.Tensor) -> torch.Tensor:
    """Soup positions f32 [V=3T, 3] -> channel-major pos9 f32 [9, T]
    (rows xa ya za xb yb zb xc yc zc)."""
    V = positions.shape[0]
    return (positions.reshape(V // 3, 3, 3).permute(1, 2, 0)
            .reshape(9, V // 3).contiguous())


def soup_static_prep(positions, normals, colors, scene: SceneData):
    """Static per-scene tables: (pos9 f32 [9, T], attrs_t f32 [3A, T]).
    A = 6 (normal, color) without point lights, 9 (+ world position) with:
    the world-position planes feed only point lights."""
    if scene.pt_pos.shape[0] == 0:
        attrs = torch.cat([normals, colors], dim=1)
    else:
        attrs = torch.cat([normals, colors, positions], dim=1)
    V, A = attrs.shape
    return (positions_to_pos9(positions),
            attrs.reshape(V // 3, 3 * A).t().contiguous())


def setup_2dh(pos9: torch.Tensor, attrs_t: torch.Tensor, mvp: torch.Tensor,
              rows: int, cols: int) -> dict:
    """Triangle setup in 2-D homogeneous coordinates as a channel dict of
    [T] tensors (see ops/setup2dh.setup_channels): the plain twin of the
    setup kernel, with the JAX ``setup_2dh`` signature."""
    return setup_channels(pos9, attrs_t, mvp, rows, cols)


def _subtile_pair_keys_bbox(cch, rows: int, cols: int, *, big_cap: int,
                            ty_lo: int = 0, tiles_y_band: int | None = None):
    """Sorted (bin << SUB_SHIFT | tri) pair keys from bbox channels (of
    the tile-row band [ty_lo, ty_lo + tiles_y_band) when given): X9's bin
    keys on a CUDA device (ops/bin_entries.pair_keys), _pair_keys_core on
    the CPU."""
    return BE.pair_keys_bbox(cch, rows, cols, big_cap=big_cap, ty_lo=ty_lo,
                             tiles_y_band=tiles_y_band)[0]


def count_big_small_bbox(cch, rows: int, cols: int, ty_lo: int = 0,
                         tiles_y_band: int | None = None, counts=None):
    """(n_small, n_big) 0-d i32 counts under _pair_keys_core's rules, its
    band restriction included; ``counts``: the ones ``BE.pair_keys`` left
    beside the keys of the same call, read instead of running the span
    test again."""
    if counts is not None:
        return counts[0], counts[1]
    _, _, _, _, small, bigt = _bin_span(cch["bx0"], cch["bx1"], cch["by0"],
                                        cch["by1"], cch["valid"], rows, cols,
                                        ty_lo, tiles_y_band)
    return small.sum(dtype=torch.int32), bigt.sum(dtype=torch.int32)


def shade_groups(e, xl, yl, table, scene: SceneData, n_attrs: int):
    """Deferred shading over grouped walk output: e f32 [grp_cap, 8, 128]
    winner ids (-1 = bg), xl/yl f32 [grp_cap, 128] pixel-origin lanes,
    table [N, W] per-triangle shade planes. Returns rgb f32
    [grp_cap, 8, 128, 3]: K2's grouped form (``ops/raster_shade.shade``,
    one launch on a CUDA device). ``render_soup_diag`` shades through K2's
    image form instead (``ops/raster_shade.shade_image``: on a CUDA device
    the shade and the image's assembly in one launch; on the CPU its plain
    version, this chain over the groups, then ``assemble_group_image``)."""
    return RSH.shade(table, e, *RSH.group_centres(xl, yl), scene, n_attrs)


def suggest_caps_grouped(n_valid: int, n_big: int, n_rows: int,
                         n_pairs: int, n_used: int):
    """Adaptive capacities for the grouped pipeline: (v_cap, big_cap, r_cap,
    pair_cap, bin_cap). v_cap is informational (no compaction); bin_cap
    (= grp_cap * 8) bounds the nonempty bins the grouping covers; r_cap
    stays a CHUNK_RG multiple."""
    v_cap = _round_up(int(n_valid) + 1, 4096)
    big_cap = 0 if n_big == 0 else max(16, _round_up(int(n_big * 1.5) + 8,
                                                     16))
    r_cap = _round_up(int(n_rows * 1.05) + 64, max(RG.CHUNK_RG, 256))
    pair_cap = _round_up(int(n_pairs * 1.06) + 256, 2048)
    bin_cap = _round_up(int(n_used * 1.08) + 8, 32)
    return v_cap, big_cap, r_cap, pair_cap, bin_cap


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------
def render_soup_diag(positions, normals, colors, scene: SceneData,
                     cam: Camera, rows: int, cols: int, pixel_aspect: float,
                     v_cap: int, big_cap: int = 64, kernel: str = "mm",
                     r_cap: int = 16384, pair_cap: int = 65536,
                     tile_cap: int | None = None, pos9=None,
                     attrs_t=None, emit: str = "rgb", ramp_len: int = 10,
                     row_lo=None, band_rows: int | None = None):
    """Compacted raster pipeline with capacity diagnostics. The soup lives
    on the device that renders.

    ``row_lo`` / ``band_rows`` (the grouped generations but 'subtile4';
    the hook of ``render_soup_rows_sharded``): rasterize only the row
    band [row_lo, row_lo + band_rows) of the rows x cols frame and return
    [band_rows, cols, 3]. The frame is banded iff band_rows is given (as
    in the reference); both must be multiples of TILE_H. Pair keys, caps
    and diag counts are the band's; the setup planes stay in global
    screen coordinates, so a band equals those rows of the full frame bit
    for bit. The reference ignores a band for the other kernels and
    returns the full frame; here they raise ValueError, as does a row_lo
    without band_rows.

    kernel 'mm' / 'loop': the clip-expansion channel pipeline
    (raster_channels.render_channels_diag: valid compaction to v_cap, the
    bin walk B6 / B6', plane-table shading); exact iff n_valid <= v_cap and
    n_big <= big_cap (grow them with ``suggest_caps``). pos9 selects the
    pre-transposed vertex stage. kernel 'subtile' runs the same compaction,
    then the packed subtile walk B9b and the tile-compacted shade; kernel
    'subtile2' the 2-D homogeneous setup and the depth-masked walk B9c
    (raster_oracles); both also count n_rows, n_pairs and n_tiles_nz
    (tile_cap = TILE capacity here) and grow their caps with
    ``suggest_caps_subtile``.

    kernel 'subtile3'..'subtile8' (the grouped generations, GROUPED_KERNELS;
    'subtile8' is the headline): returns (rgb f32 [rows, cols, 3], diag)
    with 0-d i32 counts n_valid, n_big, n_rows, n_pairs, n_tiles_nz. The
    frame is exact iff n_big <= big_cap, n_rows <= r_cap (not for
    'subtile4', which has no row layout), n_pairs <= pair_cap and
    n_tiles_nz <= tile_cap (the BIN capacity; grp_cap = tile_cap // 8);
    otherwise work was dropped and the caller re-renders with
    ``suggest_caps_grouped`` caps. emit='idx' returns (idx i32 [rows,
    cols], rgb8 u8 [rows, cols, 3]) instead, the image's rgb quantized a
    pixel at a time (``image_emit``): bit-identical to quantizing in group
    layout and assembling (assembly is a permutation, its fill 0.0
    quantizes to 0)."""
    banded = band_rows is not None
    if banded:
        row_lo = 0 if row_lo is None else int(row_lo)
        if kernel not in GROUPED_KERNELS or kernel == "subtile4":
            raise ValueError(f"row bands take the grouped kernels but "
                             f"subtile4, not {kernel!r}")
        if (band_rows <= 0 or band_rows % TILE_H or row_lo % TILE_H
                or row_lo < 0 or row_lo + band_rows > _round_up(rows,
                                                                TILE_H)):
            raise ValueError(f"row band [{row_lo}, {row_lo + band_rows}) "
                             f"of {rows} rows: TILE_H ({TILE_H}) multiples "
                             f"inside the frame")
    elif row_lo not in (None, 0):
        raise ValueError(f"row_lo {row_lo} without band_rows")
    with stage("raster.mvp"):
        mvp = camera_mvp(cam, rows, cols, pixel_aspect)
    if kernel not in GROUPED_KERNELS:
        # world-position planes feed only the point lights
        parts = [normals, colors]
        if scene.pt_pos.shape[0]:
            parts.append(positions)
        attrs = torch.cat(parts, dim=1)
        if kernel == "subtile2":
            return render_subtile2_diag(
                attrs, scene, mvp, rows, cols, big_cap=big_cap, r_cap=r_cap,
                pair_cap=pair_cap, tile_cap=tile_cap, positions=positions,
                pos9=pos9, attrs_t=attrs_t)
        return render_channels_diag(
            positions, attrs, scene, mvp, rows, cols, v_cap=v_cap,
            big_cap=big_cap, kernel=kernel, r_cap=r_cap, pair_cap=pair_cap,
            tile_cap=tile_cap, pos9=pos9)
    if pos9 is None or attrs_t is None:
        pos9, attrs_t = soup_static_prep(positions, normals, colors, scene)
    A = attrs_t.shape[0] // 3
    if banded:
        tiles_y, ty_lo, out_rows = band_rows // TILE_H, row_lo // TILE_H, \
            band_rows
    else:
        tiles_y, ty_lo, out_rows = -(-rows // TILE_H), 0, rows
    tiles_x = -(-cols // TILE_W)
    n_tiles = tiles_y * tiles_x
    if tile_cap is None:
        tile_cap = n_tiles * 8
    grp_cap = max(1, tile_cap // 8)
    tw = _round_up(3 * A + 3, 8)

    # each stage is a named range for torch.profiler (chip_smoke --profile)
    if SETUP_PACKED and kernel != "subtile4":
        with stage("raster.setup"):  # setup and pack in one kernel (B10)
            bbox, src, table = setup_2dh_fused_packed(pos9, attrs_t, mvp,
                                                      rows, cols, tw)
    else:
        with stage("raster.setup"):
            cm, bbox = setup_2dh_fused(pos9, attrs_t, mvp, rows, cols)
        with stage("raster.pack"):
            if kernel in ("subtile3", "subtile4"):
                # one wide pack (B7), walk rows and shade table as lane
                # slices of it; columns past 3A+3 are zero, never read
                cm2 = cm.view(cm.shape[0], -1)
                g = pack_channels(cm2, width=max(_round_up(cm2.shape[0], 8),
                                                 15))
                src, table = g[:, :32], g[:, 16:16 + tw]
            else:  # two contiguous spans (B3)
                src, table = pack_channels_split_blocked(
                    cm, [(0, 16), (16, 16 + tw)])
    band_kw = dict(ty_lo=ty_lo, tiles_y_band=tiles_y if banded else None)
    with stage("raster.keys"):  # X9's bin keys on a CUDA device
        keys, offsets, counts = BE.pair_keys_bbox(bbox, rows, cols,
                                                  big_cap=big_cap, **band_kw)
    e, xl, yl, gbins, ginv, n_rows, n_pairs, n_used = _grouped_walk(
        kernel, src, keys, tiles_x, n_tiles, r_cap, pair_cap, grp_cap,
        ty_lo * TILE_H, offsets)
    # K2's image form: on a CUDA device the shade and the image's assembly
    # in one launch (e, ginv), so raster.assemble launches nothing; on the
    # CPU its plain version, the shade over the groups (e, xl, yl), then the
    # assembly (gbins)
    with stage("raster.shade"):
        rgb = RSH.shade_image(table, e, xl, yl, gbins, ginv, scene, A,
                              tiles_x, out_rows, cols, ty_lo * TILE_H)
    with stage("raster.assemble"):
        _n_small, n_big = count_big_small_bbox(bbox, rows, cols,
                                               counts=counts, **band_kw)
        diag = {"n_valid": counts[3],
                "n_big": n_big, "n_rows": n_rows, "n_pairs": n_pairs,
                "n_tiles_nz": n_used}
        return image_emit(rgb, emit, ramp_len), diag


def image_emit(rgb, emit: str, ramp_len: int):
    """The image form's output for ``emit``: rgb itself, or for 'idx'
    (idx i32, rgb8 u8) quantized a pixel at a time; the same as quantizing
    the groups and assembling both (assembly is a permutation, and its fill
    0.0 quantizes to the fill 0 of both planes)."""
    if emit != "idx":
        return rgb
    # empty-ramp fallback: glyph_from_index's ramp_codes
    ramp_len = ramp_len if ramp_len > 0 else len(Q.DEFAULT_RAMP)
    rgb8 = Q.float_rgb_to_u8(rgb)
    return Q.quantize_index(rgb8, ramp_len), rgb8


def _grouped_walk(kernel: str, src, keys, tiles_x: int, n_tiles: int,
                  r_cap: int, pair_cap: int, grp_cap: int, y_off: int = 0,
                  offsets=None):
    """Layout build and walk of grouped generation ``kernel`` -> (winner
    ids e f32 [grp_cap, 8, 128], xl, yl, gbins, ginv i32 [n_tiles*8]: each
    bin's place among the groups' slots, n_rows, n_pairs, n_used).
    ``y_off``: a row band's first pixel row. Its bins, and so the lanes'
    pixel origins, are band-local, while the setup planes are in global
    screen coordinates: the build shifts yl to global rows. ``offsets``:
    the keys' bin offsets from X9 (the X10 builds read them)."""
    gen = RG.GENERATIONS[kernel]
    with stage("raster.build"):  # X10 on a CUDA device but for subtile4
        lay = gen.build(src, keys, tiles_x, n_tiles, r_cap, pair_cap,
                        grp_cap, offsets=offsets, y_off=y_off)
    with stage("raster.walk"):
        _z, e = gen.walk(*lay[:-5], grp_cap)
    return (e, *lay[-7:-4], lay[-1], *lay[-4:-1])


def suggest_caps(n_valid: int, n_big: int):
    """Adaptive (v_cap, big_cap) for the mid-scale pipeline, with growth
    margin: ~30% / 50% above the last counts, rounded to coarse quanta."""
    v_cap = min(MAX_V_CAP, _round_up(int(n_valid * 1.3) + 512, 8192))
    big_cap = max(64, _round_up(int(n_big * 1.5) + 8, 64))
    return v_cap, big_cap


def render_soup(positions, normals, colors, scene: SceneData, cam: Camera,
                rows: int, cols: int, pixel_aspect: float,
                chunk: int = 64, method: str = "auto",
                v_cap: int | None = None, big_cap: int = 64,
                r_cap: int = 16384, pair_cap: int = 65536,
                tile_cap: int | None = None, pos9=None,
                attrs_t=None) -> torch.Tensor:
    """Triangle soup -> shaded RGB f32 [rows, cols, 3].

    method: 'scatter' / 'scatter_mm' (the binned bin walk B6),
    'scatter_loop' (its scalar-loop twin B6'), 'fused' (binning and the
    fused-shading walk B8), 'scan' (the chunked dense scan, the reference
    path), or 'auto' (scatter above 512 triangle slots). v_cap routes the
    scatter methods, the channel-era generations 'subtile' / 'subtile2'
    and the grouped generations 'subtile3'..'subtile8' into the compacted
    render_soup_diag; None keeps the exact uncapped path (the subtile
    names then take the scan, as in the reference). Any other name takes
    the scan, as in the reference."""
    if method == "auto":
        method = "scatter" if positions.shape[0] // 3 * 2 > 512 else "scan"
    scatter = ("scatter", "scatter_mm", "scatter_loop")
    diag_kernels = ("subtile", "subtile2") + GROUPED_KERNELS
    if method in scatter + diag_kernels and v_cap is not None:
        kern = method if method in diag_kernels else {
            "scatter_loop": "loop"}.get(method, "mm")
        rgb, _diag = render_soup_diag(
            positions, normals, colors, scene, cam, rows, cols, pixel_aspect,
            v_cap=v_cap, big_cap=big_cap, kernel=kern, r_cap=r_cap,
            pair_cap=pair_cap, tile_cap=tile_cap, pos9=pos9,
            attrs_t=attrs_t)
        return rgb
    with stage("raster.mvp"):
        mvp = camera_mvp(cam, rows, cols, pixel_aspect)
    if method in scatter:
        # the clip, its screen setup and the plane table of the normals,
        # colors and positions: one launch of X4's table form on CUDA
        with stage("raster.clip"):
            ch, table = clip_screen_table_channels(positions, normals,
                                                   colors, mvp, rows, cols)
        with stage("raster.walk"):
            kern = "loop" if method == "scatter_loop" else "mm"
            _zbuf, tid = visibility_binned_ch(ch, rows, cols, kernel=kern)
        with stage("raster.shade"):
            return shade_planes_ch(tid, ch, None, scene, rows, cols,
                                   table=table)
    if method == "fused":
        # the clip, its screen setup and the attribute slots of the normals,
        # colors and positions: one launch of X4's slots form on CUDA
        with stage("raster.clip"):
            ch, attr_slots = RCL.clip_screen_slots(positions, normals,
                                                   colors, mvp, rows, cols)
        return render_fused_ch(ch, attr_slots, scene, rows, cols)
    attrs = torch.cat([normals, colors, positions], dim=1)  # [V, 9]
    with stage("raster.clip"):
        clip, tattr, valid = transform_clip(positions, attrs, mvp)
        setup = setup_screen(clip, valid, rows, cols)
    with stage("raster.walk"):
        _zbuf, tid = visibility_scan(setup, rows, cols, chunk)
    with stage("raster.shade"):
        return shade_visibility(tid, clip, tattr, scene, rows, cols)


def render_soup_rows_sharded(positions, normals, colors, scene: SceneData,
                             cam: Camera, rows: int, cols: int,
                             pixel_aspect: float, mesh, axis: str = "rows",
                             *, big_cap: int = 64, r_cap: int = 16384,
                             pair_cap: int = 65536,
                             bin_cap: int | None = None,
                             kernel: str | None = None):
    """Row-band sharding of the grouped raster pipeline: rank i of the
    mesh axis (``parallel.mesh.make_mesh``) rasterizes tile-row band i of
    one frame (band-local pair keys, walk, shade and assembly, no
    collective), then the bands and overflow counts are gathered.

    Returns (rgb f32 [rows, cols, 3], overflow i32 [n]) on every rank:
    overflow[i] counts the caps band i exceeded. The caps are per band and
    the same on every rank, so size them for the heaviest band and render
    again when any overflow[i] > 0."""
    from ascii_renderer_tpu_torch.parallel.mesh import (all_gather_cat,
                                                        mesh_axis)
    if kernel is None:
        kernel = HEADLINE_KERNEL
    n, i, group = mesh_axis(mesh, axis)
    assert rows % (TILE_H * n) == 0, (rows, TILE_H, n)
    band = rows // n
    tiles_x = -(-cols // TILE_W)
    if bin_cap is None:  # every bin of the band: bins never overflow
        bin_cap = (band // TILE_H) * tiles_x * 8
    T = positions.shape[0] // 3
    v_cap = _round_up(2 * T + 1, 4096)  # informational (no compaction)
    rgb, diag = render_soup_diag(
        positions, normals, colors, scene, cam, rows, cols, pixel_aspect,
        v_cap=v_cap, big_cap=big_cap, kernel=kernel, r_cap=r_cap,
        pair_cap=pair_cap, tile_cap=bin_cap, row_lo=i * band,
        band_rows=band)
    over = ((diag["n_big"] > big_cap).to(torch.int32)
            + (diag["n_rows"] > r_cap).to(torch.int32)
            + (diag["n_pairs"] > pair_cap).to(torch.int32)
            + (diag["n_tiles_nz"] > bin_cap).to(torch.int32))
    return (all_gather_cat(rgb, n, group),
            all_gather_cat(over.reshape(1), n, group))


_DIAG_KEYS = ("n_valid", "n_big", "n_rows", "n_pairs", "n_tiles_nz")


class RasterBackend:
    """Backend-protocol wrapper. Tessellation happens on scene push.

    Small scenes (< 2,048 triangle slots) render uncapped. Mid-scale and
    headline scenes: every frame's diagnostics are read on the host; on
    overflow the caps grow with margin and the frame re-renders (up to 4
    tries), so no triangle is silently dropped. After the first frame the
    backend adopts lean caps and holds them while they fit."""

    name = "raster"

    def __init__(self, cfg=None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._scene: SceneData | None = None
        self._soup = None
        self._pos9 = None
        self._attrs_t = None
        self._caps = None

    def _push(self, scene: SceneData, soup):
        self._scene = scene
        self._soup = tuple(torch.as_tensor(x, dtype=torch.float32)
                           .to(self.device).contiguous() for x in soup)
        self._pos9, self._attrs_t = soup_static_prep(*self._soup, scene)
        self._caps = None

    def set_scene(self, scene: SceneData):
        self._push(scene, tessellate_scene(scene))

    def set_soup(self, positions, normals, colors, scene: SceneData):
        """Direct mesh path for pre-tessellated geometry (benchmarks)."""
        self._push(scene, (positions, normals, colors))

    def render(self, time_sec, camera: Camera, rows: int, cols: int,
               pixel_aspect: float = 1.0) -> Frame:
        if self._scene is None or self._soup[0].shape[0] == 0:
            return Frame.blank(rows, cols, device=self.device)
        n2t = self._soup[0].shape[0] // 3 * 2
        if n2t < _ADAPTIVE_MIN_TRIS or n2t > RS.MAX_TRI - 4096:
            rgb = render_soup(*self._soup, self._scene, camera, rows, cols,
                              pixel_aspect)
            with stage("frame.from_float"):
                return Frame.from_float(rgb)
        if n2t < _GROUPED_MIN_TRIS:  # mid scale: the compacted mm walk
            caps = self._caps or (n2t, 64)
            for _ in range(4):
                rgb, diag = render_soup_diag(
                    *self._soup, self._scene, camera, rows, cols,
                    pixel_aspect, v_cap=caps[0], big_cap=caps[1],
                    pos9=self._pos9)
                with stage("raster.diag_readback"):  # the frame's host sync
                    counts = tuple(torch.stack(
                        [diag["n_valid"], diag["n_big"]]).tolist())
                if all(c <= cap for c, cap in zip(counts, caps)):
                    break
                caps = suggest_caps(*counts)
            # adopt lean caps after the first (safe-cap) frame, then hold
            self._caps = caps if self._caps else suggest_caps(*counts)
            with stage("frame.from_float"):
                return Frame.from_float(rgb)
        n_tiles = (-(-rows // TILE_H)) * (-(-cols // TILE_W))
        caps = self._caps or (n2t, 64, _round_up(n2t, 2048), 4 * n2t,
                              n_tiles * 8)
        for _ in range(4):  # overflow retries (caps grow geometrically)
            rgb, diag = render_soup_diag(
                *self._soup, self._scene, camera, rows, cols, pixel_aspect,
                kernel=HEADLINE_KERNEL, v_cap=caps[0], big_cap=caps[1],
                r_cap=caps[2], pair_cap=caps[3], tile_cap=caps[4],
                pos9=self._pos9, attrs_t=self._attrs_t)
            with stage("raster.diag_readback"):  # the frame's host sync
                counts = tuple(torch.stack([diag[k] for k in _DIAG_KEYS])
                               .tolist())
            # skip v_cap (index 0): there is no compaction to overflow
            if all(c <= cap for c, cap in zip(counts[1:], caps[1:])):
                break
            caps = suggest_caps_grouped(*counts)
        # adopt lean caps after the first (safe-cap) frame, then hold them
        self._caps = caps if self._caps else suggest_caps_grouped(*counts)
        with stage("frame.from_float"):
            return Frame.from_float(rgb)

    def dispose(self):
        self._scene = self._soup = self._pos9 = self._attrs_t = None
        self._caps = None
