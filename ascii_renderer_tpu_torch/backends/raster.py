"""Forward rasterizer backend, headline path (torch port of
``ascii_renderer_tpu/backends/raster.py``, kernel ``subtile8``).

Per frame: the camera MVP (host), 2-D homogeneous triangle setup (CUDA
kernel, ops/setup2dh), the channel pack (CUDA kernel, ops/pack), pair keys
per 8 x 16 px bin and one key sort, the depth-grouped K-gather layout
(ops/raster_group), the grouped walk (CUDA kernel), deferred shading on the
group layout, and one bin-gather image assembly.

Reference behaviours preserved (raster.js): camera mapping identical to the
tracers, near 0.05 / far 100, back-face culling, a default directional
light when the scene has none, ambient = env color * intensity, point-light
attenuation 1/(1 + d^2*0.05), no shadows.

Only the headline generation is ported: other kernel names, and scenes
below 32,768 triangle slots (the scan and scatter paths), raise
NotImplementedError (ROADMAP A5).
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function as stage

from ascii_renderer_tpu_torch.core import quantize as Q
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.geom.tessellate import tessellate_scene
from ascii_renderer_tpu_torch.ops import raster_group as RG
from ascii_renderer_tpu_torch.ops import raster_subtile as RS
from ascii_renderer_tpu_torch.ops.pack import pack_channels_split_blocked
from ascii_renderer_tpu_torch.ops.setup2dh import setup_2dh_fused, setup_channels
from ascii_renderer_tpu_torch.scene.builder import SceneData
from ascii_renderer_tpu_torch.backends.raster_common import (  # noqa: F401
    FAR, NEAR, TILE_H, TILE_W, _round_up, _shade_rows)

HEADLINE_KERNEL = "subtile8"  # K8 slot gather relaid to the base walk layout
_GROUPED_MIN_TRIS = 32768   # RasterBackend: headline path from here up


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to ascii_renderer_tpu_torch yet (ROADMAP A5: "
        f"raster small and mid scale); only render_soup_diag(kernel="
        f"'{HEADLINE_KERNEL}') and scenes of >= {_GROUPED_MIN_TRIS} triangle "
        f"slots are")


# --------------------------------------------------------------------------
# Matrices (semantics of raster.js:15-45), float32 on the host
# --------------------------------------------------------------------------
# Every chain below rounds as the reference's compiled camera_mvp does:
# products fused into the adds they feed (core/fp.py), a division by a
# constant taken as a product with the constant's float32 reciprocal, and
# the reductions (norm, matrix products) accumulated in index order with
# fused multiply-adds.
def _trig(fn, x) -> torch.Tensor:
    """fn of a float32 scalar, correctly rounded to float32 (through
    Python's float64 libm): the same on every host, unlike torch's CPU
    trig, whose vectorised paths differ by an ulp between builds."""
    return torch.tensor(fn(float(x)), dtype=torch.float32)


def perspective(fovy_rad, aspect: float, near: float = NEAR,
                far: float = FAR) -> torch.Tensor:
    fovy = torch.as_tensor(fovy_rad, dtype=torch.float32).cpu()
    f = torch.reciprocal(_trig(math.tan, torch.clamp(fovy * 0.5, min=1e-6)))
    nf = 1.0 / (near - far)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = f * torch.reciprocal(torch.tensor(aspect, dtype=torch.float32))
    m[1, 1] = f
    m[2, 2] = (far + near) * nf
    m[2, 3] = 2 * far * near * nf
    m[3, 2] = -1.0
    return m


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b, each component p*q - r*s with the left product fused."""
    return torch.stack([fma32(a[i], b[j], -(a[j] * b[i]))
                        for i, j in ((1, 2), (2, 0), (0, 1))])


def _matmul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p @ q accumulated over k in order with fused multiply-adds."""
    acc = p[:, :1] * q[:1, :]
    for k in range(1, p.shape[1]):
        acc = fma32(p[:, k:k + 1], q[k:k + 1, :], acc)
    return acc


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(_matmul(v[None, :], v[:, None])[0, 0])


def look_at(eye: torch.Tensor, center: torch.Tensor,
            up: torch.Tensor) -> torch.Tensor:
    f = _normalize(center - eye)
    s = _normalize(_cross(f, up))
    u = _cross(s, f)
    m = torch.stack([s, u, -f])  # rows
    t = _matmul(-m, eye[:, None])
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32)
    return torch.cat([torch.cat([m, t], dim=1), bottom], dim=0)


def camera_mvp(cam: Camera, rows: int, cols: int,
               pixel_aspect: float) -> torch.Tensor:
    """proj @ view, f32 [4, 4] on the CPU whatever the camera's device, so
    every device renders from the same matrix."""
    cp, sp = _trig(math.cos, cam.pitch), _trig(math.sin, cam.pitch)
    cy, sy = _trig(math.cos, cam.yaw), _trig(math.sin, cam.yaw)
    aspect = max(1e-6, (cols / max(1, rows)) * pixel_aspect)
    proj = perspective(cam.fov_y, aspect)
    pos = cam.pos.cpu()
    # pos + look, look = (cp*cy, sp, cp*sy): its products fuse into the add
    center = torch.stack([fma32(cp, cy, pos[0]), pos[1] + sp,
                          fma32(cp, sy, pos[2])])
    view = look_at(pos, center,
                   torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32))
    return _matmul(proj, view)


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


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    # saturate like XLA's f32 -> s32 conversion (huge near-plane bboxes)
    return torch.clamp(torch.floor(x), -2147483648.0, 2147483520.0).to(
        torch.int32)


def _bin_span(xmin, xmax, ymin, ymax, valid, rows: int, cols: int):
    sc0 = _floor_i32(xmin / RS.SUB_W)
    sc1 = _floor_i32(xmax / RS.SUB_W)
    ty0 = _floor_i32(ymin / TILE_H)
    ty1 = _floor_i32(ymax / TILE_H)
    onscreen = (xmax > 0) & (xmin < cols) & (ymax > 0) & (ymin < rows)
    fits = ((sc1 - sc0) < 2) & ((ty1 - ty0) < 2)
    small = valid & onscreen & fits
    bigt = valid & onscreen & ~fits
    return sc0, sc1, ty0, ty1, small, bigt


def _pair_keys_core(xmin, xmax, ymin, ymax, valid, rows: int, cols: int,
                    *, big_cap: int):
    """bbox + valid [T] -> sorted pair keys ``bin << SUB_SHIFT | tri``.
    Small tris (bbox within a 2 x 2 tile-row x subtile-col window) emit up
    to 4 candidate keys; big tris one key per overlapped bin via a
    [big_cap, n_bins] overlap matrix. Unused keys carry bin = n_bins and
    sort last."""
    T = xmin.shape[0]
    dev = xmin.device
    assert T < RS.MAX_TRI, f"subtile sort key supports < {RS.MAX_TRI} tris"
    tiles_y = -(-rows // TILE_H)
    tiles_x = -(-cols // TILE_W)
    sx_n = tiles_x * RS.N_SUB
    n_bins = tiles_y * tiles_x * RS.N_SUB

    sc0, sc1, ty0, ty1, small, bigt = _bin_span(xmin, xmax, ymin, ymax,
                                                valid, rows, cols)
    # clamp BEFORE the span test so borderless-huge bboxes (near-plane
    # crossers) classify big but index sanely
    sc0c = torch.clamp(sc0, 0, sx_n - 1)
    sc1c = torch.clamp(sc1, 0, sx_n - 1)
    ty0c = torch.clamp(ty0, 0, tiles_y - 1)
    ty1c = torch.clamp(ty1, 0, tiles_y - 1)

    tri_ids = torch.arange(T, dtype=torch.int32, device=dev)
    key_parts = []
    for k in range(4):
        ty = ty0 + (k // 2)
        sc = sc0 + (k % 2)
        ok = (small & (ty >= 0) & (ty < tiles_y) & (sc >= 0) & (sc < sx_n)
              & (ty <= ty1) & (sc <= sc1))
        bins = torch.where(ok, ty * sx_n + sc, n_bins)
        key_parts.append((bins << RS.SUB_SHIFT) | tri_ids)

    # big_cap == 0 is a specialisation for scenes without big tris (the
    # bunny headline): a big tri appearing later overflows diag n_big and
    # the caller re-renders with a real cap.
    big_cap = min(big_cap, T)
    if big_cap > 0:
        # the first big_cap big tris in id order (jax.lax.top_k's order);
        # non-big and overflow tris go to a dump slot
        rank = torch.cumsum(bigt.to(torch.int32), 0, dtype=torch.int32) - 1
        slot = torch.where(bigt & (rank < big_cap), rank, big_cap)
        big_idx = torch.full((big_cap + 1,), T, dtype=torch.int32, device=dev)
        big_idx.scatter_(0, slot.long(), tri_ids)
        big_idx[big_cap] = T
        big_idx = big_idx[:big_cap]

        def padi(c, fill):
            return torch.cat([c, c.new_full((1,), fill)])[big_idx.long()]

        bsc0 = padi(sc0c, 1)
        bsc1 = padi(sc1c, 0)
        bty0 = padi(ty0c, 1)
        bty1 = padi(ty1c, 0)
        bins_g = torch.arange(n_bins, dtype=torch.int32, device=dev)
        g_ty = bins_g // sx_n
        g_sc = bins_g % sx_n
        overlap = ((g_sc[None, :] >= bsc0[:, None])
                   & (g_sc[None, :] <= bsc1[:, None])
                   & (g_ty[None, :] >= bty0[:, None])
                   & (g_ty[None, :] <= bty1[:, None])
                   & (big_idx < T)[:, None])
        bins_big = torch.where(overlap, bins_g[None, :], n_bins)
        tri_big = torch.clamp(big_idx, max=T - 1)[:, None].expand(
            big_cap, n_bins)
        key_parts.append(((bins_big << RS.SUB_SHIFT) | tri_big).reshape(-1))
    return torch.sort(torch.cat(key_parts)).values


def _subtile_pair_keys_bbox(cch, rows: int, cols: int, *, big_cap: int):
    """Sorted (bin << SUB_SHIFT | tri) pair keys from bbox channels."""
    return _pair_keys_core(cch["bx0"], cch["bx1"], cch["by0"], cch["by1"],
                           cch["valid"], rows, cols, big_cap=big_cap)


def count_big_small_bbox(cch, rows: int, cols: int):
    """(n_small, n_big) 0-d i32 counts under _pair_keys_core's rules."""
    _, _, _, _, small, bigt = _bin_span(cch["bx0"], cch["bx1"], cch["by0"],
                                        cch["by1"], cch["valid"], rows, cols)
    return small.sum(dtype=torch.int32), bigt.sum(dtype=torch.int32)


def shade_groups(e, xl, yl, table, scene: SceneData, n_attrs: int):
    """Deferred shading over grouped walk output: e f32 [grp_cap, 8, 128]
    winner ids (-1 = bg), xl/yl f32 [grp_cap, 128] pixel-origin lanes,
    table [N, W] per-triangle shade planes. Returns rgb f32
    [grp_cap, 8, 128, 3]."""
    grp_cap = e.shape[0]
    idx = e.reshape(-1).to(torch.int64)
    hit = idx >= 0
    g = table[torch.where(hit, idx, 0)]  # non-hit rows zeroed after
    px = xl[:, None, :].expand(grp_cap, TILE_H, TILE_W)
    py = (yl[:, None, :]
          + (torch.arange(TILE_H, dtype=torch.float32, device=e.device)
             + 0.5)[None, :, None])
    return _shade_rows(g, e >= 0.0, px, py, scene, n_attrs)


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
                     attrs_t=None, emit: str = "rgb", ramp_len: int = 10):
    """Compacted raster pipeline with capacity diagnostics (kernel
    ``subtile8`` only). The soup lives on the device that renders.

    Returns (rgb f32 [rows, cols, 3], diag) with 0-d i32 counts n_valid,
    n_big, n_rows, n_pairs, n_tiles_nz. The frame is exact iff n_big <=
    big_cap, n_rows <= r_cap, n_pairs <= pair_cap and n_tiles_nz <=
    tile_cap (the BIN capacity; grp_cap = tile_cap // 8); otherwise work was
    dropped and the caller re-renders with ``suggest_caps_grouped`` caps.

    emit='idx' quantizes to ramp indices in group layout and assembles
    (idx i32 [rows, cols], rgb8 u8 [rows, cols, 3]) instead — bit-identical
    to quantizing the assembled image (assembly is a permutation)."""
    if kernel != HEADLINE_KERNEL:
        raise _not_ported(f"render_soup_diag(kernel={kernel!r})")
    with stage("raster.mvp"):
        mvp = camera_mvp(cam, rows, cols, pixel_aspect)
    if pos9 is None or attrs_t is None:
        pos9, attrs_t = soup_static_prep(positions, normals, colors, scene)
    A = attrs_t.shape[0] // 3
    tiles_y = -(-rows // TILE_H)
    tiles_x = -(-cols // TILE_W)
    n_tiles = tiles_y * tiles_x
    if tile_cap is None:
        tile_cap = n_tiles * 8
    grp_cap = max(1, tile_cap // 8)
    tw = _round_up(3 * A + 3, 8)

    # each stage is a named range for torch.profiler (chip_smoke --profile)
    with stage("raster.setup"):
        cm, bbox = setup_2dh_fused(pos9, attrs_t, mvp, rows, cols)
    with stage("raster.pack"):
        src16, table = pack_channels_split_blocked(cm,
                                                   [(0, 16), (16, 16 + tw)])
    with stage("raster.keys"):
        keys = _subtile_pair_keys_bbox(bbox, rows, cols, big_cap=big_cap)
    with stage("raster.build"):
        (rows128, rowptr, gdepth, gskip, xl, yl, gbins, n_rows, n_pairs,
         n_used) = RG.build_packed_rows_grouped_kgather(
            src16, keys, tiles_x, n_tiles, r_cap, pair_cap, grp_cap, 8)
    with stage("raster.walk"):
        _z, e = RG.tile_eval_grouped_skip(rows128, rowptr, gdepth, gskip,
                                          xl, yl, grp_cap)
    with stage("raster.shade"):
        rgbg = shade_groups(e, xl, yl, table, scene, A)
    with stage("raster.assemble"):
        _n_small, n_big = count_big_small_bbox(bbox, rows, cols)
        diag = {"n_valid": bbox["valid"].sum(dtype=torch.int32),
                "n_big": n_big, "n_rows": n_rows, "n_pairs": n_pairs,
                "n_tiles_nz": n_used}
        if emit == "idx":
            # empty-ramp fallback: glyph_from_index's ramp_codes
            ramp_len = ramp_len if ramp_len > 0 else len(Q.DEFAULT_RAMP)
            rgb8g = Q.float_rgb_to_u8(rgbg)            # [grp, 8, 128, 3]
            bidx = Q.quantize_index(rgb8g, ramp_len)   # [grp, 8, 128]
            idx_img = RG.assemble_group_image(bidx, gbins, n_tiles, tiles_y,
                                              tiles_x, rows, cols, 0)
            rgb8_img = RG.assemble_group_image(rgb8g, gbins, n_tiles,
                                               tiles_y, tiles_x, rows, cols, 0)
            return (idx_img, rgb8_img), diag
        rgb = RG.assemble_group_image(rgbg, gbins, n_tiles, tiles_y, tiles_x,
                                      rows, cols, 0.0)
    return rgb, diag


_DIAG_KEYS = ("n_valid", "n_big", "n_rows", "n_pairs", "n_tiles_nz")


class RasterBackend:
    """Backend-protocol wrapper. Tessellation happens on scene push.

    Capacity management: every frame's diagnostics are read on the host;
    on overflow the caps grow with margin and the frame re-renders (up to
    4 tries), so no triangle is silently dropped. After the first frame the
    backend adopts lean caps and holds them while they fit."""

    name = "raster"

    def __init__(self, cfg=None, device="cpu"):
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
        if n2t < _GROUPED_MIN_TRIS or n2t > RS.MAX_TRI - 4096:
            raise _not_ported(f"RasterBackend.render at {n2t} triangle slots")
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
