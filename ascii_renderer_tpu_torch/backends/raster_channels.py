"""Clip-expansion channel raster generation, live at small and mid scale
(torch port of ``ascii_renderer_tpu/backends/raster_channels.py``).

The [2T]-domain pipeline: branchless near-clip expansion into
channel-major screen triangles with their screen setup (ops/raster_clip:
one launch of the kernel X4 on CUDA; uncompacted, its table form also
writes the plane table in that launch, and its slots form the attribute
slots of the fused-shading walk), order-preserving valid compaction
(ops/partition: one launch of X13 on CUDA), exact per-tile
binning (the walk's entries and their counts through ops/bin_entries: the
four launches of X9 on CUDA), the bin walks B6 / B6' (ops/raster_bins) and
deferred plane-table shading (the attribute lerps and the table through
ops/plane_table: one launch of the kernel X3 on CUDA; the reference packs
its table with B7 when its length is a multiple of 512); and the
compacted channels of generation 1 (``render_channels_diag(kernel=
"subtile")``, raster_oracles). The chunked ``visibility_scan`` path is the
reference rasterizer the faster paths are compared with, and the one
``render_soup`` takes below 512 triangle slots.

Rounding: the reference is compiled by XLA, whose CPU code generator fuses
a product into the add or subtract it feeds (core/fp.py). Every such chain
below and in the three kernels' plain versions is written with ``fma32``
where the reference's compiled program fuses it (each one carries a
comment), so the clip channels, screen setup, bin entries, plane table
and winners equal the compiled reference bit for bit. A division by a
Python float on a CUDA tensor is not IEEE, so constants divide through
0-d tensors (``quantize.fdiv``).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function as stage

from ascii_renderer_tpu_torch.backends.raster_common import (
    _DEFAULT_DIR, _DEFAULT_DIR_COL, MAX_V_CAP, TILE_H, TILE_W,
    shade_from_table)
from ascii_renderer_tpu_torch.core.fp import fma32, sqrt32
from ascii_renderer_tpu_torch.ops import plane_table as PT
from ascii_renderer_tpu_torch.ops import raster_bins as RB
from ascii_renderer_tpu_torch.ops.bin_entries import (  # noqa: F401
    _tile_span, binned_entries, binned_entries_ref, plane_entries,
    tile_pairs)
from ascii_renderer_tpu_torch.ops import partition as PTN
from ascii_renderer_tpu_torch.ops import raster_clip as RCL
from ascii_renderer_tpu_torch.ops.plane_table import (  # noqa: F401
    _edge_coeffs, _sum3, build_plane_table, clip_attrs_channel_lists,
    clip_attrs_compact_lists, plane_channels)
from ascii_renderer_tpu_torch.ops.raster_clip import (  # noqa: F401
    _clip_channels_core, _recip_guard, setup_screen_channels,
    transform_clip_channels, transform_clip_channels9)
from ascii_renderer_tpu_torch.scene.builder import SceneData


def clip_screen_channels(positions, mvp, rows: int, cols: int, pos9=None):
    """setup_screen_channels(transform_clip_channels(positions, mvp)), or
    with ``pos9`` (the [9, T] geometry) transform_clip_channels9: the [2T]
    clipped-triangle channel dict. One launch of X4 on CUDA
    (ops/raster_clip), its plain version on the CPU."""
    if pos9 is not None:
        return RCL.clip_screen(pos9, mvp, rows, cols, pos9=True)
    return RCL.clip_screen(positions, mvp, rows, cols)


def clip_screen_table_channels(positions, normals, colors, mvp, rows: int,
                               cols: int):
    """clip_screen_channels(positions, mvp, rows, cols) and the plane table
    of its [2T] slots over the attributes [normals, colors, positions]
    with its zero background row (plane_table's uncompacted table, A =
    9): (dict, table). One launch of X4's table form on CUDA
    (ops/raster_clip.clip_screen_table), its plain version on the CPU."""
    return RCL.clip_screen_table(positions, normals, colors, mvp, rows, cols)


def channels_to_setup(ch):
    """Adapter: channel dict -> the [T, 3, ...] setup dict the scan /
    oracle paths consume (the small-lane layout; for tests)."""
    xy = torch.stack([torch.stack([ch["sxa"], ch["sya"]], dim=-1),
                      torch.stack([ch["sxb"], ch["syb"]], dim=-1),
                      torch.stack([ch["sxc"], ch["syc"]], dim=-1)], dim=1)
    z01 = torch.stack([ch["sza"], ch["szb"], ch["szc"]], dim=1)
    return {"xy": xy, "z01": z01, "valid": ch["valid"],
            "area2": ch["area2"]}


def clip_attrs_channels(attrs: torch.Tensor, ch) -> torch.Tensor:
    """Array-layout view of clip_attrs_channel_lists: tattr [2T, 3, A]
    (the scan / oracle paths and tests)."""
    out_slots = clip_attrs_channel_lists(attrs, ch)
    return torch.stack([torch.stack(s, dim=-1) for s in out_slots], dim=1)


def channels_clip_array(ch) -> torch.Tensor:
    """The [2T, 3, 4] clip array from the channels (one stack)."""
    return torch.stack([torch.stack([ch[f"x{s}"], ch[f"y{s}"], ch[f"z{s}"],
                                     ch[f"w{s}"]], dim=-1) for s in "abc"],
                       dim=1)


def transform_clip(positions: torch.Tensor, attrs: torch.Tensor,
                   mvp: torch.Tensor):
    """positions f32 [V=3T, 3], attrs f32 [V, A] -> near-clipped triangles
    (clip [2T, 3, 4], tattr [2T, 3, A], valid [2T]): each input triangle
    emits up to two output triangles (the two-in / one-out case needs both).
    The scan path's bundle form of transform_clip_channels."""
    V = positions.shape[0]
    T = V // 3
    m = mvp.tolist()
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    # the K = 4 dot, summed pairwise (see transform_clip_channels)
    clip = torch.stack([(x * m[j][0] + y * m[j][1]) + (z * m[j][2] + m[j][3])
                        for j in range(4)], dim=1)
    A = attrs.shape[1]
    bundle = torch.cat([clip, attrs], dim=1).reshape(T, 3, 4 + A)

    d = bundle[..., 2] + bundle[..., 3]  # z + w >= 0 is inside (near plane)
    inside = d >= 0.0
    n_in = inside.sum(dim=1)
    # rotate each triangle so the pattern is canonical:
    #   1-in -> the inside vertex first; 2-in -> the OUTSIDE vertex last
    idx_first_in = torch.argmax(inside.to(torch.int8), dim=1)
    idx_out = torch.argmax((~inside).to(torch.int8), dim=1)
    rot = torch.where(n_in == 1, idx_first_in,
                      torch.where(n_in == 2, (idx_out + 1) % 3, 0))
    r = rot[:, None]
    vb = torch.where(r[..., None] == 0, bundle,
                     torch.where(r[..., None] == 1,
                                 torch.roll(bundle, -1, dims=1),
                                 torch.roll(bundle, -2, dims=1)))
    db = torch.where(r == 0, d, torch.where(r == 1, torch.roll(d, -1, dims=1),
                                            torch.roll(d, -2, dims=1)))
    a, b, c = vb[:, 0], vb[:, 1], vb[:, 2]
    da, db_, dc = db[:, 0], db[:, 1], db[:, 2]

    def lerp(p, q, dp, dq):
        t = dp / (dp - dq)
        return fma32(t[:, None], q - p, p)  # p + t*(q - p): fused

    ab = lerp(a, b, da, db_)
    ac = lerp(a, c, da, dc)
    bc = lerp(b, c, db_, dc)
    one_in = (n_in == 1)[:, None, None]
    two_in = (n_in == 2)[:, None, None]
    tri1 = torch.where(one_in, torch.stack([a, ab, ac], dim=1),
                       torch.where(two_in, torch.stack([a, b, bc], dim=1),
                                   torch.stack([a, b, c], dim=1)))
    tri2 = torch.stack([a, bc, ac], dim=1)  # only in the 2-in case
    tris = torch.cat([tri1, tri2], dim=0)
    valid = torch.cat([n_in >= 1, n_in == 2])
    return tris[..., :4], tris[..., 4:], valid


def setup_screen(clip: torch.Tensor, valid: torch.Tensor, rows: int,
                 cols: int):
    """clip [T, 3, 4] -> screen-space setup dict: xy [T, 3, 2] (x right, y
    DOWN from the top row), z01 [T, 3], inv_w [T, 3], area2 [T] and valid
    after the degenerate + back-face cull (front faces have negative
    y-down area, raster.js:100-102). Rounds as the reference's compiled
    program: x and y fuse their products; z fuses only for the third
    vertex (its compiler pairs the first two vertices' products apart);
    the edges come from the stored xy."""
    hx, hy = 0.5 * cols, 0.5 * rows
    inv_w = _recip_guard(clip[..., 3], 1e-9)
    x = fma32(clip[..., 0], inv_w, 1.0) * hx
    y = fma32(-clip[..., 1], inv_w, 1.0) * hy
    zw = clip[..., 2] * inv_w
    z01 = torch.cat([zw[:, :2] + 1.0,
                     fma32(clip[:, 2:, 2], inv_w[:, 2:], 1.0)], dim=1) * 0.5
    xy = torch.stack([x, y], dim=-1)
    e0x, e0y = x[:, 1] - x[:, 0], y[:, 1] - y[:, 0]
    e1x, e1y = x[:, 2] - x[:, 0], y[:, 2] - y[:, 0]
    area2 = fma32(e0x, e1y, -(e0y * e1x))  # a*b - c*d: the left fuses
    valid = valid & (area2 < 0.0) & (area2.abs() > 1e-12)
    return {"xy": xy, "z01": z01, "inv_w": inv_w, "area2": area2,
            "valid": valid}


def _edge(ax, ay, bx, by, px, py):
    """Edge function cross(b - a, p - a): the left product fuses."""
    return fma32(bx - ax, py - ay, -((by - ay) * (px - ax)))


def visibility_scan(setup, rows: int, cols: int, chunk: int = 64):
    """Chunked z-buffer pass producing the visibility buffer: (zbuf f32
    [H, W], tid i32 [H, W], -1 = background). Each step rasterizes
    ``chunk`` triangles as a dense [C, H, W] program and min-merges
    (strict less-than across steps, the first least depth inside one)."""
    xy, z01, valid = setup["xy"], setup["z01"], setup["valid"]
    dev = xy.device
    T = xy.shape[0]
    C = min(chunk, max(T, 1))
    pad = (-T) % C
    if pad:
        xy = torch.cat([xy, xy.new_zeros((pad,) + xy.shape[1:])])
        z01 = torch.cat([z01, z01.new_zeros((pad,) + z01.shape[1:])])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    pxg = (torch.arange(cols, dtype=torch.float32, device=dev) + 0.5)[None, :]
    pyg = (torch.arange(rows, dtype=torch.float32, device=dev) + 0.5)[:, None]
    zbuf = torch.full((rows, cols), float("inf"), device=dev)
    tbuf = torch.full((rows, cols), -1, dtype=torch.int32, device=dev)
    for s in range(0, T + pad, C):
        x = xy[s:s + C, :, 0, None, None]
        y = xy[s:s + C, :, 1, None, None]
        z = z01[s:s + C, :, None, None]
        w0 = _edge(x[:, 1], y[:, 1], x[:, 2], y[:, 2], pxg, pyg)
        w1 = _edge(x[:, 2], y[:, 2], x[:, 0], y[:, 0], pxg, pyg)
        w2 = _edge(x[:, 0], y[:, 0], x[:, 1], y[:, 1], pxg, pyg)
        # front faces have negative orientation: inside = all edges <= 0
        inside = ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)
                  & valid[s:s + C, None, None])
        area = (w0 + w1) + w2
        b0, b1, b2 = w0 / area, w1 / area, w2 / area
        # b0 z0 + b1 z1 + b2 z2 (core/fp.py)
        zpix = fma32(b2, z[:, 2], fma32(b0, z[:, 0], b1 * z[:, 1]))
        ok = inside & (zpix >= 0.0) & (zpix <= 1.0)
        zpix = torch.where(ok, zpix, float("inf"))
        zmin, kmin = torch.min(zpix, dim=0)  # the first least depth
        better = zmin < zbuf
        zbuf = torch.where(better, zmin, zbuf)
        tbuf = torch.where(better, (kmin + s).to(torch.int32), tbuf)
    return zbuf, tbuf


_COMPACT_KEYS = PTN.COMPACT_KEYS


def compact_valid_ch(ch, v_cap: int):
    """Order-preserving compaction of the valid clipped triangles to a
    static [v_cap]. Returns (cch, cidx, n_valid): cch is a channel dict like
    ``ch`` but [v_cap]-shaped (slots past n_valid are inert zeros with
    valid False), cidx [v_cap] i32 maps a compacted slot to its original
    [2T] index (fill = 2T), n_valid the 0-d i32 count. **If n_valid > v_cap
    the overflow triangles are dropped**: callers check the count
    (render_soup_diag / suggest_caps) and re-render with a larger cap.
    One launch of X13's channels form on CUDA
    (ops/partition.compact_channels), its plain version on the CPU."""
    assert v_cap <= MAX_V_CAP, f"v_cap {v_cap} exceeds {MAX_V_CAP}"
    return PTN.compact_channels(ch, v_cap)


def count_big_small(ch, rows: int, cols: int, tile_window: int = 2):
    """(n_small, n_big) 0-d i32 counts under the bin pass's rules, by the
    torch chain of ``_tile_span`` (the CPU route, and the ``"subtile"``
    generation's; the card's bin walk reads X9's counts)."""
    *_, small, big = _tile_span(ch, rows, cols, tile_window)
    return small.sum(dtype=torch.int32), big.sum(dtype=torch.int32)


def shade_planes_ch(tid, ch, attrs, scene: SceneData, rows: int,
                    cols: int, rec=None, cidx=None, table=None):
    """Deferred shading via per-triangle screen-space plane coefficients:
    the plane table of the clipped triangles with its trailing all-zero
    background row (ops/plane_table: the clip's attribute lerps and the
    planes, one launch of X3 on CUDA), then shade_from_table. ``ch`` holds
    the table rows' screen channels, ``rec`` the clip records (``ch``
    itself when None), attrs f32 [3T, A] the per-vertex attributes, cidx
    the compacted rows' [2T] ids. ``table``: the finished table of
    clip_screen_table_channels (A = 9; ``attrs`` then unused), which X4's
    table form wrote in the clip's launch. The reference takes the
    attribute slot lists (clip_attrs_channel_lists) where this takes
    ``attrs``: the kernel applies the lerps itself."""
    if table is None:
        table = PT.plane_table(ch, ch if rec is None else rec, attrs, cidx)
        n_attrs = attrs.shape[1]
    else:
        n_attrs = RCL.TABLE_ATTRS
    return shade_from_table(tid, table, scene, rows, cols, n_attrs=n_attrs)


def visibility_binned_ch(ch, rows: int, cols: int, *, kernel: str = "mm",
                         big_cap: int = 64, tile_window: int = 2,
                         counts: bool = False):
    """Channel-major tile-binned visibility with EXACT per-tile bins
    (binned_entries), walked by B6 (kernel 'mm') or B6' ('loop'). Only
    big triangles past ``big_cap`` are dropped (count_big_small reports
    them). Returns (zbuf f32 [rows, cols], tid i32 [rows, cols], -1 =
    none), and with ``counts`` the bin pass's counts i32 [4] (n_small,
    n_big, n_pairs, n_valid; binned_entries')."""
    data, offsets, tiles_x, n_tiles, *cnt = binned_entries(
        ch, rows, cols, kernel=kernel, big_cap=big_cap,
        tile_window=tile_window, counts=counts)
    walk = RB.tile_eval_bins_mm if kernel == "mm" else RB.tile_eval_bins
    ztile, tidf = walk(data, offsets, tiles_x, n_tiles)
    tiles_y = n_tiles // tiles_x
    zimg = (ztile.reshape(tiles_y, tiles_x, TILE_H, TILE_W)
            .permute(0, 2, 1, 3).reshape(tiles_y * TILE_H, tiles_x * TILE_W))
    timg = (tidf.to(torch.int32).reshape(tiles_y, tiles_x, TILE_H, TILE_W)
            .permute(0, 2, 1, 3).reshape(tiles_y * TILE_H, tiles_x * TILE_W))
    tid = timg[:rows, :cols]
    return (zimg[:rows, :cols], torch.where(tid < 0, -1, tid), *cnt)


def visibility_binned(setup, rows: int, cols: int, slots: int = 256,
                      tile_window: int = 2, big_cap: int = 64,
                      slot_chunk: int = 16):
    """Setup-dict adapter over visibility_binned_ch (for tests and the
    reference's API; ``slots`` / ``slot_chunk`` are the reference's
    obsolete no-ops)."""
    xy, z01 = setup["xy"], setup["z01"]
    ch = {"sxa": xy[:, 0, 0], "sya": xy[:, 0, 1],
          "sxb": xy[:, 1, 0], "syb": xy[:, 1, 1],
          "sxc": xy[:, 2, 0], "syc": xy[:, 2, 1],
          "sza": z01[:, 0], "szb": z01[:, 1], "szc": z01[:, 2],
          "valid": setup["valid"]}
    return visibility_binned_ch(ch, rows, cols, big_cap=big_cap,
                                tile_window=tile_window)


def _reduce3(p, q):
    """sum_k p_k q_k over the last axis (size 3) as the reference's
    compiled reduce runs it: in order, each product fused into the sum."""
    return fma32(p[..., 2], q[..., 2], fma32(p[..., 1], q[..., 1],
                                             p[..., 0] * q[..., 0]))


def shade_visibility(tid, clip, attrs, scene: SceneData, rows: int,
                     cols: int):
    """The scan path's deferred pass: gather the winner triangle's clip
    vertices and attributes per pixel, re-derive perspective-correct
    barycentrics, run the reference fragment lighting. tid i32 [H, W];
    clip [T, 3, 4]; attrs [T, 3, A] (A = 9). Returns rgb f32 [H, W, 3].
    Rounds as the reference's compiled pass: the projected vertices and
    the interpolation weights are formed apart from the sums they feed;
    the edge functions, the 3-term reductions and the lighting sums fuse."""
    dev = clip.device
    hit = tid >= 0
    safe = torch.clamp(tid, min=0).long()
    tri_clip = clip[safe]  # [H, W, 3, 4]
    tri_attr = attrs[safe]  # [H, W, 3, A]
    inv_w = _recip_guard(tri_clip[..., 3], 1e-9)
    x = (tri_clip[..., 0] * inv_w + 1.0) * (0.5 * cols)
    y = (1.0 - tri_clip[..., 1] * inv_w) * (0.5 * rows)
    px = (torch.arange(cols, dtype=torch.float32, device=dev) + 0.5)[None, :]
    py = (torch.arange(rows, dtype=torch.float32, device=dev) + 0.5)[:, None]
    w0 = _edge(x[..., 1], y[..., 1], x[..., 2], y[..., 2], px, py)
    w1 = _edge(x[..., 2], y[..., 2], x[..., 0], y[..., 0], px, py)
    w2 = _edge(x[..., 0], y[..., 0], x[..., 1], y[..., 1], px, py)
    area = (w0 + w1) + w2
    area = torch.where(area.abs() < 1e-12, 1e-12, area)
    b = torch.stack([w0, w1, w2], dim=-1) / area[..., None]  # [H, W, 3]

    # perspective-correct interpolation (GL default for varyings)
    denom = _reduce3(b, inv_w)
    bpc = (b * inv_w) / torch.where(denom.abs() < 1e-12, 1e-12,
                                    denom)[..., None]
    interp = _reduce3(bpc[..., None, :], tri_attr.transpose(-1, -2))
    nrm = interp[..., 0:3]
    col = interp[..., 3:6]
    pos = interp[..., 6:9]
    n = nrm / torch.clamp(sqrt32(_reduce3(nrm, nrm)), min=1e-12)[
        ..., None]

    ambient = scene.env_color * scene.env_intensity
    have_dl = scene.n_dl > 0
    ddir = torch.where(have_dl, scene.dl_dir[0],
                       torch.tensor(_DEFAULT_DIR, dtype=torch.float32,
                                    device=dev))
    dcol = torch.where(have_dl, scene.dl_col[0],
                       torch.tensor(_DEFAULT_DIR_COL, dtype=torch.float32,
                                    device=dev))
    ndl = torch.clamp(_reduce3(n, -ddir), min=0.0)
    # col*ambient + (col*dcol)*ndl: the left product fuses
    out = fma32(col, ambient, (col * dcol) * ndl[..., None])
    n_pl = scene.pt_pos.shape[0]
    pl_valid = torch.arange(n_pl, device=dev) < scene.n_pt
    for i in range(n_pl):
        lvec = scene.pt_pos[i] - pos
        d2 = torch.clamp(_reduce3(lvec, lvec), min=1e-4)
        L = lvec / sqrt32(d2)[..., None]
        ndlp = torch.clamp(_reduce3(n, L), min=0.0)
        att = torch.reciprocal(fma32(d2, 0.05, 1.0))
        w_i = torch.where(pl_valid[i], ndlp * att, 0.0)
        out = fma32(col * scene.pt_col[i], w_i[..., None], out)
    out = torch.clamp(out, 0.0, 1.0)
    return torch.where(hit[..., None], out, 0.0)  # clear color black


def render_channels_diag(positions, attrs, scene: SceneData, mvp,
                         rows: int, cols: int, *, v_cap: int,
                         big_cap: int = 64, kernel: str = "mm",
                         r_cap: int = 16384, pair_cap: int = 65536,
                         tile_cap: int | None = None, pos9=None):
    """Clip-expansion generations of render_soup_diag: compacted channel
    pipeline, then kernel 'mm' / 'loop' (the bin walk B6 / B6' and
    plane-table shading) or 'subtile' (generation 1: the packed subtile
    walk B9b, raster_oracles.visibility_subtile_tiles, and the
    tile-compacted shade). Returns (rgb f32 [rows, cols, 3], diag) with
    0-d i32 counts n_valid, n_big, and for 'subtile' n_rows, n_pairs,
    n_tiles_nz (0 otherwise); the frame is exact iff n_valid <= v_cap,
    n_big <= big_cap and, for 'subtile', n_rows <= r_cap, n_pairs <=
    pair_cap and n_tiles_nz <= tile_cap."""
    if kernel not in ("mm", "loop", "subtile"):
        raise ValueError(f"render_channels_diag: unknown kernel {kernel!r}")
    with stage("raster.clip"):
        ch = clip_screen_channels(positions, mvp, rows, cols, pos9=pos9)
    with stage("raster.compact"):
        cch, cidx, n_valid = compact_valid_ch(ch, v_cap)
    if kernel == "subtile":
        from ascii_renderer_tpu_torch.backends import raster_oracles as RO
        if tile_cap is None:
            tile_cap = (-(-rows // TILE_H)) * (-(-cols // TILE_W))
        etile, nonempty, n_rows, n_pairs = RO.visibility_subtile_tiles(
            cch, rows, cols, big_cap=big_cap, r_cap=r_cap, pair_cap=pair_cap)
        with stage("raster.shade"):
            # the walk emits triangle ids: the shade indexes the plane
            # table directly (one trailing all-zero background row)
            table = PT.plane_table(cch, ch, attrs, cidx)
            rgb = RO.shade_tiles_compact(etile, nonempty, table, scene, rows,
                                         cols, tile_cap=tile_cap,
                                         n_attrs=attrs.shape[1])
            _n_small, n_big = count_big_small(cch, rows, cols)
        return rgb, {"n_valid": n_valid, "n_big": n_big, "n_rows": n_rows,
                     "n_pairs": n_pairs,
                     "n_tiles_nz": nonempty.sum(dtype=torch.int32)}
    with stage("raster.walk"):
        # the bin pass's counts over the compacted slots: n_big is X9's
        # (the plain chain's on the CPU), no second span test
        _zbuf, tid, counts = visibility_binned_ch(
            cch, rows, cols, kernel=kernel, big_cap=big_cap, counts=True)
    with stage("raster.shade"):
        rgb = shade_planes_ch(tid, cch, attrs, scene, rows, cols, rec=ch,
                              cidx=cidx)
    n_big = counts[1]
    zero = torch.zeros((), dtype=torch.int32, device=rgb.device)
    return rgb, {"n_valid": n_valid, "n_big": n_big, "n_rows": zero,
                 "n_pairs": zero, "n_tiles_nz": zero}
