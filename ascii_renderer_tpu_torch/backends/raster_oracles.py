"""Retired raster pipeline generations, kept as the reference keeps them:
as bit-equivalence oracles users still reach through ``render_soup`` (torch
port of ``ascii_renderer_tpu/backends/raster_oracles.py``).

  - ``render_fused_ch`` (method 'fused'): binning + the fused-shading walk
    B8 (ops/raster_bins.tile_eval_bins_shaded): no visibility buffer.
  - ``visibility_subtile`` / ``visibility_subtile_tiles`` (method
    'subtile'): generation 1, the subtile-packed walks B9a / B9b
    (ops/raster_subtile) over the compacted clip-expansion channels, then
    the tile-compacted deferred shade ``shade_tiles_compact``.
  - ``render_subtile2_diag`` (method 'subtile2'): generation 2, the 2-D
    homogeneous setup B2 ([T] domain, no clip expansion; its channels row
    views of B2's output), one pack (B7) of B2's rows read in place,
    tile-ordered packed rows and the depth-masked walk B9c.

Every name here is re-exported by ``backends.raster``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function as stage

from ascii_renderer_tpu_torch.backends.raster_channels import (
    plane_entries, tile_pairs)
from ascii_renderer_tpu_torch.backends.raster_common import (
    _DEFAULT_DIR, _DEFAULT_DIR_COL, TILE_H, TILE_W, _round_up)
from ascii_renderer_tpu_torch.ops import raster_bins as RB
from ascii_renderer_tpu_torch.ops import raster_shade as RSH
from ascii_renderer_tpu_torch.ops import raster_subtile as RS
from ascii_renderer_tpu_torch.ops import setup2dh as S
from ascii_renderer_tpu_torch.ops.pack import pack_channels
from ascii_renderer_tpu_torch.ops.setup2dh import _plane_keys
from ascii_renderer_tpu_torch.scene.builder import SceneData


# the shared binning prep: (tile, tri) pairs -> packed sort -> offsets
_build_bins = tile_pairs


def light_params(scene: SceneData) -> torch.Tensor:
    """B8's light vector f32 [64] (ops/raster_bins.py layout): ambient =
    env colour * intensity, the first directional light (a default one
    when the scene has none), the point-light count as a float and up to
    L_MAX_PL point lights."""
    dev = scene.env_color.device
    ambient = scene.env_color * scene.env_intensity
    have_dl = scene.n_dl > 0
    ddir = torch.where(have_dl, scene.dl_dir[0],
                       torch.tensor(_DEFAULT_DIR, dtype=torch.float32,
                                    device=dev))
    dcol = torch.where(have_dl, scene.dl_col[0],
                       torch.tensor(_DEFAULT_DIR_COL, dtype=torch.float32,
                                    device=dev))
    n_pl = torch.clamp(scene.n_pt, max=RB.L_MAX_PL).to(torch.float32)
    n = min(RB.L_MAX_PL, scene.pt_pos.shape[0])
    lights = torch.cat([scene.pt_pos[:n], scene.pt_col[:n]], dim=1)
    lp = torch.cat([ambient, ddir, dcol, n_pl.reshape(1), lights.reshape(-1)])
    return torch.cat([lp, lp.new_zeros(64 - lp.shape[0])])


def fused_entries(ch, attr_slots, rows: int, cols: int, big_cap: int = 64):
    """B8's input: the clipped triangles' 64-channel entries gathered into
    sorted-pair order (S_VALID, screen x / y / z, 1/w per vertex, then the
    9 attributes of each vertex slot) with an inert zero tail of
    S_CHUNK + 16 entries, two entries per row. Returns (data f32
    [P'/2, 128], offsets i32 [n_tiles+1], tiles_y, tiles_x)."""
    tri_s, offsets, tiles_y, tiles_x = _build_bins(ch, rows, cols, big_cap)
    keys = (["sxa", "sxb", "sxc", "sya", "syb", "syc", "sza", "szb", "szc",
             "iwa", "iwb", "iwc"])
    chans = [ch[k] for k in keys] + [a for slot in attr_slots for a in slot]
    T = chans[0].shape[0]
    src = torch.stack([torch.ones_like(chans[0])] + chans, dim=-1)
    src = torch.cat([src, src.new_zeros((T, RB.NS_CHAN - src.shape[1]))],
                    dim=-1)
    P = tri_s.shape[0]
    tail = RB.S_CHUNK + 8 * RB.NS_PACK
    pad_rows = (-(P + tail)) % RB.NS_PACK + tail
    data = torch.cat([src[tri_s.long()],
                      src.new_zeros((pad_rows, RB.NS_CHAN))])
    return (data.view(-1, RB.NS_PACK * RB.NS_CHAN), offsets, tiles_y,
            tiles_x)


def render_fused_ch(ch, attr_slots, scene: SceneData, rows: int, cols: int,
                    big_cap: int = 64):
    """Fully fused rasterization: binning + the shaded walk B8, no
    visibility buffer and no deferred gathers. attr_slots: 3 lists of 9
    channels [2T] each (nx ny nz cr cg cb wx wy wz per output vertex
    slot). Returns rgb f32 [rows, cols, 3]."""
    with stage("raster.build"):
        data, offsets, tiles_y, tiles_x = fused_entries(ch, attr_slots, rows,
                                                        cols, big_cap)
        lp = light_params(scene)
    with stage("raster.walk"):
        rgbt = RB.tile_eval_bins_shaded(data, offsets, lp, tiles_x,
                                        tiles_y * tiles_x)
    with stage("raster.assemble"):
        img = (rgbt.view(tiles_y, tiles_x, 3, TILE_H, TILE_W)
               .permute(0, 3, 1, 4, 2)
               .reshape(tiles_y * TILE_H, tiles_x * TILE_W, 3))
        return img[:rows, :cols]


def _entry_planes_src(ch) -> torch.Tensor:
    """Per-triangle global-coordinate walk entries for the subtile walks:
    src f32 [T+1, 16], the edge planes A/B/G per edge and the depth plane
    ZX/ZY/ZC (channels 12..15 zero); row T is the dump row for dead bin
    slots (G0 = +1: never inside; ZC = 2 fails the depth range too)."""
    planes = plane_entries(ch)
    T = planes[0].shape[0]
    src = torch.stack(planes, dim=-1)
    src = torch.cat([src, src.new_zeros((T, RS.N_CHAN - 12))], dim=-1)
    dump = src.new_zeros((1, RS.N_CHAN))
    dump[0, RS.CH_G[0]] = 1.0
    dump[0, RS.CH_ZC] = 2.0
    return torch.cat([src, dump])


def _subtile_pair_keys(cch, rows: int, cols: int, *, big_cap: int):
    """Sorted (bin << SUB_SHIFT | tri) pair keys for the subtile pipeline
    from the clipped triangles' screen bbox (see visibility_subtile for
    the binning rules)."""
    from ascii_renderer_tpu_torch.backends.raster import _pair_keys_core
    xa, xb, xc = cch["sxa"], cch["sxb"], cch["sxc"]
    ya, yb, yc = cch["sya"], cch["syb"], cch["syc"]
    return _pair_keys_core(
        torch.minimum(torch.minimum(xa, xb), xc),
        torch.maximum(torch.maximum(xa, xb), xc),
        torch.minimum(torch.minimum(ya, yb), yc),
        torch.maximum(torch.maximum(ya, yb), yc), cch["valid"], rows, cols,
        big_cap=big_cap)


def _tiles_to_image(v: torch.Tensor, tiles_y: int, tiles_x: int, rows: int,
                    cols: int) -> torch.Tensor:
    """Per-tile values [n_tiles, 8, 128, *C] -> image [rows, cols, *C]."""
    trail = tuple(v.shape[3:])
    img = (v.reshape((tiles_y, tiles_x, TILE_H, TILE_W) + trail)
           .transpose(1, 2)
           .reshape((tiles_y * TILE_H, tiles_x * TILE_W) + trail))
    return img[:rows, :cols]


def visibility_subtile(cch, rows: int, cols: int, *, big_cap: int = 64,
                       r_cap: int = 16384, pair_cap: int = 1 << 30):
    """Subtile-binned visibility through the expanded-row walk B9a.

    Bins are per (8-row tile, 16-px column subtile); small tris (bbox
    within a 2x2 tile-row x subtile-col window) emit up to 4 pairs, big
    tris (up to big_cap, compacted) one pair per overlapped subtile.
    Returns (zbuf f32 [rows, cols], pair_idx i32 [rows, cols] (-1 = bg),
    tri_s i32 [P] pair->triangle map, n_rows, n_pairs): exact iff n_rows
    <= r_cap."""
    tiles_y = -(-rows // TILE_H)
    tiles_x = -(-cols // TILE_W)
    n_tiles = tiles_y * tiles_x
    keys = _subtile_pair_keys(cch, rows, cols, big_cap=big_cap)
    tri_s = keys & (RS.MAX_TRI - 1)
    rows_data, rowptr, n_rows, n_pairs = RS.build_subtile_rows(
        _entry_planes_src(cch), keys, tiles_x, n_tiles, r_cap, pair_cap,
        entry="pair")
    ztile, etile = RS.tile_eval_subtile(rows_data, rowptr, tiles_x, n_tiles)
    zbuf = _tiles_to_image(ztile, tiles_y, tiles_x, rows, cols)
    eidx = _tiles_to_image(etile, tiles_y, tiles_x, rows, cols).to(
        torch.int32)
    return zbuf, torch.where(eidx < 0, -1, eidx), tri_s, n_rows, n_pairs


def visibility_subtile_tiles(cch, rows: int, cols: int, *, big_cap: int,
                             r_cap: int, pair_cap: int):
    """Tiled-form twin of visibility_subtile for the tile-compacted shade,
    through the packed-row walk B9b: returns (etile f32 [n_tiles, 8, 128]
    winning TRIANGLE ids (-1 = bg), nonempty bool [n_tiles], n_rows,
    n_pairs). A tile is nonempty iff it owns aligned rows."""
    tiles_x = -(-cols // TILE_W)
    n_tiles = (-(-rows // TILE_H)) * tiles_x
    with stage("raster.keys"):
        keys = _subtile_pair_keys(cch, rows, cols, big_cap=big_cap)
    with stage("raster.build"):
        rows128, rowptr, n_rows, n_pairs = RS.build_packed_rows(
            _entry_planes_src(cch), keys, tiles_x, n_tiles, r_cap, pair_cap,
            entry="tri")
    with stage("raster.walk"):
        _ztile, etile = RS.tile_eval_packed(rows128, rowptr, tiles_x,
                                            n_tiles)
    return etile, rowptr[1:] > rowptr[:-1], n_rows, n_pairs


def shade_tiles_compact(etile, nonempty, ptable, scene: SceneData,
                        rows: int, cols: int, tile_cap: int, n_attrs: int):
    """Tile-compacted deferred shading: only the first ``tile_cap``
    NONEMPTY tiles' pixels run the plane-table gather + lighting; tiles
    beyond it are dropped (callers check diag n_tiles_nz and retry).
    etile f32 [n_tiles, 8, 128] winner ids (-1 = bg) into ptable [N, W]
    (non-hits read its last row, whose content is never used); returns
    rgb f32 [rows, cols, 3]."""
    dev = etile.device
    tiles_y = -(-rows // TILE_H)
    tiles_x = -(-cols // TILE_W)
    n_tiles = tiles_y * tiles_x
    nz = torch.nonzero(nonempty).squeeze(1)[:tile_cap]
    nz_ids = torch.cat([nz, nz.new_full((tile_cap - nz.shape[0],), n_tiles)])
    pad_tile = etile.new_full((1, TILE_H, TILE_W), -1.0)
    et = torch.cat([etile, pad_tile])[nz_ids]               # [tc, 8, 128]
    t_ids = torch.clamp(nz_ids, max=n_tiles - 1)
    ty = (t_ids // tiles_x).to(torch.float32)
    tx = (t_ids % tiles_x).to(torch.float32)
    sub = torch.arange(TILE_H, dtype=torch.float32, device=dev)
    lane = torch.arange(TILE_W, dtype=torch.float32, device=dev)
    px = tx[:, None, None] * TILE_W + lane[None, None, :] + 0.5
    py = ty[:, None, None] * TILE_H + sub[None, :, None] + 0.5
    # int ids: a pixel is lit where its id, truncated, is >= 0
    rgb = RSH.shade(ptable, et.to(torch.int32), px, py, scene, n_attrs)
    full = torch.zeros((n_tiles + 1, TILE_H, TILE_W, 3), dtype=torch.float32,
                       device=dev)
    full[nz_ids] = rgb
    return _tiles_to_image(full[:n_tiles], tiles_y, tiles_x, rows, cols)


# B2's walk-plane rows, in its output's order
_WALK_KEYS = ("e0a", "e0b", "e0c", "e1a", "e1b", "e1c", "e2a", "e2b", "e2c",
              "zx", "zy", "zc")


def subtile2_setup(pos9, attrs_t, mvp, rows: int, cols: int):
    """Generation 2's setup through B2 (``ops/setup2dh.setup_2dh_fused``,
    its plain version on the CPU): (the JAX ``setup_2dh`` channel dict of
    [T] tensors, the [16 + 3A + 3, T] block the pack reads). Both are
    views of B2's [n_g + 5, Tp] output cut to the T slots (B2 pads to
    1,024 with all-zero triangles, which none of the consumers sees): its
    rows 0-11 the walk planes, 12 the float id, 13-15 zeros, then the
    shade planes, the bbox rows and ``valid``."""
    T = pos9.shape[1]
    A = attrs_t.shape[0] // 3
    cm, bbox = S.setup_2dh_fused(pos9, attrs_t, mvp, rows, cols)
    block = cm.view(cm.shape[0], -1)[:, :T]
    ach = dict(zip(_WALK_KEYS, block[:12]))
    ach.update(zip(_plane_keys(A), block[16:]))
    ach.update((k, v[:T]) for k, v in bbox.items())
    return ach, block


def render_subtile2_diag(attrs, scene: SceneData, mvp, rows: int,
                         cols: int, *, big_cap: int, r_cap: int,
                         pair_cap: int, tile_cap: int | None,
                         pos9=None, attrs_t=None, positions=None):
    """Generation-2 (kernel='subtile2') body of render_soup_diag: the 2-D
    homogeneous setup over the [T] domain (B2; no clip expansion, no
    compaction: invalid triangles emit no pairs), tile-ordered packed rows
    with the entry id baked in (B9c masks the dead slots by depth) and the
    tile-compacted shade. Returns (rgb, diag) with 0-d i32 counts n_valid,
    n_big, n_rows, n_pairs, n_tiles_nz."""
    from ascii_renderer_tpu_torch.backends import raster as R
    if pos9 is None:
        pos9 = R.positions_to_pos9(positions)
    A = attrs.shape[1]
    if attrs_t is None:
        attrs_t = attrs.reshape(-1, 3 * A).t().contiguous()
    with stage("raster.setup"):
        ach, block = subtile2_setup(pos9, attrs_t, mvp, rows, cols)
    tiles_x = -(-cols // TILE_W)
    n_tiles = (-(-rows // TILE_H)) * tiles_x
    if tile_cap is None:
        tile_cap = n_tiles
    with stage("raster.keys"):
        keys = R._subtile_pair_keys_bbox(ach, rows, cols, big_cap=big_cap)
    with stage("raster.pack"):
        # one row-major pack (B7) of B2's rows, read in place, serves both
        # consumers by slicing: cols 0..11 the entry planes, 12 the
        # triangle id, 16.. the shade table
        g40 = pack_channels(block, width=_round_up(block.shape[0], 8))
    with stage("raster.build"):
        rows128, rowptr, depth, n_rows, n_pairs = RS.build_packed_rows_pre_id(
            g40[:, :32], keys, tiles_x, n_tiles, r_cap, pair_cap)
    with stage("raster.walk"):
        _ztile, etile = RS.tile_eval_packed_d(rows128, rowptr, depth,
                                              tiles_x, n_tiles)
    nonempty = rowptr[1:] > rowptr[:-1]
    with stage("raster.shade"):
        rgb = shade_tiles_compact(etile, nonempty, g40[:, 16:16 + 3 * A + 3],
                                  scene, rows, cols, tile_cap=tile_cap,
                                  n_attrs=A)
    _n_small, n_big = R.count_big_small_bbox(ach, rows, cols)
    return rgb, {"n_valid": ach["valid"].sum(dtype=torch.int32),
                 "n_big": n_big, "n_rows": n_rows, "n_pairs": n_pairs,
                 "n_tiles_nz": nonempty.sum(dtype=torch.int32)}


def suggest_caps_subtile(n_valid: int, n_big: int, n_rows: int,
                         n_pairs: int, n_tiles_nz: int = 0):
    """Adaptive capacities for the subtile pipelines: (v_cap, big_cap,
    r_cap, pair_cap, tile_cap), ~8-50% above the last counts, rounded to
    coarse quanta; r_cap stays a multiple of both walks' chunk."""
    max_sub_v = RS.MAX_TRI - 4096
    v_cap = min(max_sub_v, _round_up(int(n_valid * 1.15) + 512, 4096))
    # n_big == 0: big_cap 0 drops the big key part; a big tri appearing
    # later overflows n_big and the retry re-caps
    big_cap = 0 if n_big == 0 else max(16, _round_up(int(n_big * 1.5) + 8,
                                                     16))
    r_cap = _round_up(int(n_rows * 1.08) + 256, max(RS.CHUNK_R, 1024))
    pair_cap = _round_up(int(n_pairs * 1.15) + 512, 4096)
    tile_cap = _round_up(int(n_tiles_nz * 1.15) + 8, 32)
    return v_cap, big_cap, r_cap, pair_cap, tile_cap
