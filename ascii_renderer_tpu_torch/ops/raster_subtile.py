"""Subtile bin geometry, the 16-channel walk-entry layout, and the
channel-era subtile walks: the CUDA kernels of ``csrc/raster_subtile.cu``
(replacing the Pallas walks of ``ascii_renderer_tpu/ops/raster_subtile.py``),
their plain-torch versions and the aligned row-layout builds.

A screen tile is TILE_H x TILE_W pixels and splits into N_SUB column
subtiles ("bins") of SUB_W pixels. Pair sort keys are
``bin << SUB_SHIFT | tri``. A walk entry row holds, per triangle:
    CH_A/CH_B/CH_G  x, y and constant coefficients of the 3 edge planes
                    (inside <=> every plane <= 0), in global pixel centres
    CH_ZX/ZY/ZC     the screen-depth plane
    CH_PAIR         the entry id as f32 (exact below 2^24)
    13..15          zero padding

Each tile walks its 8 bins side by side: row r of the tile's row range
[rowptr[t], rowptr[t+1]) holds, for every lane group g (pixel columns
16g..16g+15), the r-th entry of bin (t, g). Ranges are chunk multiples;
chunk c reads rows min(rowptr[t] + c*chunk, r_cap - chunk) + [0, chunk), so
an overflowing r_cap re-reads the last rows, as the reference does. A pixel
keeps the nearest covering entry; bins are sorted by triangle id and the
merge is a strict z < best, so the smallest id wins depth ties.

  B9a ``tile_eval_subtile`` (``_kernel``): expanded rows f32
      [r_cap, 16, 128], channel c of group g broadcast over its 16 lanes,
      CHUNK_R-row chunks, built by ``build_subtile_rows``. Dead slots hold
      an inert row (G0 = +1). Planes round as fma(A, x, B*y) + G. The
      kernel walks work items of ITEM_R rows (``subtile_work_items``) and
      merges them in a second launch.
  B9b ``tile_eval_packed`` (``_kernel_packed``): packed rows f32
      [r_cap, 128], lane g*16 + c, CHUNK_RP-row chunks, built by
      ``build_packed_rows`` (inert dead slots). The reference expands a
      chunk through a selection dot and folds the tile's x offset bx after
      it, so the planes round as fma(B, y, fma(bx, A, A*(l + 0.5) + G))
      with l the tile-local lane and the dot's product and sum rounded
      apart.
  B9c ``tile_eval_packed_d`` (``_kernel_packed_d``): B9b's walk on
      ``build_packed_rows_pre_id``'s rows, whose dead slots hold arbitrary
      live rows: slot d of bin (t, g) is live iff d < depth[t*8 + g].
The B9b and B9c kernels walk B9a's work list too: one item per CHUNK_RP
(= ITEM_R) row chunk, merged in a second launch.
The TPU expands rows through a constant selection matrix on its matrix
unit; each CUDA thread reads its lane group's channels from shared memory
instead, so the port has no such matrix.
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.ops import _build

TILE_H, TILE_W = 8, 128
SUB_W = 16          # subtile width in px; 8 subtiles per tile
N_SUB = TILE_W // SUB_W
N_CHAN = 16
SUB_SHIFT = 18      # sort key: (tile*8 + subtile) << 18 | tri
MAX_TRI = 1 << SUB_SHIFT
CHUNK_R = 8         # expanded rows per walk chunk (B9a)
CHUNK_RP = 32       # packed rows per walk chunk (B9b, B9c)
ITEM_R = 32         # rows per work item (B9a: four chunks; B9b, B9c: one)

CH_A = (0, 3, 6)
CH_B = (1, 4, 7)
CH_G = (2, 5, 8)
CH_ZX, CH_ZY, CH_ZC = 9, 10, 11
CH_PAIR = 12

launches = 0           # kernel launches by tile_eval_subtile (B9a)
launches_packed = 0    # kernel launches by tile_eval_packed (B9b)
launches_packed_d = 0  # kernel launches by tile_eval_packed_d (B9c)
# kernels each wrapper launches per call on CUDA tensors: a walk, then the
# merge of its work items' partials
LAUNCHES_PER_CALL = {"tile_eval_subtile": 2, "tile_eval_packed": 2,
                     "tile_eval_packed_d": 2}

# entry sources of subtile_walk_launch (csrc/raster_subtile.cu)
_EXPANDED, _PACKED, _PACKED_DEPTH = 0, 1, 2


# --------------------------------------------------------------------------
# Aligned row layouts
# --------------------------------------------------------------------------
def _aligned_rows(pair_key: torch.Tensor, n_tiles: int, r_cap: int,
                  chunk: int, p_search: int):
    """The layout the three builders share: bins of the sorted pair keys
    (CSR offsets over the first p_search keys), each tile's row range the
    deepest of its 8 bins rounded up to ``chunk``, and the pair slot of
    every (row, lane group). Returns (tri_s [P], depth i32 [n_tiles, 8],
    rowptr i32 [n_tiles+1] (unclamped), pidx [r_cap, 8], live bool
    [r_cap, 8], n_pairs 0-d i32)."""
    from ascii_renderer_tpu_torch.ops.raster_group import (_bin_offsets,
                                                           _round_up_i)
    if r_cap <= 0 or r_cap % chunk:
        raise ValueError(f"r_cap {r_cap} must be a positive multiple of "
                         f"{chunk}")
    dev = pair_key.device
    n_bins = n_tiles * N_SUB
    assert n_bins < (1 << 13)  # sentinel key (n_bins << 18) must fit int32
    bin_s = pair_key >> SUB_SHIFT
    tri_s = pair_key & (MAX_TRI - 1)
    offsets = _bin_offsets(bin_s, p_search, n_bins)
    n_pairs = (bin_s < n_bins).sum(dtype=torch.int32)
    depth = (offsets[1:] - offsets[:-1]).view(n_tiles, N_SUB)
    d_pad = _round_up_i(depth.amax(dim=1), chunk)
    rowptr = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        torch.cumsum(d_pad, 0).to(torch.int32)])
    # row -> (tile, row of the tile)
    r_ids = torch.arange(r_cap, dtype=torch.int32, device=dev)
    t_r = torch.clamp(torch.searchsorted(rowptr[1:].contiguous(), r_ids,
                                         right=True), max=n_tiles - 1)
    d_r = r_ids - rowptr[:-1][t_r]
    pidx = offsets[:n_bins].view(n_tiles, N_SUB)[t_r] + d_r[:, None]
    live = (d_r[:, None] < depth[t_r]) & (r_ids < rowptr[-1])[:, None]
    return tri_s, depth, rowptr, pidx, live, n_pairs


def _slot_entries(src: torch.Tensor, tri_s: torch.Tensor, p_eff: int,
                  pidx, live, entry: str, inert_zc: float) -> torch.Tensor:
    """Entry rows of every (row, lane group) slot, [r_cap, 8, 16]: the
    16 walk channels of the slot's pair, CH_PAIR set to its id (``entry``
    "tri": the triangle id, "pair": the sorted pair index); dead slots and
    pairs past p_eff take the inert row (G0 = +1, never inside; ZC =
    ``inert_zc``)."""
    if entry not in ("tri", "pair"):
        raise ValueError(f"entry must be 'tri' or 'pair', got {entry!r}")
    tri = tri_s[:p_eff].long()
    src_pair = src[tri, :N_CHAN].clone()
    src_pair[:, CH_PAIR] = (tri.to(torch.float32) if entry == "tri" else
                            torch.arange(p_eff, dtype=torch.float32,
                                         device=src.device))
    inert = src.new_zeros((1, N_CHAN))
    inert[0, CH_G[0]] = 1.0
    inert[0, CH_ZC] = inert_zc
    src_pair = torch.cat([src_pair, inert])
    slot = torch.where(live & (pidx < p_eff), pidx, p_eff)
    return src_pair[slot.long()]


def build_subtile_rows(src: torch.Tensor, pair_key: torch.Tensor,
                       tiles_x: int, n_tiles: int, r_cap: int,
                       pair_cap: int = 1 << 30, entry: str = "tri"):
    """Sorted pair keys -> B9a's expanded layout.

    src f32 [V+1, >=16] per-triangle walk entries (row V all-zero);
    pair_key i32 [P] sorted ``bin << SUB_SHIFT | tri`` (dead pairs carry
    bin n_tiles*8 and sort last). Returns (rows f32 [r_cap, 16, 128],
    rowptr i32 [n_tiles+1] clamped to r_cap, n_rows, n_pairs), the counts
    0-d i32: n_rows > r_cap means rows were dropped (the caller retries
    with ``suggest_caps_subtile`` caps)."""
    p_eff = min(pair_cap, pair_key.shape[0])
    tri_s, _depth, rowptr, pidx, live, n_pairs = _aligned_rows(
        pair_key, n_tiles, r_cap, CHUNK_R, pair_key.shape[0])
    g = _slot_entries(src, tri_s, p_eff, pidx, live, entry, 0.0)
    rows = g.transpose(1, 2).repeat_interleave(SUB_W, dim=-1)
    return rows, torch.clamp(rowptr, max=r_cap), rowptr[-1], n_pairs


def build_packed_rows(src: torch.Tensor, pair_key: torch.Tensor,
                      tiles_x: int, n_tiles: int, r_cap: int,
                      pair_cap: int = 1 << 30, entry: str = "tri"):
    """build_subtile_rows' contract in B9b's packed layout: (rows128 f32
    [r_cap, 128] (lane g*16 + c), rowptr (CHUNK_RP quanta), n_rows,
    n_pairs). Its inert row also fails the depth test (ZC = 2)."""
    p_eff = min(pair_cap, pair_key.shape[0])
    tri_s, _depth, rowptr, pidx, live, n_pairs = _aligned_rows(
        pair_key, n_tiles, r_cap, CHUNK_RP, pair_key.shape[0])
    g = _slot_entries(src, tri_s, p_eff, pidx, live, entry, 2.0)
    return (g.reshape(r_cap, TILE_W), torch.clamp(rowptr, max=r_cap),
            rowptr[-1], n_pairs)


def build_packed_rows_pre_id(src32: torch.Tensor, pair_key: torch.Tensor,
                             tiles_x: int, n_tiles: int, r_cap: int,
                             pair_cap: int = 1 << 30):
    """B9c's packed layout for sources whose entry id is already in
    channel CH_PAIR: no id column is written and no inert row exists; bin
    offsets come from the live sorted prefix of p_eff = min(pair_cap, P)
    pairs, and every slot reads some live pair's row (clamped to the
    prefix), so the walk must mask dead slots by depth. Returns (rows128
    f32 [r_cap, 128], rowptr, depth i32 [n_tiles*8], n_rows, n_pairs)
    with n_pairs the exact pair count (vs pair_cap)."""
    p_eff = min(pair_cap, pair_key.shape[0])
    tri_s, depth, rowptr, pidx, _live, n_pairs = _aligned_rows(
        pair_key, n_tiles, r_cap, CHUNK_RP, p_eff)
    tri = tri_s[torch.clamp(pidx, 0, p_eff - 1).long()]
    rows128 = src32[tri.long(), :N_CHAN].reshape(r_cap, TILE_W)
    return (rows128, torch.clamp(rowptr, max=r_cap), depth.reshape(-1),
            rowptr[-1], n_pairs)


# --------------------------------------------------------------------------
# Plain-torch versions of the walks
# --------------------------------------------------------------------------
def _plane_expanded(a, b, c, x, y):
    """B9a: A*x fused onto B*y, then + G."""
    return fma32(a, x, b * y) + c


def _plane_packed(a, b, c, x, y):
    """B9b / B9c: P = A*(l + 0.5) + G rounded twice (the expand dot), then
    A*bx and B*y each fused on (x = bx + l + 0.5, all exact)."""
    lx = (torch.arange(TILE_W, dtype=torch.float32, device=x.device)
          + 0.5).view(N_SUB, SUB_W)
    p = a * lx + c
    return fma32(b, y, fma32(x - lx, a, p))


def _tile_walk_ref(rows: torch.Tensor, rowptr: torch.Tensor, depth,
                   tiles_x: int, n_tiles: int, chunk: int, plane,
                   expanded: bool):
    """The subtile walks on the grouped walks' plain body
    (ops/raster_group._walk_ref), each tile a group whose lane origins are
    the tile's pixel centres."""
    from ascii_renderer_tpu_torch.ops.raster_group import _walk_ref
    dev = rows.device
    r_cap = rows.shape[0]
    rp = torch.clamp(rowptr.long(), 0, r_cap)
    r0 = rp[:-1]
    r_off = torch.arange(chunk, device=dev)

    def fetch(gi, c):
        start = torch.clamp(r0[gi] + c * chunk, max=r_cap - chunk)
        r = rows[start[:, None] + r_off]
        if expanded:  # lane 16 g of channel c holds group g's value
            return r[..., ::SUB_W].transpose(-1, -2)
        return r.view(-1, chunk, N_SUB, N_CHAN)

    t = torch.arange(n_tiles, device=dev)
    xl = (((t % tiles_x) * TILE_W)[:, None]
          + torch.arange(TILE_W, device=dev)[None, :]).to(torch.float32) + 0.5
    yl = ((t // tiles_x) * TILE_H).to(torch.float32)[:, None].expand(
        n_tiles, TILE_W)
    if depth is None:  # inert dead slots: every slot is walked
        depth = torch.full((n_tiles * N_SUB,), 1 << 30, dtype=torch.int32,
                           device=dev)
    return _walk_ref(fetch, ((rp[1:] - r0) // chunk) * chunk, depth,
                     torch.zeros_like(depth), xl, yl, n_tiles, chunk=chunk,
                     plane=plane)


def tile_eval_subtile_ref(rows_data: torch.Tensor, rowptr: torch.Tensor,
                          tiles_x: int, n_tiles: int):
    """Plain-torch version of ``tile_eval_subtile``."""
    return _tile_walk_ref(rows_data, rowptr, None, tiles_x, n_tiles, CHUNK_R,
                          _plane_expanded, True)


def tile_eval_packed_ref(rows128: torch.Tensor, rowptr: torch.Tensor,
                         tiles_x: int, n_tiles: int):
    """Plain-torch version of ``tile_eval_packed``."""
    return _tile_walk_ref(rows128, rowptr, None, tiles_x, n_tiles, CHUNK_RP,
                          _plane_packed, False)


def tile_eval_packed_d_ref(rows128: torch.Tensor, rowptr: torch.Tensor,
                           depth: torch.Tensor, tiles_x: int, n_tiles: int):
    """Plain-torch version of ``tile_eval_packed_d``."""
    return _tile_walk_ref(rows128, rowptr, depth, tiles_x, n_tiles, CHUNK_RP,
                          _plane_packed, False)


# --------------------------------------------------------------------------
# Kernel wrappers: CPU tensors run the plain version, CUDA tensors launch
# --------------------------------------------------------------------------
def _check(what: str, rows, row_shape, chunk: int, rowptr, depth,
           n_tiles: int):
    r_cap = rows.shape[0]
    if rows.dim() != 1 + len(row_shape) or tuple(rows.shape[1:]) != row_shape:
        raise ValueError(f"{what}: expected rows [r_cap, "
                         f"{', '.join(map(str, row_shape))}], got "
                         f"{tuple(rows.shape)}")
    if r_cap <= 0 or r_cap % chunk:
        raise ValueError(f"{what}: r_cap {r_cap} must be a positive multiple "
                         f"of {chunk}")
    if rows.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32 rows")
    ints = [(rowptr, n_tiles + 1)] + ([] if depth is None else
                                      [(depth, n_tiles * N_SUB)])
    for t, n in ints:
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{what}: expected int32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")


def _launch(what: str, rows, rowptr, depth, tiles_x: int, n_tiles: int,
            source: int):
    """One call of a subtile walk kernel (``source``): the walk over the
    work list (``subtile_work_items``), then the merge of the partial
    results in row order -> (z, entry id) f32 [n_tiles, 8, 128]."""
    r_cap = rows.shape[0]
    rowptr = torch.clamp(rowptr, 0, r_cap)  # reads stay below r_cap
    tensors = (rows, rowptr) + (() if depth is None else (depth,))
    _build.require_cuda(*tensors, what=what)
    if rows.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte aligned")
    z = torch.empty((n_tiles, TILE_H, TILE_W), dtype=torch.float32,
                    device=rows.device)
    e = torch.empty_like(z)
    if n_tiles:
        slots = subtile_n_slots(r_cap, n_tiles)
        part = torch.empty((slots, 2, TILE_H * TILE_W), dtype=torch.float32,
                           device=rows.device)
        err = _build.lib().subtile_walk_launch(
            rows.data_ptr(), rowptr.data_ptr(),
            None if depth is None else depth.data_ptr(), z.data_ptr(),
            e.data_ptr(), part.data_ptr(), slots, n_tiles, tiles_x, r_cap,
            source, _build.stream_ptr(rows.device))
        _build.check(err, "subtile_walk_launch")
    return z, e


def subtile_items(rowptr: torch.Tensor):
    """The subtile walks' work list, per tile: the first slot and the
    number of ITEM_R-row items (rowptr clamped to [0, r_cap], as the
    wrappers clamp it; B9a's rowptr in CHUNK_R multiples rounds up to a
    last short item). Item k of tile t holds the tile's rows k*ITEM_R ..
    and takes slot rowptr[t] // ITEM_R + t + k: slots increase with (t, k),
    so a tile's items are consecutive and merge in row order. One packed
    chunk (CHUNK_RP == ITEM_R) is one item."""
    from ascii_renderer_tpu_torch.ops.raster_group import group_slots
    return group_slots(rowptr, ITEM_R, round_up=True)


def subtile_n_slots(r_cap: int, n_tiles: int) -> int:
    """Slots of the subtile walks' work list for any rowptr into r_cap
    rows."""
    from ascii_renderer_tpu_torch.ops.raster_group import group_n_slots
    return group_n_slots(r_cap, n_tiles, ITEM_R, round_up=True)


def subtile_work_items(rowptr: torch.Tensor, r_cap: int):
    """(slot, tile, item) of every work item the B9a, B9b and B9c kernels
    walk."""
    from ascii_renderer_tpu_torch.ops.raster_bins import work_list
    first, n = subtile_items(torch.clamp(rowptr, 0, r_cap))
    return work_list(first, n, subtile_n_slots(r_cap, first.shape[0]))


def tile_eval_subtile(rows_data: torch.Tensor, rowptr: torch.Tensor,
                      tiles_x: int, n_tiles: int):
    """B9a: expanded rows f32 [r_cap, 16, 128], rowptr i32 [n_tiles+1] in
    CHUNK_R multiples -> (z, entry id) f32 [n_tiles, 8, 128], id -1 =
    background. CPU tensors run the plain version; CUDA tensors launch the
    kernel once: a walk over the work list (``subtile_work_items``: one
    item per ITEM_R rows of a tile and quarter of its pixel rows), then a
    merge of the partial results in row order."""
    _check("tile_eval_subtile", rows_data, (N_CHAN, TILE_W), CHUNK_R,
           rowptr, None, n_tiles)
    if rows_data.device.type == "cpu":
        return tile_eval_subtile_ref(rows_data, rowptr, tiles_x, n_tiles)
    global launches
    out = _launch("tile_eval_subtile", rows_data, rowptr, None, tiles_x,
                  n_tiles, _EXPANDED)
    launches += 1
    return out


def tile_eval_packed(rows128: torch.Tensor, rowptr: torch.Tensor,
                     tiles_x: int, n_tiles: int):
    """B9b: packed rows f32 [r_cap, 128], rowptr in CHUNK_RP multiples ->
    (z, entry id) f32 [n_tiles, 8, 128], id -1 = background. CPU tensors
    run the plain version; CUDA tensors launch the kernel once: a walk
    over the work list (``subtile_work_items``: one item per chunk of a
    tile), then a merge of the partial results in row order."""
    _check("tile_eval_packed", rows128, (TILE_W,), CHUNK_RP, rowptr, None,
           n_tiles)
    if rows128.device.type == "cpu":
        return tile_eval_packed_ref(rows128, rowptr, tiles_x, n_tiles)
    global launches_packed
    out = _launch("tile_eval_packed", rows128, rowptr, None, tiles_x,
                  n_tiles, _PACKED)
    launches_packed += 1
    return out


def tile_eval_packed_d(rows128: torch.Tensor, rowptr: torch.Tensor,
                       depth: torch.Tensor, tiles_x: int, n_tiles: int):
    """B9c: tile_eval_packed with the per-bin depth mask (depth i32
    [n_tiles*8], from ``build_packed_rows_pre_id``)."""
    _check("tile_eval_packed_d", rows128, (TILE_W,), CHUNK_RP, rowptr, depth,
           n_tiles)
    if rows128.device.type == "cpu":
        return tile_eval_packed_d_ref(rows128, rowptr, depth, tiles_x,
                                      n_tiles)
    global launches_packed_d
    out = _launch("tile_eval_packed_d", rows128, rowptr, depth, tiles_x,
                  n_tiles, _PACKED_DEPTH)
    launches_packed_d += 1
    return out
