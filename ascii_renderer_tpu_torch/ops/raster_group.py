"""Depth-sorted bin-group walks: the CUDA kernels of ``csrc/raster_group.cu``
(replacing the Pallas walks of ``ascii_renderer_tpu/ops/raster_group.py``),
their plain-torch versions, the grouped generations' table and the image
assembly. The layout builds (depth-group order, CSR offsets, the slot
gathers) live in ``ops/group_build`` (X10 and its plain versions) and are
re-exported here.

All n_tiles*8 bins (8 x 16 px) are sorted by depth (descending, stable by
bin id) and grouped 8 at a time, so one 8 x 128 pixel block walks 8 bins of
similar depth side by side. Every walk keeps, per pixel, the nearest
covering entry of its bin; they differ only in how the entries are laid
out. All four walk slab work items (one 32-entry slab of a group and a
quarter of its pixel block; ``group_work_items``, B9e's
``direct_work_items``) and merge each group's partials in slot order in a
second launch:

  B1  ``tile_eval_grouped_skip`` (``_kernel_grouped_skip``): rows128 f32
      [r_cap, 128], row r holding in lanes 16g..16g+15 the 16 walk channels
      (ops/raster_subtile) of one entry of GROUP-slot g's bin; entry idx =
      row - rowptr[t] of slot g is live iff gskip <= idx < gskip + gdepth.
      Built by ``build_packed_rows_grouped_kgather`` (subtile7 / subtile8:
      the slot gather fetches K entries per row from K-aligned starts, so a
      bin's first `skip` slots belong to the preceding bin in pair order).
  B9d ``tile_eval_grouped`` (``_kernel_grouped``): the same rows128 layout
      without the skip window, built by ``build_packed_rows_grouped``
      (subtile3).
  B9e ``tile_eval_direct`` (``_kernel_direct``): no materialised layout;
      each bin's entries are read straight from the pair-ordered table
      src_pair f32 [P + CHUNK_RG, 32] at goff, built by
      ``build_groups_direct`` (subtile4).
  B9f ``tile_eval_grouped_k2`` (``_kernel_grouped_k2``): rows256 f32
      [r_cap/2, 256], two entries per row (lane g*32 + j*16 + c holds
      channel c of sub-entry j), rowptr in row units, sub-entry idx =
      2*row + j live inside the skip window; built by
      ``build_packed_rows_grouped_k2`` (subtile5) and ``_k4`` (subtile6,
      four-entry rows relaid to this format).

  rowptr i32 [grp_cap+1]: CHUNK_RG-multiple group row ranges (in row units
  of the layout). gdepth/gskip i32 [grp_cap*8] per-bin depth and skip.
  xl/yl f32 [grp_cap, 128]: lane l of group t covers pixel column
  xl[t, l] - 0.5 and rows yl[t, l] + s, s = 0..7 (pixel centres at xl and
  yl + s + 0.5).

Tie-breaking: bins are sorted by triangle id and the depth merge is strict
less-than, so the smallest id wins depth ties. The plane evaluation
(C + A*x) + B*y fuses both products, as the reference's compiler does
(core/fp.py), in the kernels and in their plain versions alike. All
generations give bit-identical winners on the same pair keys.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import group_build as GB
# the layout builds and their pieces live in ops/group_build (X10)
from ascii_renderer_tpu_torch.ops.group_build import (  # noqa: F401
    CHUNK_RG, _bin_offsets, _group_bins, _pixel_origins,
    _round_up_i, _slot_gather, build_groups_direct,
    build_packed_rows_grouped, build_packed_rows_grouped_k2,
    build_packed_rows_grouped_k4, build_packed_rows_grouped_kgather,
    depth_group_order)
from ascii_renderer_tpu_torch.ops.raster_bins import work_list
from ascii_renderer_tpu_torch.ops.raster_subtile import (
    CH_A, CH_B, CH_G, CH_PAIR, CH_ZC, CH_ZX, CH_ZY, N_CHAN, N_SUB, SUB_W,
    TILE_H, TILE_W)

launches = 0          # kernel launches by tile_eval_grouped_skip (B1)
launches_grouped = 0  # kernel launches by tile_eval_grouped (B9d)
launches_direct = 0   # kernel launches by tile_eval_direct (B9e)
launches_k2 = 0       # kernel launches by tile_eval_grouped_k2 (B9f)
# kernels each wrapper launches per call on CUDA tensors: a walk, then
# the merge of its slabs' partials
LAUNCHES_PER_CALL = {"tile_eval_grouped_skip": 2, "tile_eval_grouped_k2": 2,
                     "tile_eval_grouped": 2, "tile_eval_direct": 2}


# --------------------------------------------------------------------------
# Plain-torch versions of the walks
# --------------------------------------------------------------------------
_REF_BATCH = 32   # groups per step of the plain walks (bounds their memory)


def _plane_fused(a, b, c, x, y):
    """(C + A*x) + B*y, both products fused."""
    return fma32(b, y, fma32(a, x, c))


def _walk_ref(fetch, nsteps: torch.Tensor, gdepth, gskip, xl, yl,
              grp_cap: int, *, chunk: int = CHUNK_RG, plane=_plane_fused):
    """The walks' shared body. Group t takes nsteps[t] steps (a ``chunk``
    multiple); step i tests entry idx = i of each slot, chunk c of groups
    gi being ``fetch(gi, c)`` -> [len(gi), chunk, 8, 16] entry channels,
    each plane evaluated as ``plane(A, B, C, x, y)``.
    A pixel keeps the first live covering entry of least z: inside a chunk
    the least index attaining the chunk's minimum, across chunks a strict
    less-than, which is the kernels' entry-by-entry strict merge. Groups
    run in batches ordered by step count, so the live ones are a prefix."""
    dev = xl.device
    inf = float("inf")
    order = torch.sort(nsteps, descending=True, stable=True).indices
    counts = (nsteps[order] // chunk).tolist()
    zb = torch.full((grp_cap, TILE_H, N_SUB, SUB_W), inf, device=dev)
    eb = torch.full((grp_cap, TILE_H, N_SUB, SUB_W), -1.0, device=dev)
    r_iota = torch.arange(chunk, device=dev).view(1, chunk, 1, 1, 1)
    # [group, 1, row, slot, lane] pixel centres
    xs_all = xl.view(grp_cap, 1, 1, N_SUB, SUB_W)
    ys_all = ((torch.arange(TILE_H, dtype=torch.float32, device=dev) + 0.5)
              [None, None, :, None, None]
              + yl.view(grp_cap, 1, 1, N_SUB, SUB_W))
    dep_all = gdepth.view(grp_cap, 1, 1, N_SUB, 1)
    skp_all = gskip.view(grp_cap, 1, 1, N_SUB, 1)
    n_live = len(counts)
    for c in range(counts[0] if counts else 0):
        while n_live and counts[n_live - 1] <= c:
            n_live -= 1
        for b in range(0, n_live, _REF_BATCH):
            gi = order[b:min(b + _REF_BATCH, n_live)]
            # [group, entry, 1, slot, channel]
            ent = fetch(gi, c)[:, :, None]
            xs, ys = xs_all[gi], ys_all[gi]

            def planes(ca, cb, cc):
                return plane(ent[..., ca:ca + 1], ent[..., cb:cb + 1],
                             ent[..., cc:cc + 1], xs, ys)

            ok = (planes(CH_A[0], CH_B[0], CH_G[0]) <= 0.0)
            ok &= planes(CH_A[1], CH_B[1], CH_G[1]) <= 0.0
            ok &= planes(CH_A[2], CH_B[2], CH_G[2]) <= 0.0
            z = planes(CH_ZX, CH_ZY, CH_ZC)
            ok &= (z >= 0.0) & (z <= 1.0)
            idx = c * chunk + r_iota
            skp = skp_all[gi]
            ok &= (idx >= skp) & (idx < skp + dep_all[gi])
            zm = torch.where(ok, z, inf)           # [g, entry, row, slot, lane]
            first = torch.where(zm == zm.amin(dim=1, keepdim=True), r_iota,
                                chunk).amin(dim=1, keepdim=True)
            first = torch.clamp(first, max=chunk - 1)  # all-inf: entry 0
            zc = zm.gather(1, first)[:, 0]
            ec = ent[..., CH_PAIR:CH_PAIR + 1].expand(zm.shape).gather(
                1, first)[:, 0]
            zg = zb[gi]
            better = zc < zg  # strict: earlier (smaller tri id) wins ties
            zb[gi] = torch.where(better, zc, zg)
            eb[gi] = torch.where(better, ec, eb[gi])
    return (zb.view(grp_cap, TILE_H, TILE_W), eb.view(grp_cap, TILE_H, TILE_W))


def tile_eval_grouped_skip_ref(rows128: torch.Tensor, rowptr: torch.Tensor,
                               gdepth: torch.Tensor, gskip: torch.Tensor,
                               xl: torch.Tensor, yl: torch.Tensor,
                               grp_cap: int):
    """Plain-torch version of ``tile_eval_grouped_skip``: chunk c of group
    t reads rows min(rowptr[t] + c*CHUNK_RG, r_cap - CHUNK_RG) + r."""
    r_cap = rows128.shape[0]
    rp = torch.clamp(rowptr.long(), 0, r_cap)
    r0 = rp[:-1]
    r_off = torch.arange(CHUNK_RG, device=rows128.device)

    def fetch(gi, c):
        start = torch.clamp(r0[gi] + c * CHUNK_RG, max=r_cap - CHUNK_RG)
        return rows128[start[:, None] + r_off].view(-1, CHUNK_RG, N_SUB,
                                                    N_CHAN)

    return _walk_ref(fetch, ((rp[1:] - r0) // CHUNK_RG) * CHUNK_RG, gdepth,
                     gskip, xl, yl, grp_cap)


def tile_eval_grouped_ref(rows128: torch.Tensor, rowptr: torch.Tensor,
                          gdepth: torch.Tensor, xl: torch.Tensor,
                          yl: torch.Tensor, grp_cap: int):
    """Plain-torch version of ``tile_eval_grouped``: the skip walk with
    every skip 0 (idx >= 0 always holds)."""
    return tile_eval_grouped_skip_ref(rows128, rowptr, gdepth,
                                      torch.zeros_like(gdepth), xl, yl,
                                      grp_cap)


def tile_eval_grouped_k2_ref(rows256: torch.Tensor, rowptr: torch.Tensor,
                             gdepth: torch.Tensor, gskip: torch.Tensor,
                             xl: torch.Tensor, yl: torch.Tensor,
                             grp_cap: int):
    """Plain-torch version of ``tile_eval_grouped_k2``: row q, sub-entry j
    relaid to single-entry row 2q + j, and the skip walk over it (the
    K2 slab start min(r0 + c*16, r_cap/2 - 16) is half of the relaid one,
    and the visit order 2r + j is the relaid row order)."""
    r_cap2 = rows256.shape[0]
    rows128 = (rows256.view(r_cap2, N_SUB, 2, N_CHAN).transpose(1, 2)
               .reshape(2 * r_cap2, N_SUB * N_CHAN))
    return tile_eval_grouped_skip_ref(rows128, torch.clamp(rowptr, 0, r_cap2)
                                      * 2, gdepth, gskip, xl, yl, grp_cap)


def tile_eval_direct_ref(src_pair: torch.Tensor, goff: torch.Tensor,
                         gdepth: torch.Tensor, gchunks: torch.Tensor,
                         xl: torch.Tensor, yl: torch.Tensor, grp_cap: int):
    """Plain-torch version of ``tile_eval_direct``: chunk c of slot g reads
    src_pair rows min(goff + c*CHUNK_RG, p_max) + r, p_max = rows -
    CHUNK_RG; entry idx live iff idx < gdepth."""
    p_max = src_pair.shape[0] - CHUNK_RG
    goff2 = torch.clamp(goff.long(), min=0).view(grp_cap, N_SUB)
    r_off = torch.arange(CHUNK_RG, device=src_pair.device)[None, :, None]

    def fetch(gi, c):
        start = torch.clamp(goff2[gi] + c * CHUNK_RG, max=p_max)
        return src_pair[start[:, None, :] + r_off, :N_CHAN]

    return _walk_ref(fetch, gchunks.long() * CHUNK_RG, gdepth,
                     torch.zeros_like(gdepth), xl, yl, grp_cap)


# --------------------------------------------------------------------------
# Kernel wrappers: CPU tensors run the plain version, CUDA tensors launch
# --------------------------------------------------------------------------
def _check(what: str, grp_cap: int, data, data_shape, ints: dict, xl, yl):
    if (tuple(data.shape) != data_shape or xl.shape != (grp_cap, TILE_W)
            or yl.shape != (grp_cap, TILE_W)
            or any(t.shape != (n,) for n, t in ints.values())):
        raise ValueError(f"{what}: bad shapes")
    if (data.dtype != torch.float32 or xl.dtype != torch.float32
            or yl.dtype != torch.float32
            or any(t.dtype != torch.int32 for _n, t in ints.values())):
        raise ValueError(f"{what}: bad dtypes")


def _launch_slabs(name: str, data, ints, xl, yl, grp_cap: int,
                  n_slots: int, n: int, scratch=()):
    """Launch slab walk ``name`` (C entry ``walk_{name}_launch``) on
    ``data`` and the int32 tensors ``ints``: the walk over its work list,
    then the merge of the partial results of n_slots slots -> (z, entry
    id) f32 [grp_cap, 8, 128]. ``n`` bounds the slab starts (r_cap, or
    B9e's p_max); ``scratch`` tensors follow the partials (B9e's rowptr,
    which its walk stores for the merge)."""
    tensors = (data, *ints, xl, yl)
    _build.require_cuda(*tensors, what=f"walk {name}")
    if not all(t.is_contiguous() for t in tensors) or data.data_ptr() % 16:
        raise ValueError(f"walk {name}: inputs must be contiguous and the "
                         f"entries 16-byte aligned")
    z = torch.empty((grp_cap, TILE_H, TILE_W), dtype=torch.float32,
                    device=data.device)
    e = torch.empty_like(z)
    part = torch.empty((n_slots, 2, TILE_H * TILE_W), dtype=torch.float32,
                       device=data.device)
    err = getattr(_build.lib(), f"walk_{name}_launch")(
        *[t.data_ptr() for t in tensors], z.data_ptr(), e.data_ptr(),
        part.data_ptr(), *[t.data_ptr() for t in scratch], n_slots, n,
        grp_cap, _build.stream_ptr(z.device))
    _build.check(err, f"walk_{name}_launch")
    return z, e


def _launch_rows(name: str, rows, rowptr, ints, xl, yl, grp_cap: int,
                 slab_rows: int):
    """A layout walk (B1, B9d, B9f): rowptr clamped to the layout's rows,
    the partials sized by ``group_n_slots``."""
    r_cap = rows.shape[0]
    rowptr = torch.clamp(rowptr, 0, r_cap)  # the walk never reads past r_cap
    return _launch_slabs(name, rows, (rowptr, *ints), xl, yl, grp_cap,
                         group_n_slots(r_cap, grp_cap, slab_rows), r_cap)


def group_slots(rowptr: torch.Tensor, rows: int = CHUNK_RG,
                round_up: bool = False):
    """A work list of slabs of ``rows`` layout rows, per group (B1, B9d,
    B9e over ``direct_rowptr``; B9f with ``rows`` = CHUNK_RG // 2, its
    two-entry rows; the subtile walks with ``round_up``, whose last item
    may be short): the first slot and the number of slabs (rowptr clamped
    to [0, r_cap], as the wrappers clamp it). Slab c of group t takes slot
    rowptr[t] // rows + t + c: slots increase with (t, c), so a group's
    slabs are consecutive and merge in slab order."""
    rp = rowptr.long()
    r0 = rp[:-1]
    first = r0 // rows + torch.arange(r0.shape[0], device=rp.device)
    span = rp[1:] - r0 + (rows - 1 if round_up else 0)
    return first, torch.clamp(span // rows, min=0)


def group_n_slots(r_cap: int, grp_cap: int, rows: int = CHUNK_RG,
                  round_up: bool = False) -> int:
    """Slots of the work list for any rowptr into r_cap layout rows."""
    return (-(-r_cap // rows) if round_up else r_cap // rows) + grp_cap


def group_work_items(rowptr: torch.Tensor, r_cap: int, rows: int = CHUNK_RG):
    """(slot, group, slab) of every work item the B1 and B9d (B9f: ``rows``
    = CHUNK_RG // 2, r_cap in two-entry rows) kernels walk."""
    first, n = group_slots(torch.clamp(rowptr, 0, r_cap), rows)
    return work_list(first, n, group_n_slots(r_cap, first.shape[0], rows))


def direct_n_slots(p_eff: int, grp_cap: int) -> int:
    """Slots of B9e's work list, from shapes alone: the bins are disjoint,
    so the groups' slabs number at most ceil(p_eff / CHUNK_RG) + grp_cap,
    and the slot numbering (``group_slots``: + t) adds one a group."""
    return -(-p_eff // CHUNK_RG) + 2 * grp_cap


def direct_rowptr(gchunks: torch.Tensor, n_slots: int) -> torch.Tensor:
    """B9e's rowptr i32 [grp_cap+1], as each block of its walk forms it
    (block 0 also stores it for the merge): CHUNK_RG times the exclusive
    prefix of gchunks, each count clamped to [0, n_slots] and the sum
    saturating at n_slots."""
    c = torch.clamp(gchunks.long(), 0, n_slots)
    incl = torch.clamp(torch.cumsum(c, 0), max=n_slots)
    return (torch.cat([incl.new_zeros((1,)), incl]) * CHUNK_RG).to(torch.int32)


def direct_work_items(gchunks: torch.Tensor, p_eff: int):
    """(slot, group, slab) of every work item the B9e kernel walks: group t
    takes gchunks[t] slabs, numbered as B9d's over ``direct_rowptr``."""
    n_slots = direct_n_slots(p_eff, gchunks.shape[0])
    first, n = group_slots(direct_rowptr(gchunks, n_slots))
    return work_list(first, n, n_slots)


def tile_eval_grouped_skip(rows128: torch.Tensor, rowptr: torch.Tensor,
                           gdepth: torch.Tensor, gskip: torch.Tensor,
                           xl: torch.Tensor, yl: torch.Tensor, grp_cap: int):
    """B1: rows128 f32 [r_cap, 128] grouped layout with skip window ->
    (z, entry id) f32 [grp_cap, 8, 128] per group (lane group g = bin
    gbins[t*8+g]); id -1 = background. CPU tensors run the plain version;
    CUDA tensors launch the kernel once (a call counts one launch): a walk
    over the work list (``group_work_items``: one item per 32-row slab of
    a group and quarter of its pixel block), then a merge of the partial
    results in slab order."""
    if rows128.device.type == "cpu":
        return tile_eval_grouped_skip_ref(rows128, rowptr, gdepth, gskip,
                                          xl, yl, grp_cap)
    global launches
    r_cap = rows128.shape[0]
    if r_cap % CHUNK_RG or r_cap == 0:
        raise ValueError("tile_eval_grouped_skip: r_cap must be a positive "
                         "CHUNK_RG multiple")
    _check("tile_eval_grouped_skip", grp_cap, rows128, (r_cap, TILE_W),
           {"rowptr": (grp_cap + 1, rowptr),
            "gdepth": (grp_cap * N_SUB, gdepth),
            "gskip": (grp_cap * N_SUB, gskip)}, xl, yl)
    out = _launch_rows("grouped_skip", rows128, rowptr, (gdepth, gskip), xl,
                       yl, grp_cap, CHUNK_RG)
    launches += 1
    return out


def tile_eval_grouped(rows128: torch.Tensor, rowptr: torch.Tensor,
                      gdepth: torch.Tensor, xl: torch.Tensor,
                      yl: torch.Tensor, grp_cap: int):
    """B9d: the single-entry grouped walk (no skip window) over
    ``build_packed_rows_grouped``'s layout -> (z, entry id) f32
    [grp_cap, 8, 128]. CPU tensors run the plain version; CUDA tensors
    launch the kernel once: B1's walk over the same work list
    (``group_work_items``) with entry idx = c*32 + r live iff idx < gdepth,
    then the merge of the partial results in slab order."""
    if rows128.device.type == "cpu":
        return tile_eval_grouped_ref(rows128, rowptr, gdepth, xl, yl,
                                     grp_cap)
    global launches_grouped
    r_cap = rows128.shape[0]
    if r_cap % CHUNK_RG or r_cap == 0:
        raise ValueError("tile_eval_grouped: r_cap must be a positive "
                         "CHUNK_RG multiple")
    _check("tile_eval_grouped", grp_cap, rows128, (r_cap, TILE_W),
           {"rowptr": (grp_cap + 1, rowptr),
            "gdepth": (grp_cap * N_SUB, gdepth)}, xl, yl)
    out = _launch_rows("grouped", rows128, rowptr, (gdepth,), xl, yl, grp_cap,
                       CHUNK_RG)
    launches_grouped += 1
    return out


def tile_eval_grouped_k2(rows256: torch.Tensor, rowptr: torch.Tensor,
                         gdepth: torch.Tensor, gskip: torch.Tensor,
                         xl: torch.Tensor, yl: torch.Tensor, grp_cap: int):
    """B9f: the two-entry-row walk over rows256 f32 [r_cap/2, 256] (rowptr
    in row units, CHUNK_RG/2 multiples) -> (z, entry id) f32
    [grp_cap, 8, 128]. CPU tensors run the plain version; CUDA tensors
    launch the kernel once: a walk over the work list
    (``group_work_items(rowptr, r_cap2, CHUNK_RG // 2)``: one item per
    16-row, 32-entry slab of a group and quarter of its pixel block), then
    a merge of the partial results in slab order."""
    if rows256.device.type == "cpu":
        return tile_eval_grouped_k2_ref(rows256, rowptr, gdepth, gskip, xl,
                                        yl, grp_cap)
    global launches_k2
    r_cap2 = rows256.shape[0]
    if r_cap2 % (CHUNK_RG // 2) or r_cap2 == 0:
        raise ValueError("tile_eval_grouped_k2: rows must be a positive "
                         "CHUNK_RG/2 multiple")
    _check("tile_eval_grouped_k2", grp_cap, rows256, (r_cap2, 2 * TILE_W),
           {"rowptr": (grp_cap + 1, rowptr),
            "gdepth": (grp_cap * N_SUB, gdepth),
            "gskip": (grp_cap * N_SUB, gskip)}, xl, yl)
    out = _launch_rows("grouped_k2", rows256, rowptr, (gdepth, gskip), xl, yl,
                       grp_cap, CHUNK_RG // 2)
    launches_k2 += 1
    return out


def tile_eval_direct(src_pair: torch.Tensor, goff: torch.Tensor,
                     gdepth: torch.Tensor, gchunks: torch.Tensor,
                     xl: torch.Tensor, yl: torch.Tensor, grp_cap: int):
    """B9e: the direct walk, each bin read straight from the pair-ordered
    table src_pair f32 [P_pad, 32] (reads clamped to start <= P_pad -
    CHUNK_RG) -> (z, entry id) f32 [grp_cap, 8, 128]; equal to
    ``tile_eval_grouped`` on the same grouping. CPU tensors run the plain
    version; CUDA tensors launch the kernel once: a walk over
    ``direct_work_items`` (slab c of group t and a quarter of its pixel
    block, slot g's 32 entries read from src_pair rows min(goff + c*32,
    P_pad - CHUNK_RG) + r), then the merge of the partial results in slab
    order. The partials are sized from shapes alone (``direct_n_slots``);
    a gchunks that is not the build's is read only as far as they reach."""
    if src_pair.device.type == "cpu":
        return tile_eval_direct_ref(src_pair, goff, gdepth, gchunks, xl, yl,
                                    grp_cap)
    global launches_direct
    p_pad = src_pair.shape[0]
    if p_pad < CHUNK_RG:
        raise ValueError("tile_eval_direct: src_pair needs >= CHUNK_RG rows")
    _check("tile_eval_direct", grp_cap, src_pair, (p_pad, 32),
           {"goff": (grp_cap * N_SUB, goff),
            "gdepth": (grp_cap * N_SUB, gdepth),
            "gchunks": (grp_cap, gchunks)}, xl, yl)
    goff = torch.clamp(goff, min=0)  # the walk never reads before row 0
    p_max = p_pad - CHUNK_RG
    rowptr = torch.empty((grp_cap + 1,), dtype=torch.int32,
                         device=src_pair.device)
    out = _launch_slabs("direct", src_pair, (goff, gdepth, gchunks), xl, yl,
                        grp_cap, direct_n_slots(p_max, grp_cap), p_max,
                        (rowptr,))
    launches_direct += 1
    return out


# --------------------------------------------------------------------------
# The grouped generations: the layout each builds and the walk that reads it
# --------------------------------------------------------------------------
class Generation(NamedTuple):
    """A grouped generation's layout builder, called as ``build(src, pair_key,
    tiles_x, n_tiles, r_cap, pair_cap, grp_cap, offsets=None, y_off=0)``
    (``offsets``: the keys' bin offsets where X9 left them; ``y_off``: a
    row band's first pixel row, added to yl), its walk's kernel wrapper and
    that walk's plain version. Every layout tuple ends (xl, yl, gbins,
    n_rows, n_pairs, n_used, ginv), ginv each bin's place in the depth
    order (``ops/group_build``; K2's image form reads it), and the walk
    takes all of it but the last five items: ``walk(*lay[:-5], grp_cap)``.
    """
    build: Callable
    walk: Callable
    walk_ref: Callable


def _build_direct(src32, pair_key, tiles_x, n_tiles, _r_cap, pair_cap,
                  grp_cap, offsets=None, y_off=0):
    """subtile4's grouping, the torch chain on every device (X10 builds
    the row layouts only; the offsets are formed again here)."""
    return GB._shift_rows(GB.groups_direct(src32, pair_key, tiles_x, n_tiles,
                                           pair_cap, grp_cap), y_off)


def _x10(gen: str):
    """Generation ``gen``'s build: X10's ``build_rows`` at its layout (the
    name read at each call, so a caller may wrap it)."""
    k, rows256 = GB.LAYOUTS[gen]

    def build(*args, **kw):
        return GB.build_rows(*args, k=k, rows256=rows256, **kw)
    return build


_KGATHER_WALK = (tile_eval_grouped_skip, tile_eval_grouped_skip_ref)
_K2_WALK = (tile_eval_grouped_k2, tile_eval_grouped_k2_ref)
GENERATIONS = {
    "subtile3": Generation(_x10("subtile3"), tile_eval_grouped,
                           tile_eval_grouped_ref),                    # B9d
    "subtile4": Generation(_build_direct, tile_eval_direct,
                           tile_eval_direct_ref),                     # B9e
    "subtile5": Generation(_x10("subtile5"), *_K2_WALK),             # B9f
    "subtile6": Generation(_x10("subtile6"), *_K2_WALK),             # B9f
    "subtile7": Generation(_x10("subtile7"), *_KGATHER_WALK),        # B1
    "subtile8": Generation(_x10("subtile8"), *_KGATHER_WALK),        # B1
}


def assemble_group_image(vals: torch.Tensor, gbins: torch.Tensor,
                         n_tiles: int, tiles_y: int, tiles_x: int,
                         rows: int, cols: int, fill: float) -> torch.Tensor:
    """Grouped per-pixel values [grp_cap, 8, 128(, C)] -> image
    [rows, cols(, C)]. Bins not covered by any group (empty or overflow)
    take `fill`. One [n_bins]-row gather + two reshuffles."""
    n_bins = n_tiles * N_SUB
    grp_cap = vals.shape[0]
    trail = tuple(vals.shape[3:])
    dev = vals.device
    # inverse map; sentinel bins (= n_bins) land in a dump slot
    inv = torch.full((n_bins + 1,), grp_cap * N_SUB, dtype=torch.long,
                     device=dev)
    inv.scatter_(0, gbins.long(),
                 torch.arange(grp_cap * N_SUB, dtype=torch.long, device=dev))
    inv = inv[:n_bins]
    flat = (vals.reshape((grp_cap, TILE_H, N_SUB, SUB_W) + trail)
            .transpose(1, 2)
            .reshape((grp_cap * N_SUB, TILE_H * SUB_W) + trail))
    bg = torch.full((1, TILE_H * SUB_W) + trail, fill, dtype=vals.dtype,
                    device=dev)
    img_bins = torch.cat([flat, bg])[inv]
    img = (img_bins.reshape((tiles_y, tiles_x, N_SUB, TILE_H, SUB_W) + trail)
           .permute((0, 3, 1, 2, 4) + tuple(range(5, 5 + len(trail))))
           .reshape((tiles_y * TILE_H, tiles_x * TILE_W) + trail))
    return img[:rows, :cols]
