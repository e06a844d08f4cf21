"""The grouped generations' layout build (X10): the CUDA kernels of
``csrc/group_build.cu``, their plain versions and the torch layout code
they replace (torch port of ``ascii_renderer_tpu/ops/raster_group.py``'s
layout builds, depth-group order and CSR offsets, moved here from
``ops/raster_group``, which re-exports them).

From the sorted pair keys ``bin << SUB_SHIFT | tri`` every layout build
forms the CSR offsets of the first p_eff = min(pair_cap, P) pairs, orders
the bins by depth (descending, ascending bin id among equal depths) into
groups of 8, gives each group CHUNK_RG-multiple rows and gathers each
slot's entries K at a time from K-aligned starts (``_slot_gather``). On
CUDA tensors the chain is some 87 launches at the headline;
``build_rows`` is two (three when the caller has no offsets: X9 leaves
them beside the keys): one block for the depth order (the nonempty bins
compacted by ballots and counted into depth buckets, each placed by its
bucket's start and the bins of its bucket ahead of it; the empty ones
after them; each bin's place in that order, ``ginv``, which K2's image
form reads), a thread a slot for the slots, skips and row pointers, and
each used K-row's group; four lanes a (row, slot) gathering its pair's 16
channels straight into the layout, the K-row relayout folded into the store's
address, and the lanes' pixel origins.
It serves the rows128 layout (subtile3: K = 1; subtile7 / subtile8: K =
4 / 8) and rows256 (subtile5 / subtile6: K = 2 / 4), ``LAYOUTS``;
subtile4's direct grouping (``build_groups_direct``) stays the torch
chain. Stands for XLA code, not a Pallas kernel.
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops.raster_subtile import (
    MAX_TRI, N_CHAN, N_SUB, SUB_SHIFT, SUB_W, TILE_H, TILE_W)

CHUNK_RG = 32      # entries per bin slot per walk slab (16 KB of shared memory)

launches = 0       # calls of build_rows that launched X10
last_launches = 0  # kernels the last launching call ran (2; 3 without offsets)
# the depth order with the slots and row pointers, the gather (the bins'
# offsets first when the caller has none)
LAUNCHES_PER_CALL = {"build_rows": 2}
# the generations X10 builds: (K entries a gathered row, rows256)
LAYOUTS = {"subtile3": (1, False), "subtile5": (2, True),
           "subtile6": (4, True), "subtile7": (4, False),
           "subtile8": (8, False)}


def _round_up_i(x, q: int):
    return ((x + q - 1) // q) * q


def _bin_offsets(bin_s: torch.Tensor, p_eff: int, n_bins: int) -> torch.Tensor:
    """offsets[q] = #entries of the SORTED bin_s[:p_eff] with bin < q,
    q in [0, n_bins] — the CSR offsets of the pair list."""
    q = torch.arange(n_bins + 1, dtype=bin_s.dtype, device=bin_s.device)
    return torch.searchsorted(bin_s[:p_eff].contiguous(), q,
                              side="left").to(torch.int32)


def depth_group_order(depth_bins: torch.Tensor, n_bins: int):
    """Bin visit order for the depth-similar grouping: (binperm i32
    [n_bins], depth_sorted i32 [n_bins]), depth descending, ascending bin
    id among equal depths (a stable sort)."""
    negd, binperm = torch.sort(-depth_bins, stable=True)
    return binperm.to(torch.int32), -negd


def _pixel_origins(gbins, tiles_x: int, n_bins: int, grp_cap: int):
    """Per-group lane pixel origins xl, yl f32 [grp_cap, 128] (sentinel
    slots clamp to the last bin: their depth is 0, so no lane lights)."""
    safe_bins = torch.clamp(gbins, max=n_bins - 1)
    tile = safe_bins // N_SUB
    sub = safe_bins % N_SUB
    x0 = ((tile % tiles_x) * TILE_W + sub * SUB_W).to(torch.float32)
    y0 = ((tile // tiles_x) * TILE_H).to(torch.float32)
    lane_in = torch.arange(SUB_W, dtype=torch.float32, device=gbins.device) + 0.5
    xl = (torch.repeat_interleave(x0.view(grp_cap, N_SUB), SUB_W, dim=1)
          + lane_in.repeat(N_SUB)[None, :])
    yl = torch.repeat_interleave(y0.view(grp_cap, N_SUB), SUB_W, dim=1)
    return xl, yl


def group_inverse(binperm: torch.Tensor) -> torch.Tensor:
    """ginv i32 [n_bins]: each bin's place in the depth order ``binperm``
    [n_bins] (every bin's, the places from grp_cap*8 on included)."""
    ginv = torch.empty_like(binperm)
    ginv[binperm.long()] = torch.arange(binperm.shape[0], dtype=binperm.dtype,
                                        device=binperm.device)
    return ginv


def _group_bins(pair_key: torch.Tensor, n_tiles: int, pair_cap: int,
                grp_cap: int):
    """Sorted pair keys ``bin << SUB_SHIFT | tri`` -> (tri_s, p_eff,
    offsets [n_bins+1], gbins, gdepth [grp_cap*8], n_pairs, n_used, ginv
    [n_bins]): the CSR offsets of the first p_eff = min(pair_cap, P) pairs
    and the bins in depth-group order, sentinel-padded (bin n_bins, depth
    0) when there are more group slots than bins, and each bin's place in
    that order (``group_inverse``). Bins past grp_cap*8 (the shallowest)
    are dropped; n_used > grp_cap*8 reports it."""
    n_bins = n_tiles * N_SUB
    assert n_bins < (1 << 13)  # sentinel key (n_bins << 18) must fit int32
    bin_s = pair_key >> SUB_SHIFT
    tri_s = pair_key & (MAX_TRI - 1)
    p_eff = min(pair_cap, pair_key.shape[0])
    offsets = _bin_offsets(bin_s, p_eff, n_bins)
    n_pairs = (bin_s < n_bins).sum(dtype=torch.int32)
    depth_bins = offsets[1:] - offsets[:-1]
    n_used = (depth_bins > 0).sum(dtype=torch.int32)
    binperm, dsorted = depth_group_order(depth_bins, n_bins)
    ginv = group_inverse(binperm)
    nsel = grp_cap * N_SUB
    if nsel > n_bins:  # more group slots than bins: sentinel-pad
        pad = nsel - n_bins
        binperm = torch.cat([binperm, binperm.new_full((pad,), n_bins)])
        dsorted = torch.cat([dsorted, dsorted.new_zeros((pad,))])
    return (tri_s, p_eff, offsets, binperm[:nsel], dsorted[:nsel], n_pairs,
            n_used, ginv)


def _slot_gather(src32, pair_key, tiles_x: int, n_tiles: int, r_cap: int,
                 pair_cap: int, grp_cap: int, k: int):
    """The slot gather every materialised layout shares: K consecutive bin
    entries per gathered row, from K-aligned starts in the pair-ordered
    16-channel source. Returns (g f32 [r_cap/k*8, k*16] (gathered row q of
    group slot s at q*8 + s), rowptr [grp_cap+1] in entries (CHUNK_RG
    multiples, clamped to r_cap), gdepth, gskip, xl, yl, gbins, n_rows,
    n_pairs, n_used, ginv) with n_rows the true entry-row total (vs
    r_cap)."""
    assert k in (1, 2, 4, 8) and CHUNK_RG % k == 0 and r_cap % CHUNK_RG == 0
    dev = pair_key.device
    n_bins = n_tiles * N_SUB
    tri_s, p_eff, offsets, gbins, gdepth, n_pairs, n_used, ginv = \
        _group_bins(pair_key, n_tiles, pair_cap, grp_cap)
    # a sentinel slot (depth 0, never live) reads bin n_bins's offset; the
    # single-entry layout's reference gathers from offsets[:n_bins], which
    # clamps it to the last bin
    last = n_bins - 1 if k == 1 else n_bins
    off_g = offsets[torch.clamp(gbins, max=last).long()]
    gskip = torch.where(gdepth > 0, off_g % k, torch.zeros_like(off_g))
    offk = (off_g - gskip) // k          # K-aligned K-row start per bin
    rbk = (gdepth + gskip + k - 1) // k  # K-rows needed per bin
    d_pad = _round_up_i(rbk.view(grp_cap, N_SUB).amax(dim=1) * k, CHUNK_RG)
    rowptr = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        torch.cumsum(d_pad, 0).to(torch.int32)])
    n_rows = rowptr[-1]

    # group of each K-row, and its offset inside the group
    rowptrk = rowptr // k
    rk_ids = torch.arange(r_cap // k, dtype=torch.int32, device=dev)
    t_r = torch.clamp(torch.searchsorted(rowptrk[1:].contiguous(), rk_ids,
                                         right=True), max=grp_cap - 1)
    d_rk = rk_ids - rowptrk[:-1][t_r]
    off_rows = offk.view(grp_cap, N_SUB)[t_r]          # [r_cap/k, 8]

    # pair-ordered 16-channel source, K entries per k*16-lane row
    src_pair = src32[tri_s[:p_eff].long(), :N_CHAN]
    pek = _round_up_i(p_eff, k)
    if pek > p_eff:
        src_pair = torch.cat([src_pair, src_pair.new_zeros((pek - p_eff,
                                                            N_CHAN))])
    srckk = src_pair.view(pek // k, k * N_CHAN)
    pidx = torch.clamp(off_rows + d_rk[:, None], 0, pek // k - 1).reshape(-1)
    g = srckk[pidx.long()]                              # [r_cap/k*8, k*16]
    xl, yl = _pixel_origins(gbins, tiles_x, n_bins, grp_cap)
    return (g, torch.clamp(rowptr, max=r_cap), gdepth, gskip, xl, yl, gbins,
            n_rows, n_pairs, n_used, ginv)


def build_packed_rows_grouped(src32: torch.Tensor, pair_key: torch.Tensor,
                              tiles_x: int, n_tiles: int, r_cap: int,
                              pair_cap: int, grp_cap: int):
    """Sorted pair keys -> the single-entry grouped layout (subtile3).

    src32 f32 [Tp, >=16] walk-entry rows (only channels :16 are read, so
    the 16-wide rows of ``setup_2dh_fused_packed`` serve too); pair_key
    i32 [P] sorted ``bin << SUB_SHIFT | tri``. Returns (rows128 [r_cap,
    128], rowptr [grp_cap+1], gdepth [grp_cap*8], xl, yl [grp_cap, 128],
    gbins [grp_cap*8], n_rows, n_pairs, n_used), the counts as 0-d i32
    tensors: n_rows = true row total (vs r_cap), n_pairs = true pair count
    (vs pair_cap), n_used = nonempty bins (vs grp_cap*8). A count over its
    cap means work was dropped and the caller must re-render."""
    return build_rows_ref(src32, pair_key, tiles_x, n_tiles, r_cap,
                          pair_cap, grp_cap, k=1)[:-1]


def build_packed_rows_grouped_kgather(src32: torch.Tensor,
                                      pair_key: torch.Tensor,
                                      tiles_x: int, n_tiles: int,
                                      r_cap: int, pair_cap: int,
                                      grp_cap: int, k: int):
    """The K-entry slot gather (subtile7: K = 4, subtile8: K = 8) relaid to
    the single-entry rows128 layout (bins whose CSR offset is not K-aligned
    start mid-row; the walk masks those leading slots by gskip).

    Returns (rows128 [r_cap, 128], rowptr [grp_cap+1] (CHUNK_RG multiples,
    clamped to r_cap), gdepth, gskip [grp_cap*8], xl, yl [grp_cap, 128],
    gbins [grp_cap*8], n_rows, n_pairs, n_used), as
    ``build_packed_rows_grouped`` plus gskip."""
    assert k in (2, 4, 8)
    return build_rows_ref(src32, pair_key, tiles_x, n_tiles, r_cap,
                          pair_cap, grp_cap, k=k)[:-1]


def build_packed_rows_grouped_k2(src32: torch.Tensor, pair_key: torch.Tensor,
                                 tiles_x: int, n_tiles: int, r_cap: int,
                                 pair_cap: int, grp_cap: int):
    """The two-entry-row layout of the K2 walk (subtile5): the slot gather
    fetches two consecutive bin entries per row; a bin whose CSR offset is
    odd starts mid-row (gskip = 1).

    Returns (rows256 [r_cap/2, 256], rowptr [grp_cap+1] in row units
    (CHUNK_RG/2 multiples), gdepth, gskip [grp_cap*8], xl, yl, gbins,
    n_rows, n_pairs, n_used) with n_rows in ENTRY units, compared against
    the same r_cap as the single-entry walk."""
    return build_rows_ref(src32, pair_key, tiles_x, n_tiles, r_cap,
                          pair_cap, grp_cap, k=2, rows256=True)[:-1]


def build_packed_rows_grouped_k4(src32: torch.Tensor, pair_key: torch.Tensor,
                                 tiles_x: int, n_tiles: int, r_cap: int,
                                 pair_cap: int, grp_cap: int):
    """Four entries per gathered row relaid to the K2 row format by one
    permutation (subtile6): gskip in [0, 3]. Same tuple as
    ``build_packed_rows_grouped_k2``."""
    return build_rows_ref(src32, pair_key, tiles_x, n_tiles, r_cap,
                          pair_cap, grp_cap, k=4, rows256=True)[:-1]


def build_groups_direct(src32: torch.Tensor, pair_key: torch.Tensor,
                        tiles_x: int, n_tiles: int, pair_cap: int,
                        grp_cap: int):
    """Grouping for the direct walk (subtile4): no layout is materialised,
    only the pair-ordered source and per-bin (offset, depth) in depth-group
    order.

    src32 f32 [Tp, 32]. Returns (src_pair [p_eff + CHUNK_RG, 32] (zero
    rows past p_eff, the walk's clamped reads land there), goff, gdepth
    [grp_cap*8], gchunks [grp_cap] (ceil(group max depth / CHUNK_RG)), xl,
    yl [grp_cap, 128], gbins [grp_cap*8], n_rows, n_pairs, n_used) with
    n_rows = gchunks.sum() * CHUNK_RG, the walk's slot count (there is no
    r_cap to overflow)."""
    return groups_direct(src32, pair_key, tiles_x, n_tiles, pair_cap,
                         grp_cap)[:-1]


def groups_direct(src32: torch.Tensor, pair_key: torch.Tensor, tiles_x: int,
                  n_tiles: int, pair_cap: int, grp_cap: int):
    """``build_groups_direct``'s tuple, then ginv [n_tiles*8], each bin's
    place in the depth order (``_group_bins``)."""
    n_bins = n_tiles * N_SUB
    tri_s, p_eff, offsets, gbins, gdepth, n_pairs, n_used, ginv = \
        _group_bins(pair_key, n_tiles, pair_cap, grp_cap)
    gchunks = (gdepth[0::N_SUB] + CHUNK_RG - 1) // CHUNK_RG
    n_rows = (gchunks * CHUNK_RG).sum(dtype=torch.int32)
    goff = offsets[torch.clamp(gbins, max=n_bins - 1).long()]
    src_pair = torch.cat([src32[tri_s[:p_eff].long()],
                          src32.new_zeros((CHUNK_RG, src32.shape[1]))])
    xl, yl = _pixel_origins(gbins, tiles_x, n_bins, grp_cap)
    return (src_pair, goff, gdepth, gchunks, xl, yl, gbins, n_rows, n_pairs,
            n_used, ginv)


def build_rows_ref(src32: torch.Tensor, pair_key: torch.Tensor, tiles_x: int,
                   n_tiles: int, r_cap: int, pair_cap: int, grp_cap: int, *,
                   k: int, rows256: bool = False):
    """The plain version of ``build_rows``: the torch chain of the layout
    K and rows256 name (``LAYOUTS``), its tuple then ginv."""
    g, rowptr, gdepth, gskip, *rest = _slot_gather(
        src32, pair_key, tiles_x, n_tiles, r_cap, pair_cap, grp_cap, k)
    if rows256:
        # K4 row q, half p, slot s -> K2 row 2q+p, slot s (K2: the identity)
        rows = (g.view(r_cap // k, N_SUB, k // 2, 2 * N_CHAN).transpose(1, 2)
                .reshape(r_cap // 2, N_SUB * 2 * N_CHAN))
        return (rows, rowptr // 2, gdepth, gskip, *rest)
    if k == 1:
        return (g.view(r_cap, N_SUB * N_CHAN), rowptr, gdepth, *rest)
    # K-row q, sub-entry p, slot s -> row q*k+p, slot s
    rows = (g.view(r_cap // k, N_SUB, k, N_CHAN).transpose(1, 2)
            .reshape(r_cap, N_SUB * N_CHAN))
    return (rows, rowptr, gdepth, gskip, *rest)


def _shift_rows(lay, y_off: int):
    """A row band's layout (a tuple ending xl, yl, gbins, n_rows, n_pairs,
    n_used, ginv): its lanes' pixel rows, yl, moved to global rows (exact:
    small integers in float32)."""
    if not y_off:
        return lay
    return (*lay[:-6], lay[-6] + float(y_off), *lay[-5:])


def build_rows(src32: torch.Tensor, pair_key: torch.Tensor, tiles_x: int,
               n_tiles: int, r_cap: int, pair_cap: int, grp_cap: int, *,
               k: int, rows256: bool = False, offsets=None, y_off: int = 0):
    """X10: the grouped layout of K entries a gathered row (rows128 [r_cap,
    128], or rows256 [r_cap/2, 256]) from the sorted pair keys, with the
    tuple of ``build_packed_rows_grouped`` (K = 1),
    ``build_packed_rows_grouped_kgather`` (K = 4, 8) or
    ``build_packed_rows_grouped_k2`` / ``_k4`` (rows256), then ginv i32
    [n_tiles*8], each bin's place in the depth order (``group_inverse``:
    the layout block stores it; K2's image form reads it). ``offsets``:
    the bins' offsets over all keys, i32 [n_tiles*8 + 1], as X9 leaves
    them (computed here when None); ``y_off``: a row band's first pixel
    row, added to yl. On the CPU the plain version; on a CUDA device two
    kernel launches (three without offsets), bit for bit with it. The
    outputs are views of one int32 and one float32 buffer."""
    if (k, rows256) not in LAYOUTS.values():
        raise ValueError(f"build_rows: no layout of K = {k}, rows256 = "
                         f"{rows256}")
    if pair_key.device.type == "cpu":
        return _shift_rows(build_rows_ref(src32, pair_key, tiles_x, n_tiles,
                                          r_cap, pair_cap, grp_cap, k=k,
                                          rows256=rows256), y_off)
    global launches, last_launches
    n_bins = n_tiles * N_SUB
    P = pair_key.shape[0]
    p_eff = min(pair_cap, P)
    if not 1 <= n_bins < (1 << 13) or p_eff < 1 or grp_cap < 1 or \
            r_cap <= 0 or r_cap % CHUNK_RG:
        raise ValueError(f"build_rows: {n_bins} bins (1 to 8191), {p_eff} "
                         f"pairs, grp_cap {grp_cap}, r_cap {r_cap} (a "
                         f"positive CHUNK_RG multiple)")
    _build.require_cuda(pair_key, *(() if offsets is None else (offsets,)),
                        what="build_rows")
    if (src32.device != pair_key.device or src32.dtype != torch.float32
            or src32.dim() != 2
            or src32.shape[1] < N_CHAN or src32.stride(1) != 1
            or src32.stride(0) % 4 or src32.data_ptr() % 16):
        raise ValueError("build_rows: src32 must be float32 [N, >= 16] rows "
                         "of a 16-byte aligned stride on the keys' device")
    if pair_key.dtype != torch.int32 or pair_key.dim() != 1:
        raise ValueError("build_rows: pair_key must be contiguous int32 [P]")
    if offsets is not None and (offsets.dtype != torch.int32
                                or offsets.shape != (n_bins + 1,)):
        raise ValueError(f"build_rows: offsets must be contiguous int32 "
                         f"[{n_bins + 1}]")
    (rows, rowptr, gdepth, gskip, xl, yl, gbins, counts, ginv), ws = \
        layout_buffers(n_bins, r_cap, grp_cap, k, rows256, pair_key.device)
    err = _build.lib().group_build_launch(
        src32.data_ptr(), src32.stride(0), pair_key.data_ptr(), P,
        None if offsets is None else offsets.data_ptr(), p_eff, n_bins,
        tiles_x, k, int(rows256), r_cap, grp_cap, float(y_off),
        ws.data_ptr(), rows.data_ptr(), rowptr.data_ptr(), gdepth.data_ptr(),
        gskip.data_ptr(), xl.data_ptr(), yl.data_ptr(), gbins.data_ptr(),
        counts.data_ptr(), ginv.data_ptr(), _build.stream_ptr(pair_key.device))
    launches += 1
    last_launches = 2 if offsets is not None else 3
    _build.check(err, "group_build_launch")
    skip = () if k == 1 and not rows256 else (gskip,)
    return (rows, rowptr, gdepth, *skip, xl, yl, gbins, counts[0],
            counts[1], counts[2], ginv)


def layout_buffers(n_bins: int, r_cap: int, grp_cap: int, k: int,
                   rows256: bool, device):
    """The kernels' outputs as views of one int32 and one float32 buffer:
    ((rows, rowptr, gdepth, gskip, xl, yl, gbins, counts, ginv), ws), ws
    the kernels' own ints (offsets [n_bins + 1], each slot's K-row start
    less its group's [8 grp_cap], the unclamped row pointers [grp_cap + 1],
    each K-row's group [r_cap / k])."""
    ns = grp_cap * N_SUB
    sizes = (grp_cap + 1, ns, ns, ns, 3, n_bins,
             n_bins + 1 + ns + grp_cap + 1 + r_cap // k)
    ints = torch.empty((sum(sizes),), dtype=torch.int32, device=device)
    rowptr, gdepth, gskip, gbins, counts, ginv, ws = ints.split(sizes)
    n_rows = r_cap * TILE_W
    floats = torch.empty((n_rows + 2 * grp_cap * TILE_W,),
                         dtype=torch.float32, device=device)
    rows = floats[:n_rows].view((r_cap // 2, 2 * TILE_W) if rows256 else
                                (r_cap, TILE_W))
    xl, yl = floats[n_rows:].view(2, grp_cap, TILE_W).unbind(0)
    return (rows, rowptr, gdepth, gskip, xl, yl, gbins, counts, ginv), ws
