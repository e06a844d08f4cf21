"""Depth-sorted bin-group walk: the CUDA kernel ``csrc/raster_group.cu``
(replaces the Pallas ``ascii_renderer_tpu/ops/raster_group.py:
_kernel_grouped_skip``), its plain-torch version, and the torch layout
code around it (torch port of the same JAX module's K-gather build,
depth-group order, CSR offsets and image assembly).

All n_tiles*8 bins (8 x 16 px) are sorted by depth (descending, stable by
bin id) and grouped 8 at a time, so one 8 x 128 pixel block walks 8 bins of
similar depth side by side. Layout (built by
``build_packed_rows_grouped_kgather``, walked by ``tile_eval_grouped_skip``):

  rows128 f32 [r_cap, 128]: row r, lanes 16g..16g+15 hold the 16 walk
  channels (ops/raster_subtile) of one entry of GROUP-slot g's bin.
  rowptr i32 [grp_cap+1] CHUNK_RG-multiple group row ranges.
  gdepth/gskip i32 [grp_cap*8]: entry idx = row - rowptr[t] of slot g is
  live iff gskip <= idx < gskip + gdepth (the K-gather fetches K entries
  from K-aligned starts, so a bin's first `skip` slots belong to the
  preceding bin in pair order).
  xl/yl f32 [grp_cap, 128]: lane l of group t covers pixel column
  xl[t, l] - 0.5 and rows yl[t, l] + s, s = 0..7 (pixel centres at
  xl and yl + s + 0.5).

Tie-breaking: bins are sorted by triangle id and the depth merge is strict
less-than, so the smallest id wins depth ties. The plane evaluation
(C + A*x) + B*y fuses both products, as the reference's compiler does
(core/fp.py), in the kernel and in its plain version alike.
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops.raster_subtile import (
    CH_A, CH_B, CH_G, CH_PAIR, CH_ZC, CH_ZX, CH_ZY, MAX_TRI, N_CHAN, N_SUB,
    SUB_SHIFT, SUB_W, TILE_H, TILE_W)

CHUNK_RG = 32      # rows per walk slab (16 KB of shared memory in the kernel)

launches = 0       # kernel launches by tile_eval_grouped_skip


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


def build_packed_rows_grouped_kgather(src32: torch.Tensor,
                                      pair_key: torch.Tensor,
                                      tiles_x: int, n_tiles: int,
                                      r_cap: int, pair_cap: int,
                                      grp_cap: int, k: int):
    """Sorted pair keys -> depth-grouped walk layout, with the slot gather
    fetching K consecutive bin entries per row from K-aligned starts and
    relaid to the single-entry rows128 layout (bins whose CSR offset is not
    K-aligned start mid-row; the walk masks those leading slots by gskip).

    src32 f32 [Tp, >=16] walk-entry rows (channel CH_PAIR = triangle id);
    pair_key i32 [P] sorted ``bin << SUB_SHIFT | tri``. Returns (rows128
    [r_cap, 128], rowptr [grp_cap+1] (CHUNK_RG multiples, clamped to
    r_cap), gdepth, gskip [grp_cap*8], xl, yl [grp_cap, 128], gbins
    [grp_cap*8], n_rows, n_pairs, n_used) with the counts as 0-d i32
    tensors: n_rows = true row total (vs r_cap), n_pairs = true pair count
    (vs pair_cap), n_used = nonempty bins (vs grp_cap*8). A count over its
    cap means work was dropped and the caller must re-render."""
    assert k in (2, 4, 8) and CHUNK_RG % k == 0 and r_cap % CHUNK_RG == 0
    dev = pair_key.device
    r_capk = r_cap // k
    n_bins = n_tiles * N_SUB
    assert n_bins < (1 << 13)  # sentinel key (n_bins << 18) must fit int32
    bin_s = pair_key >> SUB_SHIFT
    tri_s = pair_key & (MAX_TRI - 1)
    P = pair_key.shape[0]
    p_eff = min(pair_cap, P)
    offsets = _bin_offsets(bin_s, p_eff, n_bins)
    n_pairs = (bin_s < n_bins).sum(dtype=torch.int32)
    depth_bins = offsets[1:] - offsets[:-1]
    n_used = (depth_bins > 0).sum(dtype=torch.int32)

    binperm, dsorted = depth_group_order(depth_bins, n_bins)
    nsel = grp_cap * N_SUB
    if nsel > n_bins:  # more group slots than bins: sentinel-pad
        pad = nsel - n_bins
        binperm = torch.cat([binperm, binperm.new_full((pad,), n_bins)])
        dsorted = torch.cat([dsorted, dsorted.new_zeros((pad,))])
    gbins = binperm[:nsel]
    gdepth = dsorted[:nsel]
    off_g = offsets[torch.clamp(gbins, max=n_bins).long()]
    gskip = torch.where(gdepth > 0, off_g % k, torch.zeros_like(off_g))
    offk = (off_g - gskip) // k          # K-aligned K-row start per bin
    rbk = (gdepth + gskip + k - 1) // k  # K-rows needed per bin
    gmaxk = rbk.view(grp_cap, N_SUB).amax(dim=1)
    d_pad = _round_up_i(gmaxk * k, CHUNK_RG)
    rowptr = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        torch.cumsum(d_pad, 0).to(torch.int32)])
    n_rows = rowptr[-1]

    # group of each K-row, and its offset inside the group
    rowptrk = rowptr // k
    rk_ids = torch.arange(r_capk, dtype=torch.int32, device=dev)
    t_r = torch.clamp(torch.searchsorted(rowptrk[1:].contiguous(), rk_ids,
                                         right=True), max=grp_cap - 1)
    d_rk = rk_ids - rowptrk[:-1][t_r]
    off_rows = offk.view(grp_cap, N_SUB)[t_r]          # [r_capk, 8]

    # pair-ordered 16-channel source, K entries per k*16-lane row
    src_pair = src32[tri_s[:p_eff].long(), :N_CHAN]
    pek = _round_up_i(p_eff, k)
    if pek > p_eff:
        src_pair = torch.cat([src_pair, src_pair.new_zeros((pek - p_eff,
                                                            N_CHAN))])
    srckk = src_pair.view(pek // k, k * N_CHAN)
    pidx = torch.clamp(off_rows + d_rk[:, None], 0, pek // k - 1).reshape(-1)
    g = srckk[pidx.long()]                              # [r_capk*8, k*16]
    # K-row q, sub-entry p, slot s -> row q*k+p, slot s
    rows128 = (g.view(r_capk, N_SUB, k, N_CHAN).transpose(1, 2)
               .reshape(r_cap, N_SUB * N_CHAN))

    xl, yl = _pixel_origins(gbins, tiles_x, n_bins, grp_cap)
    rowptr_k = torch.clamp(rowptr, max=r_cap)
    return (rows128, rowptr_k, gdepth, gskip, xl, yl, gbins,
            n_rows, n_pairs, n_used)


def tile_eval_grouped_skip_ref(rows128: torch.Tensor, rowptr: torch.Tensor,
                               gdepth: torch.Tensor, gskip: torch.Tensor,
                               xl: torch.Tensor, yl: torch.Tensor,
                               grp_cap: int):
    """Plain-torch version of ``tile_eval_grouped_skip``: one step per
    group row index, vectorised over the groups that still have rows
    (groups ordered by row count, so the live ones are a prefix)."""
    dev = rows128.device
    r_cap = rows128.shape[0]
    inf = float("inf")
    rp = torch.clamp(rowptr.long(), 0, r_cap)
    r0 = rp[:-1]
    nrows = ((rp[1:] - r0) // CHUNK_RG) * CHUNK_RG
    order = torch.sort(nrows, descending=True, stable=True).indices
    counts = nrows[order].tolist()
    zb = torch.full((grp_cap, TILE_H, N_SUB, SUB_W), inf, device=dev)
    eb = torch.full((grp_cap, TILE_H, N_SUB, SUB_W), -1.0, device=dev)
    xs_all = xl.view(grp_cap, 1, N_SUB, SUB_W)
    ys_all = ((torch.arange(TILE_H, dtype=torch.float32, device=dev) + 0.5)
              [None, :, None, None] + yl.view(grp_cap, 1, N_SUB, SUB_W))
    dep_all = gdepth.view(grp_cap, 1, N_SUB, 1)
    skp_all = gskip.view(grp_cap, 1, N_SUB, 1)
    n_live = len(counts)
    for i in range(counts[0] if counts else 0):
        while n_live and counts[n_live - 1] <= i:
            n_live -= 1
        gi = order[:n_live]
        c, r = divmod(i, CHUNK_RG)
        row = torch.clamp(r0[gi] + c * CHUNK_RG, max=r_cap - CHUNK_RG) + r
        ent = rows128[row].view(n_live, 1, N_SUB, N_CHAN)
        xs, ys = xs_all[gi], ys_all[gi]

        def plane(ca, cb, cc):  # (C + A*x) + B*y, both products fused
            return fma32(ent[..., cb:cb + 1], ys,
                         fma32(ent[..., ca:ca + 1], xs, ent[..., cc:cc + 1]))

        ok = (plane(CH_A[0], CH_B[0], CH_G[0]) <= 0.0)
        ok &= plane(CH_A[1], CH_B[1], CH_G[1]) <= 0.0
        ok &= plane(CH_A[2], CH_B[2], CH_G[2]) <= 0.0
        z = plane(CH_ZX, CH_ZY, CH_ZC)
        ok &= (z >= 0.0) & (z <= 1.0)
        skp = skp_all[gi]
        ok &= (i >= skp) & (i < skp + dep_all[gi])
        zm = torch.where(ok, z, inf)
        zg = zb[gi]
        better = zm < zg  # strict: earlier (smaller tri id) wins ties
        zb[gi] = torch.where(better, zm, zg)
        eb[gi] = torch.where(better, ent[..., CH_PAIR:CH_PAIR + 1], eb[gi])
    return (zb.view(grp_cap, TILE_H, TILE_W), eb.view(grp_cap, TILE_H, TILE_W))


def tile_eval_grouped_skip(rows128: torch.Tensor, rowptr: torch.Tensor,
                           gdepth: torch.Tensor, gskip: torch.Tensor,
                           xl: torch.Tensor, yl: torch.Tensor, grp_cap: int):
    """rows128 f32 [r_cap, 128] grouped layout -> (z, entry id) f32
    [grp_cap, 8, 128] per group (lane group g = bin gbins[t*8+g]); id -1 =
    background. CPU tensors run the plain version; CUDA tensors launch the
    kernel (one block of 1024 threads per group)."""
    if rows128.device.type == "cpu":
        return tile_eval_grouped_skip_ref(rows128, rowptr, gdepth, gskip,
                                          xl, yl, grp_cap)
    global launches
    r_cap = rows128.shape[0]
    if (rows128.shape[1:] != (TILE_W,) or r_cap % CHUNK_RG or r_cap == 0
            or rowptr.shape != (grp_cap + 1,)
            or gdepth.shape != (grp_cap * N_SUB,)
            or gskip.shape != (grp_cap * N_SUB,)
            or xl.shape != (grp_cap, TILE_W) or yl.shape != (grp_cap, TILE_W)):
        raise ValueError("tile_eval_grouped_skip: bad shapes")
    if (rows128.dtype != torch.float32 or xl.dtype != torch.float32
            or yl.dtype != torch.float32 or rowptr.dtype != torch.int32
            or gdepth.dtype != torch.int32 or gskip.dtype != torch.int32):
        raise ValueError("tile_eval_grouped_skip: bad dtypes")
    rowptr = torch.clamp(rowptr, 0, r_cap)  # the walk never reads past r_cap
    _build.require_cuda(rows128, rowptr, gdepth, gskip, xl, yl,
                        what="tile_eval_grouped_skip")
    z = torch.empty((grp_cap, TILE_H, TILE_W), dtype=torch.float32,
                    device=rows128.device)
    e = torch.empty_like(z)
    err = _build.lib().walk_grouped_skip_launch(
        rows128.data_ptr(), rowptr.data_ptr(), gdepth.data_ptr(),
        gskip.data_ptr(), xl.data_ptr(), yl.data_ptr(), z.data_ptr(),
        e.data_ptr(), r_cap, grp_cap, _build.stream_ptr(rows128.device))
    launches += 1
    _build.check(err, "walk_grouped_skip_launch")
    return z, e


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
