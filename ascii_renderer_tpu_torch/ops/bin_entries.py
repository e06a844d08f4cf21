"""The raster's pair keys and their counting sort (X9): the CUDA kernels of
``csrc/bin_entries.cu`` and their plain versions, in two key layouts:

- tile keys ``(tile << 19) | tri`` (``binned_entries``): the small and
  mid paths' bin walk B6 / B6''s input built from the clipped triangles'
  screen channels, each sorted key's source row (the 12 plane channels,
  1.0, the id as float, two zeros) in walk "mm"'s layout ([P/128, 16,
  128] channel-major chunks) or row-major ([P, 16], which
  ``raster_bins.pack_entries`` views as "loop"'s [P/8, 128]);
- bin keys ``(bin << 18) | tri`` (``pair_keys``): the grouped
  generations' raster.keys from the setup's bbox channels over 16-pixel
  sub-tile bins, a row band's band-local bins included: the sorted keys,
  the bins' offsets [n_bins + 1] and the counts (n_small, n_big, n_pairs,
  n_valid) that the frame's diagnostics read.

Stands for XLA code, not a Pallas kernel: the front of
``visibility_binned_ch`` in ``ascii_renderer_tpu/backends/raster_channels
.py`` (:546; the tile span, the pair keys, the plane-form entries and
their gather) and ``_subtile_pair_keys_bbox`` with its ``lax.sort`` in
``ascii_renderer_tpu/backends/raster.py`` (:249, :345), which XLA compiles
into each frame's program. On CUDA tensors the plain versions are some 250
and 137 launches; the kernels are four launches: the triangles' pass,
whose last block ranks the big triangles once (a small call's sequence
blocks rank for themselves instead); the keys in sequence order with
their stable ranks in a chunk and its histogram; 8 lanes a bin scanning
its column of histograms, the last block the blocks' offsets (done by
each block of the scatter where the histogram is tiny: three launches);
the scatter. The ``FORMS`` differ in the sequence pass's chunk; the
launch picks one by size (``auto_form``). The sort is a
counting sort of the keys' bins; it is stable and every bin's keys come
in ascending triangle order, so its order is ``torch.sort``'s (the
reference's ``lax.sort``); equal keys, in the fill bin, are equal values
and equal rows.

The plain versions are the chains the backends ran before, moved here
(``backends/raster_channels`` re-exports ``_tile_span``, ``tile_pairs``,
``plane_entries`` and ``binned_entries_ref``; ``backends/raster``
re-exports ``_bin_span`` and ``_pair_keys_core``). Each product the
reference's compiled program fuses is an ``fma32`` there and an ``fmaf``
in the kernel, in the same order (core/fp.py); the reciprocal is IEEE,
the tile divisions are true divisions.
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.core.quantize import fdiv
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import raster_bins as RB
from ascii_renderer_tpu_torch.ops import raster_subtile as RS
from ascii_renderer_tpu_torch.ops.plane_table import _edge_coeffs, _sum3
from ascii_renderer_tpu_torch.ops.raster_clip import _recip_guard

launches = 0       # calls of binned_entries that launched X9 (tile keys)
launches_keys = 0  # calls of pair_keys that launched X9 (bin keys)
last_launches = 0  # kernels the last launching call ran: 3 or 4
# triangles, sequence, scan, scatter (a tiny histogram's scan is done by
# each scatter block)
LAUNCHES_PER_CALL = {"binned_entries": 4, "pair_keys": 4}
TILE_H, TILE_W = RB.TILE_H, RB.TILE_W
TRI_BITS = 19  # a tile key is (tile << 19) | tri
MAX_BIG_CAP = 8192  # binned_entries' big_cap, 1 to this
# the kernels' forms: (warps a block, steps of 32 keys a warp) of the
# sequence pass, whose chunk is 32 W J keys
FORMS = {1: (4, 8), 2: (8, 8), 3: (8, 16)}
TINY_HIST_MAX = 2048   # histogram ints each scatter block scans itself (csrc)
SMALL_P = 16384        # keys below which the launch takes 1,024-key chunks
WIDE_P = 400000        # keys from which it takes 4,096-key chunks
# the screen channels a triangle reads, in the kernel's order
KEYS = ("sxa", "sxb", "sxc", "sya", "syb", "syc", "sza", "szb", "szc")


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    # saturate like XLA's f32 -> s32 conversion (huge near-plane bboxes)
    return torch.clamp(torch.floor(x), -2147483648.0, 2147483520.0).to(
        torch.int32)


def _tile_span(ch, rows: int, cols: int, tile_window: int):
    """Per-triangle bbox tile span and the small / big classification of
    the bin pass: (tx0, tx1, ty0, ty1, small, big)."""
    xa, xb, xc = ch["sxa"], ch["sxb"], ch["sxc"]
    ya, yb, yc = ch["sya"], ch["syb"], ch["syc"]
    xmin = torch.minimum(torch.minimum(xa, xb), xc)
    xmax = torch.maximum(torch.maximum(xa, xb), xc)
    ymin = torch.minimum(torch.minimum(ya, yb), yc)
    ymax = torch.maximum(torch.maximum(ya, yb), yc)
    tx0 = _floor_i32(fdiv(xmin, float(TILE_W)))
    ty0 = _floor_i32(fdiv(ymin, float(TILE_H)))
    tx1 = _floor_i32(fdiv(xmax, float(TILE_W)))
    ty1 = _floor_i32(fdiv(ymax, float(TILE_H)))
    onscreen = (xmax > 0) & (xmin < cols) & (ymax > 0) & (ymin < rows)
    fits = ((tx1 - tx0) < tile_window) & ((ty1 - ty0) < tile_window)
    small = ch["valid"] & onscreen & fits
    big = ch["valid"] & onscreen & ~fits
    return tx0, tx1, ty0, ty1, small, big


def tile_pairs(ch, rows: int, cols: int, big_cap: int = 64,
               tile_window: int = 2):
    """Exact per-tile bins of the clipped triangles: small triangles (bbox
    within a 2 x 2 tile window) emit up to 4 (tile, tri) pairs, big ones
    (the first ``big_cap``, in id order) one pair per overlapped tile; one
    (tile << 19 | tri) int32 sort and a left-side searchsorted give the
    bins. Returns (tri_s i32 [P] the sorted pairs' triangles, all < T,
    offsets i32 [n_tiles + 1], tiles_y, tiles_x)."""
    xa = ch["sxa"]
    dev = xa.device
    T = xa.shape[0]
    assert T < (1 << TRI_BITS), \
        "packed sort key supports < 524288 clipped tris"
    tiles_y = -(-rows // TILE_H)
    tiles_x = -(-cols // TILE_W)
    n_tiles = tiles_y * tiles_x
    assert n_tiles < (1 << 12), "tile << 19 must fit int32"
    tx0, tx1, ty0, ty1, small, big = _tile_span(ch, rows, cols, tile_window)

    # small pairs: a static 2 x 2 window, as flat [T] channels
    tri_ids = torch.arange(T, dtype=torch.int32, device=dev)
    tile_parts = []
    for k in range(tile_window * tile_window):
        ty = ty0 + (k // tile_window)
        tx = tx0 + (k % tile_window)
        ok = (small & (ty >= 0) & (ty < tiles_y) & (tx >= 0) & (tx < tiles_x)
              & (ty <= ty1) & (tx <= tx1))
        tile_parts.append(torch.where(ok, ty * tiles_x + tx, n_tiles))
    pair_tri = [tri_ids.repeat(tile_window * tile_window)]

    # big pairs: the first big_cap big triangles in id order (the
    # reference's stable top_k on a 0/1 score), one pair per tile overlap
    rank = torch.cumsum(big.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(big & (rank < big_cap), rank, big_cap)
    big_idx = torch.full((big_cap + 1,), T, dtype=torch.int32, device=dev)
    big_idx.scatter_(0, slot.long(), tri_ids)
    big_idx = big_idx[:big_cap]

    def padi(c, fill):
        return torch.cat([c, c.new_full((1,), fill)])[big_idx.long()]

    btx0, btx1 = padi(tx0, 1), padi(tx1, 0)  # fill slots: an empty range
    bty0, bty1 = padi(ty0, 1), padi(ty1, 0)
    tids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    g_ty, g_tx = tids // tiles_x, tids % tiles_x
    overlap = ((g_tx[None, :] >= btx0[:, None]) & (g_tx[None, :] <= btx1[:, None])
               & (g_ty[None, :] >= bty0[:, None])
               & (g_ty[None, :] <= bty1[:, None]) & (big_idx < T)[:, None])
    tile_parts.append(torch.where(overlap, tids[None, :], n_tiles).reshape(-1))
    pair_tri.append(torch.clamp(big_idx, max=T - 1)[:, None].expand(
        big_cap, n_tiles).reshape(-1))

    packed = torch.sort((torch.cat(tile_parts) << TRI_BITS)
                        | torch.cat(pair_tri)).values
    tile_s = packed >> TRI_BITS
    tri_s = packed & ((1 << TRI_BITS) - 1)
    offsets = torch.searchsorted(
        tile_s, torch.arange(n_tiles + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    return tri_s, offsets, tiles_y, tiles_x


def plane_entries(ch):
    """The 12 plane-form walk channels of each clipped triangle (ops/
    raster_bins.py CH_A0 .. CH_ZC): three edge planes w_k = A_k px + B_k py
    + G_k and the screen-depth plane, each a [T] tensor."""
    xa, xb, xc = ch["sxa"], ch["sxb"], ch["sxc"]
    ya, yb, yc = ch["sya"], ch["syb"], ch["syc"]
    za, zb, zc = ch["sza"], ch["szb"], ch["szc"]
    acs, bcs, gcs = _edge_coeffs((xa, xb, xc), (ya, yb, yc))
    # (xb - xa)(yc - ya) - (yb - ya)(xc - xa) == w0 + w1 + w2
    area = fma32(xb - xa, yc - ya, -((yb - ya) * (xc - xa)))
    inv_area = _recip_guard(area, 1e-12)
    zs = (za, zb, zc)
    return [acs[0], bcs[0], gcs[0], acs[1], bcs[1], gcs[1],
            acs[2], bcs[2], gcs[2],
            # sum_k coef_k z_k: for alpha the second product fuses first,
            # as in build_plane_table's denominator
            fma32(acs[2], zc, fma32(acs[1], zb, acs[0] * za)) * inv_area,
            _sum3(bcs, zs) * inv_area,
            _sum3(gcs, zs) * inv_area]


def pad_rows(P: int, kernel: str) -> int:
    """Rows of the inert zero tail after P pairs: an aligned chunk read
    past the last bin stays in bounds, and the layout divides evenly."""
    if kernel == "mm":
        tail, quantum = 2 * RB.MM_CHUNK, RB.MM_CHUNK
    else:
        tail, quantum = RB.CHUNK + 8 * RB.PACK, RB.PACK
    return (-(P + tail)) % quantum + tail


def binned_entries_ref(ch, rows: int, cols: int, *, kernel: str = "mm",
                       big_cap: int = 64, tile_window: int = 2,
                       counts: bool = False):
    """The plain version of ``binned_entries``: ``tile_pairs``, the source
    rows of ``plane_entries``, their gather into pair order; the counts
    from ``_tile_span``'s classes (``count_big_small``'s chain), the
    offsets' last and the valid flags."""
    tri_s, offsets, tiles_y, tiles_x = tile_pairs(
        ch, rows, cols, big_cap=big_cap, tile_window=tile_window)
    n_tiles = tiles_y * tiles_x
    xa = ch["sxa"]
    T = xa.shape[0]
    src = torch.stack(plane_entries(ch) + [
        torch.ones_like(xa),
        torch.arange(T, dtype=torch.float32, device=xa.device)], dim=-1)
    src = torch.cat([src, src.new_zeros((T, RB.N_CHAN - 14))], dim=-1)
    # row T of src is zero and the padded tail of tri_s points at it
    src = torch.cat([src, src.new_zeros((1, RB.N_CHAN))])
    tri_sp = torch.cat([tri_s, tri_s.new_full(
        (pad_rows(tri_s.shape[0], kernel),), T)])
    data = src[tri_sp.long()]
    if kernel == "mm":
        data = data.reshape(-1, RB.MM_CHUNK, RB.N_CHAN).transpose(1, 2)
        out = (data.contiguous(), offsets, tiles_x, n_tiles)
    else:
        out = (RB.pack_entries(data), offsets, tiles_x, n_tiles)
    if not counts:
        return out
    *_, small, big = _tile_span(ch, rows, cols, tile_window)
    return out + (torch.stack([
        small.sum(dtype=torch.int32), big.sum(dtype=torch.int32),
        offsets[-1], ch["valid"].sum(dtype=torch.int32)]),)


def binned_entries(ch, rows: int, cols: int, *, kernel: str = "mm",
                   big_cap: int = 64, tile_window: int = 2, form: int = 0,
                   counts: bool = False):
    """The bin walk's input: the exact bins of ``tile_pairs`` and the
    plane-form entries gathered into pair order, in the layout of kernel
    'mm' (B6: [P/128, 16, 128]) or 'loop' (B6': [P/8, 128]), with an inert
    zero tail. Returns (data, offsets i32 [n_tiles + 1], tiles_x,
    n_tiles), and with ``counts`` the counts i32 [4] (n_small, n_big,
    n_pairs, n_valid) of the triangles' classes, the pairs in real bins
    and the valid slots. On the CPU the plain version; on a CUDA device X9
    (``form`` 0: by size, else one of ``FORMS``), bit for bit with the
    plain version, the counts those its triangles' pass leaves."""
    if kernel not in ("mm", "loop"):
        raise ValueError(f"binned_entries: unknown kernel {kernel!r}")
    valid = ch["valid"]
    if valid.device.type == "cpu":
        return binned_entries_ref(ch, rows, cols, kernel=kernel,
                                  big_cap=big_cap, tile_window=tile_window,
                                  counts=counts)
    global launches
    chans = [ch[k] for k in KEYS]
    T = valid.shape[0]
    tiles_y, tiles_x = -(-rows // TILE_H), -(-cols // TILE_W)
    n_tiles = tiles_y * tiles_x
    if not 1 <= T < (1 << TRI_BITS) or not 1 <= n_tiles < (1 << 12):
        raise ValueError(f"binned_entries: {T} triangles (1 to 2^19 - 1), "
                         f"{n_tiles} tiles (1 to 4095)")
    if not 1 <= big_cap <= MAX_BIG_CAP or tile_window < 1:
        raise ValueError(f"binned_entries: big_cap {big_cap} (1 to "
                         f"{MAX_BIG_CAP}), tile_window {tile_window}")
    _build.require_cuda(valid, what="binned_entries")
    _check_chans(chans, valid, "binned_entries", "screen")
    dev = valid.device
    P = tile_window * tile_window * T + big_cap * n_tiles
    n_rows = P + pad_rows(P, kernel)
    if n_rows * RB.N_CHAN >= 2 ** 31:
        raise ValueError(f"binned_entries: {n_rows} entries, too many")
    src = torch.empty(((T + 1) * RB.N_CHAN,), dtype=torch.float32,
                      device=dev)
    offsets = torch.empty((n_tiles + 1,), dtype=torch.int32, device=dev)
    cnt = torch.empty((4,), dtype=torch.int32, device=dev)
    data = torch.empty((n_rows * RB.N_CHAN,), dtype=torch.float32,
                       device=dev)
    err = _launch(chans, valid, 0, T, rows, cols, tile_window, big_cap, 0,
                  0, tile_window * tile_window, n_tiles, P, form, src=src,
                  offsets=offsets, counts=cnt, data=data, n_out=n_rows,
                  mm=kernel == "mm")
    launches += 1
    _build.check(err, "bin_entries_launch")
    if kernel == "mm":
        out = (data.view(-1, RB.N_CHAN, RB.MM_CHUNK), offsets, tiles_x,
               n_tiles)
    else:
        out = (RB.pack_entries(data.view(n_rows, RB.N_CHAN)), offsets,
               tiles_x, n_tiles)
    return out + (cnt,) if counts else out


# --------------------------------------------------------------------------
# bin keys: the grouped generations' pair keys
# --------------------------------------------------------------------------
def _bin_span(xmin, xmax, ymin, ymax, valid, rows: int, cols: int,
              ty_lo: int = 0, tiles_y_band: int | None = None):
    """Bin spans (sc0, sc1, ty0, ty1: subtile columns and tile rows) and
    the small / big classes of each triangle; with ``tiles_y_band``, on
    screen means inside the tile-row band [ty_lo, ty_lo + tiles_y_band)."""
    sc0 = _floor_i32(xmin / RS.SUB_W)
    sc1 = _floor_i32(xmax / RS.SUB_W)
    ty0 = _floor_i32(ymin / TILE_H)
    ty1 = _floor_i32(ymax / TILE_H)
    if tiles_y_band is None:
        y_lo_px, y_hi_px = 0, rows
    else:
        y_lo_px = ty_lo * TILE_H
        y_hi_px = min((ty_lo + tiles_y_band) * TILE_H, rows)
    onscreen = ((xmax > 0) & (xmin < cols) & (ymax > y_lo_px)
                & (ymin < y_hi_px))
    fits = ((sc1 - sc0) < 2) & ((ty1 - ty0) < 2)
    small = valid & onscreen & fits
    bigt = valid & onscreen & ~fits
    return sc0, sc1, ty0, ty1, small, bigt


def _pair_keys_core(xmin, xmax, ymin, ymax, valid, rows: int, cols: int,
                    *, big_cap: int, ty_lo: int = 0,
                    tiles_y_band: int | None = None):
    """bbox + valid [T] -> sorted pair keys ``bin << SUB_SHIFT | tri``.
    Small tris (bbox within a 2 x 2 tile-row x subtile-col window) emit up
    to 4 candidate keys; big tris one key per overlapped bin via a
    [big_cap, n_bins] overlap matrix. Unused keys carry bin = n_bins and
    sort last. ``ty_lo`` / ``tiles_y_band`` restrict the keys to the
    tile-row band [ty_lo, ty_lo + tiles_y_band), with band-local bin ids
    (bin 0 = the band's first subtile) over global tile rows."""
    T = xmin.shape[0]
    dev = xmin.device
    assert T < RS.MAX_TRI, f"subtile sort key supports < {RS.MAX_TRI} tris"
    tiles_y = -(-rows // TILE_H)
    tiles_x = -(-cols // TILE_W)
    tiles_y_eff = tiles_y if tiles_y_band is None else tiles_y_band
    sx_n = tiles_x * RS.N_SUB
    n_bins = tiles_y_eff * tiles_x * RS.N_SUB

    sc0, sc1, ty0, ty1, small, bigt = _bin_span(
        xmin, xmax, ymin, ymax, valid, rows, cols, ty_lo, tiles_y_band)
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
        tyl = ty - ty_lo  # band-local tile row (ty when unbanded)
        ok = (small & (tyl >= 0) & (tyl < tiles_y_eff) & (sc >= 0)
              & (sc < sx_n) & (ty <= ty1) & (sc <= sc1))
        bins = torch.where(ok, tyl * sx_n + sc, n_bins)
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
        g_ty = bins_g // sx_n + ty_lo  # global tile row of the local bin
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


def _bin_grid(rows: int, cols: int, tiles_y_band) -> int:
    """The bins of a bin-key call: the band's, or the frame's."""
    tiles_y = -(-rows // TILE_H) if tiles_y_band is None else tiles_y_band
    return tiles_y * -(-cols // TILE_W) * RS.N_SUB


def pair_keys_ref(xmin, xmax, ymin, ymax, valid, rows: int, cols: int, *,
                  big_cap: int, ty_lo: int = 0,
                  tiles_y_band: int | None = None):
    """The plain version of ``pair_keys``: ``_pair_keys_core``'s sorted
    keys, their bins' offsets (a left searchsorted over all keys) and the
    counts (n_small, n_big, n_pairs, n_valid) i32 [4] under
    ``_bin_span``'s rules."""
    keys = _pair_keys_core(xmin, xmax, ymin, ymax, valid, rows, cols,
                           big_cap=big_cap, ty_lo=ty_lo,
                           tiles_y_band=tiles_y_band)
    n_bins = _bin_grid(rows, cols, tiles_y_band)
    offsets = torch.searchsorted(
        keys >> RS.SUB_SHIFT, torch.arange(n_bins + 1, dtype=torch.int32,
                                           device=keys.device),
        side="left").to(torch.int32)
    _, _, _, _, small, bigt = _bin_span(xmin, xmax, ymin, ymax, valid, rows,
                                        cols, ty_lo, tiles_y_band)
    counts = torch.stack([small.sum(dtype=torch.int32),
                          bigt.sum(dtype=torch.int32), offsets[n_bins],
                          valid.sum(dtype=torch.int32)])
    return keys, offsets, counts


def pair_keys(xmin, xmax, ymin, ymax, valid, rows: int, cols: int, *,
              big_cap: int, ty_lo: int = 0, tiles_y_band: int | None = None,
              form: int = 0):
    """The grouped generations' pair keys from the bbox channels f32 [T]
    and valid bool [T], of the tile-row band [ty_lo, ty_lo +
    tiles_y_band) when given: (sorted keys i32 [P] ``bin << 18 | tri``
    (P = 4 T + min(big_cap, T) n_bins), offsets i32 [n_bins + 1], counts
    i32 [4]: n_small, n_big, n_pairs, n_valid). On the CPU the plain
    version; on a CUDA device X9 (``form`` 0: by size, else one of
    ``FORMS``), bit for bit with it."""
    if valid.device.type == "cpu":
        return pair_keys_ref(xmin, xmax, ymin, ymax, valid, rows, cols,
                             big_cap=big_cap, ty_lo=ty_lo,
                             tiles_y_band=tiles_y_band)
    global launches_keys
    chans = [xmin, xmax, ymin, ymax]
    T = valid.shape[0]
    n_bins = _bin_grid(rows, cols, tiles_y_band)
    band = 0 if tiles_y_band is None else int(tiles_y_band)
    if not 1 <= T < RS.MAX_TRI or not 1 <= n_bins < (1 << 13):
        raise ValueError(f"pair_keys: {T} triangles (1 to 2^18 - 1), "
                         f"{n_bins} bins (1 to 8191)")
    if big_cap < 0 or ty_lo < 0 or (tiles_y_band is not None and band < 1):
        raise ValueError(f"pair_keys: big_cap {big_cap}, band {ty_lo} + "
                         f"{tiles_y_band}")
    _build.require_cuda(valid, what="pair_keys")
    _check_chans(chans, valid, "pair_keys", "bbox")
    dev = valid.device
    P = 4 * T + min(big_cap, T) * n_bins
    if P >= 2 ** 31 - 1:
        raise ValueError(f"pair_keys: {P} keys, too many")
    keys = torch.empty((P,), dtype=torch.int32, device=dev)
    offsets = torch.empty((n_bins + 1,), dtype=torch.int32, device=dev)
    counts = torch.empty((4,), dtype=torch.int32, device=dev)
    # the kernel reads the four bbox channels (slots 0-3 of its nine)
    err = _launch((chans * 3)[:9], valid, 1, T, rows, cols, 2, big_cap,
                  ty_lo, band, 4, n_bins, P, form, offsets=offsets,
                  counts=counts, keys=keys, n_out=P)
    launches_keys += 1
    _build.check(err, "bin_entries_launch")
    return keys, offsets, counts


def pair_keys_bbox(cch, rows: int, cols: int, *, big_cap: int,
                   ty_lo: int = 0, tiles_y_band: int | None = None,
                   form: int = 0):
    """``pair_keys`` of a bbox dict (bx0 bx1 by0 by1 valid)."""
    return pair_keys(cch["bx0"], cch["bx1"], cch["by0"], cch["by1"],
                     cch["valid"], rows, cols, big_cap=big_cap, ty_lo=ty_lo,
                     tiles_y_band=tiles_y_band, form=form)


# --------------------------------------------------------------------------
# the launch
# --------------------------------------------------------------------------
_tickets: dict = {}  # device -> two uint32 zeros the last blocks reset


def _check_chans(chans, valid, what: str, kind: str) -> None:
    T = valid.shape[0]
    for t in chans:
        if t.device != valid.device or t.dim() != 1 or t.shape[0] != T or \
                t.dtype != torch.float32:
            raise ValueError(f"{what}: {kind} channels must be float32 "
                             f"[{T}] on {valid.device}")
    if valid.dtype != torch.bool or valid.dim() != 1:
        raise ValueError(f"{what}: valid must be bool [T]")


def auto_form(n_bins: int, P: int) -> int:
    """The form a launch takes by size (``tools/bin_variants``' table):
    chunks of 1,024 keys (4 warps of 8 steps) below SMALL_P keys, of 2,048
    (8 of 8) up to WIDE_P, of 4,096 (8 of 16) from there. ``n_bins`` is
    the grid's: every form takes any."""
    del n_bins
    return 1 if P < SMALL_P else 3 if P >= WIDE_P else 2


def launches_of(form: int, n_bins: int, P: int) -> int:
    """Kernels a launch of ``form`` makes: four, three where each scatter
    block scans a tiny histogram itself."""
    return 3 if -(-P // chunk_of(form)) * (n_bins + 1) <= TINY_HIST_MAX else 4


def chunk_of(form: int) -> int:
    """Keys a chunk of the sequence pass."""
    if form not in FORMS:
        raise ValueError(f"bin entries: form {form}, not one of "
                         f"{sorted(FORMS)}")
    return 32 * FORMS[form][0] * FORMS[form][1]


def _workspace(T: int, S: int, n_bins: int, P: int, big_cap: int,
               chunk: int, dev):
    """The kernels' int32 scratch in one tensor: tiles, span, mask, bpart,
    big_idx, seg, meta, seq, lrank, hist, tot, bsum, rspan (csrc's Work),
    each piece's start a multiple of four ints (16 bytes)."""
    n_chunks = -(-P // chunk) if chunk else 0
    sizes = (T * S, 4 * T, -(-T // 32), 4 * -(-(T + 1) // 128),
             max(big_cap, 1), max(big_cap, 1), 4, P, P,
             n_chunks * (n_bins + 1), n_bins + 1, -(-(n_bins + 1) // 32),
             4 * max(big_cap, 1))
    starts, o = [], 0
    for n in sizes:
        starts.append(o)
        o += -(-n // 4) * 4
    ws = torch.empty((o,), dtype=torch.int32, device=dev)
    base = ws.data_ptr()
    return ws, (ctypes.c_longlong * 13)(*(base + 4 * s for s in starts))


def _launch(chans, valid, layout: int, T: int, rows: int, cols: int,
            tw: int, big_cap: int, ty_lo: int, band: int, S: int,
            n_bins: int, P: int, form: int, *, offsets, counts, n_out: int,
            src=None, data=None, keys=None, mm: bool = False) -> int:
    """One X9 launch (three or four kernels): its cudaError code."""
    global last_launches
    dev = valid.device
    form = form or auto_form(n_bins, P)
    chunk = chunk_of(form)
    cap = min(big_cap, T) if layout == 1 else big_cap
    ws, ws13 = _workspace(T, S, n_bins, P, cap, chunk, dev)
    if dev not in _tickets:
        _tickets[dev] = torch.zeros((2,), dtype=torch.int32, device=dev)
    scr = (ctypes.c_longlong * 20)(*(t.data_ptr() for t in chans),
                                   valid.data_ptr(),
                                   *(t.stride(0) for t in chans),
                                   valid.stride(0))
    last_launches = launches_of(form, n_bins, P)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    # ws is freed on return: the stream orders its reuse after the kernels
    return _build.lib().bin_entries_launch(
        scr, ws13, layout, T, rows, cols, tw, big_cap, ty_lo, band, ptr(src),
        offsets.data_ptr(), counts.data_ptr(), ptr(data), ptr(keys), n_out,
        int(mm), form, _tickets[dev].data_ptr(), _build.stream_ptr(dev))
