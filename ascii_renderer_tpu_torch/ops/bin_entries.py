"""The small and mid raster paths' bin entries (X9): the CUDA kernels of
``csrc/bin_entries.cu`` and their plain version, the walk B6 / B6''s
input built from the clipped triangles' screen channels.

Stands for XLA code, not a Pallas kernel: the front of
``visibility_binned_ch`` in ``ascii_renderer_tpu/backends/raster_channels
.py`` (:546; the tile span, the pair keys, the plane-form entries and
their gather), which XLA compiles into each frame's program. On CUDA
tensors the plain version is some 250 launches (10 of them ``fma32``);
``binned_entries`` is four kernel launches, its sort of the pair keys a
counting sort of their tiles:

- the triangles' pass, a thread a triangle: the bbox tile span and the
  small / big test, the tiles of its ``tile_window``-square window's pairs
  (``n_tiles`` where a pair is not emitted), its row of the source table
  (the 12 plane channels, 1.0, the id as float, two zeros; rows staged in
  shared memory and stored as one span) and a bit of the big triangles'
  mask;
- the sequence pass, a thread a key: every block ranks the first
  ``big_cap`` big triangles in id order from the mask (a block scan of its
  words' counts: the plain version's cumsum and scatter, the reference's
  stable top_k), then writes the keys ``(tile << 19) | tri`` in an order
  that puts each tile's keys in ascending triangle order (triangle t's
  small keys, then, for a ranked big one, its overlap keys; the fill
  ranks' keys last) and the histogram of its chunk of 1,024 keys' tiles;
- the scan, one block: the exclusive scan of the histograms (tile-major)
  gives each tile and chunk its first place in the sorted keys, and the
  bins' offsets (the reference's ``searchsorted``); it zeroes the inert
  tail;
- the scatter, a thread a key: its rank among its chunk's keys of the same
  tile (stable) places it, and it writes its source row there, in the
  layout of walk "mm" ([P/128, 16, 128] channel-major chunks) or
  row-major ([P, 16], which ``raster_bins.pack_entries`` views as
  "loop"'s [P/8, 128]).

The sort is stable and every tile's keys come in ascending triangle order,
so its order is ``torch.sort``'s (the reference's ``lax.sort``); equal
keys, in the tail, are equal rows.

The plain version is the chain the backend ran before, moved here
(``backends/raster_channels`` re-exports it): ``_tile_span``,
``tile_pairs``, ``plane_entries`` and ``binned_entries_ref``. Each product
the reference's compiled program fuses is an ``fma32`` there and an
``fmaf`` in the kernel, in the same order (core/fp.py); the reciprocal is
IEEE, the tile divisions are true divisions.
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.core.quantize import fdiv
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import raster_bins as RB
from ascii_renderer_tpu_torch.ops.plane_table import _edge_coeffs, _sum3
from ascii_renderer_tpu_torch.ops.raster_clip import _recip_guard

launches = 0  # calls of binned_entries that launched its kernels
# triangles, sequence, scan, scatter
LAUNCHES_PER_CALL = {"binned_entries": 4}
TILE_H, TILE_W = RB.TILE_H, RB.TILE_W
TRI_BITS = 19  # a key is (tile << 19) | tri
MAX_BIG_CAP = 8192  # the sequence pass keeps the ranks in shared memory
CHUNK = 1024  # keys a block of the sequence pass and the scatter
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
                       big_cap: int = 64, tile_window: int = 2):
    """The plain version of ``binned_entries``: ``tile_pairs``, the source
    rows of ``plane_entries``, their gather into pair order."""
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
        return data.contiguous(), offsets, tiles_x, n_tiles
    return RB.pack_entries(data), offsets, tiles_x, n_tiles


def binned_entries(ch, rows: int, cols: int, *, kernel: str = "mm",
                   big_cap: int = 64, tile_window: int = 2):
    """The bin walk's input: the exact bins of ``tile_pairs`` and the
    plane-form entries gathered into pair order, in the layout of kernel
    'mm' (B6: [P/128, 16, 128]) or 'loop' (B6': [P/8, 128]), with an inert
    zero tail. Returns (data, offsets i32 [n_tiles + 1], tiles_x,
    n_tiles). On the CPU the plain version; on a CUDA device four kernel
    launches, bit for bit with the plain version."""
    if kernel not in ("mm", "loop"):
        raise ValueError(f"binned_entries: unknown kernel {kernel!r}")
    valid = ch["valid"]
    if valid.device.type == "cpu":
        return binned_entries_ref(ch, rows, cols, kernel=kernel,
                                  big_cap=big_cap, tile_window=tile_window)
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
    for t in chans:
        if t.device != valid.device or t.dim() != 1 or t.shape[0] != T or \
                t.dtype != torch.float32:
            raise ValueError(f"binned_entries: screen channels must be "
                             f"float32 [{T}] on {valid.device}")
    if valid.dtype != torch.bool or valid.dim() != 1:
        raise ValueError("binned_entries: valid must be bool [T]")
    dev = valid.device
    P = tile_window * tile_window * T + big_cap * n_tiles
    n_rows = P + pad_rows(P, kernel)
    if n_rows * RB.N_CHAN >= 2 ** 31:
        raise ValueError(f"binned_entries: {n_rows} entries, too many")
    n_chunks = -(-P // CHUNK)
    i32 = dict(dtype=torch.int32, device=dev)
    tiles = torch.empty((T * tile_window * tile_window,), **i32)
    span = torch.empty((T, 4), **i32)
    mask = torch.empty((-(-T // 32),), **i32)
    src = torch.empty(((T + 1) * RB.N_CHAN,), dtype=torch.float32,
                      device=dev)
    seq = torch.empty((P,), **i32)
    hist = torch.empty(((n_tiles + 1) * n_chunks,), **i32)
    offsets = torch.empty((n_tiles + 1,), **i32)
    data = torch.empty((n_rows * RB.N_CHAN,), dtype=torch.float32,
                       device=dev)
    scr = (ctypes.c_longlong * 20)(*(t.data_ptr() for t in chans),
                                   valid.data_ptr(),
                                   *(t.stride(0) for t in chans),
                                   valid.stride(0))
    err = _build.lib().bin_entries_launch(
        scr, T, rows, cols, tile_window, big_cap, tiles.data_ptr(),
        span.data_ptr(), mask.data_ptr(), src.data_ptr(), seq.data_ptr(),
        hist.data_ptr(), offsets.data_ptr(), data.data_ptr(), n_rows,
        int(kernel == "mm"), _build.stream_ptr(dev))
    launches += 1
    _build.check(err, "bin_entries_launch")
    if kernel == "mm":
        return (data.view(-1, RB.N_CHAN, RB.MM_CHUNK), offsets, tiles_x,
                n_tiles)
    return (RB.pack_entries(data.view(n_rows, RB.N_CHAN)), offsets, tiles_x,
            n_tiles)
