"""Binned rasterization with exact per-tile bins: the CUDA kernels
``csrc/raster_bins.cu`` (replaces the Pallas
``ascii_renderer_tpu/ops/raster_bins.py:_kernel_mm``, B6, and ``:_kernel``,
B6') and ``csrc/raster_shaded.cu`` (replaces ``:_shaded_kernel``, B8), and
their plain-torch versions.

Each 8 x 128 pixel tile walks its EXACT bin of (tile, tri) pairs, entries
[offsets[t], offsets[t + 1]) of the pair-sorted entry table, and keeps the
nearest hit per pixel; nothing is capped or dropped. Entries are in PLANE
form, 16 channels (CH_*): three edge planes w_k = A_k px + B_k py + G_k
(inside <=> every w_k <= 0), the screen-depth plane z = ZX px + ZY py + ZC,
a valid flag and the triangle id as f32.

Two entry layouts, one kernel:
  tile_eval_bins_mm (B6): data f32 [P/128, N_CHAN, 128], channel-major
    chunks of MM_CHUNK entries. A chunk's winner is the least z, then the
    least triangle id among equal z; chunks merge with a strict z < best.
    The planes round as the reference's K = 3 dot does on the CPU:
    fma(B, py, A*px) + G.
  tile_eval_bins (B6'): data f32 [P/8, 128] (pack_entries of [P, N_CHAN]
    rows). Entries with CH_VALID <= 0 are skipped, and the merge is a
    strict z < best in bin order. The planes round as the reference's loop
    kernel does: fma(A, px, B*py) + G.
Bins are sorted by triangle id, so both rules let the smallest id win a
depth tie. Outputs: z and tid f32 [n_tiles, 8, 128], tid -1 = none.

  tile_eval_bins_shaded (B8): the fused-shading walk over 64-channel
    vertex-form entries (S_*: screen vertices, 1/w and 9 attributes per
    vertex), two per row, that keeps the winner's perspective-correct
    attributes and lights them (ambient, one directional, up to L_MAX_PL
    point lights): rgb f32 [n_tiles, 3, 8, 128], black where nothing hit.
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.core.fp import fma32, sqrt32
from ascii_renderer_tpu_torch.ops import _build

TILE_H, TILE_W = 8, 128
N_CHAN = 16
PACK = 8  # entries per 128-lane row of the loop layout
CHUNK_ROWS = 32
CHUNK = PACK * CHUNK_ROWS  # the loop layout's inert-tail unit
MM_CHUNK = 128  # entries per chunk (both layouts, kernel and plain version)
PIX = TILE_H * TILE_W

CH_A0, CH_B0, CH_G0 = 0, 1, 2  # edge 0 plane: w0 = A0*px + B0*py + G0
CH_A1, CH_B1, CH_G1 = 3, 4, 5
CH_A2, CH_B2, CH_G2 = 6, 7, 8
CH_ZX, CH_ZY, CH_ZC = 9, 10, 11  # depth plane: z = ZX*px + ZY*py + ZC
CH_VALID = 12
CH_TID = 13

launches = 0       # kernel launches by tile_eval_bins_mm (B6)
launches_loop = 0  # kernel launches by tile_eval_bins (B6')
# kernels each wrapper launches per call on CUDA tensors (a walk, then the
# merge of its work items' partials)
LAUNCHES_PER_CALL = {"tile_eval_bins_mm": 2, "tile_eval_bins": 2,
                     "tile_eval_bins_shaded": 2}


def pack_entries(data: torch.Tensor) -> torch.Tensor:
    """[P, N_CHAN] entries (P a multiple of PACK) -> packed [P/PACK, 128]
    (a view)."""
    p = data.shape[0]
    if p % PACK:
        raise ValueError(f"pack_entries: {p} entries, not a multiple of {PACK}")
    return data.reshape(p // PACK, PACK * N_CHAN)


def _check(data, offsets, n_tiles: int, what: str):
    if offsets.shape != (n_tiles + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"{what}: offsets must be int32 [{n_tiles + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if data.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32 entries")


def _bins_walk_ref(ent: torch.Tensor, offsets: torch.Tensor, tiles_x: int,
                   n_tiles: int, mm: bool):
    """Plain version of both walks over row-major entries ent [P, N_CHAN]:
    one step per chunk index, vectorised over the tiles that still have
    chunks; each step evaluates a whole 128-entry chunk against the 1,024
    pixels of every live tile."""
    dev = ent.device
    inf = float("inf")
    off = offsets.long()
    off0, off1 = off[:-1], off[1:]
    start = (off0 // MM_CHUNK) * MM_CHUNK
    n_chunks = torch.where(off1 > off0,
                           (off1 - start + MM_CHUNK - 1) // MM_CHUNK, 0)
    P = ent.shape[0]
    p_pad = -(-(P + MM_CHUNK) // MM_CHUNK) * MM_CHUNK
    ent = torch.cat([ent, ent.new_zeros((p_pad - P, N_CHAN))])
    px, py = tile_pixel_centres(tiles_x, n_tiles, dev)  # [n_tiles, 1024]
    zb = torch.full((n_tiles, PIX), inf, device=dev)
    tb = torch.full((n_tiles, PIX), -1.0, device=dev)
    n_max = int(n_chunks.max()) if n_tiles else 0
    e_in = torch.arange(MM_CHUNK, device=dev)
    for i in range(n_max):
        gi = torch.nonzero(n_chunks > i).squeeze(1)
        base = start[gi] + i * MM_CHUNK                  # [n]
        eidx = base[:, None] + e_in[None, :]             # [n, 128]
        ch = ent[torch.clamp(eidx, max=p_pad - 1)]       # [n, 128, 16]
        live = (eidx >= off0[gi, None]) & (eidx < off1[gi, None])
        if not mm:
            live &= ch[..., CH_VALID] > 0.0
        x, y = px[gi][:, None, :], py[gi][:, None, :]    # [n, 1, 1024]

        def plane(ca, cb, cg):
            a, b, g = (ch[..., c, None] for c in (ca, cb, cg))
            if mm:  # the K = 3 dot: B*py fused onto A*px, then + G
                return fma32(b, y, a * x) + g
            return fma32(a, x, b * y) + g  # the loop: A*px fused onto B*py

        ok = live[..., None] & (plane(CH_A0, CH_B0, CH_G0) <= 0.0)
        ok &= plane(CH_A1, CH_B1, CH_G1) <= 0.0
        ok &= plane(CH_A2, CH_B2, CH_G2) <= 0.0
        z = plane(CH_ZX, CH_ZY, CH_ZC)
        ok &= (z >= 0.0) & (z <= 1.0)
        zm = torch.where(ok, z, inf)                     # [n, 128, 1024]
        zc = zm.amin(dim=1)                              # [n, 1024]
        tid = ch[..., CH_TID, None].expand_as(zm)
        if mm:  # least id among the chunk's least z
            tc = torch.where(zm == zc[:, None], tid, inf).amin(dim=1)
        else:   # the first entry reaching the least z, in bin order
            tc = tid.gather(1, zm.argmin(dim=1, keepdim=True))[:, 0]
        better = zc < zb[gi]
        zb[gi] = torch.where(better, zc, zb[gi])
        tb[gi] = torch.where(better, tc, tb[gi])
    return (zb.view(n_tiles, TILE_H, TILE_W), tb.view(n_tiles, TILE_H, TILE_W))


def tile_eval_bins_mm_ref(data_mm: torch.Tensor, offsets: torch.Tensor,
                          tiles_x: int, n_tiles: int):
    """Plain-torch version of ``tile_eval_bins_mm``."""
    _check(data_mm, offsets, n_tiles, "tile_eval_bins_mm")
    ent = data_mm.transpose(1, 2).reshape(-1, N_CHAN)
    return _bins_walk_ref(ent, offsets, tiles_x, n_tiles, mm=True)


def tile_eval_bins_ref(data_packed: torch.Tensor, offsets: torch.Tensor,
                       tiles_x: int, n_tiles: int):
    """Plain-torch version of ``tile_eval_bins``."""
    _check(data_packed, offsets, n_tiles, "tile_eval_bins")
    return _bins_walk_ref(data_packed.reshape(-1, N_CHAN), offsets, tiles_x,
                          n_tiles, mm=False)


def bin_slots(offsets: torch.Tensor):
    """The walk's work list, per tile: the first slot and the number of
    128-entry chunks of its bin. Chunk c of tile t is the global chunk
    off0 // 128 + c and takes slot off0 // 128 + t + c: slots increase with
    (t, c), so each tile's chunks are consecutive and slots merge in bin
    order."""
    off = offsets.long()
    off0, off1 = off[:-1], off[1:]
    first = off0 // MM_CHUNK + torch.arange(off0.shape[0], device=off.device)
    n = torch.where(off1 > off0, (off1 - 1) // MM_CHUNK - off0 // MM_CHUNK
                    + 1, 0)
    return first, n


def n_slots(n_entries: int, n_tiles: int) -> int:
    """Slots of the work list for any offsets into n_entries entries: the
    host sizes the grid and the partial results from this bound."""
    return n_entries // MM_CHUNK + n_tiles


def work_list(first: torch.Tensor, n: torch.Tensor, slots: int):
    """(slot, bin, chunk) of every work item of a work list whose bin i
    takes the n[i] consecutive slots from first[i] (first increasing). A
    slot's bin is the last whose first slot is not above it (the kernels'
    binary search); slots past that bin's chunks are unused."""
    q = torch.arange(slots, device=first.device)
    t = torch.clamp(torch.searchsorted(first, q, right=True) - 1, min=0)
    c = q - first[t]
    used = (c >= 0) & (c < n[t])
    return q[used], t[used], c[used]


def work_items(offsets: torch.Tensor, n_entries: int):
    """(slot, tile, chunk) of every work item the B6 / B6' kernel walks."""
    first, n = bin_slots(offsets)
    return work_list(first, n, n_slots(n_entries, first.shape[0]))


def _launch(data, offsets, tiles_x: int, n_tiles: int, mm: bool, what: str):
    _build.require_cuda(data, offsets, what=what)
    if data.data_ptr() % 16:
        raise ValueError(f"{what}: data must be 16-byte aligned")
    z = torch.empty((n_tiles, TILE_H, TILE_W), dtype=torch.float32,
                    device=data.device)
    t = torch.empty_like(z)
    if n_tiles == 0:
        return z, t
    n_entries = data.numel() // N_CHAN
    slots = n_slots(n_entries, n_tiles)
    part = torch.empty((slots, 2, PIX), dtype=torch.float32,
                       device=data.device)
    err = _build.lib().bins_walk_launch(
        data.data_ptr(), offsets.data_ptr(), z.data_ptr(), t.data_ptr(),
        part.data_ptr(), slots, n_tiles, tiles_x, n_entries, int(mm),
        _build.stream_ptr(data.device))
    _build.check(err, "bins_walk_launch")
    return z, t


def tile_eval_bins_mm(data_mm: torch.Tensor, offsets: torch.Tensor,
                      tiles_x: int, n_tiles: int):
    """data_mm f32 [P/128, N_CHAN, 128] (channel-major 128-entry chunks);
    offsets i32 [n_tiles+1] in ENTRY units -> (z, tid) f32
    [n_tiles, 8, 128], tid -1 = none. CPU tensors run the plain version;
    CUDA tensors launch the kernel once: a walk over the work list
    (``work_items``: a block per chunk of a bin and quarter of a tile),
    then a merge of the partial results in bin order."""
    if data_mm.dim() != 3 or data_mm.shape[1:] != (N_CHAN, MM_CHUNK):
        raise ValueError(f"tile_eval_bins_mm: expected [P/128, 16, 128], got "
                         f"{tuple(data_mm.shape)}")
    if data_mm.device.type == "cpu":
        return tile_eval_bins_mm_ref(data_mm, offsets, tiles_x, n_tiles)
    global launches
    _check(data_mm, offsets, n_tiles, "tile_eval_bins_mm")
    out = _launch(data_mm, offsets, tiles_x, n_tiles, True,
                  "tile_eval_bins_mm")
    launches += 1
    return out


def tile_eval_bins(data_packed: torch.Tensor, offsets: torch.Tensor,
                   tiles_x: int, n_tiles: int):
    """data_packed f32 [P/8, 128] (see pack_entries); offsets i32
    [n_tiles + 1] in ENTRY units -> (z, tid) as tile_eval_bins_mm. CPU
    tensors run the plain version; CUDA tensors launch the kernel once
    (walk and merge, as tile_eval_bins_mm)."""
    if data_packed.dim() != 2 or data_packed.shape[1] != PACK * N_CHAN:
        raise ValueError(f"tile_eval_bins: expected [P/8, 128], got "
                         f"{tuple(data_packed.shape)}")
    if data_packed.device.type == "cpu":
        return tile_eval_bins_ref(data_packed, offsets, tiles_x, n_tiles)
    global launches_loop
    _check(data_packed, offsets, n_tiles, "tile_eval_bins")
    out = _launch(data_packed, offsets, tiles_x, n_tiles, False,
                  "tile_eval_bins")
    launches_loop += 1
    return out


# --------------------------------------------------------------------------
# B8: the fused-shading walk (csrc/raster_shaded.cu)
# --------------------------------------------------------------------------
NS_CHAN = 64       # channels per fused-shading entry
NS_PACK = 2        # entries per 128-lane row
S_VALID = 0
S_X0, S_X1, S_X2 = 1, 2, 3
S_Y0, S_Y1, S_Y2 = 4, 5, 6
S_Z0, S_Z1, S_Z2 = 7, 8, 9
S_IW0, S_IW1, S_IW2 = 10, 11, 12
S_ATTR = 13  # 9 attrs (nx ny nz cr cg cb wx wy wz) x 3 vertices = 27 ch
S_CHUNK_ROWS = 32
S_CHUNK = NS_PACK * S_CHUNK_ROWS  # entries per walk chunk
# light params f32 [64]: 0..2 ambient rgb, 3..5 directional light direction,
# 6..8 its colour, 9 the point-light count (a float), then point light i at
# 10 + 6*i: position xyz, colour rgb, up to L_MAX_PL
L_MAX_PL = 8
_SHADED_BATCH = 32  # tiles per step of the plain version (bounds its memory)

launches_shaded = 0  # kernel launches by tile_eval_bins_shaded (B8)


def _shaded_planes(e, px, py):
    """Edge functions in vertex form (w_k <= 0 inside, each a*b - c*d with
    the left product fused) and z = sum_k w_k z_k / area for entries e
    [..., NS_CHAN] at pixel centres px, py."""
    x0, x1, x2 = e[..., S_X0], e[..., S_X1], e[..., S_X2]
    y0, y1, y2 = e[..., S_Y0], e[..., S_Y1], e[..., S_Y2]
    w0 = fma32(x2 - x1, py - y1, -((y2 - y1) * (px - x1)))
    w1 = fma32(x0 - x2, py - y2, -((y0 - y2) * (px - x2)))
    w2 = fma32(x1 - x0, py - y0, -((y1 - y0) * (px - x0)))
    inv_area = torch.reciprocal((w0 + w1) + w2)
    # (w0 z0 + w1 z1) + w2 z2: the first two products fuse, then the third
    z = fma32(w2, e[..., S_Z2], fma32(w0, e[..., S_Z0],
                                      w1 * e[..., S_Z1])) * inv_area
    return w0, w1, w2, z


def _rsqrt(x):
    """1 / sqrtf(x), both operations IEEE: the kernel's rounding."""
    return torch.reciprocal(sqrt32(x))


def tile_eval_bins_shaded_ref(data_packed: torch.Tensor,
                              offsets: torch.Tensor,
                              light_params: torch.Tensor, tiles_x: int,
                              n_tiles: int):
    """Plain-torch version of ``tile_eval_bins_shaded``. The walk finds
    each pixel's winner (the first live entry of least z, which is the
    reference's strict merge in bin order), then the winner's attributes
    are interpolated and lit once: the reference keeps the interpolation
    of every better entry, whose last value is the winner's, bit for
    bit."""
    dev = data_packed.device
    inf = float("inf")
    ent = data_packed.reshape(-1, NS_CHAN)
    P = ent.shape[0]
    off = offsets.long()
    off0, off1 = off[:-1], off[1:]
    start = (off0 // (8 * NS_PACK)) * (8 * NS_PACK)
    n_chunks = torch.where(off1 > off0,
                           (off1 - start + S_CHUNK - 1) // S_CHUNK, 0)
    px, py = tile_pixel_centres(tiles_x, n_tiles, dev)  # [n_tiles, 1024]
    zb = torch.full((n_tiles, PIX), inf, device=dev)
    wb = torch.zeros((n_tiles, PIX), dtype=torch.long, device=dev)
    e_in = torch.arange(S_CHUNK, device=dev)
    order = torch.sort(n_chunks, descending=True, stable=True).indices
    steps = n_chunks[order].tolist()
    for b in range(0, n_tiles, _SHADED_BATCH):
        gi = order[b:b + _SHADED_BATCH]
        for i in range(steps[b]):
            eidx = (start[gi] + i * S_CHUNK)[:, None] + e_in[None, :]
            ch = ent[torch.clamp(eidx, max=P - 1)]          # [n, 64, 64]
            live = ((eidx >= off0[gi, None]) & (eidx < off1[gi, None])
                    & (ch[..., S_VALID] > 0.0))
            w0, w1, w2, z = _shaded_planes(ch[:, :, None, :],
                                           px[gi][:, None, :],
                                           py[gi][:, None, :])
            ok = (live[..., None] & (w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)
                  & (z >= 0.0) & (z <= 1.0))
            zm = torch.where(ok, z, inf)                    # [n, 64, 1024]
            kc = zm.argmin(dim=1, keepdim=True)  # the first of least z
            zc = zm.gather(1, kc)[:, 0]
            better = zc < zb[gi]
            zb[gi] = torch.where(better, zc, zb[gi])
            wb[gi] = torch.where(better, eidx.gather(1, kc[:, 0]), wb[gi])
    return _shade_winners(ent, wb, zb < inf, px, py, light_params, n_tiles)


def tile_pixel_centres(tiles_x: int, n_tiles: int, device):
    """Pixel centres (px, py) f32 [n_tiles, 1024] of the tiles."""
    t_ids = torch.arange(n_tiles, device=device)
    pix = torch.arange(PIX, device=device)
    px = ((pix % TILE_W)[None, :] + (t_ids % tiles_x)[:, None] * TILE_W
          ).to(torch.float32) + 0.5
    py = ((pix // TILE_W)[None, :] + (t_ids // tiles_x)[:, None] * TILE_H
          ).to(torch.float32) + 0.5
    return px, py


def _shade_winners(ent, wb, hit, px, py, light_params, n_tiles: int):
    """The winners' perspective-correct attributes, lit: entry wb [n_tiles,
    1024] of ent [P, NS_CHAN] at pixel centres px, py where ``hit`` ->
    rgb f32 [n_tiles, 3, 8, 128], black elsewhere."""
    e = ent[torch.where(hit, wb, 0)]                        # [n_tiles, 1024, 64]
    w0, w1, w2, _z = _shaded_planes(e, px, py)
    # perspective-correct barycentrics
    bw0, bw1, bw2 = (w * e[..., c] for w, c in ((w0, S_IW0), (w1, S_IW1),
                                                 (w2, S_IW2)))
    dnm = (bw0 + bw1) + bw2
    inv_dnm = torch.reciprocal(torch.where(dnm.abs() < 1e-30, 1e-30, dnm))
    p0, p1, p2 = bw0 * inv_dnm, bw1 * inv_dnm, bw2 * inv_dnm
    nx, ny, nz, cr, cg, cb, wx, wy, wz = (
        fma32(p2, e[..., S_ATTR + 18 + a],
              fma32(p0, e[..., S_ATTR + a], p1 * e[..., S_ATTR + 9 + a]))
        for a in range(9))
    # lighting: ambient + one directional + up to L_MAX_PL point lights;
    # torch.clamp keeps NaN, as the reference's max and clip do
    lp = light_params
    inv_nl = _rsqrt(torch.clamp(fma32(nz, nz, fma32(nx, nx, ny * ny)),
                                min=1e-24))
    nx, ny, nz = nx * inv_nl, ny * inv_nl, nz * inv_nl
    ndl = torch.clamp(-fma32(nz, lp[5], fma32(nx, lp[3], ny * lp[4])),
                      min=0.0)
    lit = [fma32(lp[6 + k], ndl, lp[k]) for k in range(3)]
    out = [c * lit[k] for k, c in enumerate((cr, cg, cb))]
    for i in range(L_MAX_PL):
        base = 10 + 6 * i
        lx, ly, lz = lp[base] - wx, lp[base + 1] - wy, lp[base + 2] - wz
        d2 = torch.clamp(fma32(lz, lz, fma32(lx, lx, ly * ly)), min=1e-4)
        ndlp = torch.clamp(fma32(nz, lz, fma32(nx, lx, ny * ly))
                           * _rsqrt(d2), min=0.0)
        att = torch.reciprocal(fma32(d2, 0.05, 1.0))
        on = torch.where(lp[9] > i + 0.5, ndlp * att, 0.0)
        for k, c in enumerate((cr, cg, cb)):
            # out + (c * col) * on: the first light's add sees two products
            # and fuses the left one, c * lit
            if i == 0:
                out[k] = fma32(c, lit[k], (c * lp[base + 3 + k]) * on)
            else:
                out[k] = fma32(c * lp[base + 3 + k], on, out[k])
    rgb = torch.stack([torch.where(hit, torch.clamp(o, 0.0, 1.0), 0.0)
                       for o in out], dim=1)
    return rgb.view(n_tiles, 3, TILE_H, TILE_W)


def shaded_bin_slots(offsets: torch.Tensor):
    """B8's work list, per tile: the first slot and the number of S_CHUNK
    (64-entry) chunks of its bin, the first starting at off0 rounded down
    to 16 entries (the reference's DMA alignment). Chunk c of tile t takes
    slot off0 // 64 + t + c: slots increase with (t, c), so a tile's chunks
    are consecutive and merge in bin order."""
    off = offsets.long()
    off0, off1 = off[:-1], off[1:]
    start = (off0 // (8 * NS_PACK)) * (8 * NS_PACK)
    first = off0 // S_CHUNK + torch.arange(off0.shape[0], device=off.device)
    n = torch.where(off1 > off0, (off1 - start + S_CHUNK - 1) // S_CHUNK, 0)
    return first, n


def shaded_n_slots(n_entries: int, n_tiles: int) -> int:
    """Slots of B8's work list for any offsets into n_entries entries."""
    return n_entries // S_CHUNK + n_tiles


def shaded_work_items(offsets: torch.Tensor, n_entries: int):
    """(slot, tile, chunk) of every work item the B8 kernel walks."""
    first, n = shaded_bin_slots(offsets)
    return work_list(first, n, shaded_n_slots(n_entries, first.shape[0]))


def tile_eval_bins_shaded(data_packed: torch.Tensor, offsets: torch.Tensor,
                          light_params: torch.Tensor, tiles_x: int,
                          n_tiles: int):
    """B8: the fused walk + perspective-correct interpolation + fragment
    lighting. data_packed f32 [P/2, 128] (NS_CHAN-channel entries, two per
    row, with >= S_CHUNK + 16 inert trailing entries), offsets i32
    [n_tiles+1] in entry units, light_params f32 [64] (layout above) ->
    rgb f32 [n_tiles, 3, 8, 128]. CPU tensors run the plain version; CUDA
    tensors launch the kernel once: a walk over the work list
    (``shaded_work_items``: one item per 64-entry chunk of a bin and
    quarter of a tile, keeping (z, entry) per pixel), then a merge in bin
    order that shades each pixel from its winning entry."""
    if data_packed.dim() != 2 or data_packed.shape[1] != NS_PACK * NS_CHAN:
        raise ValueError(f"tile_eval_bins_shaded: expected [P/2, 128], got "
                         f"{tuple(data_packed.shape)}")
    _check(data_packed, offsets, n_tiles, "tile_eval_bins_shaded")
    if light_params.shape != (64,) or light_params.dtype != torch.float32:
        raise ValueError("tile_eval_bins_shaded: light_params must be f32 [64]")
    if data_packed.device.type == "cpu":
        return tile_eval_bins_shaded_ref(data_packed, offsets, light_params,
                                         tiles_x, n_tiles)
    global launches_shaded
    _build.require_cuda(data_packed, offsets, light_params,
                        what="tile_eval_bins_shaded")
    if data_packed.data_ptr() % 16:
        raise ValueError("tile_eval_bins_shaded: data must be 16-byte aligned")
    rgb = torch.empty((n_tiles, 3, TILE_H, TILE_W), dtype=torch.float32,
                      device=data_packed.device)
    if n_tiles:
        n_entries = data_packed.numel() // NS_CHAN
        slots = shaded_n_slots(n_entries, n_tiles)
        part = torch.empty((slots, 2, PIX), dtype=torch.float32,
                           device=data_packed.device)
        err = _build.lib().shaded_walk_launch(
            data_packed.data_ptr(), offsets.data_ptr(),
            light_params.data_ptr(), rgb.data_ptr(), part.data_ptr(), slots,
            n_tiles, tiles_x, n_entries,
            _build.stream_ptr(data_packed.device))
        _build.check(err, "shaded_walk_launch")
    launches_shaded += 1
    return rgb
