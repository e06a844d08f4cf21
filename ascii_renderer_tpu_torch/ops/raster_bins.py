"""Binned rasterization with exact per-tile bins: the CUDA kernel
``csrc/raster_bins.cu`` (replaces the Pallas
``ascii_renderer_tpu/ops/raster_bins.py:_kernel_mm``, B6, and ``:_kernel``,
B6') and its plain-torch version.

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
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
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
    t_ids = torch.arange(n_tiles, device=dev)
    pix = torch.arange(PIX, device=dev)
    px = ((pix % TILE_W)[None, :] + (t_ids % tiles_x)[:, None] * TILE_W
          ).to(torch.float32) + 0.5                      # [n_tiles, 1024]
    py = ((pix // TILE_W)[None, :] + (t_ids // tiles_x)[:, None] * TILE_H
          ).to(torch.float32) + 0.5
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


def _launch(data, offsets, tiles_x: int, n_tiles: int, mm: bool, what: str):
    _build.require_cuda(data, offsets, what=what)
    z = torch.empty((n_tiles, TILE_H, TILE_W), dtype=torch.float32,
                    device=data.device)
    t = torch.empty_like(z)
    if n_tiles == 0:
        return z, t
    err = _build.lib().bins_walk_launch(
        data.data_ptr(), offsets.data_ptr(), z.data_ptr(), t.data_ptr(),
        n_tiles, tiles_x, data.numel() // N_CHAN, int(mm),
        _build.stream_ptr(data.device))
    _build.check(err, "bins_walk_launch")
    return z, t


def tile_eval_bins_mm(data_mm: torch.Tensor, offsets: torch.Tensor,
                      tiles_x: int, n_tiles: int):
    """data_mm f32 [P/128, N_CHAN, 128] (channel-major 128-entry chunks);
    offsets i32 [n_tiles+1] in ENTRY units -> (z, tid) f32
    [n_tiles, 8, 128], tid -1 = none. CPU tensors run the plain version;
    CUDA tensors launch the kernel once (one block per tile)."""
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
    tensors run the plain version; CUDA tensors launch the kernel once."""
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


def tile_eval_bins_shaded(*args, **kwargs):
    """The fused visibility + shading walk (``_shaded_kernel``, method
    'fused') is not ported yet."""
    raise NotImplementedError(
        "tile_eval_bins_shaded (the fused-shading walk, method 'fused') is "
        "not ported to ascii_renderer_tpu_torch yet (ROADMAP B8)")
