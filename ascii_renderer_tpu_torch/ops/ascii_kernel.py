"""The modal glyph vote: the CUDA kernel ``csrc/modal.cu`` (replaces the
Pallas ``ascii_renderer_tpu/ops/ascii_kernel.py:_kernel``) and its plain
version, ``ascii.modal.modal_filter`` (the order-exact Boyer-Moore vote of
ascii_pass_shader.js:77-138). Integer-only: kernel and plain version agree
exactly. The kernel is instantiated for each radius, for 1 or 4 cells a
thread (``cells_per_thread``), for one grid or a batch, and for each form.

Its chars form (``glyph_chars``) is the glyph decision from a frame's
bytes to its chars in one launch: each cell's ramp index from its rgb
bytes (``core/quantize.quantize_index``) or a given index plane, the
override flags from the alpha bytes, the vote when the mode filter is on
(without it ``glyph_map_kernel``, a thread a cell), then the ramp's codes
and the override cells' alpha bytes. Its plain version ``glyph_chars_ref``
is the torch chain of ``ascii/ascii_pass``. The ramp's codes reach the
kernel as a device copy made once for each (ramp, device).
"""

from __future__ import annotations

import functools

import torch

from ascii_renderer_tpu_torch.ascii.modal import modal_filter  # noqa: F401
from ascii_renderer_tpu_torch.core import quantize
from ascii_renderer_tpu_torch.ops import _build

launches = 0        # modal_kernel launches, both forms (the vote B4)
launches_chars = 0  # of those, the chars form's (glyph_chars)
launches_map = 0    # glyph_map_kernel launches (glyph_chars, no vote)

MAX_RADIUS = 3      # MAX_MODE_RADIUS (ascii_pass_shader.js:83)
TILE_W, WARPS = 32, 4   # modal.cu: a block is 32 columns x 4 thread rows
CELLS = 4           # cells a thread walks down its column on large grids
# below this many blocks of CELLS-cell threads a grid walks one cell a
# thread: too few threads would hold the card
MIN_BLOCKS = 264


def cells_per_thread(h: int, w: int, v: int = 1) -> int:
    """K of ``modal_kernel<R, K>`` for v grids of h x w: CELLS where that
    still gives MIN_BLOCKS blocks over the batch, else 1."""
    blocks = v * -(-h // (CELLS * WARPS)) * -(-w // TILE_W)
    return CELLS if blocks >= MIN_BLOCKS else 1


def modal_filter_kernel(idx: torch.Tensor, override: torch.Tensor,
                        radius: int, thresh: int, *,
                        cells: int | None = None) -> torch.Tensor:
    """Twin of ``modal_filter`` (and of the JAX ``modal_filter_pallas``):
    idx int32 [H, W] ramp indices, override bool [H, W], radius 1..3; or a
    batch of V grids, [V, H, W] each, every grid voted alone. Returns the
    smoothed int32 plane(s). CPU tensors run the plain version; CUDA
    tensors launch the kernel once, the batch included (an empty grid
    launches nothing). A contiguous bool override plane goes to the kernel
    as its bytes. ``cells`` sets K (1 or 4) where a measurement or a test
    needs it; by default ``cells_per_thread(h, w, v)``."""
    if idx.dim() not in (2, 3) or override.shape != idx.shape:
        raise ValueError(f"modal_filter_kernel: idx and override must be "
                         f"[H, W] or [V, H, W], got {tuple(idx.shape)} / "
                         f"{tuple(override.shape)}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"modal_filter_kernel: radius {radius} not in "
                         f"1..{MAX_RADIUS}")
    if cells not in (None, 1, CELLS):
        raise ValueError(f"modal_filter_kernel: cells {cells} not 1 or "
                         f"{CELLS}")
    if idx.device.type == "cpu":
        return modal_filter(idx, override, radius, thresh)
    global launches
    idx = idx.to(torch.int32).contiguous()
    if override.dtype != torch.bool:
        override = override != 0
    ovr = override.contiguous().view(torch.uint8)  # the bool bytes, no copy
    _build.require_cuda(idx, ovr, what="modal_filter_kernel")
    v, h, w = (1,) * (3 - idx.dim()) + tuple(idx.shape)
    out = torch.empty_like(idx)
    if out.numel() == 0:
        return out
    err = _build.lib().modal_launch(idx.data_ptr(), ovr.data_ptr(),
                                    out.data_ptr(), v, h, w, int(radius),
                                    int(thresh),
                                    cells or cells_per_thread(h, w, v),
                                    _build.stream_ptr(idx.device))
    launches += 1
    _build.check(err, "modal_launch")
    return out


def ramp_len_of(ramp: str) -> int:
    """The ramp's length, the default ramp's for an empty one."""
    return len(ramp) if ramp else len(quantize.DEFAULT_RAMP)


@functools.lru_cache(maxsize=None)
def ramp_codes(ramp: str, device) -> torch.Tensor:
    """The ramp's codes, u8 [ramp_len] on ``device``: made once for each
    (ramp, device), never again a frame."""
    return torch.as_tensor(quantize.ramp_codes(ramp), device=device)


def glyph_chars_ref(src: torch.Tensor, alpha: torch.Tensor, ramp: str, *,
                    mode_on: bool, radius: int, thresh: int) -> torch.Tensor:
    """The plain chars form: ``src`` the rgb bytes u8 [..., H, W, 3] (their
    ramp indices by ``quantize_index``) or a ramp-index plane int32
    [..., H, W]; ``alpha`` the alpha bytes u8 [..., H, W]. Returns chars
    u8 [..., H, W]: the ramp's code of each cell's index (voted by
    ``modal_filter`` when ``mode_on``), the alpha byte at override cells."""
    idx = (quantize.quantize_index(src, ramp_len_of(ramp))
           if src.dtype == torch.uint8 else src)
    override = quantize.is_override(alpha)
    if mode_on:
        idx = modal_filter(idx, override, radius, thresh)
    codes = ramp_codes(ramp, idx.device)
    return torch.where(override, alpha.to(torch.uint8), codes[idx.long()])


def glyph_chars(src: torch.Tensor, alpha: torch.Tensor, ramp: str, *,
                mode_on: bool, radius: int, thresh: int,
                cells: int | None = None) -> torch.Tensor:
    """Twin of ``glyph_chars_ref``: a grid [H, W] or a batch of V grids
    [V, H, W] (each voted alone). CPU tensors run the plain version; CUDA
    tensors launch once: the chars form of ``modal_kernel<R, K>`` with the
    mode filter on (``cells`` sets K as ``modal_filter_kernel``'s does),
    ``glyph_map_kernel`` without it. The kernel clamps an index plane's
    indices into the ramp (the plain version takes only indices in it). An
    empty grid launches nothing."""
    rgb_form = src.dtype == torch.uint8
    grid = tuple(src.shape[:-1] if rgb_form else src.shape)
    if (len(grid) not in (2, 3) or tuple(alpha.shape) != grid
            or (rgb_form and src.shape[-1] != 3)):
        raise ValueError(f"glyph_chars: src [H, W, 3] u8 or [H, W] int32 "
                         f"and alpha [H, W] (or a leading [V]), got "
                         f"{tuple(src.shape)} {src.dtype} / "
                         f"{tuple(alpha.shape)}")
    if mode_on and not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"glyph_chars: radius {radius} not in "
                         f"1..{MAX_RADIUS}")
    if cells not in (None, 1, CELLS):
        raise ValueError(f"glyph_chars: cells {cells} not 1 or {CELLS}")
    if src.device.type == "cpu":
        return glyph_chars_ref(src, alpha, ramp, mode_on=mode_on,
                               radius=radius, thresh=thresh)
    global launches, launches_chars, launches_map
    if not rgb_form and src.dtype != torch.int32:
        raise ValueError(f"glyph_chars: an index plane must be int32, got "
                         f"{src.dtype}")
    src, alpha = src.contiguous(), alpha.contiguous()
    if alpha.dtype != torch.uint8:
        raise ValueError(f"glyph_chars: alpha must be uint8, got "
                         f"{alpha.dtype}")
    _build.require_cuda(src, alpha, what="glyph_chars")
    v, h, w = (1,) * (3 - len(grid)) + grid
    chars = torch.empty(grid, dtype=torch.uint8, device=src.device)
    if chars.numel() == 0:
        return chars
    codes = ramp_codes(ramp, src.device)
    err = _build.lib().glyph_launch(
        0 if rgb_form else src.data_ptr(), src.data_ptr() if rgb_form else 0,
        alpha.data_ptr(), chars.data_ptr(), codes.data_ptr(), codes.numel(),
        v, h, w, int(mode_on), int(radius), int(thresh),
        cells or cells_per_thread(h, w, v), _build.stream_ptr(src.device))
    if mode_on:
        launches += 1
        launches_chars += 1
    else:
        launches_map += 1
    _build.check(err, "glyph_launch")
    return chars
