"""The modal glyph vote: the CUDA kernel ``csrc/modal.cu`` (replaces the
Pallas ``ascii_renderer_tpu/ops/ascii_kernel.py:_kernel``) and its plain
version, ``ascii.modal.modal_filter`` (the order-exact Boyer-Moore vote of
ascii_pass_shader.js:77-138). Integer-only: kernel and plain version agree
exactly. The kernel is instantiated for each radius and for 1 or 4 cells
a thread (``cells_per_thread``).
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.ascii.modal import modal_filter  # noqa: F401
from ascii_renderer_tpu_torch.ops import _build

launches = 0        # kernel launches by modal_filter_kernel

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
