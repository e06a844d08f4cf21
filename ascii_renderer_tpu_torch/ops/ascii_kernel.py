"""The modal glyph vote: the CUDA kernel ``csrc/modal.cu`` (replaces the
Pallas ``ascii_renderer_tpu/ops/ascii_kernel.py:_kernel``) and its plain
version, ``ascii.modal.modal_filter`` (the order-exact Boyer-Moore vote of
ascii_pass_shader.js:77-138). Integer-only: kernel and plain version agree
exactly.
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.ascii.modal import modal_filter  # noqa: F401
from ascii_renderer_tpu_torch.ops import _build

launches = 0        # kernel launches by modal_filter_kernel

MAX_RADIUS = 3      # MAX_MODE_RADIUS (ascii_pass_shader.js:83)


def modal_filter_kernel(idx: torch.Tensor, override: torch.Tensor,
                        radius: int, thresh: int) -> torch.Tensor:
    """Twin of ``modal_filter`` (and of the JAX ``modal_filter_pallas``):
    idx int32 [H, W] ramp indices, override bool [H, W], radius 1..3.
    Returns the smoothed int32 [H, W]. CPU tensors run the plain version;
    CUDA tensors launch the kernel once."""
    if idx.dim() != 2 or override.shape != idx.shape:
        raise ValueError(f"modal_filter_kernel: idx and override must be "
                         f"[H, W], got {tuple(idx.shape)} / "
                         f"{tuple(override.shape)}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"modal_filter_kernel: radius {radius} not in "
                         f"1..{MAX_RADIUS}")
    if idx.device.type == "cpu":
        return modal_filter(idx, override, radius, thresh)
    global launches
    idx = idx.to(torch.int32).contiguous()
    ovr = override.to(torch.uint8).contiguous()
    _build.require_cuda(idx, ovr, what="modal_filter_kernel")
    h, w = idx.shape
    out = torch.empty_like(idx)
    err = _build.lib().modal_launch(idx.data_ptr(), ovr.data_ptr(),
                                    out.data_ptr(), h, w, int(radius),
                                    int(thresh), _build.stream_ptr(idx.device))
    launches += 1
    _build.check(err, "modal_launch")
    return out
