"""Color packing + small math helpers (torch port of
``ascii_renderer_tpu/core/color.py``; ref: js/utils.js).

``normalize`` rounds as the reference's ``jnp.linalg.norm``: XLA fuses
the sum of squares into a chain of fused multiply-adds (``x*x``, then
``fma(y, y, .)``, ...; ``core/camera._norm3`` for three components), the
root is correctly rounded (``core/fp.sqrt32``) and the division is IEEE
(a tensor divided by a tensor).
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.core.fp import fma32, sqrt32


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def pack_color(r, g, b) -> torch.Tensor:
    """(r,g,b) bytes -> 0xRRGGBB int32 (ref: js/utils.js:2-4)."""
    return (_i32(r) << 16) | (_i32(g) << 8) | _i32(b)


def unpack_color(packed):
    """0xRRGGBB -> (r,g,b) int32 bytes (ref: js/utils.js:5-11)."""
    p = _i32(packed)
    return (p >> 16) & 255, (p >> 8) & 255, p & 255


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, keepdim: the squares summed left
    to right, each after the first fused into the running sum. That is
    XLA's rounding for a last axis of 1 to 4; a longer axis XLA reduces
    in another order, which is not emulated."""
    s = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        s = fma32(v[..., i], v[..., i], s)
    return sqrt32(s)[..., None]


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    e = torch.tensor(eps, dtype=v.dtype, device=v.device)
    return v / torch.maximum(_norm(v), e)


def saturate(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)
