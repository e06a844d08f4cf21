"""Path-tracing core (torch port of the part of
``ascii_renderer_tpu/backends/pt_core.py`` the scene packer uses).

The XLA core's vectorised intersection and ``trace_eye_paths`` are not
ported (ROADMAP A7): the port always traces through the megakernel
(``ops/pt_kernel``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TriPack(NamedTuple):
    """Per-triangle constants, f32 [T, 3] each, and the valid mask [T]."""

    a: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def build(va, vb, vc, valid) -> "TriPack":
        return TriPack(va, vb - va, vc - va, valid)
