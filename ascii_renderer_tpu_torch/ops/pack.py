"""Channel-major -> row-major packing: the CUDA kernel ``csrc/pack.cu``
(replaces the Pallas ``ascii_renderer_tpu/ops/pack.py:
_pack_split_kernel_blk``) and its plain-torch version.

The setup stage emits channel-major [C, N] planes; the row-gather
consumers (the walk source, the deferred-shade table) need row-major
[N, W] arrays, one contiguous array per channel span. The transpose is an
exact copy, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.ops import _build

launches = 0        # kernel launches by pack_channels_split_blocked


def _check_spans(cm3: torch.Tensor, spans):
    c, r, lanes = cm3.shape
    if lanes != 128 or r % 8 != 0:
        raise ValueError(f"pack: expected [C, R, 128] with R % 8 == 0, got "
                         f"{tuple(cm3.shape)}")
    w = max(b for _, b in spans)
    if w < c or any(not 0 <= a < b for a, b in spans):
        raise ValueError(f"pack: spans {spans} must cover all {c} channels")
    return c, r * lanes


def pack_channels_split_blocked_ref(cm3: torch.Tensor, spans):
    """Plain-torch version of ``pack_channels_split_blocked``."""
    c, n = _check_spans(cm3, spans)
    w = max(b for _, b in spans)
    cm = cm3.reshape(c, n)
    if w > c:
        cm = torch.cat([cm, cm.new_zeros((w - c, n))], dim=0)
    return tuple(cm[a:b].t().contiguous() for a, b in spans)


def pack_channels_split_blocked(cm3: torch.Tensor, spans):
    """cm3 f32 [C, R, 128] (R*128 = N channel-major) -> one contiguous
    row-major f32 [N, b - a] array per (a, b) span; channels past C read as
    zeros. CPU tensors run the plain version; CUDA tensors launch the
    kernel once per span."""
    if cm3.device.type == "cpu":
        return pack_channels_split_blocked_ref(cm3, spans)
    global launches
    _build.require_cuda(cm3, what="pack_channels_split_blocked")
    if cm3.dtype != torch.float32:
        raise ValueError("pack_channels_split_blocked: expected float32")
    c, n = _check_spans(cm3, spans)
    stream = _build.stream_ptr(cm3.device)
    outs = []
    for a, b in spans:
        out = torch.empty((n, b - a), dtype=torch.float32, device=cm3.device)
        err = _build.lib().pack_span_launch(cm3.data_ptr(), out.data_ptr(),
                                            c, n, a, b, stream)
        launches += 1
        _build.check(err, "pack_span_launch")
        outs.append(out)
    return tuple(outs)
