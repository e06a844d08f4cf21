"""Channel-major -> row-major packing: the CUDA kernel ``csrc/pack.cu``
and its plain-torch versions. It replaces three Pallas kernels of
``ascii_renderer_tpu/ops/pack.py``: ``_pack_split_kernel_blk`` (B3,
``pack_channels_split_blocked``), ``_pack_kernel`` (B7, ``pack_channels``)
and ``_pack_split_kernel`` (B7', ``pack_channels_split``).

The setup stages emit channel-major [C, N] planes; the row-gather
consumers (the walk source, the deferred-shade and plane tables) need
row-major [N, W] arrays, one contiguous array per channel span. The
blocked [C, N/128, 128] input of B3 is the flat [C, N] one, so every
wrapper launches the same span kernel, once per span: a thread gathers
one 16-byte quad of the span's contiguous output and stores it whole.
The reference pads N to a multiple of BLK inside its kernels and drops
the pad rows; the span kernel takes any N. The transpose is an exact
copy, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from ascii_renderer_tpu_torch.ops import _build

BLK = 512

launches = 0           # kernel launches by pack_channels_split_blocked (B3)
launches_channels = 0  # kernel launches by pack_channels (B7)
launches_split = 0     # kernel launches by pack_channels_split (B7')


def _check_spans(cm: torch.Tensor, spans, what: str):
    """cm must be [C, N] and the spans must cover its C channels."""
    if cm.dim() != 2:
        raise ValueError(f"{what}: expected [C, N], got {tuple(cm.shape)}")
    w = max(b for _, b in spans)
    if w < cm.shape[0] or any(not 0 <= a < b for a, b in spans):
        raise ValueError(f"{what}: spans {spans} must cover all "
                         f"{cm.shape[0]} channels")


def _flat(cm3: torch.Tensor, spans) -> torch.Tensor:
    """The blocked [C, R, 128] input of B3 as its flat [C, R*128] view."""
    c, r, lanes = cm3.shape
    if lanes != 128 or r % 8 != 0:
        raise ValueError(f"pack: expected [C, R, 128] with R % 8 == 0, got "
                         f"{tuple(cm3.shape)}")
    cm = cm3.view(c, r * lanes)
    _check_spans(cm, spans, "pack_channels_split_blocked")
    return cm


def _stack(channels) -> torch.Tensor:
    if isinstance(channels, torch.Tensor):
        return channels
    return torch.stack(list(channels), dim=0)


def pack_channels_split_ref(cm: torch.Tensor, spans):
    """Plain-torch version of ``pack_channels_split``."""
    _check_spans(cm, spans, "pack_channels_split")
    c, n = cm.shape
    w = max(b for _, b in spans)
    if w > c:
        cm = torch.cat([cm, cm.new_zeros((w - c, n))], dim=0)
    return tuple(cm[a:b].t().contiguous() for a, b in spans)


def pack_channels_split_blocked_ref(cm3: torch.Tensor, spans):
    """Plain-torch version of ``pack_channels_split_blocked``."""
    return pack_channels_split_ref(_flat(cm3, spans), spans)


def pack_channels_ref(channels, width: int | None = None) -> torch.Tensor:
    """Plain-torch version of ``pack_channels``."""
    cm = _stack(channels)
    return pack_channels_split_ref(cm, [(0, width or -(-cm.shape[0] // 8)
                                         * 8)])[0]


def _rows(cm: torch.Tensor):
    """(cm [C, N] as the kernel reads it, its row stride): rows of unit
    stride, each at least N apart (the first N columns of a wider
    channel-major block are read in place), else a contiguous copy."""
    c, n = cm.shape
    if (n > 1 and cm.stride(1) != 1) or (c > 1 and cm.stride(0) < n):
        cm = cm.contiguous()
    return cm, cm.stride(0) if c > 1 else n


def _launch_spans(cm: torch.Tensor, spans, what: str):
    """One kernel launch per span over the [C, N] input (its rows one
    stride apart, ``_rows``)."""
    cm, ld = _rows(cm)
    _build.require_device(cm, what=what)
    if cm.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32")
    c, n = cm.shape
    stream = _build.stream_ptr(cm.device)
    outs = []
    for a, b in spans:
        out = torch.empty((n, b - a), dtype=torch.float32, device=cm.device)
        err = _build.lib().pack_span_launch(cm.data_ptr(), out.data_ptr(),
                                            c, n, ld, a, b, stream)
        _build.check(err, "pack_span_launch")
        outs.append(out)
    return tuple(outs)


def pack_channels_split_blocked(cm3: torch.Tensor, spans):
    """cm3 f32 [C, R, 128] (R*128 = N channel-major) -> one contiguous
    row-major f32 [N, b - a] array per (a, b) span; channels past C read as
    zeros. CPU tensors run the plain version; CUDA tensors launch the
    kernel once per span."""
    if cm3.device.type == "cpu":
        return pack_channels_split_blocked_ref(cm3, spans)
    global launches
    outs = _launch_spans(_flat(cm3, spans), spans,
                         "pack_channels_split_blocked")
    launches += len(spans)
    return outs


def pack_channels(channels, width: int | None = None) -> torch.Tensor:
    """[C] f32 channel arrays (each [N]), or one pre-stacked [C, N] array
    (on a CUDA device read in place where its rows have unit stride, e.g.
    the first N columns of a wider block), -> row-major [N, W] with W =
    width or C rounded up to 8; extra columns zero. CPU tensors run the
    plain version; CUDA tensors launch the kernel once."""
    cm = _stack(channels)
    spans = [(0, width or -(-cm.shape[0] // 8) * 8)]
    _check_spans(cm, spans, "pack_channels")
    if cm.device.type == "cpu":
        return pack_channels_split_ref(cm, spans)[0]
    global launches_channels
    (out,) = _launch_spans(cm, spans, "pack_channels")
    launches_channels += 1
    return out


def pack_channels_split(cm: torch.Tensor, spans):
    """Like pack_channels, but one CONTIGUOUS row-major f32 [N, b - a]
    array per (a, b) channel span of cm f32 [C, N] (spans may overlap;
    channels past C read as zeros). CPU tensors run the plain version;
    CUDA tensors launch the kernel once per span."""
    _check_spans(cm, spans, "pack_channels_split")
    if cm.device.type == "cpu":
        return pack_channels_split_ref(cm, spans)
    global launches_split
    outs = _launch_spans(cm, spans, "pack_channels_split")
    launches_split += len(spans)
    return outs
