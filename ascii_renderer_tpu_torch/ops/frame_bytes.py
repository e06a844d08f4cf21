"""A frame's bytes from its float colours: the kernel of
``csrc/frame_bytes.cu`` (X12a, one launch) and its plain version, the
torch chain of ``core/frame.Frame.from_float`` and ``with_overrides``.

Stands for XLA code, not a Pallas kernel: the reference's frame program
converts the renderer's float image to UNORM bytes and burns the UI char
plane into the alpha byte inside its one compiled frame. ``Frame.from_float``
is the wrapper: CPU tensors take the plain version, CUDA tensors the kernel,
which raises where it cannot run. The kernel rounds the product and the sum
of ``floor(clamp(v, 0, 1) * 255 + 0.5)`` each on its own, as the plain
version does, so both agree bit for bit.

Its UI form (X16) takes the frame step's UI layer by value
(``sim/ui.UiParams``: the pi digits, the FPS readout, the live ripples)
instead of planes, and draws it in the same launch: the frame step's
``frame.compose`` is one launch with no copy to the card (the pi digits'
device copy is made once a device). Its plain version draws the planes on
the host (``UiParams.planes``, the chain of ``sim/ui.ui_char_plane``) and
burns them in as ``with_overrides``.
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core import quantize
from ascii_renderer_tpu_torch.ops import _build

launches = 0  # kernel launches by frame_bytes
launches_ui = 0  # of them, the UI form's
LAUNCHES_PER_CALL = {"frame_bytes": 1}  # kernels a call launches
_pi_codes = {}  # (pi digits, device) -> their codes, u8 on the device


def frame_bytes_ref(rgb: torch.Tensor, a: torch.Tensor | None = None,
                    ui_chars: torch.Tensor | None = None,
                    ui_mask: torch.Tensor | None = None, ui=None):
    """(rgb u8 [..., 3], a u8 [...]): the plain chain, on ``rgb``'s
    device; ``ui`` (a ``sim/ui.UiParams``) its planes drawn on the host
    first."""
    if ui is not None:
        ui_chars, ui_mask = ui.planes(rgb.device)
    rgb_u8 = quantize.float_rgb_to_u8(rgb)
    if a is None:
        a_u8 = torch.ones(rgb.shape[:-1], dtype=torch.uint8,
                          device=rgb.device)
    else:
        a_u8 = a.to(torch.uint8)
    if ui_mask is not None:  # Frame.with_overrides
        rgb_u8 = torch.where(ui_mask[..., None], torch.zeros_like(rgb_u8),
                             rgb_u8)
        a_u8 = torch.where(ui_mask, ui_chars.to(torch.uint8), a_u8)
    return rgb_u8, a_u8


def _row_stride(rgb: torch.Tensor):
    """The floats between rows of rgb [..., W, 3] whose cells are
    contiguous and whose rows lie one stride apart (the kernel reads it as
    it is), or None where its strides do not allow that. Read from its
    sizes and strides alone: no tensor operation."""
    w = rgb.shape[-2]
    if rgb.stride(-1) != 1 or rgb.stride(-2) != 3:
        return None
    lead = [(n, st) for n, st in zip(rgb.shape[:-2], rgb.stride()[:-2])
            if n > 1]
    for (_n, outer), (n, inner) in zip(lead, lead[1:]):
        if outer != inner * n:  # the leading dims are not one row index
            return None
    step = lead[-1][1] if lead else 3 * w
    return step if step >= 3 * w else None


def _plane(t: torch.Tensor | None, shape, what: str):
    """A uint8 or bool plane of ``shape``, contiguous (the kernel reads its
    bytes), or None."""
    if t is None:
        return None
    if t.dtype not in (torch.uint8, torch.bool) or tuple(t.shape) != shape:
        raise ValueError(f"frame_bytes: {what} must be uint8 or bool "
                         f"{list(shape)}, got {t.dtype} {list(t.shape)}")
    return t if t.is_contiguous() else t.contiguous()


def _pi_device(pi: str, device) -> torch.Tensor:
    """The pi digits' codes on ``device``, copied once."""
    key = (pi, device)
    t = _pi_codes.get(key)
    if t is None:
        t = _pi_codes[key] = torch.tensor(list(pi.encode()),
                                          dtype=torch.uint8).to(device)
    return t


def frame_bytes(rgb: torch.Tensor, a: torch.Tensor | None = None,
                ui_chars: torch.Tensor | None = None,
                ui_mask: torch.Tensor | None = None, ui=None):
    """Twin of ``frame_bytes_ref``: rgb float32 [..., 3] (a frame [H, W, 3]
    or a batch of views), ``a`` an optional uint8 alpha plane [...] (1
    where None), ``ui_chars`` / ``ui_mask`` an optional UI plane of the
    same shape (u8 chars, bool mask: rgb 0 and alpha the char where the
    mask is set), or ``ui`` the UI layer by value (``sim/ui.UiParams``,
    one frame [rows, cols, 3]). CPU tensors run the plain version; CUDA
    tensors launch the kernel once (an empty frame launches nothing)."""
    if (ui_chars is None) != (ui_mask is None):
        raise ValueError("frame_bytes: ui_chars and ui_mask go together")
    if ui is not None and ui_chars is not None:
        raise ValueError("frame_bytes: a UI plane or UI values, not both")
    if ui is not None and tuple(rgb.shape) != (ui.rows, ui.cols, 3):
        raise ValueError(f"frame_bytes: UI values of a {ui.rows} x "
                         f"{ui.cols} grid, rgb {list(rgb.shape)}")
    if rgb.device.type == "cpu":
        return frame_bytes_ref(rgb, a, ui_chars, ui_mask, ui)
    global launches, launches_ui
    if rgb.dtype != torch.float32 or rgb.dim() < 2 or rgb.shape[-1] != 3:
        raise ValueError(f"frame_bytes: rgb must be float32 [..., W, 3], "
                         f"got {rgb.dtype} {list(rgb.shape)}")
    shape = tuple(rgb.shape[:-1])
    row_stride = _row_stride(rgb)
    if row_stride is None:  # rows the kernel cannot address: one copy
        rgb = rgb.contiguous()
        row_stride = 3 * rgb.shape[-2]
    planes = [_plane(t, shape, w) for t, w in ((a, "a"),
                                               (ui_chars, "ui_chars"),
                                               (ui_mask, "ui_mask"))]
    given = [p for p in planes if p is not None]
    if rgb.device.type != "cuda" or any(p.device != rgb.device
                                        for p in given):
        raise ValueError(f"frame_bytes: expected CUDA tensors on one device, "
                         f"got {rgb.device}")
    vals = pi = None
    if ui is not None:
        v = ui.values()
        vals = (ctypes.c_int * len(v))(*v)
        pi = _pi_device(ui.pi, rgb.device).data_ptr()
    rgb_u8 = torch.empty(rgb.shape, dtype=torch.uint8, device=rgb.device)
    a_u8 = torch.empty(shape, dtype=torch.uint8, device=rgb.device)
    n = a_u8.numel()
    if n == 0:
        return rgb_u8, a_u8
    err = _build.lib().frame_bytes_launch(
        rgb.data_ptr(), *(0 if p is None else p.data_ptr() for p in planes),
        rgb_u8.data_ptr(), a_u8.data_ptr(), n, rgb.shape[-2], row_stride,
        vals, pi, _build.stream_ptr(rgb.device))
    launches += 1
    launches_ui += ui is not None
    _build.check(err, "frame_bytes_launch")
    return rgb_u8, a_u8
