"""``core/fp.fma32`` on CUDA tensors: the kernel of ``csrc/fp.cu`` (one
launch of ``__fmaf_rn`` over the broadcast operands) and its plain
version, ``core/fp.fma32_f64`` (the float64 emulation).

Stands for XLA code, not a Pallas kernel: the reference's compiler fuses
a product into the add it feeds, and the port writes each such fusion as
an ``fma32`` (about 90 call sites: the small and mid raster paths' clip
and shading, the frame clock, the progressive tracer, colour, the camera
and the plain versions of the other kernels). Both forms are correctly
rounded, so they agree bit for bit.

``core/fp.fma32`` is the wrapper: it takes CPU tensors to the plain
version and any other device to ``fma32_kernel``, which raises where it
cannot run (no ``nvcc``, a failed build, a tensor that is not on a CUDA
device).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ascii_renderer_tpu_torch.ops import _build

launches = 0  # kernel launches by fma32_kernel
LAUNCHES_PER_CALL = {"fma32_kernel": 1}  # kernels a call launches
MAX_DIMS = 6  # the plain walks of ops/raster_group and raster_subtile use 5


def broadcast_shape(*shapes) -> tuple:
    """The broadcast of ``shapes``, computed here: ``torch.broadcast_shapes``
    imports sympy on its first call, seconds of a process's first frame."""
    nd = max((len(s) for s in shapes), default=0)
    out = [1] * nd
    for s in shapes:
        for i, d in enumerate(s, nd - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def broadcast_geom(tensors, shape, dims: int = MAX_DIMS) -> list[int]:
    """``shape`` padded in front with 1s to ``dims`` dimensions, then the
    element strides of each tensor broadcast to it (0 along a broadcast
    dimension; all 0 for None, a scalar operand)."""
    pad = dims - len(shape)
    geom = [1] * pad + list(shape)
    for t in tensors:
        geom += [0] * dims if t is None else (
            [0] * pad + list(t.expand(shape).stride()))
    return geom


def pack_operands(a, b, c, device):
    """The kernel's view of the three operands: (tensors, scalars, mask,
    shape). Operand k is the float32 tensor ``tensors[k]`` on ``device``
    (taken as ``torch.as_tensor`` takes it), or, for a Python number or a
    0-d CPU tensor, None there and its float32 value in ``scalars[k]``,
    bit k of ``mask`` set. ``shape`` is the broadcast shape. Raises for an
    operand that requires a gradient (the kernel has no backward)."""
    tensors, scalars, mask = [None] * 3, [0.0] * 3, 0
    for k, x in enumerate((a, b, c)):
        if isinstance(x, torch.Tensor) and x.requires_grad:
            raise ValueError("fma32: an operand requires a gradient; the "
                             "kernel has no backward")
        if not isinstance(x, torch.Tensor) or (x.dim() == 0
                                               and x.device.type == "cpu"):
            val = x.to(torch.float32).item() if isinstance(
                x, torch.Tensor) else x
            scalars[k] = float(np.float32(val))
            mask |= 1 << k
        else:
            tensors[k] = torch.as_tensor(x, dtype=torch.float32,
                                         device=device)
    shape = broadcast_shape(*(t.shape for t in tensors if t is not None))
    return tensors, scalars, mask, shape


def fma32_kernel(a, b, c) -> torch.Tensor:
    """One launch of ``csrc/fp.cu``'s kernel on the device of the first
    tensor operand (``pack_operands``: Python floats and 0-d CPU tensors
    are kernel arguments, rounded to float32 first). Up to 6 dimensions
    after broadcasting."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    dev = ref.device
    if dev.type != "cuda":
        raise ValueError(f"fma32: expected CUDA tensors, got {dev}")
    global launches
    tensors, scalars, mask, shape = pack_operands(a, b, c, dev)
    if len(shape) > MAX_DIMS:
        raise ValueError(f"fma32: {len(shape)} dimensions after "
                         f"broadcasting, at most {MAX_DIMS}")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    n = out.numel()
    if n >= 2 ** 31:
        raise ValueError(f"fma32: {n} elements, at most 2^31 - 1")
    if n == 0:
        return out
    flat = all(t is None or (t.shape == shape and t.is_contiguous())
               for t in tensors)
    geom = broadcast_geom(tensors, shape)
    g = (ctypes.c_longlong * len(geom))(*geom)
    err = _build.lib().fma32_launch(
        *(t.data_ptr() if t is not None else None for t in tensors),
        *scalars, mask, g, int(flat), out.data_ptr(), n,
        _build.stream_ptr(dev))
    launches += 1
    _build.check(err, "fma32_launch")
    return out
