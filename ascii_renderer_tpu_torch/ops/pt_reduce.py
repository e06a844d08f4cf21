"""The path tracer's batch fold and frame resolve: the kernel of
``csrc/pt_reduce.cu`` (X14, one launch a batch) and its plain version.

Stands for XLA code, not a Pallas kernel: the reference's ``batch_step``
(``ascii_renderer_tpu/backends/pathtrace.py:611-641``) and the frame's
end (``:657-678``) around the megakernel. A batch's fold adds its valid
samples' radiance into the frame's running totals and keeps the first
overriding sample where the frame has none yet; the last batch's fold
also resolves the frame: the probe's overrides take precedence, the
overridden pixels take their clamped override colour and alpha, the
others their clamped mean and alpha 255, written in pixel order.

The order of the sum is part of the function: a batch's samples are
added one at a time, s = 0 first, into an accumulator that starts at
zero, and the accumulator is then added to the running total once. The
plain version spells that order out (the reference's ``jnp.sum`` leaves
it to the compiler, so the port's totals are held to it within a
tolerance), so the kernel equals it bit for bit on the card, and a
pixel's total does not depend on its slot in the stream or on the
frame's shape: bands and the compacted order stay bit-identical to the
full frame.

CPU tensors run the plain version; CUDA tensors launch the kernel, which
raises where it cannot run.
"""

from __future__ import annotations

import numpy as np
import torch

from ascii_renderer_tpu_torch.ops import _build

launches = 0  # kernel launches by fold
LAUNCHES_PER_CALL = {"fold": 1}  # kernels a call launches
# The kernel's two forms: "tile" (a block folds a tile of 32 slots, their
# samples staged in shared memory) below TILE_BELOW slots, "slot" (a
# thread folds one slot) from there on. Timed on an NVIDIA H100 80GB HBM3
# at 700 W, the tile form was 2.2x faster at 3,456 slots, even at 32,400
# and 1.7x slower at 129,600
TILE_BELOW = 32768


def form_of(pc: int) -> str:
    """The kernel's own form for a launch over pc stream slots."""
    return "tile" if pc < TILE_BELOW else "slot"


def new_state(pc: int, device):
    """The frame's running state for pc stream slots: (f32 [6, pc]: the
    totals r, g, b and the override colour r, g, b; int32 [pc]: the
    override), unset: the frame's first fold (``first=True``) does not
    read it."""
    return (torch.empty((6, pc), dtype=torch.float32, device=device),
            torch.empty(pc, dtype=torch.int32, device=device))


def inv_spp_of(spp: int) -> float:
    """The float32 1 / spp the resolve scales the totals by."""
    return float(np.float32(1.0) / np.float32(spp))


def _clip(pc: int, n_valid: int, *planes):
    n = n_valid * pc
    return [p.reshape(-1)[:n].reshape(n_valid, pc) for p in planes]


def fold_ref(state, cr, cg, cb, ovf, n_valid: int, *, first: bool,
             probe=None, spp: int | None = None, slot=None):
    """Plain version of ``fold``: the same arguments and result, the sum
    in the order of the module's docstring."""
    tf, tov = state
    pc = tov.shape[0]
    cs = _clip(pc, n_valid, cr, cg, cb)
    (ov,) = _clip(pc, n_valid, ovf)
    ov = torch.round(ov).to(torch.int32)
    acc = [torch.zeros(pc, dtype=torch.float32, device=tov.device)
           for _ in range(3)]
    for s in range(n_valid):
        acc = [a + c[s] for a, c in zip(acc, cs)]
    # the batch's first override: later samples are written first, so the
    # smallest s is the one that stays
    fo = torch.zeros(pc, dtype=torch.int32, device=tov.device)
    fc = [torch.zeros_like(a) for a in acc]
    for s in reversed(range(n_valid)):
        hit = ov[s] > 0
        fo = torch.where(hit, ov[s], fo)
        fc = [torch.where(hit, c[s], f) for c, f in zip(cs, fc)]
    if first:
        t_prev = torch.zeros((6, pc), dtype=torch.float32, device=tov.device)
        ov_prev = torch.zeros_like(tov)
    else:
        t_prev, ov_prev = tf, tov
    tot = [t_prev[k] + acc[k] for k in range(3)]
    new = (fo > 0) & (ov_prev == 0)
    override = torch.where(new, fo, ov_prev)
    oc = [torch.where(new, fc[k], t_prev[3 + k]) for k in range(3)]
    if probe is None:
        tf.copy_(torch.stack(tot + oc))
        tov.copy_(override)
        return None
    lor0, log0, lob0, ov0f = (x.reshape(-1)[:pc] for x in probe)
    ov0 = torch.round(ov0f).to(torch.int32)
    has0 = ov0 > 0  # the probe's overrides take precedence
    override = torch.where(has0, ov0, override)
    oc = [torch.where(has0, l0, o) for l0, o in zip((lor0, log0, lob0), oc)]
    has_ov = override > 0
    inv_spp = inv_spp_of(spp)
    rgb = torch.stack([torch.where(has_ov, torch.clamp(o, 0.0, 1.0),
                                   torch.clamp(t * inv_spp, 0.0, 1.0))
                       for o, t in zip(oc, tot)], dim=-1)
    a = torch.where(has_ov, override, 255).to(torch.uint8)
    if slot is not None:  # back to pixel order: slot p holds pixel slot[p]
        idx = slot.long()
        rgb = torch.empty_like(rgb).index_copy_(0, idx, rgb)
        a = torch.empty_like(a).index_copy_(0, idx, a)
    return rgb, a


def fold(state, cr, cg, cb, ovf, n_valid: int, *, first: bool, probe=None,
         spp: int | None = None, slot=None):
    """Fold one sample batch into the frame's running ``state``
    (``new_state``). cr, cg, cb, ovf: the megakernel's outputs for the
    batch's rays s * pc + p, f32 (flat or blocked, at least n_valid * pc);
    the batch's first ``n_valid`` samples are folded (those below spp).
    ``first``: the frame's first batch (the state is taken as zero).

    With ``probe`` = the probe's (lor0, log0, lob0, ov0f) (f32, pc or
    more each) the fold is the frame's last and resolves it: returns (rgb
    f32 [pc, 3] in [0, 1], alpha u8 [pc]) in pixel order (``slot``: int32
    [pc], the pixel of each stream slot, for a compacted stream), and
    leaves the state as it was. ``spp``: the frame's samples a pixel.
    Without it, updates the state in place and returns None. CPU tensors
    run the plain version; CUDA tensors launch the kernel once, in the
    form ``form_of(pc)``."""
    tf, tov = state
    pc = tov.shape[0]
    if tf.shape != (6, pc) or tf.dtype != torch.float32 \
            or tov.dtype != torch.int32:
        raise ValueError("fold: state must be (f32 [6, pc], int32 [pc])")
    if n_valid < 1:
        raise ValueError("fold: a batch folds one sample at least")
    if probe is not None and (spp is None or spp < 1):
        raise ValueError("fold: the resolve needs the frame's spp")
    planes = [t.reshape(-1) for t in (cr, cg, cb, ovf)]
    if any(t.dtype != torch.float32 or t.numel() < n_valid * pc
           for t in planes):
        raise ValueError(f"fold: cr, cg, cb, ovf must be float32 with "
                         f"{n_valid} x {pc} rays at least")
    if slot is not None and (slot.dtype != torch.int32
                             or slot.numel() != pc):
        raise ValueError(f"fold: slot must be int32 [{pc}]")
    if tov.device.type == "cpu":
        return fold_ref(state, cr, cg, cb, ovf, n_valid, first=first,
                        probe=probe, spp=spp, slot=slot)
    global launches
    tensors = [tf, tov, *planes]
    rgb = a = None
    if probe is not None:
        probe = [t.reshape(-1) for t in probe]
        if any(t.dtype != torch.float32 or t.numel() < pc for t in probe):
            raise ValueError(f"fold: the probe's outputs must be float32 "
                             f"[>= {pc}]")
        rgb = torch.empty((pc, 3), dtype=torch.float32, device=tov.device)
        a = torch.empty(pc, dtype=torch.uint8, device=tov.device)
        tensors += [*probe, rgb, a]
        if slot is not None:
            tensors.append(slot)
    _build.require_cuda(*tensors, what="fold")
    err = _build.lib().pt_reduce_launch(
        *(t.data_ptr() for t in planes), tf.data_ptr(), tov.data_ptr(), pc,
        n_valid, int(bool(first)), int(probe is not None),
        int(form_of(pc) == "tile"),
        *((t.data_ptr() for t in probe) if probe is not None
          else (None,) * 4),
        inv_spp_of(spp) if probe is not None else 0.0,
        slot.data_ptr() if slot is not None and probe is not None else None,
        rgb.data_ptr() if rgb is not None else None,
        a.data_ptr() if a is not None else None,
        _build.stream_ptr(tov.device))
    launches += 1
    _build.check(err, "pt_reduce_launch")
    return None if probe is None else (rgb, a)
