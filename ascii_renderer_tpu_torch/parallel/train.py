"""Sharded inverse-rendering train step (torch port of
``ascii_renderer_tpu/parallel/train.py``; BASELINE config 5).

Optimises soft-raster scene parameters (vertex positions and colours) to
match target images; gradients flow through the luminance -> glyph
assignment (``diff/soft_raster``). The step runs on every rank of a 2-D
mesh (``parallel.mesh.make_mesh((dp, sp), ("dp", "sp"))``):

  axis "dp" — data parallel over the target views (each rank owns a
              contiguous shard of the views);
  axis "sp" — spatial parallel over row bands of the image.

The parameters are replicated. Each rank renders its views' full images,
takes its row band's loss (a band mean over nsp, so the sum over the mesh
is the full images' mean per view, summed over the views), and the
gradients and loss are all-reduced (SUM) over both axes; every rank then
takes the same Adam step, so the parameters stay replicated. The Adam is
``torch.optim.Adam`` (the reference's ``optax.adam``); its state rides in
the ``TrainState``, so a step is a function of its state.

Ranges for ``torch.profiler``: ``train.render`` (the soft render and the
loss: on the card X5's forward and X5b, one launch each after the
projection's few), ``train.backward`` (X5's backward and the
projection's), ``train.allreduce`` and ``train.adam``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.diff.soft_raster import (camera_mvps,
                                                       soft_band_losses,
                                                       soft_render_mvp)
from ascii_renderer_tpu_torch.parallel.mesh import mesh_axis


def adam(lr: float = 1e-2, betas=(0.9, 0.999), eps: float = 1e-8):
    """The optimizer factory of ``make_train_step``: ``params ->
    torch.optim.Adam`` (``optax.adam(lr)``'s defaults)."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=betas, eps=eps)


class TrainState(NamedTuple):
    verts: torch.Tensor   # f32 [N, 3]
    colors: torch.Tensor  # f32 [N, 3]
    # Adam's state: {"step": f32 0-d (host), "exp_avg": (verts', colors'),
    # "exp_avg_sq": (verts', colors')}
    opt_state: dict


def init_train_state(verts, colors, *, device="cuda") -> TrainState:
    """The parameters (numpy or tensors) on ``device`` and a fresh Adam
    state (zero moments, step 0)."""
    v = torch.as_tensor(verts, dtype=torch.float32, device=device).clone()
    c = torch.as_tensor(colors, dtype=torch.float32, device=device).clone()
    return TrainState(v, c, {
        "step": torch.tensor(0.0),
        "exp_avg": (torch.zeros_like(v), torch.zeros_like(c)),
        "exp_avg_sq": (torch.zeros_like(v), torch.zeros_like(c))})


def _optimizer_step(optimizer: Callable, state: TrainState, grads):
    """One step of ``optimizer(params)`` (a torch.optim.Adam) from the
    state's parameters and moments; returns the new TrainState. The old
    state's tensors are left as they were."""
    params = [state.verts.detach().clone(), state.colors.detach().clone()]
    opt = optimizer(params)
    st = state.opt_state
    for k, (p, g) in enumerate(zip(params, grads)):
        p.grad = g
        opt.state[p] = {"step": st["step"].clone(),
                        "exp_avg": st["exp_avg"][k].clone(),
                        "exp_avg_sq": st["exp_avg_sq"][k].clone()}
    opt.step()
    new = [opt.state[p] for p in params]
    return TrainState(params[0], params[1], {
        "step": new[0]["step"],
        "exp_avg": tuple(s["exp_avg"] for s in new),
        "exp_avg_sq": tuple(s["exp_avg_sq"] for s in new)})


def make_targets_sharding(mesh) -> Callable:
    """``pick(targets [B, rows, cols, 3]) -> this rank's block``: its view
    shard on "dp" and its row band on "sp" (the reference's
    NamedSharding(mesh, P("dp", "sp")))."""
    ndp, i_dp, _g = mesh_axis(mesh, "dp")
    nsp, i_sp, _g = mesh_axis(mesh, "sp")

    def pick(targets):
        B, rows = targets.shape[:2]
        per, band = B // ndp, rows // nsp
        return targets[i_dp * per:(i_dp + 1) * per,
                       i_sp * band:(i_sp + 1) * band]

    return pick


def _step_fn(mesh, faces, rows: int, cols: int, optimizer, pixel_aspect,
             sigma, gamma, ramp_len):
    """``(step(state, mvps_local, targets_local), local_views)``: one
    step on this rank's block, the views' MVPs computed once by the
    caller."""
    optimizer = optimizer or adam(1e-2)
    ndp, i_dp, _g = mesh_axis(mesh, "dp")
    nsp, i_sp, _g = mesh_axis(mesh, "sp")
    assert rows % nsp == 0
    band = rows // nsp
    groups = [mesh.get_group(name) for name in mesh.mesh_dim_names]

    def step(state: TrainState, mvps, targets):
        verts = state.verts.detach().requires_grad_()
        colors = state.colors.detach().requires_grad_()
        with record_function("train.render"):
            img = soft_render_mvp(verts, colors, faces, mvps, rows, cols,
                                  sigma=sigma, gamma=gamma)
            losses = soft_band_losses(img, targets, i_sp * band, ramp_len)
            # a band mean each; the sum over "sp" of nsp band means / nsp
            # is the full image's mean whatever the mesh's shape
            loss = losses.sum() / nsp
        with record_function("train.backward"):
            gv, gc = torch.autograd.grad(loss, (verts, colors))
        with record_function("train.allreduce"):
            flat = torch.cat([gv.reshape(-1), gc.reshape(-1),
                              loss.detach().reshape(1)])
            for g in groups:  # SUM over "dp", then over "sp"
                dist.all_reduce(flat, group=g)
            n = gv.numel()
            grads = (flat[:n].view_as(gv), flat[n:2 * n].view_as(gc))
        with record_function("train.adam"):
            state = _optimizer_step(optimizer, state, grads)
        return state, flat[-1]

    return step, (ndp, i_dp)


def _local(mesh_views, cameras: Camera, targets, rows, cols, pixel_aspect,
           device):
    """This rank's views' MVPs f32 [per, 4, 4] and target block."""
    (ndp, i_dp), pick = mesh_views
    B = cameras.yaw.shape[0]
    assert B % ndp == 0, f"{B} views do not divide over dp = {ndp}"
    per = B // ndp
    mvps = camera_mvps(cameras[i_dp * per:(i_dp + 1) * per], rows, cols,
                       pixel_aspect)
    if not isinstance(targets, torch.Tensor):
        # a copy: the caller's numpy array may be read-only
        targets = torch.from_numpy(np.array(targets, np.float32))
    tgt = pick(targets.to(torch.float32)).to(device)
    return mvps.to(device), tgt


def make_train_step(mesh, faces, rows: int, cols: int, *, optimizer=None,
                    pixel_aspect: float = 1.0, sigma: float = 1e-2,
                    gamma: float = 1e-2, ramp_len: int = 10):
    """The sharded train step, called on every rank of ``mesh`` (axes
    "dp" and "sp"):

      step(state, cameras [B views], targets f32 [B, rows, cols, 3])
          -> (state', loss)

    B must divide over dp and rows over sp. ``optimizer``: a factory
    ``params -> torch.optim.Adam`` (default ``adam(1e-2)``). The loss is
    the sum over the views of each view's image loss, all-reduced; every
    rank returns the same state and loss."""
    one, dp = _step_fn(mesh, faces, rows, cols, optimizer, pixel_aspect,
                       sigma, gamma, ramp_len)
    mesh_views = (dp, make_targets_sharding(mesh))

    def step(state: TrainState, cameras: Camera, targets):
        mvps, tgt = _local(mesh_views, cameras, targets, rows, cols,
                           pixel_aspect, state.verts.device)
        return one(state, mvps, tgt)

    return step


def make_train_steps(mesh, faces, rows: int, cols: int, *, n_steps: int,
                     optimizer=None, pixel_aspect: float = 1.0,
                     sigma: float = 1e-2, gamma: float = 1e-2,
                     ramp_len: int = 10):
    """``steps(state, cameras, targets) -> (state', losses f32 [n_steps])``:
    n_steps of ``make_train_step``'s step on fixed cameras and targets (the
    reference's lax.scan), the same trajectory as n_steps calls of it."""
    one, dp = _step_fn(mesh, faces, rows, cols, optimizer, pixel_aspect,
                       sigma, gamma, ramp_len)
    mesh_views = (dp, make_targets_sharding(mesh))

    def steps(state: TrainState, cameras: Camera, targets):
        mvps, tgt = _local(mesh_views, cameras, targets, rows, cols,
                           pixel_aspect, state.verts.device)
        losses = []
        for _ in range(n_steps):
            state, loss = one(state, mvps, tgt)
            losses.append(loss)
        return state, torch.stack(losses)

    return steps
