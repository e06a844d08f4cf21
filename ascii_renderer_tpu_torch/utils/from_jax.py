"""Hand state from the JAX package to the port as numpy arrays.

The port never imports jax; a caller that holds both packages turns the
JAX ``SceneData`` / ``Camera`` leaves into numpy arrays (a dict per
dataclass, ``camera`` nested as its own dict) and gets the port's tensors:

    d = {f.name: np.asarray(getattr(scene, f.name))
         for f in dataclasses.fields(scene) if f.name != "camera"}
    d["camera"] = {f.name: np.asarray(getattr(scene.camera, f.name))
                   for f in dataclasses.fields(scene.camera)}
    scene_t = scene_from_numpy(d, device)

``device`` is required: the caller says where the scene lives. The camera
stays a host object (its basis and MVP are computed on the host).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.scene.builder import SceneData


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), device=device)


def camera_from_numpy(d: dict, device) -> Camera:
    """Camera leaves (pos, yaw, pitch, fov_y, speed, sensitivity) -> Camera."""
    return Camera(**{f.name: _t(d[f.name], device).to(torch.float32)
                     for f in dataclasses.fields(Camera)})


def scene_from_numpy(d: dict, device) -> SceneData:
    """Every SceneData leaf as a numpy array (``camera`` as a dict of its
    leaves) -> the port's SceneData on ``device`` (spheres, triangles,
    quads, planes, materials, lights and the atlas alike); the camera
    stays on the host."""
    kw = {}
    for f in dataclasses.fields(SceneData):
        if f.name == "camera":
            kw[f.name] = camera_from_numpy(d["camera"], "cpu")
        else:
            kw[f.name] = _t(d[f.name], device)
    return SceneData(**kw)


def accum_state_from_numpy(d: dict, device):
    """A JAX ``AccumState``'s leaves as numpy arrays (count, mean, m2,
    cam_sig, mean_y, m2_y, alpha) -> the port's ``sim.accum.AccumState``
    on ``device``; cam_sig stays on the host, as the port keeps it."""
    from ascii_renderer_tpu_torch.sim.accum import AccumState

    kw = {f.name: _t(d[f.name], "cpu" if f.name == "cam_sig" else device)
          for f in dataclasses.fields(AccumState)}
    return AccumState(**kw)


def train_state_from_numpy(verts, colors, mu, nu, count, device):
    """A JAX train state carried to the port: the parameters (numpy
    verts, colors [N, 3]) and optax adam's state (``mu`` and ``nu``, each
    a dict with "verts" and "colors", and ``count``, the steps taken) ->
    ``parallel.train.TrainState`` on ``device``, whose torch.optim.Adam
    state (exp_avg = mu, exp_avg_sq = nu, step = count) continues the
    reference's trajectory."""
    from ascii_renderer_tpu_torch.parallel.train import TrainState

    def t(x):
        return _t(np.asarray(x, np.float32), device)

    return TrainState(t(verts), t(colors), {
        "step": torch.tensor(float(np.asarray(count))),
        "exp_avg": (t(mu["verts"]), t(mu["colors"])),
        "exp_avg_sq": (t(nu["verts"]), t(nu["colors"]))})
