"""Hand state from the JAX package to the port as numpy arrays.

The port never imports jax; a caller that holds both packages turns the
JAX ``SceneData`` / ``Camera`` leaves into numpy arrays (a dict per
dataclass, ``camera`` nested as its own dict) and gets the port's tensors:

    d = {f.name: np.asarray(getattr(scene, f.name))
         for f in dataclasses.fields(scene) if f.name != "camera"}
    d["camera"] = {f.name: np.asarray(getattr(scene.camera, f.name))
                   for f in dataclasses.fields(scene.camera)}
    scene_t = scene_from_numpy(d, device)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.scene.builder import SceneData


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), device=device)


def camera_from_numpy(d: dict, device="cpu") -> Camera:
    """Camera leaves (pos, yaw, pitch, fov_y, speed, sensitivity) -> Camera."""
    return Camera(**{f.name: _t(d[f.name], device).to(torch.float32)
                     for f in dataclasses.fields(Camera)})


def scene_from_numpy(d: dict, device="cpu") -> SceneData:
    """Every SceneData leaf as a numpy array (``camera`` as a dict of its
    leaves) -> the port's SceneData on ``device``."""
    kw = {}
    for f in dataclasses.fields(SceneData):
        if f.name == "camera":
            kw[f.name] = camera_from_numpy(d["camera"])
        else:
            kw[f.name] = _t(d[f.name], device)
    return SceneData(**kw)
