"""``core/camera.camera_bases`` (the ray tracer's and the farm's camera
frames, taken on the host) against a copy of its earlier form, which
called libm on one 0-d tensor element at a time: bit for bit on seeded
poses, the farm's 1,024 orbit poses and the axis and edge poses. Both
take cos, sin and tan through Python's float64 libm and round once to
float32; only the iteration over the views changed. No JAX here: the
JAX side of the basis is ``tests/test_torch_camera_exact.py``."""

import math

import numpy as np
import pytest
import torch

from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras

torch.set_num_threads(2)


def _bases_per_element(yaw, pitch, fov_y):
    """camera_bases as it was: a 0-d tensor for each element."""
    def trig(fn, x):
        return torch.tensor([fn(float(v)) for v in x.reshape(-1)],
                            dtype=torch.float32)

    cp, sp = trig(math.cos, pitch), trig(math.sin, pitch)
    cy, sy = trig(math.cos, yaw), trig(math.sin, yaw)
    zero, one = torch.zeros_like(cp), torch.ones_like(cp)
    ww = torch.stack([cp * cy, sp, cp * sy])
    ww = ww / TC._norm3(ww)
    uu = TC._cross(ww, torch.stack([zero, one, zero]))
    nu = TC._norm3(uu)
    x_axis = torch.stack([one, zero, zero])
    uu = torch.where(nu < 1e-3, x_axis, uu / torch.clamp(nu, min=1e-20))
    vv = TC._cross(uu, ww)
    vv = vv / TC._norm3(vv)
    half = trig(math.tan, 0.5 * fov_y.reshape(-1))
    focal = one / torch.clamp(half, min=1e-6)
    return uu.t(), vv.t(), ww.t(), focal


def _poses(name):
    """(yaw, pitch, fov_y) f32 [V] of a named pose set."""
    if name == "seeded 2,000":
        rng = np.random.default_rng(20)
        lim = math.pi * 0.5 - 0.1
        yaw = rng.uniform(-math.pi, math.pi, 2000)
        pitch = rng.uniform(-lim, lim, 2000)
        fov = np.radians(rng.uniform(20.0, 140.0, 2000))
    elif name == "farm 1,024 orbit":
        cams = orbit_cameras(1024, center=(0, 1.0, 1.0))
        return cams.yaw, cams.pitch, cams.fov_y
    else:  # the axes, the pitch limits, a straight-up look, fov extremes
        yaw = np.repeat([0.0, math.pi / 2, -math.pi / 2, math.pi, -math.pi,
                         1e-7, -0.0], 5)
        pitch = np.tile([0.0, 1.4707963, -1.4707963, math.pi / 2, -0.0], 7)
        fov = np.tile([math.radians(60.0), 1e-3, 3.0, math.pi / 2, 0.5], 7)
    return tuple(torch.from_numpy(np.asarray(x, np.float32))
                 for x in (yaw, pitch, fov))


@pytest.mark.parametrize("name", ["seeded 2,000", "farm 1,024 orbit",
                                  "axis and edge poses"])
def test_camera_bases_equal_the_per_element_form(name):
    """uu, vv, ww and focal of every view equal the per-element form's bit
    for bit (compared as int32 bit patterns)."""
    yaw, pitch, fov = _poses(name)
    got = TC.camera_bases(yaw, pitch, fov)
    want = _bases_per_element(yaw, pitch, fov)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_camera_basis_of_one_pose_is_its_batch_row():
    """camera_basis of a 0-d pose is row 0 of camera_bases of that pose,
    and row v of a batch is the basis of view v alone."""
    yaw, pitch, fov = _poses("seeded 2,000")
    batch = TC.camera_bases(yaw[:16], pitch[:16], fov[:16])
    for v in (0, 7, 15):
        one = TC.camera_basis(yaw[v], pitch[v], fov[v])
        for b, o in zip(batch, one):
            assert torch.equal(b[v].view(torch.int32), o.view(torch.int32))
