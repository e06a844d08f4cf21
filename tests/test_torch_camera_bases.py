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


def _trig_poses(name):
    """(pos [V, 3], yaw, pitch, fov_y [V]) f32 of a pose set for the
    trig table: the farm's first n orbit views, or the edge poses (the
    axis poses with pitch +-pi/2, the nu < 1e-3 case; a NaN pitch, a NaN
    yaw; fov_y 0)."""
    if name.startswith("farm "):
        n = int(name.split()[1].replace(",", ""))
        cams = orbit_cameras(1024, center=(0, 1.0, 1.0))
        return (cams.pos[:n], cams.yaw[:n], cams.pitch[:n], cams.fov_y[:n])
    yaw, pitch, fov = (x.clone() for x in _poses("axis and edge poses"))
    pitch[::6] = math.pi / 2
    pitch[3::6] = -math.pi / 2
    pitch[4], yaw[9] = math.nan, math.nan
    fov[::5] = 0.0
    pos = torch.arange(3 * yaw.shape[0], dtype=torch.float32).reshape(-1, 3)
    return pos, yaw, pitch, fov


@pytest.mark.parametrize("name", ["farm 1", "farm 8", "farm 9", "farm 16",
                                  "farm 1,024", "edge poses"])
def test_trig_table_and_chain_equal_bases_arrays(name):
    """core/camera.view_trig (libm once a distinct argument) and then
    bases_from_trig (the plain version of the bases K3's trig form forms
    on the card) give bases_arrays' and the per-element form's uu, vv, ww
    and focal bit for bit; the table's origins are the views' own."""
    pos, yaw, pitch, fov = _trig_poses(name)
    table = TC.view_trig(pos, yaw, pitch, fov)
    assert table.dtype == np.float32 and table.shape == (yaw.shape[0], 8)
    assert np.array_equal(table[:, :3], pos.numpy())
    got = TC.bases_from_trig(*table[:, 3:].T)
    want = TC.bases_arrays(*(x.tolist() for x in (yaw, pitch, fov)))
    old = _bases_per_element(yaw, pitch, fov)
    for g, w, o in zip((got[0].T, got[1].T, got[2].T, got[3]), want, old):
        g = torch.from_numpy(np.ascontiguousarray(g))
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(g.view(torch.int32), o.view(torch.int32))
    if name == "edge poses":  # the axis case and the NaN poses came through
        assert np.isnan(got[0][:, 4]).all() and np.isnan(got[0][:, 9]).all()
        assert (got[0][:, ::6] == np.float32([[1], [0], [0]])).all()


def test_trig_table_calls_libm_once_per_distinct_argument(monkeypatch):
    """The farm's 1,024 orbit views share one pitch and one fov_y: the
    table takes cos and sin of each distinct pitch and yaw and tan of each
    distinct half angle, 2 + 2,048 + 1 calls, not 5 x 1,024; -0.0 and 0.0
    are distinct arguments (their sines differ)."""
    calls = []

    class Counting:
        def __getattr__(self, name):
            fn = getattr(math, name)
            return lambda x: calls.append(name) or fn(x)

    monkeypatch.setattr(TC, "math", Counting())
    pos, yaw, pitch, fov = _trig_poses("farm 1,024")
    assert torch.unique(pitch).numel() == torch.unique(fov).numel() == 1
    table = TC.view_trig(pos, yaw, pitch, fov)
    assert sorted(set(calls)) == ["cos", "sin", "tan"]
    assert (calls.count("cos"), calls.count("sin"), calls.count("tan")) == (
        1 + 1024, 1 + 1024, 1)
    calls.clear()
    zeros = torch.tensor([0.0, -0.0, 0.0, -0.0])
    t = TC.view_trig(torch.zeros(4, 3), zeros, zeros, torch.ones(4))
    assert calls.count("sin") == 4 and calls.count("tan") == 1
    assert np.array_equal(np.signbit(t[:, 4]), [False, True, False, True])
    assert np.array_equal(table, TC.view_trig(pos.numpy(), yaw.numpy(),
                                              pitch.numpy(), fov.numpy()))
