"""The camera basis and the path tracer's ray grids against the reference,
bit for bit, away from the axis poses (ROADMAP C5).

The reference's ``camera_basis`` goes through ``jnp.linalg.norm`` and
``jnp.cross``, jitted helpers whose products XLA fuses into the adds they
feed even when the basis is called eagerly; its ray grids add the
components one operation at a time and normalise through the same fused
norm. The port rounds as that eager call does (``core/camera._norm3``,
``_cross``, ``ray_dirs``) and takes cos, sin and tan through Python's
float64 libm, rounded once. XLA's float32 trig is not always that value:
the poses where it is not are counted, and the basis is held exact on
all the others. Inputs are seeded with numpy; JAX runs on its CPU
backend."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.ops.ray_grid import batch_ray_dirs

torch.set_num_threads(2)

N_POSES = 2000
# poses of the 2,000 below where XLA's float32 cos or sin of the yaw or
# the pitch is not the libm value rounded once (JAX 0.9.0 on the CPU)
TRIG_APART = 91
# the path tracer's poses: the poster view and the axis view
PT_POSES = ((-math.pi / 2, 0.0), (0.0, 0.0))
# rays of the 96 x 36 grid at PT_POSES where JAX's jitted
# primary_ray_grid differs from its eager call: under jit XLA also fuses
# px*uu + py*vv + focal*ww (JAX 0.9.0 on the CPU)
JIT_APART = (2655, 2638)
# whole degrees of field of view 20..140 where XLA's float32 tan of the
# half angle is not the libm value rounded once (JAX 0.9.0 on the CPU)
TAN_APART = 13


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _poses():
    rng = np.random.default_rng(11)
    lim = math.pi * 0.5 - 0.1
    yaw = rng.uniform(-math.pi, math.pi, N_POSES).astype(np.float32)
    pitch = rng.uniform(-lim, lim, N_POSES).astype(np.float32)
    return yaw, pitch


def _trig_apart(yaw, pitch) -> np.ndarray:
    """Where XLA's float32 cos / sin of yaw or pitch, called on the scalar
    as the eager basis calls it, is not the libm value rounded once."""
    apart = np.zeros(yaw.shape, bool)
    for i, (y, p) in enumerate(zip(yaw, pitch)):
        for x in (y, p):
            for j, m in ((jnp.cos, math.cos), (jnp.sin, math.sin)):
                apart[i] |= bool(_bits(j(jnp.float32(x)))
                                 != _bits(np.float32(m(float(x)))))
    return apart


def _port_basis(yaw, pitch, fov):
    return TC.camera_basis(torch.tensor(yaw), torch.tensor(pitch),
                           torch.tensor(fov))


def test_camera_basis_equals_jax_where_the_trig_agrees():
    """2,000 seeded (yaw, pitch) poses: uu, vv, ww and focal equal JAX's
    eager camera_basis bit for bit on every pose where XLA's trig is the
    libm value; the poses where it is not are counted."""
    yaw, pitch = _poses()
    fov = np.float32(80 * math.pi / 180)
    apart = _trig_apart(yaw, pitch)
    assert int(apart.sum()) == TRIG_APART
    differ = np.zeros(N_POSES, bool)
    for i in range(N_POSES):
        want = JC.camera_basis(jnp.float32(yaw[i]), jnp.float32(pitch[i]),
                               jnp.float32(fov))
        got = _port_basis(yaw[i], pitch[i], fov)
        differ[i] = any((_bits(g.numpy()) != _bits(w)).any()
                        for g, w in zip(got, want))
    assert not differ[~apart].any(), np.flatnonzero(differ & ~apart)
    assert differ[apart].any()  # the trig does move the basis there


def test_focal_equals_jax_where_the_tangent_agrees():
    """focal = 1 / tan(fov/2) for every whole degree 20..140: equal to
    JAX's eager basis where XLA's float32 tan of the half angle is the
    libm value; the degrees where it is not are counted (60 among them,
    not the default 80)."""
    degs = np.arange(20, 141)
    fov = (degs * np.float32(math.pi / 180)).astype(np.float32)
    zero = np.float32(0)
    apart, got, want = [], [], []
    for f in fov:
        half = f * np.float32(0.5)
        apart.append(bool(_bits(jnp.tan(jnp.float32(half)))
                          != _bits(np.float32(math.tan(float(half))))))
        want.append(_bits(JC.camera_basis(jnp.float32(0), jnp.float32(0),
                                          jnp.float32(f))[3])[0])
        got.append(_bits(_port_basis(zero, zero, f)[3].numpy())[0])
    apart, got, want = np.array(apart), np.array(got), np.array(want)
    np.testing.assert_array_equal(got[~apart], want[~apart])
    assert (got[apart] != want[apart]).all()
    assert apart[degs == 60].all() and not apart[degs == 80].any()
    assert int(apart.sum()) == TAN_APART


def _off_axis_poses(k):
    """The first k seeded poses whose trig XLA rounds as libm does."""
    yaw, pitch = _poses()
    keep = np.flatnonzero(~_trig_apart(yaw[:4 * k], pitch[:4 * k]))[:k]
    return [(float(yaw[i]), float(pitch[i])) for i in keep]


GRID_POSES = list(PT_POSES) + _off_axis_poses(4)


@pytest.mark.parametrize("rows,cols", [(36, 96), (20, 44)])
@pytest.mark.parametrize("pose", range(len(GRID_POSES)))
def test_ray_grids_equal_jax_eager(pose, rows, cols):
    """primary_ray_grid (ro, rd, px, py) and primary_ray_dirs, without
    and with a seeded jitter, equal JAX's eager functions bit for bit at
    the PT poses and at off-axis poses."""
    yaw, pitch = GRID_POSES[pose]
    jcam = JC.Camera.create(pos=(0.0, 2.5, 6.0), yaw=yaw, pitch=pitch)
    tcam = TC.Camera.create(pos=(0.0, 2.5, 6.0), yaw=yaw, pitch=pitch)
    want = JPT.primary_ray_grid(jcam, rows, cols, 0.5)
    got = TPT.primary_ray_grid(tcam, rows, cols, 0.5, device="cpu")
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    jit = np.random.default_rng(pose).normal(0, 0.02, (rows, cols, 2))
    jit = jit.astype(np.float32)
    for j in (None, jit):
        want = JC.primary_ray_dirs(jcam, rows, cols, 0.5,
                                   None if j is None else jnp.asarray(j))
        got = TC.primary_ray_dirs(tcam, rows, cols, 0.5,
                                  None if j is None else torch.from_numpy(j),
                                  device="cpu")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_batch_ray_dirs_equal_jax_eager():
    """A sample batch's jittered directions (batch_ray_dirs: the hash
    jitter of the kernel path) at an off-axis pose equal JAX's eager
    arithmetic on the same jitter bit for bit."""
    yaw, pitch = GRID_POSES[2]
    rows, cols, B = 36, 96, 2
    tcam = TC.Camera.create(pos=(0.0, 2.5, 6.0), yaw=yaw, pitch=pitch)
    basis, px, py, aspect, _rd0 = TPT._centre_rays(tcam, rows, cols, 0.5,
                                                   "cpu")
    fetched = torch.from_numpy(
        np.random.default_rng(5).random((rows, cols)) < 0.2)
    uid = (torch.arange(B, dtype=torch.int32)[:, None] * (rows * cols)
           + torch.arange(rows * cols, dtype=torch.int32)[None])
    s_idx = torch.arange(B)
    got = batch_ray_dirs(basis, px, py, aspect, fetched, uid, 77, s_idx)
    jcam = JC.Camera.create(pos=(0.0, 2.5, 6.0), yaw=yaw, pitch=pitch)
    uu, vv, ww, focal = JC.camera_basis(jcam.yaw, jcam.pitch, jcam.fov_y)
    _ro, _rd, jpx, jpy = JPT.primary_ray_grid(jcam, rows, cols, 0.5)
    juid = jnp.asarray(uid.numpy())
    jxu = JPT._hash_unit(juid, jnp.int32(77), 0x40000001)
    jyu = JPT._hash_unit(juid, jnp.int32(77), 0x40000002)
    r2 = jnp.stack([jxu, jyu], axis=-1).reshape(B, rows, cols, 2)
    rpof = 2.0 * (r2 - 0.5) / jnp.float32(rows)
    rpof = rpof.at[..., 0].multiply(jnp.float32(aspect))
    use = (jnp.arange(B) > 0)[:, None, None] & ~jnp.asarray(
        fetched.numpy())[None]
    jx = jnp.where(use, rpof[..., 0], 0.0)
    jy = jnp.where(use, rpof[..., 1], 0.0)
    rd = ((jpx[None] + jx)[..., None] * uu + (jpy[None] + jy)[..., None] * vv
          + focal * ww)
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(rd))


@pytest.mark.parametrize("pose", range(len(PT_POSES)))
def test_jitted_ray_grid_rounds_apart_from_eager(pose):
    """Records how far JAX's jitted ray grid is from the eager one the
    port targets: the count of the 3,456 rays that differ, and that the
    port's grid is the eager one there."""
    yaw, pitch = PT_POSES[pose]
    jcam = JC.Camera.create(pos=(0.0, 2.5, 6.0), yaw=yaw, pitch=pitch)
    tcam = TC.Camera.create(pos=(0.0, 2.5, 6.0), yaw=yaw, pitch=pitch)
    eager = _bits(JPT.primary_ray_grid(jcam, 36, 96, 0.5)[1])
    jitted = _bits(jax.jit(JPT.primary_ray_grid, static_argnums=(1, 2, 3))(
        jcam, 36, 96, 0.5)[1])
    port = _bits(TPT.primary_ray_grid(tcam, 36, 96, 0.5,
                                      device="cpu")[1].numpy())
    assert int((jitted != eager).any(-1).sum()) == JIT_APART[pose]
    np.testing.assert_array_equal(port, eager)
