"""Port parity for the 2-D homogeneous setup (kernel B2's plain version)
and the camera MVP against the JAX package, bit for bit.

JAX runs its Pallas setup kernel as its own suite does on the CPU
(interpret mode), where XLA fuses products into the adds they feed; the
port fuses the same products (core/fp.py), so every plane, bbox value,
valid flag and id is equal, as is the compiled XLA twin ``setup_2dh``.
(The JAX suite itself holds kernel and twin only to rtol 5e-4,
tests/test_raster_group.py:32-66.)"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.ops.setup2dh import setup_2dh_fused as j_setup
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.ops import setup2dh as S

torch.set_num_threads(2)

CAM = dict(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)


def _rand_soup(T, seed=5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    nrm = rng.normal(size=(3 * T, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0.2, 1.0, (3 * T, 3)).astype(np.float32)
    return pos, nrm, col


def _bits(a):
    """float32 arrays as their bit patterns (tells -0.0 from 0.0)."""
    return a.view(np.int32) if a.dtype == np.float32 else a


def _inputs(T, n_attrs):
    pos, nrm, col = _rand_soup(T)
    parts = [nrm, col] + ([pos] if n_attrs == 9 else [])
    attrs = np.concatenate(parts, axis=1)
    pos9 = np.ascontiguousarray(
        pos.reshape(T, 3, 3).transpose(1, 2, 0).reshape(9, T))
    attrs_t = np.ascontiguousarray(attrs.reshape(T, 3 * n_attrs).T)
    mvp = np.array(JR.camera_mvp(JCam.create(**CAM), 48, 96, 0.5))
    return pos9, attrs_t, mvp


@pytest.mark.parametrize("n_attrs", [6, 9])
def test_setup_ref_matches_jax_fused_setup(n_attrs):
    T = 700
    pos9, attrs_t, mvp = _inputs(T, n_attrs)
    cm_j, bb_j = j_setup(jnp.asarray(pos9), jnp.asarray(attrs_t),
                         jnp.asarray(mvp), 48, 96)
    cm_t, bb_t = S.setup_2dh_fused(torch.from_numpy(pos9),
                                   torch.from_numpy(attrs_t),
                                   torch.from_numpy(mvp), 48, 96)
    cm_j = np.asarray(cm_j).reshape(cm_j.shape[0], -1)
    assert tuple(cm_t.shape) == (16 + 3 * n_attrs + 3, 1024 // 128, 128)
    cm_t = cm_t.reshape(cm_t.shape[0], -1).numpy()
    valid = bb_t["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(bb_j["valid"]))
    assert valid[:T].sum() > 100
    np.testing.assert_array_equal(_bits(cm_t), _bits(cm_j))
    for k in ("bx0", "bx1", "by0", "by1"):
        np.testing.assert_array_equal(_bits(bb_t[k].numpy()),
                                      _bits(np.asarray(bb_j[k])))
    np.testing.assert_array_equal(cm_t[12], np.arange(1024, dtype=np.float32))
    np.testing.assert_array_equal(cm_t[13:16], 0.0)


def test_setup_channels_equal_jax_xla_twin_bitwise():
    T = 700
    pos9, attrs_t, mvp = _inputs(T, 6)
    twin = jax.jit(JR.setup_2dh, static_argnums=(3, 4))
    ach = twin(jnp.asarray(pos9), jnp.asarray(attrs_t), jnp.asarray(mvp), 48,
               96)
    tch = R.setup_2dh(torch.from_numpy(pos9), torch.from_numpy(attrs_t),
                      torch.from_numpy(mvp), 48, 96)
    assert set(tch) == set(ach)
    for k in ach:
        np.testing.assert_array_equal(_bits(tch[k].numpy()),
                                      _bits(np.asarray(ach[k])), err_msg=k)
    assert tuple(S._plane_keys(6)) == JR._plane_keys_2dh(6)


@pytest.mark.parametrize("cam,rows,cols,pa", [
    (dict(pos=(2.4, 1.4, 2.8), yaw=float(np.arctan2(-2.8, -2.4)),
          pitch=-0.3), 540, 960, 0.5),
    (CAM, 48, 96, 0.5),
    (dict(pos=(-3.0, 0.2, 7.5), yaw=1.1, pitch=0.9, fov_y_deg=55.0),
     36, 96, 1.0),
    (dict(pos=(0.0, 1.0, 2.0), yaw=-1.57, pitch=-0.5), 48, 96, 0.5),
])
def test_camera_mvp_matches_jax(cam, rows, cols, pa):
    """Equal to the compiled reference bit for bit. (XLA's sin, cos and tan
    are not always correctly rounded, the port's are; at other poses the
    two can differ by an ulp.)"""
    mvp = jax.jit(functools.partial(JR.camera_mvp, rows=rows, cols=cols,
                                    pixel_aspect=pa))
    want = np.asarray(mvp(JCam.create(**cam)))
    got = R.camera_mvp(Camera.create(**cam), rows, cols, pa)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
