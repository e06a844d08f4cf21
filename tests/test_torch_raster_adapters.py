"""The raster channels' adapters and the builder's default material, on
the CPU against the JAX package: ``channels_to_setup``,
``clip_attrs_channels``, ``channels_clip_array`` and ``visibility_binned``
(``backends/raster_channels``, re-exported by ``backends/raster`` as the
reference re-exports them) equal the reference's compiled functions bit
for bit on a soup whose triangles straddle the near plane;
``scene/builder.DEFAULT_MAT_ID`` is the reference's and the builder's
default."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.scene import builder as JB
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_channels as RC
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.scene import builder as TB

torch.set_num_threads(2)

ROWS, COLS = 36, 96
CAM = dict(pos=(0.0, 0.2, 0.3), yaw=-np.pi / 2, pitch=-0.1)


def _bits(a):
    """int32 view, NaNs made equal."""
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


@pytest.fixture(scope="module")
def chans():
    rng = np.random.default_rng(9)
    T = 300
    p = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-1.5, 1.0, 3 * T)
    attrs = rng.uniform(-1, 1, (3 * T, 9)).astype(np.float32)
    mvp_j = jax.jit(lambda c: JR.camera_mvp(c, ROWS, COLS, 0.5))(
        JCam.create(**CAM))
    mvp_t = R.camera_mvp(Camera.create(**CAM), ROWS, COLS, 0.5)
    jch = jax.jit(lambda s, m: JR.setup_screen_channels(
        JR.transform_clip_channels(s, m), ROWS, COLS))(jnp.asarray(p), mvp_j)
    tch = R.clip_screen_channels(torch.from_numpy(p), mvp_t, ROWS, COLS)
    assert {1, 2, 3} <= set(tch["n_in"].tolist())
    return attrs, jch, tch


def test_adapters_are_reexported():
    for name in ("channels_to_setup", "clip_attrs_channels",
                 "channels_clip_array", "visibility_binned"):
        assert getattr(R, name) is getattr(RC, name)
        assert callable(getattr(JR, name))


def test_channels_to_setup_equals_jax(chans):
    _attrs, jch, tch = chans
    want = jax.jit(lambda ch: JR.channels_to_setup(dict(ch)))(jch)
    got = R.channels_to_setup(tch)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if k == "valid":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                          err_msg=k)


def test_clip_attrs_channels_equals_jax(chans):
    attrs, jch, tch = chans
    want = jax.jit(lambda a, ch: JR.clip_attrs_channels(a, dict(ch)))(
        jnp.asarray(attrs), jch)
    got = R.clip_attrs_channels(torch.from_numpy(attrs), tch)
    assert tuple(got.shape) == want.shape == (600, 3, 9)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_channels_clip_array_equals_jax(chans):
    _attrs, jch, tch = chans
    want = jax.jit(lambda ch: JR.channels_clip_array(dict(ch)))(jch)
    got = R.channels_clip_array(tch)
    assert tuple(got.shape) == want.shape == (600, 3, 4)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_visibility_binned_equals_jax(chans):
    """The setup-dict adapter over the bin walk: the same winner ids and
    depths as the reference's (Pallas in interpret mode; the depths with
    -0.0 folded into +0.0, as the walk's own tests compare them)."""
    _attrs, jch, tch = chans
    jz, jt = jax.jit(lambda ch: JR.visibility_binned(
        JR.channels_to_setup(dict(ch)), ROWS, COLS))(jch)
    tz, tt = R.visibility_binned(R.channels_to_setup(tch), ROWS, COLS)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(_bits(tz + 0.0), _bits(np.asarray(jz)
                                                          + np.float32(0)))
    assert int((tt >= 0).sum()) > 500


def test_default_material_id_equals_jax():
    """DEFAULT_MAT_ID is the reference's, and the builder's default for a
    primitive without a material and a scene object without a matId."""
    assert TB.DEFAULT_MAT_ID == JB.DEFAULT_MAT_ID == TB.MaterialIds.WHITE
    obj = {"geometry": {"spheres": [{"p": [0, 1, 0], "r": 0.5}],
                        "planes": [{"n": [0, 1, 0], "d": 0.0}]}}
    for sb in (TB.from_object(obj),
               TB.SceneBuilder().add_sphere([0, 1, 0], 0.5)
               .add_plane([0, 1, 0], 0.0)):
        scene = sb.build(device="cpu")
        assert int(scene.sph_mat[0]) == int(scene.pln_mat[0]) == \
            TB.DEFAULT_MAT_ID
