"""Port parity for the many-view farm (``parallel/mesh``: batch_cameras,
orbit_cameras, render_views) and the batched glyph vote, against the JAX
package (``make_views_sharded_fn`` on a one-device CPU mesh, ``jax.vmap``),
from the same seeded inputs.

Tolerances: camera fields, glyph grids and vote outputs exactly; rgb within
1e-5 (every orbit pose has a pitch whose float32 sine XLA does not round as
libm, which the port takes: the count is recorded)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.ascii import modal as JMOD
from ascii_renderer_tpu.ascii.ascii_pass import glyph_decide as jglyph
from ascii_renderer_tpu.backends.raytrace import render_rgb as jrender
from ascii_renderer_tpu.core.config import Config as JConfig
from ascii_renderer_tpu.core.frame import Frame as JFrame
from ascii_renderer_tpu.parallel import mesh as JM
from ascii_renderer_tpu.scene.demo import create_rt_demo_scene as jdemo
from ascii_renderer_tpu_torch.ascii import modal as TMOD
from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
from ascii_renderer_tpu_torch.backends.raytrace import render_rgb
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
from ascii_renderer_tpu_torch.parallel import mesh as TM
from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene

torch.set_num_threads(2)

FARM = dict(center=(0, 1.0, 1.0), radius=6.0)  # bench.py config 4
# of the 1,024 orbit poses: those whose float32 cos / sin of the yaw, and
# of the pitch (one value, -0.24497867, for every view), XLA does not
# round as libm (JAX 0.9.0 on the CPU)
YAW_COS_APART, YAW_SIN_APART, PITCH_APART_VIEWS = 24, 22, 1024


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def test_orbit_cameras_equal_jax():
    """orbit_cameras(1024) of config 4: every field of every view equals
    JAX's bit for bit; batch_cameras keeps the views leading."""
    want = JM.orbit_cameras(1024, **FARM)
    got = TM.orbit_cameras(1024, **FARM)
    for f in ("pos", "yaw", "pitch", "fov_y", "speed", "sensitivity"):
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                      _bits(getattr(want, f)), err_msg=f)
    assert tuple(got.pos.shape) == (1024, 3)
    b = TM.batch_cameras([(0, 1, 2)], [0.5], [-0.1], fov_y_deg=60.0)
    jb = JM.batch_cameras([(0, 1, 2)], [0.5], [-0.1], fov_y_deg=60.0)
    np.testing.assert_array_equal(_bits(b.fov_y.numpy()), _bits(jb.fov_y))


def test_orbit_trig_apart_from_libm_counts():
    """The orbit poses where XLA's float32 trig is not the libm value the
    port takes, counted: 24 cosines and 22 sines of the 1,024 yaws, and
    the sine of the one pitch, so every view's basis (and rgb) rounds
    apart from JAX's at its last bit."""
    c = JM.orbit_cameras(1024, **FARM)
    yaw, pitch = np.asarray(c.yaw), np.asarray(c.pitch)
    apart = {}
    for name, jf, mf in (("cos", jnp.cos, math.cos),
                         ("sin", jnp.sin, math.sin)):
        lib = np.array([mf(float(v)) for v in yaw], np.float32)
        apart[name] = int((_bits(jax.jit(jf)(yaw)) != _bits(lib)).sum())
        plib = np.array([mf(float(v)) for v in pitch], np.float32)
        apart["pitch " + name] = int((_bits(jax.jit(jf)(pitch))
                                      != _bits(plib)).sum())
    assert apart["cos"] == YAW_COS_APART and apart["sin"] == YAW_SIN_APART
    assert apart["pitch cos"] == 0
    assert apart["pitch sin"] == PITCH_APART_VIEWS


def _render_one_jax(cfg, rows, cols):
    def one(scene, cam):
        rgb = jrender(scene, cam, rows, cols, cfg.pixel_aspect)
        chars, _ = jglyph(JFrame.from_float(rgb), ramp=cfg.ascii_ramp,
                          mode_on=cfg.ascii_mode_filter,
                          mode_radius=cfg.mode_radius,
                          mode_thresh=cfg.ascii_mode_thresh,
                          grayscale=cfg.use_grayscale)
        return chars, rgb
    return one


def _render_one_port(cfg, rows, cols):
    def one(scene, cam):
        rgb = render_rgb(scene, cam, rows, cols, cfg.pixel_aspect)
        chars, _ = glyph_decide(Frame.from_float(rgb), ramp=cfg.ascii_ramp,
                                mode_on=cfg.ascii_mode_filter,
                                mode_radius=cfg.mode_radius,
                                mode_thresh=cfg.ascii_mode_thresh,
                                grayscale=cfg.use_grayscale)
        return chars, rgb
    return one


def test_farm_views_equal_jax_sharded():
    """8 orbit views at 12 x 32 (config 4's smoke size) of the rt_demo
    scene with exact primitive counts, rendered and glyph-decided with the
    mode filter on: render_views' glyph grids equal JAX's
    make_views_sharded_fn on a one-device CPU mesh exactly, rgb within
    1e-5."""
    views, rows, cols = 8, 12, 32
    jcfg, cfg = JConfig(pixel_aspect=0.5), Config(pixel_aspect=0.5)
    mesh = JM.make_mesh((1,), ("views",))
    jchars, jrgb = JM.make_views_sharded_fn(
        _render_one_jax(jcfg, rows, cols), mesh)(
            jdemo().build(min_pad=1), JM.orbit_cameras(views, **FARM))
    chars, rgb = TM.render_views(
        _render_one_port(cfg, rows, cols),
        create_rt_demo_scene().build(min_pad=1, device="cpu"),
        TM.orbit_cameras(views, **FARM))
    assert tuple(chars.shape) == (views, rows, cols)
    np.testing.assert_array_equal(chars.numpy(), np.asarray(jchars))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-5)
    assert len(np.unique(chars.numpy())) >= 4


def test_farm_batch_equals_single_views():
    """A batched render_rgb equals each view's own single-camera call bit
    for bit (rays of one view never meet another's)."""
    scene = create_rt_demo_scene().build(min_pad=1, device="cpu")
    cams = TM.orbit_cameras(5, **FARM)
    batch = render_rgb(scene, cams, 6, 10, 0.5)
    for v in range(5):
        one = TM.batch_cameras(cams.pos[v:v + 1].numpy(),
                               cams.yaw[v:v + 1].numpy(),
                               cams.pitch[v:v + 1].numpy())
        single = one.replace(pos=one.pos[0], yaw=one.yaw[0],
                             pitch=one.pitch[0], fov_y=one.fov_y[0])
        assert torch.equal(batch[v].view(torch.int32),
                           render_rgb(scene, single, 6, 10, 0.5)
                           .view(torch.int32))
    with pytest.raises(ValueError, match="batch"):
        TM.render_views(lambda s, c: None, scene, scene.camera)


@pytest.mark.parametrize("radius,thresh", [(1, 5), (2, 12), (3, 24)])
def test_batched_modal_equals_loop_and_jax_vmap(radius, thresh):
    """modal_filter over [V, H, W] (the plain version, and the kernel
    wrapper's CPU path) equals a loop over the views and JAX's
    vmap(modal_filter) exactly; no vote crosses a view's edge."""
    rng = np.random.default_rng(radius)
    idx = rng.integers(0, 6, (6, 13, 21)).astype(np.int32)
    ovr = rng.random((6, 13, 21)) < 0.15
    want = np.asarray(jax.vmap(lambda i, o: JMOD.modal_filter(
        i, o, radius, thresh))(jnp.asarray(idx), jnp.asarray(ovr)))
    ti, to = torch.from_numpy(idx), torch.from_numpy(ovr)
    got = TMOD.modal_filter(ti, to, radius, thresh)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        AK.modal_filter_kernel(ti, to, radius, thresh).numpy(), want)
    loop = torch.stack([TMOD.modal_filter(ti[v], to[v], radius, thresh)
                        for v in range(6)])
    assert torch.equal(got, loop)
