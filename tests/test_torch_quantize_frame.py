"""Port parity: core/quantize, core/frame, core/camera and core/config of
ascii_renderer_tpu_torch against the JAX package, exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu.core import config as JCFG
from ascii_renderer_tpu.core import quantize as JQ
from ascii_renderer_tpu.core.frame import Frame as JFrame
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.core import config as TCFG
from ascii_renderer_tpu_torch.core import quantize as TQ
from ascii_renderer_tpu_torch.core.frame import Frame as TFrame

torch.set_num_threads(2)


def _all_sums_rgb():
    """u8 [N, 3] covering every byte sum 0..765, each value of every
    channel, and random triples."""
    s = np.arange(766)
    a = np.minimum(s, 255)
    b = np.minimum(s - a, 255)
    c = s - a - b
    rgb = [np.stack([a, b, c], 1), np.stack([c, a, b], 1)]
    v = np.arange(256)
    rgb.append(np.stack([v, np.zeros_like(v), np.zeros_like(v)], 1))
    rgb.append(np.random.default_rng(0).integers(0, 256, (20000, 3)))
    return np.concatenate(rgb).astype(np.uint8)


@pytest.mark.parametrize("ramp_len", [0, 1, 2, 3, 5, 10, 16, 70, 255])
def test_quantize_index_exhaustive(ramp_len):
    rgb = _all_sums_rgb()
    want = np.asarray(JQ.quantize_index(jnp.asarray(rgb), ramp_len))
    got = TQ.quantize_index(torch.from_numpy(rgb), ramp_len).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_float_rgb_to_u8_every_boundary():
    """Every float32 within 4 ulps of each k/255 half-step boundary, a
    dense grid over [-0.25, 1.25], and the special values."""
    mids = ((np.arange(-2, 258, dtype=np.float64) + 0.5) / 255.0).astype(
        np.float32)
    near = [mids]
    for _ in range(4):
        near.append(np.nextafter(near[-1], np.float32(np.inf)))
    lo = [mids]
    for _ in range(4):
        lo.append(np.nextafter(lo[-1], np.float32(-np.inf)))
    grid = np.linspace(-0.25, 1.25, 1_000_003, dtype=np.float32)
    special = np.asarray([0.0, -0.0, 1.0, np.inf, -np.inf, 1e-30, -1e-30,
                          0.5 / 255, 254.5 / 255], np.float32)
    x = np.concatenate(near + lo + [grid, special]).reshape(-1, 1)
    x = np.repeat(x, 3, axis=1)
    want = np.asarray(JQ.float_rgb_to_u8(jnp.asarray(x)))
    got = TQ.float_rgb_to_u8(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_ramp_codes_and_override_mask():
    for ramp in ("", "@%#*+=-:. ", "ab"):
        np.testing.assert_array_equal(TQ.ramp_codes(ramp), JQ.ramp_codes(ramp))
    a = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(TQ.is_override(torch.from_numpy(a)).numpy(),
                                  np.asarray(JQ.is_override(jnp.asarray(a))))


def test_frame_from_float_blank_overrides():
    rng = np.random.default_rng(1)
    rgb = rng.uniform(-0.2, 1.2, (9, 13, 3)).astype(np.float32)
    a = rng.integers(0, 256, (9, 13)).astype(np.uint8)
    chars = rng.integers(32, 127, (9, 13)).astype(np.uint8)
    mask = rng.random((9, 13)) < 0.3
    for alpha in (None, a):
        jf = JFrame.from_float(jnp.asarray(rgb),
                               None if alpha is None else jnp.asarray(alpha))
        tf = TFrame.from_float(torch.from_numpy(rgb),
                               None if alpha is None else torch.from_numpy(alpha))
        jo = jf.with_overrides(jnp.asarray(chars), jnp.asarray(mask))
        to = tf.with_overrides(torch.from_numpy(chars), torch.from_numpy(mask))
        for j, t in ((jf, tf), (jo, to)):
            np.testing.assert_array_equal(t.rgb.numpy(), np.asarray(j.rgb))
            np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    jb, tb = JFrame.blank(4, 6), TFrame.blank(4, 6, device="cpu")
    np.testing.assert_array_equal(tb.rgb.numpy(), np.asarray(jb.rgb))
    np.testing.assert_array_equal(tb.a.numpy(), np.asarray(jb.a))
    assert (tb.rows, tb.cols) == (4, 6)


@pytest.mark.parametrize("keys,dx,dy", [
    (("w", "arrowleft"), 0.0, 0.0),
    (("s", "d", " ", "arrowup"), 3.0, -2.0),
    (("a", "shift", "arrowdown", "arrowright"), -40.0, 900.0),
    ((), 2000.0, 0.0),
])
def test_update_camera_matches_jax(keys, dx, dy):
    """Bit for bit against the jitted integrator (the reference's frame
    step compiles it, fusing its products into the adds)."""
    upd = jax.jit(JC.update_camera)
    jc = JC.Camera.create(pos=(0.5, 1.0, 3.0), yaw=3.0, pitch=1.3)
    tc = TC.Camera.create(pos=(0.5, 1.0, 3.0), yaw=3.0, pitch=1.3)
    for _ in range(5):
        jc = upd(jc, JC.CameraInputs.from_keys(keys, dx, dy),
                 jnp.float32(0.05))
        tc = TC.update_camera(tc, TC.CameraInputs.from_keys(keys, dx, dy), 0.05)
    for f in dataclasses.fields(jc):
        np.testing.assert_array_equal(
            getattr(tc, f.name).numpy().view(np.uint32),
            np.asarray(getattr(jc, f.name)).view(np.uint32), err_msg=f.name)


def test_config_is_a_copy():
    assert TCFG.Config() == TCFG.default_config()
    assert dataclasses.asdict(TCFG.Config()) == dataclasses.asdict(
        JCFG.Config())
    assert TCFG.Config().mode_radius == JCFG.Config().mode_radius
