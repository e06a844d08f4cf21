"""The glyph tail's plain chain (the CPU route of X12a and B4's chars
form) against the JAX package, exactly: ``Frame.from_float`` (with the UI
plane of ``with_overrides``) against JAX's ``from_float`` then
``with_overrides``; ``glyph_decide`` and ``glyph_from_index`` against
JAX's on seeded planes (``tools/xla_inputs.glyph_frame``: floats outside
[0, 1] and at the bytes' rounding edges, the alpha protocol's edges),
ramps of one code, ten and a hundred, the mode
filter on (radius 1-3) and off; batches of views against JAX a view at a
time. The ramp's codes are made once for each (ramp, device)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.ascii import ascii_pass as JA
from ascii_renderer_tpu.core import quantize as JQ
from ascii_renderer_tpu.core.frame import Frame as JFrame
from ascii_renderer_tpu_torch.ascii import ascii_pass as TA
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
from ascii_renderer_tpu_torch.ops import frame_bytes as FB
from ascii_renderer_tpu_torch.tools.xla_inputs import GLYPH_RAMPS, glyph_frame

torch.set_num_threads(2)

THRESH = {1: 5, 2: 12, 3: 24}


def _jax_frame(rgb, a=None, ui=None):
    f = JFrame.from_float(jnp.asarray(rgb), None if a is None
                          else jnp.asarray(a))
    if ui is not None:
        f = f.with_overrides(jnp.asarray(ui[0]), jnp.asarray(ui[1]))
    return f


@pytest.mark.parametrize("form", ["rgb", "rgb+a", "rgb+a+ui", "rgb+ui"])
@pytest.mark.parametrize("shape", [(36, 96), (3, 12, 20), (1, 1)])
def test_from_float_equals_jax(form, shape):
    rgb, a, chars, mask = glyph_frame(shape, seed=len(shape) + len(form))
    a = a if "+a" in form else None
    ui = (chars, mask) if "ui" in form else None
    want = _jax_frame(rgb, a, ui)
    got = Frame.from_float(
        torch.from_numpy(rgb), None if a is None else torch.from_numpy(a),
        overrides=None if ui is None else tuple(map(torch.from_numpy, ui)))
    assert got.rgb.dtype == got.a.dtype == torch.uint8
    np.testing.assert_array_equal(got.rgb.numpy(), np.asarray(want.rgb))
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    # every byte's rounding turn is reached: bytes of k / 255 and of
    # (k + 0.5) / 255 on both sides
    assert len(np.unique(got.rgb.numpy())) > min(200, rgb.size // 4)


def test_with_overrides_equals_the_from_float_form():
    rgb, a, chars, mask = (torch.from_numpy(x)
                           for x in glyph_frame((20, 30), seed=4))
    one = Frame.from_float(rgb, a, overrides=(chars, mask))
    two = Frame.from_float(rgb, a).with_overrides(chars, mask)
    assert torch.equal(one.rgb, two.rgb) and torch.equal(one.a, two.a)
    with pytest.raises(ValueError, match="go together"):
        FB.frame_bytes(rgb, a, chars, None)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])  # 0: the mode filter off
@pytest.mark.parametrize("ramp", range(len(GLYPH_RAMPS)))
def test_glyph_decide_equals_jax(ramp, mode):
    ramp = GLYPH_RAMPS[ramp]
    rgb, a, chars, mask = glyph_frame((45, 70), seed=mode + 7 * len(ramp))
    want = _jax_frame(rgb, a, (chars, mask))
    kw = dict(ramp=ramp, mode_on=mode > 0, mode_radius=max(mode, 1),
              mode_thresh=THRESH[max(mode, 1)], grayscale=False)
    jc, jt = JA.glyph_decide(want, **kw)
    frame = Frame.from_float(torch.from_numpy(rgb), torch.from_numpy(a),
                             overrides=(torch.from_numpy(chars),
                                        torch.from_numpy(mask)))
    tc, tt = TA.glyph_decide(frame, **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the ramp's every code and the override bytes show up
    codes = set(ramp.encode())
    got = set(np.unique(tc.numpy()).tolist())
    assert len(got & codes) >= min(len(codes), 8)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("ramp", range(len(GLYPH_RAMPS)))
def test_glyph_from_index_equals_jax(ramp, mode):
    ramp = GLYPH_RAMPS[ramp]
    rgb, a, _c, _m = glyph_frame((33, 50), seed=40 + mode)
    idx = JQ.quantize_index(JFrame.from_float(jnp.asarray(rgb)).rgb,
                            len(ramp))
    kw = dict(ramp=ramp, mode_on=mode > 0, mode_radius=max(mode, 1),
              mode_thresh=THRESH[max(mode, 1)], grayscale=True)
    tint = np.full(a.shape + (3,), 9, np.uint8)
    jc, jt = JA.glyph_from_index(idx, jnp.asarray(a), jnp.asarray(tint), **kw)
    tc, tt = TA.glyph_from_index(torch.from_numpy(np.asarray(idx)),
                                 torch.from_numpy(a), torch.from_numpy(tint),
                                 **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("mode", [0, 2])
def test_glyph_decide_of_views_equals_jax_view_by_view(mode):
    ramp = GLYPH_RAMPS[1]
    rgb, a, _c, _m = glyph_frame((4, 36, 96), seed=mode)
    kw = dict(ramp=ramp, mode_on=mode > 0, mode_radius=max(mode, 1),
              mode_thresh=THRESH[max(mode, 1)], grayscale=False)
    got, _tint = TA.glyph_decide(Frame.from_float(torch.from_numpy(rgb),
                                                  torch.from_numpy(a)), **kw)
    assert tuple(got.shape) == (4, 36, 96)
    for v in range(4):
        jc, _jt = JA.glyph_decide(_jax_frame(rgb[v], a[v]), **kw)
        np.testing.assert_array_equal(got[v].numpy(), np.asarray(jc))


def test_ramp_codes_are_made_once_a_ramp_and_device():
    for ramp in GLYPH_RAMPS + ("",):
        first = AK.ramp_codes(ramp, torch.device("cpu"))
        assert AK.ramp_codes(ramp, torch.device("cpu")) is first
        want = (ramp or JQ.DEFAULT_RAMP).encode()
        assert bytes(first.numpy()) == want
        assert AK.ramp_len_of(ramp) == len(want)
    assert first.dtype == torch.uint8


def test_chars_wrapper_checks_its_planes():
    """The chars form takes u8 rgb [.., 3] or int32 indices and a matching
    alpha plane; off the CPU it launches or raises."""
    meta = torch.device("meta")
    n = (AK.launches, AK.launches_chars, AK.launches_map)
    for src in (torch.empty((8, 9, 3), dtype=torch.uint8, device=meta),
                torch.empty((8, 9), dtype=torch.int32, device=meta)):
        for mode_on in (True, False):
            with pytest.raises(ValueError, match="CUDA"):
                AK.glyph_chars(src, torch.empty((8, 9), dtype=torch.uint8,
                                                device=meta), "ab",
                               mode_on=mode_on, radius=2, thresh=12)
    assert (AK.launches, AK.launches_chars, AK.launches_map) == n
    with pytest.raises(ValueError, match="alpha"):
        AK.glyph_chars(torch.zeros((8, 9, 3), dtype=torch.uint8),
                       torch.zeros((8, 8), dtype=torch.uint8), "ab",
                       mode_on=False, radius=1, thresh=1)
    with pytest.raises(ValueError, match="radius"):
        AK.glyph_chars(torch.zeros((8, 9), dtype=torch.int32),
                       torch.zeros((8, 9), dtype=torch.uint8), "ab",
                       mode_on=True, radius=4, thresh=1)
    with pytest.raises(ValueError, match="CUDA"):
        FB.frame_bytes(torch.empty((4, 5, 3), device=meta))


def test_chars_form_constants_match_quantize_index():
    """modal.cu's upper clamp is float32(1 - 1e-6), the bound
    quantize_index clamps to."""
    import re
    from pathlib import Path
    src = (Path(AK.__file__).parent / "csrc" / "modal.cu").read_text()
    (hexf,) = re.findall(r"kClampHi = (0x[0-9a-fp.+-]+)f;", src)
    assert float.fromhex(hexf) == float(np.float32(1.0 - 1e-6))
