"""Port parity for the glyph pass: modal vote, glyph_decide,
glyph_from_index, AsciiPass and chars_to_strings against the JAX package,
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.ascii import ascii_pass as JA
from ascii_renderer_tpu.ascii import modal as JM
from ascii_renderer_tpu.ascii.text import chars_to_strings as j_strings
from ascii_renderer_tpu.core.config import Config as JConfig
from ascii_renderer_tpu.core.frame import Frame as JFrame
from ascii_renderer_tpu_torch.ascii import ascii_pass as TA
from ascii_renderer_tpu_torch.ascii import modal as TM
from ascii_renderer_tpu_torch.ascii.text import chars_to_strings
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame

torch.set_num_threads(2)


def _planes(seed, h=23, w=37, levels=4, p_override=0.15):
    rng = np.random.default_rng(seed)
    # few levels + blobs so majorities exist and Boyer-Moore order matters
    idx = rng.integers(0, levels, (h, w)).astype(np.int32)
    idx[5:12, 8:20] = min(2, levels - 1)
    override = rng.random((h, w)) < p_override
    a = np.where(override, rng.integers(2, 255, (h, w)),
                 rng.integers(0, 2, (h, w))).astype(np.uint8)
    a[0, 0], a[1, 1] = 255, 254  # protocol edges
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    rgb[5:12, 8:20] = 128
    return idx, override, a, rgb


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_modal_candidate_and_filter_equal_jax(radius, seed):
    idx, override, _a, _rgb = _planes(seed)
    jc, jv = JM.modal_candidate(jnp.asarray(idx), jnp.asarray(override), radius)
    tc, tv = TM.modal_candidate(torch.from_numpy(idx),
                                torch.from_numpy(override), radius)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    thresh = {1: 4, 2: 12, 3: 24}[radius]
    for t in (1, thresh):
        want = JM.modal_filter(jnp.asarray(idx), jnp.asarray(override),
                               radius, t)
        got = TM.modal_filter(torch.from_numpy(idx), torch.from_numpy(override),
                              radius, t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("grayscale", [False, True])
def test_glyph_decide_chars_and_tint_equal_jax(radius, grayscale):
    _idx, _ovr, a, rgb = _planes(radius + 10)
    kw = dict(ramp="@%#*+=-:. ", mode_on=True, mode_radius=radius,
              mode_thresh=int((2 * radius + 1) ** 2 * 0.5), grayscale=grayscale)
    jc, jt = JA.glyph_decide(JFrame(rgb=jnp.asarray(rgb), a=jnp.asarray(a)),
                             **kw)
    tc, tt = TA.glyph_decide(Frame(rgb=torch.from_numpy(rgb),
                                   a=torch.from_numpy(a)), **kw)
    assert tc.dtype == torch.uint8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("ramp,mode_on", [("", True), (" .:-=+*#%@", False),
                                          ("ab", True)])
def test_glyph_from_index_equal_jax(ramp, mode_on):
    idx, _ovr, a, _rgb = _planes(5, levels=max(1, len(ramp) or 10))
    kw = dict(ramp=ramp, mode_on=mode_on, mode_radius=2, mode_thresh=12,
              grayscale=False)
    jc, jt = JA.glyph_from_index(jnp.asarray(idx), jnp.asarray(a), None, **kw)
    tc, tt = TA.glyph_from_index(torch.from_numpy(idx), torch.from_numpy(a),
                                 None, **kw)
    assert jt is None and tt is None
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_ascii_pass_and_text_equal_jax():
    _idx, _ovr, a, rgb = _planes(9)
    a[:] = 1  # plain frame: every cell goes through the ramp
    jc, _ = JA.AsciiPass(JConfig())(JFrame(rgb=jnp.asarray(rgb),
                                           a=jnp.asarray(a)))
    tc, _ = TA.AsciiPass(Config())(Frame(rgb=torch.from_numpy(rgb),
                                         a=torch.from_numpy(a)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert chars_to_strings(tc) == j_strings(np.asarray(jc))
    odd = torch.tensor([[31, 32, 126, 127, 200]], dtype=torch.uint8)
    assert chars_to_strings(odd) == ["? ~??"]


# ---- the modal vote kernel's wrapper (B4, ops/ascii_kernel) ----

@pytest.mark.parametrize("radius,thresh", [(1, 5), (2, 12), (3, 24)])
@pytest.mark.parametrize("h,w", [(24, 48), (16, 32)])
def test_modal_kernel_wrapper_equals_jax_pallas(radius, thresh, h, w):
    """On the CPU the wrapper runs the plain vote; it equals the Pallas
    kernel in interpret mode, overrides and clamped edges included."""
    from ascii_renderer_tpu.ops.ascii_kernel import modal_filter_pallas
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    rng = np.random.default_rng(radius * 100 + h)
    idx = rng.integers(0, 4, (h, w)).astype(np.int32)
    idx[2:9, 3:15] = 2
    ovr = rng.random((h, w)) < 0.1
    want = modal_filter_pallas(jnp.asarray(idx), jnp.asarray(ovr), radius,
                               thresh, interpret=True)
    launches = AK.launches
    got = AK.modal_filter_kernel(torch.from_numpy(idx),
                                 torch.from_numpy(ovr), radius, thresh)
    assert AK.launches == launches  # the CPU never launches
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_modal_kernel_wrapper_edge_clamping():
    from ascii_renderer_tpu.ops.ascii_kernel import modal_filter_pallas
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    idx = np.zeros((12, 40), np.int32)
    idx[0, 0] = 3
    ovr = np.zeros((12, 40), bool)
    got = AK.modal_filter_kernel(torch.from_numpy(idx),
                                 torch.from_numpy(ovr), 1, 5).numpy()
    assert got[0, 0] == 0
    np.testing.assert_array_equal(got, np.asarray(modal_filter_pallas(
        jnp.asarray(idx), jnp.asarray(ovr), 1, 5, interpret=True)))


def test_modal_kernel_wrapper_never_falls_back():
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    meta = torch.device("meta")
    launches = AK.launches
    with pytest.raises(ValueError):
        AK.modal_filter_kernel(torch.empty((8, 8), dtype=torch.int32,
                                           device=meta),
                               torch.empty((8, 8), dtype=torch.bool,
                                           device=meta), 2, 12)
    with pytest.raises(ValueError, match="radius"):
        AK.modal_filter_kernel(torch.zeros((8, 8), dtype=torch.int32),
                               torch.zeros((8, 8), dtype=torch.bool), 4, 12)
    assert AK.launches == launches

