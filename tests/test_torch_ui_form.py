"""X12a's UI form (X16): the frame step's UI layer passed by value
(``sim/ui.ui_params``) and drawn in the frame's byte launch. Its plain
version (``ops/frame_bytes.frame_bytes_ref(..., ui=)``: the planes drawn on
the host, then burnt in) against JAX's ``ui_char_plane`` and
``Frame.from_float(...).with_overrides``, bit for bit, on seeded ripple
pools, FPS values and grids; and the kernel's per-cell ripple rule
(``sim/ui.ripple_cells``: a ring prefilter, then the march's rows in closed
form, the march replayed where it could pass 128 steps) against the
reference march ``_bresenham_np`` for every radius 0-200 over every offset
of the ring's box. The kernel against this plain version
on the card is ``tests/test_torch_build_glyph.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.core.config import Config as JConfig
from ascii_renderer_tpu.core.frame import Frame as JFrame
from ascii_renderer_tpu.sim import ui as JU
from ascii_renderer_tpu_torch.core.config import Config
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ops import frame_bytes as FB
from ascii_renderer_tpu_torch.sim import ui as U

torch.set_num_threads(2)

GRIDS = ((1, 1), (36, 96), (540, 960))
FPS = (0.0, 7.0, 1e7, float("nan"), 2.5, 3.5, 0.5, 59.5, 9999999.5, -3.0)
TIME_MS = 1500.0  # the pools' clock; a ripple started at t has radius
SPEED = Config().ripple_speed  # (TIME_MS - t) * SPEED


def _pool(rows, cols, n, seed):
    """A ripple pool of n live slots (16 rows; the rest stale): at the
    border, past the grid's edge, radius 0 and the largest radius, the
    rest seeded over and around the grid."""
    rng = np.random.default_rng(seed)
    rip = np.stack([rng.uniform(-20, cols + 20, 16),
                    rng.uniform(-20, rows + 20, 16),
                    rng.uniform(0, TIME_MS, 16)], -1).astype(np.float32)
    max_r = Config().max_ripple_radius
    rip[0] = (0.0, rows - 1.0, TIME_MS)                    # radius 0
    rip[1] = (cols - 1.0, 0.0, TIME_MS - max_r / SPEED)    # radius max
    rip[2] = (cols + 30.0, rows / 2, TIME_MS - 600.0)      # past the edge
    rip[3] = (cols / 2, -0.5, TIME_MS - 200.0)             # at the border
    rip[4] = (2.5, 3.5, TIME_MS + 10.0)                    # not yet born
    rip[5] = (cols / 2, rows / 2, TIME_MS - 2.5 / SPEED)   # radius 2.5
    return rip, n


def _rgb_a(rows, cols, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(-0.1, 1.1, (rows, cols, 3)).astype(np.float32)
    a = rng.integers(0, 256, (rows, cols)).astype(np.uint8)
    return rgb, a


@pytest.mark.parametrize("n", [0, 1, 16])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_ui_form_plain_equals_jax(grid, n):
    """The UI form's plain version (values in, bytes out) against JAX's
    ui_char_plane then from_float and with_overrides, bit for bit, for
    every FPS value of ``FPS``; with and without an alpha plane."""
    rows, cols = grid
    rip, n = _pool(rows, cols, n, seed=rows + n)
    rgb, a = _rgb_a(rows, cols, seed=cols + n)
    jcfg, cfg = JConfig(), Config()
    for k, fps in enumerate(FPS):
        alpha = a if k % 2 else None
        jc, jm = JU.ui_char_plane(jcfg, rows, cols, jnp.float32(fps),
                                  jnp.asarray(rip), jnp.int32(n),
                                  jnp.float32(TIME_MS))
        jf = JFrame.from_float(jnp.asarray(rgb), None if alpha is None
                               else jnp.asarray(alpha)).with_overrides(jc, jm)
        ui = U.ui_params(cfg, rows, cols, fps, torch.from_numpy(rip),
                         torch.tensor(n, dtype=torch.int32),
                         torch.tensor(TIME_MS))
        got = FB.frame_bytes_ref(torch.from_numpy(rgb), None if alpha is None
                                 else torch.from_numpy(alpha), ui=ui)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jf.rgb),
                                      err_msg=f"rgb fps={fps}")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jf.a),
                                      err_msg=f"alpha fps={fps}")
        # the frame's own route on the CPU is the same plain version
        f = Frame.from_float(torch.from_numpy(rgb), None if alpha is None
                             else torch.from_numpy(alpha), ui=ui)
        assert torch.equal(f.a, got[1]) and torch.equal(f.rgb, got[0])
        # and the planes are ui_char_plane's
        chars, mask = U.ui_char_plane(cfg, rows, cols, fps,
                                      torch.from_numpy(rip),
                                      torch.tensor(n, dtype=torch.int32),
                                      torch.tensor(TIME_MS), device="cpu")
        np.testing.assert_array_equal(chars.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))


def test_ui_params_carry_what_the_kernel_reads():
    """The values: the grid, the digits' codes right-aligned at cols -
    len - 1 (half to even, NaN 0, clamped), only the live ripples, rounded
    half to even; padded to the kernel's fixed slots."""
    cfg = Config()
    rip = np.zeros((16, 3), np.float32)
    rip[:3] = [(2.5, 3.5, 0.0), (7.5, -1.5, 100.0), (1.0, 1.0, 5000.0)]
    ui = U.ui_params(cfg, 36, 96, 60.5, rip, 3, 1000.0)
    assert ui.fps_codes == tuple(b"60") and ui.fps_x == 96 - 2 - 1
    # 1000 ms: radii 50 and 45 live, the third not yet born
    assert ui.circles == ((2, 4, 50), (8, -2, 45))
    vals = ui.values()
    assert len(vals) == 6 + U.FPS_MAX_DIGITS + 3 * U.MAX_RIPPLES
    assert vals[:6] == [36, 96, len(cfg.pi_digits), 93, 2, 2]
    assert U.ui_params(cfg, 4, 12, float("nan"), rip, 0, 0.0).fps_codes == (
        ord("0"),)
    assert U.ui_params(cfg, 4, 12, 1e12, rip, 0, 0.0).fps_codes == tuple(
        b"9999999")


def test_frame_bytes_refuses_a_ui_plane_and_values_together():
    ui = U.ui_params(Config(), 2, 3, 1.0, np.zeros((16, 3), np.float32), 0,
                     0.0)
    rgb = torch.zeros((2, 3, 3))
    plane = (torch.zeros((2, 3), dtype=torch.uint8),
             torch.zeros((2, 3), dtype=torch.bool))
    with pytest.raises(ValueError):
        FB.frame_bytes(rgb, None, *plane, ui=ui)
    with pytest.raises(ValueError):
        FB.frame_bytes(torch.zeros((3, 2, 3)), None, ui=ui)


def _march_box(r: int, h: int):
    """The reference march's cells of a ripple of radius r at the centre of
    the box [-h, h]^2, as a bool mask."""
    px, py, on = U._bresenham_np(np.array([0], np.int32),
                                 np.array([0], np.int32),
                                 np.array([r], np.int32))
    mask = np.zeros((2 * h + 1, 2 * h + 1), bool)
    mask[py[on] + h, px[on] + h] = True
    return mask


@pytest.mark.parametrize("radii", [range(0, 50), range(50, 100),
                                   range(100, 150), range(150, 201)],
                         ids=["0-49", "50-99", "100-149", "150-200"])
def test_ripple_rule_equals_the_march_exhaustively(radii):
    """The kernel's per-cell rule (ring prefilter r^2 - 3 r - 1 <= a^2 +
    b^2 <= r^2, then the march's rows in closed form, or the march
    replayed to the cell where it could pass 128 steps) emits exactly the
    reference march's cells, 128 steps at most (truncated from radius ~181
    on), for every radius and every offset of the ring's box (two cells
    past it on each side)."""
    for r in radii:
        h = r + 2
        dy, dx = np.mgrid[-h:h + 1, -h:h + 1]
        want = _march_box(r, h)
        got = U.ripple_cells(dx, dy, r)
        assert np.array_equal(got, want), (r, np.argwhere(got != want)[:5])
        assert want.any()
