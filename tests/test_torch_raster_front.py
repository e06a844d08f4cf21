"""The raster front end of the small and mid paths on the CPU: the plain
versions of the clip with its screen setup (``ops/raster_clip``, X4 on the
card) and of the plane table with its attribute lerps (``ops/plane_table``,
X3 on the card) against the JAX package's compiled functions
(``jax.jit`` on the CPU backend; the table's B7 pack in the reference's
own CPU form), bit for bit.

The soups are seeded numpy triangles around a camera at the near plane, in
which 1-in, 2-in and 3-in clips, back faces, degenerate triangles and
vertices with w near 0 (and at the eye, w = 0) all occur. The clip dict and
its records are compared with the sign of zero and NaN in the same places;
so is the plane table where the reference stacks it. Where the reference
packs it (a length that is a multiple of 512), its pack drops the sign of
zero, and only there -0.0 is folded into +0.0. The kernels themselves are
held to these plain versions on the card
(``tests/test_torch_build_xla.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.ops import plane_table as PT
from ascii_renderer_tpu_torch.ops import raster_clip as RCL
from ascii_renderer_tpu_torch.tools.xla_inputs import (FRONT_CAM,
                                                       front_soup)

torch.set_num_threads(2)

ROWS, COLS = 36, 96


def _mvp():
    mvp_j = jax.jit(lambda c: JR.camera_mvp(c, ROWS, COLS, 0.5))(
        JCam.create(**FRONT_CAM))
    mvp_t = R.camera_mvp(Camera.create(**FRONT_CAM), ROWS, COLS, 0.5)
    np.testing.assert_array_equal(mvp_t.numpy(), np.asarray(mvp_j))
    return mvp_j, mvp_t


def _same(got, want, fold_zero=False, what=""):
    """Bit for bit, NaN in the same places (payloads aside); with
    ``fold_zero`` -0.0 counts as +0.0."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype != np.float32:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=what)
        return
    assert got.dtype == np.float32, what
    if fold_zero:
        got, want = got + np.float32(0), want + np.float32(0)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32), err_msg=what)


@pytest.fixture(scope="module", params=[256, 300], ids=["T256", "T300"])
def soup(request):
    mvp_j, mvp_t = _mvp()
    p, attrs = front_soup(request.param, mvp_t.numpy(), seed=request.param)
    jch = jax.jit(lambda s, mm: JR.setup_screen_channels(
        JR.transform_clip_channels(s, mm), ROWS, COLS))(jnp.asarray(p),
                                                        mvp_j)
    return p, attrs, mvp_j, mvp_t, {k: np.array(v) for k, v in jch.items()}


@pytest.mark.parametrize("layout", ["positions", "pos9"])
def test_clip_screen_equals_jax(soup, layout):
    """X4's plain version, the [2T] dict and its [T] records, equals
    setup_screen_channels(transform_clip_channels[9](...)) compiled by
    JAX, keys, dtypes and bits; every case of the front end occurs."""
    p, _attrs, mvp_j, mvp_t, jch = soup
    if layout == "pos9":
        pos9 = np.array(JR.positions_to_pos9(p))
        jch = {k: np.array(v) for k, v in jax.jit(
            lambda s, mm: JR.setup_screen_channels(
                JR.transform_clip_channels9(s, mm), ROWS, COLS))(
            jnp.asarray(pos9), mvp_j).items()}
        tch = RCL.clip_screen(torch.from_numpy(pos9), mvp_t, ROWS, COLS,
                              pos9=True)
        via = R.clip_screen_channels(None, mvp_t, ROWS, COLS,
                                     pos9=torch.from_numpy(pos9))
    else:
        tch = RCL.clip_screen(torch.from_numpy(p), mvp_t, ROWS, COLS)
        via = R.clip_screen_channels(torch.from_numpy(p), mvp_t, ROWS, COLS)
    assert list(tch) == list(via) and set(tch) == set(jch)
    T = p.shape[0] // 3
    for k, want in jch.items():
        assert tuple(tch[k].shape) == want.shape == (
            (T,) if k in PT.RECORD_KEYS else (2 * T,)), k
        _same(tch[k].numpy(), want, what=k)
        _same(via[k].numpy(), want, what=k)
    n_in, valid = tch["n_in"].numpy(), tch["valid"].numpy()
    area2 = tch["area2"].numpy()[:T]
    assert {0, 1, 2, 3} <= set(n_in.tolist())  # every clip case
    live = n_in >= 1
    assert (live & (area2 >= 0) & (np.abs(area2) > 1e-12)).sum() > 20
    assert (live & (np.abs(area2) <= 1e-12)).any()  # degenerate
    # the all-outside slots keep their w near 0: the guarded reciprocal
    w = np.concatenate([tch[f"w{s}"].numpy() for s in "abc"])
    iw = np.concatenate([tch[f"iw{s}"].numpy() for s in "abc"])
    assert (np.abs(w) < 1e-6).sum() >= 60 and (np.abs(iw) >= 1e8).any()
    assert valid.sum() > 100


def test_clip_screen_dict_layout():
    """The kernel's outputs, one [25, 2T] float buffer, valid and the
    records, assembled by the wrapper (``_channel_dict``), are the plain
    version's dict: its keys in order, dtypes and shapes, each channel a
    row of the buffer."""
    _mvp_j, mvp_t = _mvp()
    p, _a = front_soup(60, mvp_t.numpy(), seed=3)
    ref = RCL.clip_screen_ref(torch.from_numpy(p), mvp_t, ROWS, COLS)
    fb = torch.stack([ref[k] for k in RCL.FLOAT_KEYS])
    tr = torch.stack([ref["t_ab"], ref["t_ac"], ref["t_bc"]])
    ir = torch.stack([ref["rot"], ref["n_in"]])
    got = RCL._channel_dict(fb, ref["valid"], tr, ir)
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v) or torch.equal(
            torch.isnan(got[k]), torch.isnan(v)), k
    assert got["xa"].data_ptr() == fb.data_ptr()


@pytest.mark.parametrize("n_attrs", [9, 6])
@pytest.mark.parametrize("form", ["uncompacted", "compacted"])
def test_plane_table_equals_jax(soup, n_attrs, form):
    """X3's plain version equals build_plane_table(ch,
    clip_attrs_{channel,compact}_lists(...)) compiled by JAX, with the
    zero background row: uncompacted over [2T] (T = 256: 512 rows, the
    reference's B7 pack; T = 300: stacked and padded) and compacted at
    v_cap 512 (packed) and 520 (stacked)."""
    p, attrs, _mvp_j, _mvp_t, jch = soup
    T = p.shape[0] // 3
    a = attrs[:, :n_attrs]
    tch = {k: torch.from_numpy(v) for k, v in jch.items()}
    if form == "uncompacted":
        jt = jax.jit(lambda aa, ch: JR.build_plane_table(
            dict(ch), JR.clip_attrs_channel_lists(aa, dict(ch))))(
            jnp.asarray(a), jch)
        got = PT.plane_table(tch, tch, torch.from_numpy(a))
        n = 2 * T
    else:
        n = 512 if T == 256 else 520
        cch, cidx, n_valid = jax.jit(
            lambda ch: JR.compact_valid_ch(dict(ch), n))(jch)
        assert 100 < int(n_valid) < n
        jt = jax.jit(lambda aa, ch, c, ci: JR.build_plane_table(
            dict(c), JR.clip_attrs_compact_lists(aa, dict(ch), ci)))(
            jnp.asarray(a), jch, cch, cidx)
        tcch = {k: torch.from_numpy(np.array(v)) for k, v in cch.items()}
        got = PT.plane_table(tcch, tch, torch.from_numpy(a),
                             torch.from_numpy(np.array(cidx)))
    W = PT.table_width(n_attrs)
    want = np.concatenate([np.asarray(jt), np.zeros((1, W), np.float32)])
    assert tuple(got.shape) == want.shape == (n + 1, W)
    _same(got.numpy(), want, fold_zero=n % 512 == 0, what=form)
    assert np.isfinite(want[:-1]).mean() > 0.5
    assert (got[-1] == 0).all() and not torch.signbit(got[-1]).any()


def test_shade_planes_ch_takes_the_plane_table(soup):
    """shade_planes_ch shades the table of plane_table (its zero row
    included) as the reference shades build_plane_table's with the zero
    row appended: the same rgb, bit for bit."""
    from ascii_renderer_tpu_torch.backends import raster_common as RCM
    from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
    p, attrs, _mvp_j, _mvp_t, jch = soup
    tch = {k: torch.from_numpy(v) for k, v in jch.items()}
    scene = SceneBuilder().set_env_light([0.2, 0.2, 0.2], 1.0).add_point_light(
        [0.0, 1.0, -1.0], [1.0, 0.9, 0.8], 1.0).build(device="cpu")
    n = 2 * (p.shape[0] // 3)
    tid = torch.from_numpy(np.random.default_rng(1).integers(
        -1, n, (ROWS, COLS)).astype(np.int32))
    a = torch.from_numpy(attrs)
    rgb = R.shade_planes_ch(tid, tch, a, scene, ROWS, COLS)
    slots = R.clip_attrs_channel_lists(a, tch)
    table = R.build_plane_table(tch, slots)
    table = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    want = RCM.shade_from_table(tid, table, scene, ROWS, COLS, n_attrs=9)
    _same(rgb.numpy(), want.numpy())
