"""X4's table form on the CPU: ``ops/raster_clip.clip_screen_table``, the
uncompacted path's clip, screen setup and plane table in one launch on the
card, whose plain version is ``clip_screen_ref`` followed by
``plane_table_ref`` over the attributes [normals, colors, positions].

On CPU tensors the wrapper is that plain chain, and it equals the JAX
package's compiled chain (``transform_clip_channels[9]``,
``setup_screen_channels``, ``clip_attrs_channel_lists``,
``build_plane_table`` and the zero row; ``jax.jit`` on the CPU backend)
bit for bit, on seeded soups at the near plane in which every clip case
occurs, at 2T a multiple of 512 (the reference's B7 pack, which drops the
sign of zero: only there -0.0 is folded into +0.0) and not.
``render_soup``'s binned walk takes it, and its frames stay equal to
JAX's. The kernel itself is held to this plain version on the card
(``tests/test_torch_build_xla.py``, ``chip_smoke.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_channels as RCH
from ascii_renderer_tpu_torch.core import quantize as Q
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import plane_table as PT
from ascii_renderer_tpu_torch.ops import raster_clip as RCL
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder as TSB
from ascii_renderer_tpu_torch.tools.xla_inputs import (FRONT_CAM,
                                                       front_soup,
                                                       shade_builder)

torch.set_num_threads(2)

ROWS, COLS = 36, 96


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


def _mvp():
    return R.camera_mvp(Camera.create(**FRONT_CAM), ROWS, COLS, 0.5)


def _soup(T, seed):
    """(positions, normals, colors) f32 numpy of a front_soup of T
    triangles: unit normals and colours in [0, 1] from its attributes."""
    p, a = front_soup(T, _mvp().numpy(), seed=seed)
    n = a[:, :3] / np.linalg.norm(a[:, :3], axis=1, keepdims=True)
    return p, n.astype(np.float32), np.abs(a[:, 3:6])


def _src(p, layout):
    t = torch.from_numpy(p)
    return R.positions_to_pos9(t) if layout == "pos9" else t


@pytest.mark.parametrize("layout", ["positions", "pos9"])
@pytest.mark.parametrize("T", [1, 255, 256, 300])
def test_table_form_cpu_is_the_plain_chain(T, layout):
    """On CPU tensors clip_screen_table is clip_screen_ref, then
    plane_table_ref of the uncompacted dict over [normals, colors,
    positions] (pos9's rows turned back into positions exactly): the dict
    and the [2T + 1, 32] table bit for bit, the background row +0.0."""
    p, n, c = _soup(T, seed=T)
    src = _src(p, layout)
    mvp = _mvp()
    ch, table = RCL.clip_screen_table(src, torch.from_numpy(n),
                                      torch.from_numpy(c), mvp, ROWS, COLS,
                                      pos9=layout == "pos9")
    want_ch = RCL.clip_screen_ref(src, mvp, ROWS, COLS,
                                  pos9=layout == "pos9")
    attrs = torch.from_numpy(np.concatenate([n, c, p], axis=1))
    want = PT.plane_table_ref(want_ch, want_ch, attrs)
    assert list(ch) == list(want_ch)
    for k, v in want_ch.items():
        _same(ch[k].numpy(), v.numpy(), what=k)
    assert tuple(table.shape) == (2 * T + 1, RCL.TABLE_WIDTH)
    assert RCL.TABLE_WIDTH == PT.table_width(RCL.TABLE_ATTRS)
    _same(table.numpy(), want.numpy(), what="table")
    assert (table[-1] == 0).all() and not torch.signbit(table[-1]).any()
    assert torch.equal(RCL.pos9_to_positions(R.positions_to_pos9(
        torch.from_numpy(p))), torch.from_numpy(p))


@pytest.fixture(scope="module", params=[256, 300], ids=["2T_512", "2T_600"])
def jax_front(request):
    """A near-plane soup of T triangles and the JAX package's compiled
    clip dicts (both vertex layouts) and uncompacted plane table with its
    zero row, over [normals, colors, positions]."""
    T = request.param
    p, n, c = _soup(T, seed=T + 1)
    mvp_j = jax.jit(lambda cam: JR.camera_mvp(cam, ROWS, COLS, 0.5))(
        JCam.create(**FRONT_CAM))
    np.testing.assert_array_equal(np.asarray(mvp_j), _mvp().numpy())
    attrs = jnp.asarray(np.concatenate([n, c, p], axis=1))

    def clip(src, mm, pos9):
        return JR.setup_screen_channels(
            (JR.transform_clip_channels9 if pos9
             else JR.transform_clip_channels)(src, mm), ROWS, COLS)

    def table(aa, ch, stacked=False):
        slots = JR.clip_attrs_channel_lists(aa, dict(ch))
        ch = dict(ch)
        if stacked:  # one more row: the stack, not the pack, at any 2T
            ch = {k: jnp.concatenate([v, v[:1]]) for k, v in ch.items()}
            slots = [[jnp.concatenate([x, x[:1]]) for x in s]
                     for s in slots]
        t = JR.build_plane_table(ch, slots)[:2 * T]
        return jnp.concatenate([t, jnp.zeros((1, t.shape[1]), t.dtype)])

    out = {}
    for layout in ("positions", "pos9"):
        src = (JR.positions_to_pos9(jnp.asarray(p)) if layout == "pos9"
               else jnp.asarray(p))
        # compiled as the suite's own front-end tests compile them: the
        # clip, then the table from its dict
        ch = jax.jit(functools.partial(clip, pos9=layout == "pos9"))(
            src, mvp_j)
        out[layout] = ({k: np.array(v) for k, v in ch.items()},
                       np.array(jax.jit(table)(attrs, ch)),
                       np.array(jax.jit(functools.partial(
                           table, stacked=True))(attrs, ch)))
    return (p, n, c), out


@pytest.mark.parametrize("layout", ["positions", "pos9"])
def test_table_form_equals_jax(jax_front, layout):
    """clip_screen_table's dict and table equal JAX's compiled
    setup_screen_channels(transform_clip_channels[9](...)) and
    build_plane_table(ch, clip_attrs_channel_lists(...)) with the zero
    row: keys, dtypes and bits, NaN in the same places. Every clip case
    occurs. Where 2T is a multiple of 512 the reference packs the table
    with B7's MXU transpose, an identity product that drops the sign of
    zero and spreads a non-finite value over its column's 128-row block:
    the table is held bit for bit to the reference's stacked planes (its
    table one row longer), and to the packed table with -0.0 folded
    wherever the column's block is finite."""
    (p, n, c), out = jax_front
    jch, jtable, jstacked = out[layout]
    T = p.shape[0] // 3
    ch, table = RCL.clip_screen_table(
        _src(p, layout), torch.from_numpy(n), torch.from_numpy(c), _mvp(),
        ROWS, COLS, pos9=layout == "pos9")
    assert set(ch) == set(jch)
    for k, want in jch.items():
        _same(ch[k].numpy(), want, what=k)
    assert {0, 1, 2, 3} <= set(ch["n_in"].tolist())  # every clip case
    assert 0 < int(ch["valid"].sum()) < 2 * T
    got = table.numpy()
    _same(got, jstacked, what="table")
    if (2 * T) % 512:
        _same(got, jtable, what="table")
    else:  # the pack's blocks of 128 rows whose column is finite
        fin = np.isfinite(got[:-1]).reshape(-1, 128, got.shape[1]).all(1)
        keep = np.concatenate([np.repeat(fin, 128, axis=0),
                               np.ones((1, got.shape[1]), bool)])
        assert keep.mean() > 0.75
        _same(got[keep], jtable[keep], fold_zero=True, what="packed table")
    assert np.isfinite(jtable[:-1]).mean() > 0.5


@pytest.mark.parametrize("method", ["scatter", "scatter_loop"])
@pytest.mark.parametrize("T", [256, 300], ids=["2T_512", "2T_600"])
def test_scatter_frame_takes_the_table_form_and_equals_jax(monkeypatch, T,
                                                           method):
    """render_soup's binned walk takes its clip, setup and table from one
    clip_screen_table call (no plane_table call; the shade reads that
    table), and its frame of a near-plane soup under a directional and two
    point lights equals JAX's render_soup: every quantized byte, the
    floats within 2.5e-7 (the file of the demo room's frames holds them
    so)."""
    p, n, c = _soup(T, seed=T + 2)
    calls = []
    for mod, name in ((RCL, "clip_screen_table"), (RCL, "clip_screen"),
                      (PT, "plane_table")):
        def rec(*a, _real=getattr(mod, name), _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    scene = shade_builder(TSB, True, 2).build(device="cpu")
    got = R.render_soup(torch.from_numpy(p), torch.from_numpy(n),
                        torch.from_numpy(c), scene, Camera.create(
                            **FRONT_CAM), ROWS, COLS, 0.5, method=method)
    assert calls == ["clip_screen_table"]
    jscene = shade_builder(JSB, True, 2).build()
    want = np.array(jax.jit(functools.partial(
        JR.render_soup, rows=ROWS, cols=COLS, pixel_aspect=0.5,
        method=method))(jnp.asarray(p), jnp.asarray(n), jnp.asarray(c),
                        jscene, JCam.create(**FRONT_CAM)))
    assert tuple(got.shape) == want.shape == (ROWS, COLS, 3)
    np.testing.assert_array_equal(
        Q.float_rgb_to_u8(got).numpy(),
        Q.float_rgb_to_u8(torch.from_numpy(want)).numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-7)
    assert (got.numpy().max(-1) > 0).sum() > 100


def test_shade_planes_ch_takes_the_finished_table():
    """shade_planes_ch(table=) shades the table it is given (A = 9) as
    it shades the one plane_table builds from the same dict and
    attributes: the same rgb, bit for bit."""
    p, n, c = _soup(300, seed=9)
    ch, table = RCL.clip_screen_table(torch.from_numpy(p),
                                      torch.from_numpy(n),
                                      torch.from_numpy(c), _mvp(), ROWS,
                                      COLS)
    scene = shade_builder(TSB, True, 3).build(device="cpu")
    tid = torch.from_numpy(np.random.default_rng(3).integers(
        -1, 600, (ROWS, COLS)).astype(np.int32))
    attrs = torch.from_numpy(np.concatenate([n, c, p], axis=1))
    got = RCH.shade_planes_ch(tid, ch, None, scene, ROWS, COLS, table=table)
    want = RCH.shade_planes_ch(tid, ch, attrs, scene, ROWS, COLS)
    _same(got.numpy(), want.numpy())


def _meta_inputs(T=40):
    p, n, c = _soup(T, seed=5)
    meta = torch.device("meta")
    return tuple(torch.from_numpy(x).to(meta) for x in (p, n, c))


@pytest.mark.parametrize("case", ["positions", "pos9", "normals_short",
                                  "colors_f64", "src_f64"])
def test_table_form_never_falls_back(monkeypatch, case):
    """Tensors that are not on the CPU reach the kernel path, whose checks
    raise ValueError for anything but float32 CUDA tensors of the shapes
    the kernel takes; no call reaches the plain version and nothing
    launches."""
    p, n, c = _meta_inputs()
    calls = []
    monkeypatch.setattr(RCL, "clip_screen_table_ref",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(RCL, "launches", 0)
    monkeypatch.setattr(RCL, "launches_table", 0)
    src, pos9 = p, False
    if case == "pos9":
        src, pos9 = R.positions_to_pos9(p), True
    elif case == "normals_short":
        n = n[:-3]
    elif case == "colors_f64":
        c = c.double()
    elif case == "src_f64":
        src = p.double()
    with pytest.raises(ValueError):
        RCL.clip_screen_table(src, n, c, _mvp(), ROWS, COLS, pos9=pos9)
    assert calls == []
    assert (RCL.launches, RCL.launches_table) == (0, 0)


class _FailingLib:
    """A kernel library whose every launch reports a CUDA error."""

    def __getattr__(self, name):
        return lambda *args: 700  # cudaErrorIllegalAddress


def test_table_form_raises_on_build_or_launch_failure(monkeypatch):
    """Past the device checks, a failed build and a failed launch each
    raise out of clip_screen_table; it never falls back to the plain
    version. The failed launch is counted as X4's and as the table
    form's."""
    p, n, c = _meta_inputs()
    calls = []
    monkeypatch.setattr(RCL, "clip_screen_table_ref",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(RCL, "launches", 0)
    monkeypatch.setattr(RCL, "launches_table", 0)
    monkeypatch.setattr(_build, "require_cuda", lambda *t, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)

    def no_build():
        raise RuntimeError("nvcc failed")

    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        with pytest.raises(RuntimeError, match=match):
            RCL.clip_screen_table(p, n, c, _mvp(), ROWS, COLS)
    assert calls == []
    assert (RCL.launches, RCL.launches_table) == (1, 1)
