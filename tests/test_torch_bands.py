"""Row bands of the port (ROADMAP A12): the camera grids, the ray
tracer's frame (its jitted grid kernel's plain version), the path tracer
on the megakernel's plain version and on the XLA core, and the grouped
raster generations, each against the port's full frame and against the
JAX package's direct band calls (``row_lo`` / ``n_rows``, under
``jax.jit``; not its shard_map over virtual devices).

Tolerances:
- a band against the port's full frame: bit for bit (every path; the PT
  kernel path's rays carry their pixel's global uid);
- against JAX: the grids and the ray tracer's band bit for bit (as whole
  frames are in tests/test_torch_raytrace.py); PT bands to the PT
  contract, alpha exactly and rgb within 1e-5 (the kernel path against
  JAX's kernel path in interpret mode; the core against JAX's core band,
  whose threefry draws cover the band's shape); grouped raster bands
  within JAX's frame bound, at most 6 pixels over 2e-3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.atlas import io as JIO
from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.backends import raytrace as JRT
from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu.geom import meshes as JM
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.backends import raster as TR
from ascii_renderer_tpu_torch.backends import raytrace as TRT
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.ops import ray_grid as RYG
from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras
from ascii_renderer_tpu_torch.parallel.worlds import pt_fixture, soup_scene
from ascii_renderer_tpu_torch.scene import demo as TD

torch.set_num_threads(2)

LIGHT = (16.86, 10.76, 8.2)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _same(a, b):
    np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("pose", [dict(pos=(0, 2.5, 6), yaw=-np.pi / 2),
                                  dict(pos=(1.2, 0.7, 4.1), yaw=-1.9,
                                       pitch=0.21)])
def test_camera_grids_bands(pose):
    """primary_ray_dirs, ndc_grid(_jit), the PT centre-ray grid and the
    ray tracer's jitted grid: each band is the full grid's rows bit for
    bit, and primary_ray_dirs / primary_ray_grid's bands equal JAX's eager
    band calls bit for bit."""
    rows, cols = 24, 40
    tcam, jcam = TC.Camera.create(**pose), JC.Camera.create(**pose)
    full_d = TC.primary_ray_dirs(tcam, rows, cols, 0.5, device="cpu")
    full_g = TPT.primary_ray_grid(tcam, rows, cols, 0.5, device="cpu")
    bases = TC.camera_bases(tcam.yaw[None], tcam.pitch[None],
                            tcam.fov_y[None])
    full_j = RYG.ray_grid_jit(bases, rows, cols, 0.5, "cpu")
    for lo, n in ((0, 8), (8, 8), (16, 8), (5, 11)):
        d = TC.primary_ray_dirs(tcam, rows, cols, 0.5, row_lo=lo, n_rows=n,
                                device="cpu")
        _same(d, full_d[lo:lo + n])
        _same(d, JC.primary_ray_dirs(jcam, rows, cols, 0.5, row_lo=lo,
                                     n_rows=n))
        g = TPT.primary_ray_grid(tcam, rows, cols, 0.5, row_lo=lo,
                                 n_rows=n, device="cpu")
        jg = JPT.primary_ray_grid(jcam, rows, cols, 0.5, row_lo=lo,
                                  n_rows=n)
        for got, full, want in zip(g, full_g, jg):
            _same(got, full[lo:lo + n])
            _same(got, want)
        _same(RYG.ray_grid_jit(bases, rows, cols, 0.5, "cpu", lo, n),
              full_j[:, lo:lo + n])
        for grid in (TC.ndc_grid, TC.ndc_grid_jit):
            for a, b in zip(grid(rows, cols, 0.5, "cpu", lo, n)[:2],
                            grid(rows, cols, 0.5, "cpu")[:2]):
                _same(a, b[lo:lo + n])
    for bad in (dict(row_lo=20, n_rows=8), dict(row_lo=-1, n_rows=2),
                dict(row_lo=3)):
        with pytest.raises(ValueError):
            TC.primary_ray_dirs(tcam, rows, cols, 0.5, device="cpu", **bad)


@functools.lru_cache(maxsize=None)
def _jax_rt(rows, cols):
    return jax.jit(JRT.render_rgb, static_argnames=("rows", "cols",
                                                    "pixel_aspect", "n_rows"))


# rgb values of the scene camera's 24 x 40 bands (lo, n) that are not
# bit-identical to JAX's jitted band call (JAX 0.9.0 on the CPU). The port's
# band is its full frame's rows, which equal JAX's jitted full frame bit
# for bit (tests/test_torch_raytrace.py); XLA's band program rounds the
# cell centres apart from its full one: with the rows sliced out of the
# grid, y / rows becomes y * (1 / rows), rounded, then 2 y' - 1, where the
# full grid fuses fma(y, 2 / rows, -1). The band's directions differ, and
# so do its rgb values at these counts, within JAX's own 1e-4 for a
# sharded frame (tests/test_parallel.py:61).
RT_BAND_APART = {(0, 8): 0, (8, 8): 160, (16, 8): 65, (3, 13): 160}


def test_raytrace_bands():
    """render_rgb's bands, for one camera and a batch of three orbit
    views: the full frame's rows bit for bit. Against JAX's jitted band
    calls of the scene camera: within 1e-4, the values not bit-identical
    counted (RT_BAND_APART)."""
    rows, cols = 24, 40
    ts = TD.create_rt_demo_scene().build(device="cpu")
    js = JD.create_rt_demo_scene().build()
    full = TRT.render_rgb(ts, ts.camera, rows, cols, 0.5)
    cams = orbit_cameras(3, center=(0, 1.0, 1.0))
    fullv = TRT.render_rgb(ts, cams, rows, cols, 0.5)
    fn = _jax_rt(rows, cols)
    _same(full, fn(js, js.camera, rows=rows, cols=cols, pixel_aspect=0.5))
    for lo, n in RT_BAND_APART:
        band = TRT.render_rgb(ts, ts.camera, rows, cols, 0.5, row_lo=lo,
                              n_rows=n)
        _same(band, full[lo:lo + n])
        want = fn(js, js.camera, rows=rows, cols=cols, pixel_aspect=0.5,
                  row_lo=jnp.int32(lo), n_rows=n)
        apart = int((_bits(band) != _bits(want)).sum())
        print(f"RT band ({lo}, {n}): {apart} rgb values apart from JAX's")
        assert apart <= RT_BAND_APART[(lo, n)]
        np.testing.assert_allclose(band.numpy(), want, atol=1e-4, rtol=0)
        _same(TRT.render_rgb(ts, cams, rows, cols, 0.5, row_lo=lo,
                             n_rows=n), fullv[:, lo:lo + n])


def _pt_scenes():
    jsb = JD.create_demo_scene()
    jsb.set_atlas(JIO.demo_atlas())
    ts, tcam, kw = pt_fixture("cpu")
    return jsb.build(min_pad=1), ts, tcam, kw


@functools.lru_cache(maxsize=None)
def _jax_pt(rows, cols, n_rows, use_kernel, active):
    js, _ts, _c, kw = _pt_scenes()
    cam = JC.Camera.create(pos=(0, 2.5, 6), yaw=-np.pi / 2)

    def one(row_lo, key, pa):
        return JPT.render_pt(js, cam, 0.0, jax.random.key(key), rows=rows,
                             cols=cols, use_kernel=use_kernel, row_lo=row_lo,
                             n_rows=n_rows, pixel_active=pa if active
                             else None, **kw)
    fn = jax.jit(one, static_argnums=1)
    return lambda lo, key, pa=None: [np.asarray(x) for x in fn(
        jnp.int32(lo), key, pa)]


def test_pathtrace_kernel_path_bands():
    """render_pt on the megakernel's plain version: every band (and a
    band under pixel_active's compaction, at its active pixels) is the
    full frame's rows bit for bit, rgb and alpha; against JAX's kernel
    path band (interpret mode): alpha exactly, rgb within 1e-5."""
    rows, cols, n = 16, 32, 8
    _js, ts, tcam, kw = _pt_scenes()
    rgb, a = TPT.render_pt(ts, tcam, 0.0, 3, rows=rows, cols=cols, **kw)
    assert int(((a >= 2) & (a <= 254)).sum()) > 5
    jfn = _jax_pt(rows, cols, n, True, False)
    for lo in (0, 8, 5):
        br, ba = TPT.render_pt(ts, tcam, 0.0, 3, rows=rows, cols=cols,
                               row_lo=lo, n_rows=n, **kw)
        _same(br, rgb[lo:lo + n])
        assert torch.equal(ba, a[lo:lo + n])
        if lo != 5:
            jr, ja = jfn(lo, 3)
            np.testing.assert_array_equal(ba.numpy(), ja)
            np.testing.assert_allclose(br.numpy(), jr, atol=1e-5, rtol=0)
    act = torch.from_numpy(np.random.default_rng(1).random((n, cols)) < 0.3)
    cr, ca = TPT.render_pt(ts, tcam, 0.0, 3, rows=rows, cols=cols, row_lo=8,
                           n_rows=n, pixel_active=act, **kw)
    _same(cr[act], rgb[8:16][act])
    assert torch.equal(ca[act], a[8:16][act])


def test_pathtrace_core_bands():
    """render_pt's XLA core (use_kernel=False) over a band draws its
    threefry jitter and paths over the band's shape, as JAX's core band
    does: alpha exactly and rgb within 1e-5 of JAX's band call; the band
    [0, rows) is the full frame bit for bit."""
    rows, cols, n = 16, 32, 8
    _js, ts, tcam, kw = _pt_scenes()
    key = np.asarray([0, 3], np.uint32)
    jfn = _jax_pt(rows, cols, n, False, False)
    for lo in (0, 8):
        br, ba = TPT.render_pt(ts, tcam, 0.0, key=key, rows=rows, cols=cols,
                               use_kernel=False, row_lo=lo, n_rows=n, **kw)
        jr, ja = jfn(lo, 3)
        np.testing.assert_array_equal(ba.numpy(), ja)
        np.testing.assert_allclose(br.numpy(), jr, atol=1e-5, rtol=0)
    fr, fa = TPT.render_pt(ts, tcam, 0.0, key=key, rows=rows, cols=cols,
                           use_kernel=False, **kw)
    wr, wa = TPT.render_pt(ts, tcam, 0.0, key=key, rows=rows, cols=cols,
                           use_kernel=False, row_lo=0, n_rows=rows, **kw)
    _same(wr, fr)
    assert torch.equal(wa, fa)


def _jax_soup():
    v, i = JM.uv_sphere(12, 16, radius=1.2, center=(0.0, 1.0, 0.0))
    soup = tuple(jnp.asarray(x) for x in JM.mesh_to_soup(
        v, i, color=(0.8, 0.5, 0.4)))
    sb = JSB().set_env_light([0.2, 0.22, 0.25], 1.0)
    sb.add_dir_light([-0.5, -0.7, -0.6], [1, 1, 1], 0.9)
    cam = JC.Camera.create(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)
    return soup, sb.build(), cam


@pytest.mark.parametrize("kernel", ["subtile3", "subtile5", "subtile6",
                                    "subtile7", "subtile8", "packed"])
def test_raster_grouped_bands(kernel):
    """render_soup_diag's direct bands of every grouped generation but
    subtile4 (and subtile8 with the fused setup+pack): each band the full
    frame's rows bit for bit, with the band's own diag counts; subtile3,
    subtile6 and subtile8 bands within JAX's frame bound of JAX's direct
    band call (jitted, row_lo traced)."""
    rows, cols, n = 64, 96, 16
    soup, scene, cam, caps = soup_scene("cpu")
    gen = "subtile8" if kernel == "packed" else kernel
    kw = dict(v_cap=4096, kernel=gen, **caps)
    TR.SETUP_PACKED = kernel == "packed"
    try:
        full, fd = TR.render_soup_diag(*soup, scene, cam, rows, cols, 0.5,
                                       **kw)
        bands = []
        for lo in range(0, rows, n):
            b, d = TR.render_soup_diag(*soup, scene, cam, rows, cols, 0.5,
                                       row_lo=lo, band_rows=n, tile_cap=16,
                                       **kw)
            _same(b, full[lo:lo + n])
            assert int(d["n_valid"]) == int(fd["n_valid"])
            assert int(d["n_pairs"]) <= int(fd["n_pairs"])
            bands.append((lo, b.numpy(), int(d["n_pairs"])))
    finally:
        TR.SETUP_PACKED = False
    assert sum(p for _l, _b, p in bands) >= int(fd["n_pairs"])
    assert (full.amax(-1) > 0).sum() > 500
    if kernel not in ("subtile3", "subtile6", "subtile8"):
        return
    jsoup, jscene, jcam = _jax_soup()
    fn = jax.jit(lambda lo: JR.render_soup_diag(
        *jsoup, jscene, jcam, rows, cols, 0.5, tile_cap=16, row_lo=lo,
        band_rows=n, **kw)[0])
    for lo, b, _p in bands:
        d = np.abs(b - np.asarray(fn(jnp.int32(lo)))).max(-1)
        assert (d > 2e-3).sum() <= 6, (kernel, lo, int((d > 2e-3).sum()))


def test_raster_band_arguments():
    """A band goes only to the grouped kernels but subtile4 (JAX asserts
    for subtile4 and renders the full frame for the others; the port
    raises ValueError), in TILE_H multiples inside the frame; a row_lo
    without band_rows raises, and row_lo 0 alone is the full frame."""
    soup, scene, cam, caps = soup_scene("cpu")
    args = (*soup, scene, cam, 32, 48, 0.5)
    for kernel in ("mm", "loop", "subtile", "subtile2", "subtile4"):
        with pytest.raises(ValueError, match="grouped kernels"):
            TR.render_soup_diag(*args, v_cap=4096, kernel=kernel, row_lo=8,
                                band_rows=8, **caps)
    for band in (dict(row_lo=4, band_rows=8), dict(row_lo=0, band_rows=12),
                 dict(row_lo=24, band_rows=16), dict(row_lo=8)):
        with pytest.raises(ValueError):
            TR.render_soup_diag(*args, v_cap=4096, kernel="subtile8",
                                **band, **caps)
    full, _d = TR.render_soup_diag(*args, v_cap=4096, kernel="subtile8",
                                   **caps)
    zero, _d = TR.render_soup_diag(*args, v_cap=4096, kernel="subtile8",
                                   row_lo=0, **caps)
    _same(zero, full)
