"""Square roots of the port against the reference's (ROADMAP C4).

torch's CPU float32 ``sqrt`` is not always correctly rounded: on MKL's
AVX-512 path a fraction of a percent of inputs come out an ulp off (its
AVX2 path rounds them right), while XLA's float32 ``sqrt`` and CUDA's
``sqrtf`` are correctly rounded. Every site of the port takes its root
through ``core/fp.sqrt32`` (float64, rounded once). Each test below draws
seeded inputs with numpy, takes first those on which torch's float32
``sqrt`` misrounds (filling up with the others, so the test runs on any
CPU) and holds the site's function against its JAX counterpart (JAX on
its CPU backend) bit for bit. Where torch misrounds at all
(``_torch_misrounds``), the tests also require that such inputs were
found and, where the site's output moves with the root, that the
parent's arithmetic (torch's float32 ``sqrt`` put back in the module)
misses JAX on them.

Where a function also rounds elsewhere as the reference does not, the
inputs keep that arithmetic exact and leave the root as the one rounding
that matters: the camera's sums of squares (the port adds its squares
apart, JAX's ``jnp.linalg.norm`` fuses them) take components with few
significant bits, and ``shade_visibility`` takes triangles at w = 1 whose
attributes sit on one vertex."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.atlas import io as JIO
from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.backends import raster_channels as JRC
from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu.ops import pt_kernel as JPK
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu_torch.atlas import io as TIO
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.backends import pt_core as PC
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_channels as RC
from ascii_renderer_tpu_torch.backends import raytrace as TRT
from ascii_renderer_tpu_torch.backends import rt_core as RTC
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.core import color as TCO
from ascii_renderer_tpu_torch.core.fp import fma32, sqrt32, sqrt32_scalar
from ascii_renderer_tpu_torch.geom import intersect as TG
from ascii_renderer_tpu_torch.ops import accum as TA
from ascii_renderer_tpu_torch.ops import pt_kernel as TPK
from ascii_renderer_tpu_torch.scene import demo as TD
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder as TSB

torch.set_num_threads(2)


def _misrounds(x) -> np.ndarray:
    """Where torch's CPU float32 sqrt of x is not the correctly rounded
    root (numpy's float64 root rounded once)."""
    x = np.ascontiguousarray(x, np.float32)
    good = np.sqrt(x.astype(np.float64)).astype(np.float32)
    return torch.sqrt(torch.from_numpy(x)).numpy().view(np.int32) != \
        good.view(np.int32)


def _torch_misrounds() -> bool:
    """Whether torch's CPU float32 sqrt misrounds here at all."""
    x = np.random.default_rng(99).uniform(0, 100, 100_000)
    return bool(_misrounds(x).any())


def _first(mask: np.ndarray, n: int) -> np.ndarray:
    """Indices of n drawn inputs, those where ``mask`` holds first."""
    return np.argsort(~mask, kind="stable")[:n]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def test_fp_sqrt32_is_the_correctly_rounded_root():
    """``sqrt32`` equals JAX's float32 root everywhere; torch's float32
    root misses it exactly where ``_misrounds`` says."""
    x = np.random.default_rng(0).uniform(0, 100, 200_000).astype(np.float32)
    want = _bits(jnp.sqrt(x))
    np.testing.assert_array_equal(_bits(sqrt32(torch.from_numpy(x))), want)
    off = _misrounds(x)
    np.testing.assert_array_equal(
        _bits(torch.sqrt(torch.from_numpy(x))) != want, off)
    assert off.sum() > 300 or not _torch_misrounds()


def test_camera_norm_equals_jax():
    """``camera._norm3`` (the basis' norms) against ``jnp.linalg.norm``:
    components k / 32 with |k| < 2^11, so every square and sum is exact."""
    rng = np.random.default_rng(1)
    a = (rng.integers(-2047, 2048, (3, 40_000)) / 32).astype(np.float32)
    s = (a[0] * a[0] + a[1] * a[1]) + a[2] * a[2]
    off = _misrounds(s)
    keep = _first(off, 200)
    assert off[keep].all() or not _torch_misrounds()
    got = TC._norm3(torch.from_numpy(np.ascontiguousarray(a[:, keep])))
    want = _bits(jnp.linalg.norm(jnp.asarray(a[:, keep]), axis=0))
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    parent = torch.sqrt(torch.from_numpy(s[keep])).numpy()
    np.testing.assert_array_equal(_bits(parent) != want, off[keep])


def test_color_normalize_equals_jax(monkeypatch):
    """``color.normalize`` against JAX's (``jnp.linalg.norm``, then the
    division) on [N, 3] vectors of components k / 32 with |k| < 2^11, so
    every square and sum is exact and the root is the one rounding that
    can differ; with torch's float32 sqrt put back the misrounded roots
    move the output."""
    from ascii_renderer_tpu.core import color as JCO
    rng = np.random.default_rng(6)
    v = (rng.integers(-2047, 2048, (40_000, 3)) / 32).astype(np.float32)
    s = (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
    off = _misrounds(s)
    keep = _first(off, 200)
    assert off[keep].all() or not _torch_misrounds()
    x = torch.from_numpy(np.ascontiguousarray(v[keep]))
    want = _bits(JCO.normalize(jnp.asarray(v[keep])))
    np.testing.assert_array_equal(_bits(TCO.normalize(x)), want)
    monkeypatch.setattr(TCO, "sqrt32", torch.sqrt)
    moved = (_bits(TCO.normalize(x)) != want).any(axis=1)
    assert moved.any() or not _torch_misrounds()


def test_ray_grid_equals_jax(monkeypatch):
    """``primary_ray_dirs`` (``camera.ray_dirs``) against JAX's at the pose
    whose basis is the axes (yaw = pitch = 0), on an 8 x 16 grid of aspect
    1: each cell's jitter (a multiple of 2^-10) is the first of a seeded
    list of 2,000 whose sum of squares torch's float32 sqrt misrounds (the
    list's first where none does)."""
    rows, cols = 8, 16
    jcam = JC.Camera.create(pos=(1, 2, 3), yaw=0.0, pitch=0.0)
    tcam = TC.Camera.create(pos=(1, 2, 3), yaw=0.0, pitch=0.0)
    focal = TC.camera_basis(tcam.yaw, tcam.pitch, tcam.fov_y)[3].numpy()
    px, py, aspect = (np.asarray(v) for v in TC.ndc_grid(rows, cols, 0.5,
                                                         "cpu"))
    assert aspect == 1.0
    rng = np.random.default_rng(2)
    cand = (rng.integers(-51, 52, (2000, rows, cols, 2)) / 1024).astype(
        np.float32)
    cx, cy = px + cand[..., 0], py + cand[..., 1]
    # the ray is (focal, py, px): squares of 11-bit values are exact
    s = (focal * focal + cy * cy) + cx * cx
    off = _misrounds(s)
    cell_off = off.any(0)
    assert cell_off.mean() > 0.9 or not _torch_misrounds()
    jitter = np.take_along_axis(cand, off.argmax(0)[None, ..., None],
                                0)[0]
    want = np.asarray(JC.primary_ray_dirs(jcam, rows, cols, 0.5,
                                          jnp.asarray(jitter)))

    def dirs():
        return TC.primary_ray_dirs(tcam, rows, cols, 0.5,
                                   torch.from_numpy(jitter),
                                   device="cpu").numpy()

    np.testing.assert_array_equal(_bits(dirs()), _bits(want))
    monkeypatch.setattr(TC, "sqrt32", torch.sqrt)
    moved = (_bits(dirs()) != _bits(want)).any(-1)
    assert not moved[~cell_off].any()
    assert moved[cell_off].mean() > 0.5 or not cell_off.any()


def test_raster_look_at_normalise_equals_jax(monkeypatch):
    """``raster.look_at`` (its ``_normalize``, under ``camera_mvp``)
    against the reference's jitted ``look_at`` on 40 eyes and centres,
    first those whose |center - eye|^2 torch's float32 sqrt misrounds."""
    rng = np.random.default_rng(3)
    eye = rng.uniform(-5, 5, (20_000, 3)).astype(np.float32)
    cen = rng.uniform(-5, 5, (20_000, 3)).astype(np.float32)
    f = torch.from_numpy(cen - eye)
    # f . f as _normalize's _matmul sums it
    d2 = fma32(f[:, 2], f[:, 2], fma32(f[:, 1], f[:, 1], f[:, 0] * f[:, 0]))
    off = _misrounds(d2.numpy())
    keep = _first(off, 40)
    assert off[keep].all() or not _torch_misrounds()
    up = np.float32([0, 1, 0])
    look_at = jax.jit(JR.look_at)
    n_parent_off = 0
    for i in keep:
        want = _bits(look_at(jnp.asarray(eye[i]), jnp.asarray(cen[i]),
                             jnp.asarray(up)))
        args = [torch.from_numpy(v) for v in (eye[i], cen[i], up)]
        np.testing.assert_array_equal(_bits(R.look_at(*args)), want)
        with monkeypatch.context() as m:  # the root torch's float32 takes
            m.setattr(TC, "sqrt32_scalar", lambda x: float(torch.sqrt(
                torch.tensor(x, dtype=torch.float32))))
            n_parent_off += not np.array_equal(_bits(R.look_at(*args)), want)
    assert n_parent_off >= off[keep].sum() // 2


def _light_scenes():
    out = []
    for builder, kw in ((JSB, {}), (TSB, {"device": "cpu"})):
        sb = builder().set_env_light([0.15, 0.15, 0.2], 1.0)
        sb.add_dir_light([-0.5, -0.7, -0.6], [1, 1, 1], 0.9)
        sb.add_point_light([1.0, 2.0, 1.0], [1.0, 0.9, 0.8], 1.0)
        sb.add_point_light([-1.0, 0.5, 2.0], [0.5, 0.9, 0.8], 1.0)
        out.append(sb.build(**kw))
    return out


def test_shade_visibility_equals_jax(monkeypatch):
    """``raster_channels.shade_visibility`` (unit normal and point-light
    directions) against the reference's jitted pass on a 24 x 40 grid,
    two point lights: each pixel takes the first of 60 seeded triangles
    whose shading the parent's float32 sqrt changes (the first where none
    does)."""
    rows, cols, T, K = 24, 40, 50, 60
    rng = np.random.default_rng(4)
    clip = (rng.integers(-64, 65, (T, 3, 4)) / 64).astype(np.float32)
    clip[..., 3] = 1.0
    attrs = rng.uniform(-1, 1, (T, 3, 9)).astype(np.float32)
    attrs[:, 1:] = 0.0
    jscene, tscene = _light_scenes()
    tc, ta = torch.from_numpy(clip), torch.from_numpy(attrs)

    def shade(tid, root):
        with monkeypatch.context() as m:
            m.setattr(RC, "sqrt32", root)
            return RC.shade_visibility(torch.from_numpy(tid), tc, ta, tscene,
                                       rows, cols).numpy()

    layers = rng.integers(0, T, (K, rows, cols)).astype(np.int32)
    moved = np.stack([(_bits(shade(t, sqrt32)) != _bits(shade(
        t, torch.sqrt))).any(-1) for t in layers])
    chosen = moved.any(0)
    chosen[0, :5] = False
    assert chosen.mean() > 0.1 or not _torch_misrounds()
    tid = np.take_along_axis(layers, moved.argmax(0)[None], 0)[0]
    tid[0, :5] = -1  # background
    want = np.asarray(jax.jit(functools.partial(
        JRC.shade_visibility, rows=rows, cols=cols))(
            jnp.asarray(tid), jnp.asarray(clip), jnp.asarray(attrs), jscene))
    np.testing.assert_array_equal(_bits(shade(tid, sqrt32)), _bits(want))
    parent = _bits(shade(tid, torch.sqrt))
    np.testing.assert_array_equal((parent != _bits(want)).any(-1), chosen)


def test_b5_plain_version_equals_jax_kernel(monkeypatch):
    """B5's plain version (``trace_blocks_raw_ref``) against the Pallas
    kernel in interpret mode on one block of 1,024 rays, 2 bounces without
    NEE (no transcendental of XLA's in the result): the rays, with their
    uids, are drawn from 32 seeded blocks, those first one of whose roots
    (sphere tests, the BRDF and specular directions) torch's float32 sqrt
    misrounds. All five outputs bit for bit."""
    jsb, tsb = JD.create_demo_scene(), TD.create_demo_scene()
    jsb.set_atlas(JIO.demo_atlas())
    tsb.set_atlas(TIO.demo_atlas())
    js, ts = jsb.build(min_pad=1), tsb.build(min_pad=1, device="cpu")
    rng = np.random.default_rng(5)
    n = 32 * TPK.BLOCK
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5  # towards the poster wall
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ro = np.tile(np.float32([0, 2.5, 5.2]), (n, 1))
    tp = TPT.pack_scene_entries(ts)
    lc, lr = TPT.get_light_sphere(ts, 0.0)
    params = TPT._params(lc, lr, torch.tensor([16.86, 10.76, 8.2]) * 1.3,
                         "cpu")
    kw = dict(bounces=2, nee=False, atlas_w=tp[2], atlas_h=tp[3],
              sph_rows=tp[4])
    off = np.zeros(n, bool)

    def record(x):
        if x.shape[-1] == off.size:
            off[:] |= _misrounds(x.numpy()).reshape(-1, off.size).any(0)
        return sqrt32(x)

    monkeypatch.setattr(TPK, "sqrt32", record)
    TPK.trace_blocks_raw_ref(params, tp[0], torch.from_numpy(ro).reshape(
        -1, 8, 128, 3), torch.from_numpy(rd).reshape(-1, 8, 128, 3), 9,
        tp[1], **kw)
    monkeypatch.setattr(TPK, "sqrt32", sqrt32)
    keep = np.sort(_first(off, TPK.BLOCK))
    assert off[keep].all() or not _torch_misrounds()
    uid = keep.astype(np.int32).reshape(1, 8, 128)
    ro_k, rd_k = ro[keep].reshape(1, 8, 128, 3), rd[keep].reshape(1, 8, 128,
                                                                  3)
    jp = JPT.pack_scene_entries(js)
    want = JPK.trace_blocks_raw(
        jnp.asarray(params.numpy()), jp[0], jnp.asarray(ro_k),
        jnp.asarray(rd_k), 9, jp[1], interpret=True, uid=jnp.asarray(uid),
        **kw)
    got = TPK.trace_blocks_raw(params, tp[0], torch.from_numpy(ro_k),
                               torch.from_numpy(rd_k), 9, tp[1],
                               uid=torch.from_numpy(uid), **kw)
    for name, g, w in zip(("lor", "log", "lob", "ov", "fet"), got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                      err_msg=name)
    assert (got[0].numpy() > 0).sum() > 50  # the paths gathered light


@pytest.mark.parametrize("module", [RC, R, TC, TPK, TPT, PC, RTC, TRT, TG,
                                    TA, TCO])
def test_every_site_takes_the_shared_root(module):
    """No site of these modules takes torch's float32 sqrt directly: each
    root is the shared one, on tensors or on Python floats (directly or
    through camera.norm3)."""
    assert "torch.sqrt(" not in inspect.getsource(module)
    shared = (sqrt32, sqrt32_scalar, TC.norm3)
    roots = [getattr(module, n, None) for n in ("sqrt32", "sqrt32_scalar",
                                                "norm3")]
    assert any(r is s for r, s in zip(roots, shared))
    assert all(r is None or r is s for r, s in zip(roots, shared))
