"""Port parity for the whole headline raster frame,
``render_soup_diag(kernel="subtile8")`` at 48x96, against the JAX package
compiled as its own suite runs it (jit on the CPU backend, Pallas in
interpret mode).

The port fuses products into adds where XLA does (core/fp.py), so every
diag count and every quantized byte is equal. Float shading may still
differ by a few ulps: XLA's rsqrt is a CPU estimate refined by one Newton
step, and how it fuses the point-light sums depends on each compile. The
float frame is held to JAX's own bound (tests/test_raster_group.py:83):
at most 6 pixels over 2e-3.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.geom.tessellate import tessellate_scene as j_tess
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.core import quantize as Q
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.geom.tessellate import tessellate_scene
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
from ascii_renderer_tpu_torch.utils.from_jax import scene_from_numpy

torch.set_num_threads(2)

ROWS, COLS = 48, 96
DIAG = ("n_valid", "n_big", "n_rows", "n_pairs", "n_tiles_nz")


def rand_soup(T, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    nrm = rng.normal(size=(3 * T, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0.2, 1.0, (3 * T, 3)).astype(np.float32)
    return pos, nrm, col


def crossers(flip):
    """A floor and a wall that cross the near plane; ``flip`` turns their
    faces toward the camera."""
    s = 5.0
    floor = [(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)]
    wall = [(-s, 0, -s), (-s, 4, -s), (s, 4, -s), (s, 0, -s)]

    def qt(q):
        a, b, c, d = q
        return [a, c, b, a, d, c] if flip else [a, b, c, a, c, d]
    pos = np.asarray(qt(floor) + qt(wall), np.float32)
    nrm = np.zeros_like(pos)
    nrm[:6] = (0, 1, 0)
    nrm[6:] = (0, 0, 1)
    col = np.tile(np.asarray([[0.7, 0.6, 0.5]], np.float32), (12, 1))
    return pos, nrm, col


DIR_SCENE = [("set_env_light", [0.2, 0.2, 0.25], 1.0),
             ("add_dir_light", [-0.5, -0.7, -0.6], [1, 1, 1], 0.9)]
POINT_SCENE = [("set_env_light", [0.15, 0.15, 0.2], 1.0),
               ("add_point_light", [1.0, 2.0, 1.0], [1.0, 0.9, 0.8], 1.0)]
CAM = dict(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)
NEAR_CAM = dict(pos=(0.0, 1.0, 2.0), yaw=-1.57, pitch=-0.5)
# name -> (soup, scene calls, camera, big_cap)
CASES = {
    "random3000": (rand_soup(3000, 5), DIR_SCENE, CAM, 2048),
    "near_plane_crossers": (crossers(False), DIR_SCENE, NEAR_CAM, 16),
    "near_plane_crossers_front": (crossers(True), DIR_SCENE, NEAR_CAM, 16),
    "point_light_a9": (rand_soup(2000, 9), POINT_SCENE, CAM, 1024),
}


def build_scene(builder_cls, calls):
    sb = builder_cls()
    for name, *args in calls:
        getattr(sb, name)(*args)
    return sb.build(device="cpu") if builder_cls is SceneBuilder else \
        sb.build()


def caps(T, big_cap):
    return dict(v_cap=4096, big_cap=big_cap, r_cap=32 * 512,
                pair_cap=8 * T + big_cap * 48 * 8 + 4096, tile_cap=48)


def _port(name, emit="rgb"):
    (p, n, c), calls, cam, big = CASES[name]
    scene = build_scene(SceneBuilder, calls)
    return R.render_soup_diag(
        torch.from_numpy(p), torch.from_numpy(n), torch.from_numpy(c), scene,
        Camera.create(**cam), ROWS, COLS, 0.5, kernel="subtile8", emit=emit,
        **caps(p.shape[0] // 3, big))


@pytest.mark.parametrize("name", sorted(CASES))
def test_subtile8_frame_matches_jax(name):
    (p, n, c), calls, cam, big = CASES[name]
    rgb, diag = _port(name)
    rgb = rgb.numpy()
    assert rgb.shape == (ROWS, COLS, 3) and np.isfinite(rgb).all()
    f = jax.jit(functools.partial(
        JR.render_soup_diag, rows=ROWS, cols=COLS, pixel_aspect=0.5,
        kernel="subtile8", **caps(p.shape[0] // 3, big)))
    jrgb, jdiag = f(jnp.asarray(p), jnp.asarray(n), jnp.asarray(c),
                    build_scene(JSB, calls), JCam.create(**cam))
    jrgb = np.asarray(jrgb)
    assert {k: int(diag[k]) for k in DIAG} == {k: int(jdiag[k]) for k in DIAG}
    np.testing.assert_array_equal(
        Q.float_rgb_to_u8(torch.from_numpy(rgb)).numpy(),
        Q.float_rgb_to_u8(torch.from_numpy(jrgb)).numpy())
    bad = (np.abs(jrgb - rgb).max(-1) > 2e-3).sum()
    assert bad <= 6, f"{bad} pixels differ from JAX"
    if name != "near_plane_crossers":  # that camera sees only back faces
        assert (rgb.max(-1) > 0).sum() > 200


@pytest.mark.parametrize("name", ["random3000", "point_light_a9"])
def test_emit_idx_equals_quantized_rgb(name):
    rgb, d_rgb = _port(name)
    (idx, rgb8), d_idx = _port(name, emit="idx")
    want8 = Q.float_rgb_to_u8(rgb)
    assert idx.dtype == torch.int32 and rgb8.dtype == torch.uint8
    assert torch.equal(rgb8, want8)
    assert torch.equal(idx, Q.quantize_index(want8, 10))
    assert {k: int(d_rgb[k]) for k in DIAG} == {k: int(d_idx[k]) for k in DIAG}


def _big_soup(T=16400, seed=3):
    """>= 32768 triangle slots (RasterBackend's headline threshold) of
    small triangles around the origin."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.5, 1.5, (T, 1, 3))
    pos = (c + rng.normal(scale=0.08, size=(T, 3, 3))).reshape(-1, 3)
    nrm = rng.normal(size=(3 * T, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    col = rng.uniform(0.2, 1.0, (3 * T, 3))
    return tuple(a.astype(np.float32) for a in (pos, nrm, col))


def test_backend_overflow_retry_equals_generous_caps():
    """Undersized caps are detected through the diag counts and the
    backend's retry loop re-renders until nothing is dropped: the result
    equals a generously capped render (raster.py:878-922)."""
    p, n, c = _big_soup()
    scene = build_scene(SceneBuilder, DIR_SCENE)
    cam = Camera.create(**CAM)
    be = R.RasterBackend(device="cpu")
    be.set_soup(p, n, c, scene)
    be._caps = (4096, 16, 256, 4096, 8)  # far too small everywhere
    frame = be.render(0.0, cam, ROWS, COLS, 0.5)
    T = p.shape[0] // 3
    rgb, diag = R.render_soup_diag(
        torch.from_numpy(p), torch.from_numpy(n), torch.from_numpy(c), scene,
        cam, ROWS, COLS, 0.5, kernel="subtile8", v_cap=2 * T,
        big_cap=8192, r_cap=1 << 17, pair_cap=1 << 19, tile_cap=48)
    counts = [int(diag[k]) for k in DIAG]
    assert counts[2] > 256 and counts[3] > 4096 and counts[4] > 8
    caps = be._caps
    assert all(cnt <= cap for cnt, cap in zip(counts[1:], caps[1:]))
    assert torch.equal(frame.rgb, Q.float_rgb_to_u8(rgb))
    assert torch.equal(frame.a, torch.ones((ROWS, COLS), dtype=torch.uint8))
    assert (frame.rgb.amax(-1) > 0).sum() > 1000


def test_backend_rejects_unported_paths():
    p, n, c = CASES["random3000"][0]
    scene = build_scene(SceneBuilder, DIR_SCENE)
    cam = Camera.create(**CAM)
    be = R.RasterBackend(device="cpu")
    assert torch.equal(be.render(0.0, cam, 8, 16).a,
                       torch.ones((8, 16), dtype=torch.uint8))  # no scene
    be.set_soup(p, n, c, scene)
    frame = be.render(0.0, cam, ROWS, COLS, 0.5)  # 6000 slots: mid scale
    assert tuple(frame.rgb.shape) == (ROWS, COLS, 3)
    assert be._caps[0] % 8192 == 0  # mid-scale (v_cap, big_cap) caps
    args = (torch.from_numpy(p), torch.from_numpy(n), torch.from_numpy(c),
            scene, cam, ROWS, COLS, 0.5)
    # the channel-era generations render (B9b, B9c), within JAX's
    # cross-generation bound of the headline's frame
    want, _d = _port("random3000")
    for kernel in ("subtile", "subtile2"):
        rgb, diag = R.render_soup_diag(*args, kernel=kernel,
                                       **caps(p.shape[0] // 3, 2048))
        assert int(diag["n_valid"]) <= 4096 and int(diag["n_big"]) <= 2048
        bad = (np.abs(rgb.numpy() - want.numpy()).max(-1) > 2e-3).sum()
        assert bad <= 6, (kernel, bad)
    with pytest.raises(ValueError):
        R.render_soup_diag(*args, v_cap=4096, kernel="subtile9")
    # the grouped generations render the headline's frame bit for bit
    for kernel in ("subtile3", "subtile7"):
        rgb, diag = R.render_soup_diag(*args, kernel=kernel,
                                       **caps(p.shape[0] // 3, 2048))
        assert torch.equal(rgb.view(torch.int32), want.view(torch.int32))
    be.dispose()
    assert be._soup is None


def test_scene_from_jax_tessellates_and_preps_like_jax():
    import dataclasses
    jsb = JSB().set_env_light([0.2, 0.3, 0.4], 0.5)
    jsb.add_point_light([1, 2, 3], [1, 1, 1], 2.0)
    rng = np.random.default_rng(4)
    for _ in range(9):
        a, b, cc = rng.uniform(-1, 1, (3, 3))
        jsb.add_triangle(a, b, cc, material_id=int(rng.integers(0, 4)))
    jscene = jsb.build()
    d = {f.name: np.asarray(getattr(jscene, f.name))
         for f in dataclasses.fields(jscene) if f.name != "camera"}
    d["camera"] = {f.name: np.asarray(getattr(jscene.camera, f.name))
                   for f in dataclasses.fields(jscene.camera)}
    scene = scene_from_numpy(d, "cpu")
    for f in dataclasses.fields(jscene):
        if f.name != "camera":
            np.testing.assert_array_equal(getattr(scene, f.name).numpy(),
                                          d[f.name], err_msg=f.name)
    jsoup, tsoup = j_tess(jscene), tessellate_scene(scene)
    for a, b in zip(jsoup, tsoup):
        np.testing.assert_array_equal(b, a)
    jprep = JR.soup_static_prep(*[jnp.asarray(x) for x in jsoup], jscene)
    tprep = R.soup_static_prep(*[torch.from_numpy(x) for x in tsoup], scene)
    assert tprep[1].shape[0] == 27  # A = 9 with a point light
    for a, b in zip(jprep, tprep):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the port's own builder gives the same light/material tables
    own = SceneBuilder().set_env_light([0.2, 0.3, 0.4], 0.5).add_point_light(
        [1, 2, 3], [1, 1, 1], 2.0).build(device="cpu")
    for k in ("env_color", "env_intensity", "pt_pos", "pt_col", "n_pt",
              "dl_dir", "dl_col", "n_dl", "mat_albedo", "mat_emissive"):
        np.testing.assert_array_equal(getattr(own, k).numpy(), d[k],
                                      err_msg=k)
    assert json.dumps(own.camera.pos.tolist()) == json.dumps(
        np.asarray(jscene.camera.pos).tolist())
