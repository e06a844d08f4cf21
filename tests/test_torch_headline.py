"""The port's whole headline slice on the CPU (plain-torch kernel
versions): bunny-class mesh, 68,644 triangles, 960x540, the bench config-3
camera, through RasterBackend and glyph_decide. It must reproduce the JAX
golden (tests/test_headline_goldens.py): checksum 32392648 over all
518,400 glyph codes, the ds20 lines, and the JAX golden path's grid cell
for cell.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from ascii_renderer_tpu_torch.ascii.ascii_pass import glyph_decide
from ascii_renderer_tpu_torch.backends.raster import RasterBackend
from ascii_renderer_tpu_torch.core.config import Config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_golden_chars():
    """tests/test_headline_goldens.py:32-62, the JAX golden path."""
    from ascii_renderer_tpu.ascii.ascii_pass import glyph_decide as j_glyph
    from ascii_renderer_tpu.backends import raster as JR
    from ascii_renderer_tpu.core.camera import Camera
    from ascii_renderer_tpu.core.frame import Frame
    from ascii_renderer_tpu.geom import meshes
    from ascii_renderer_tpu.scene.builder import SceneBuilder

    cfg = Config(pixel_aspect=0.5)
    v, i = meshes.bunny_like(69000)
    p, n, c = meshes.mesh_to_soup(v, i, color=(0.8, 0.78, 0.75))
    sb = SceneBuilder().set_env_light([0.22, 0.24, 0.28], 1.0)
    sb.add_dir_light([-0.5, -0.7, -0.6], [1, 1, 1], 0.9)
    cam = Camera.create(pos=(2.4, 1.4, 2.8),
                        yaw=float(np.arctan2(-2.8, -2.4)), pitch=-0.3)
    T = p.shape[0] // 3

    @jax.jit
    def full(p_, n_, c_, scene, cam):
        rgb = JR.render_soup(
            p_, n_, c_, scene, cam, 540, 960, cfg.pixel_aspect,
            method="subtile3", v_cap=JR._round_up(T, 4096), big_cap=0,
            r_cap=JR._round_up(2 * T, 2048), pair_cap=8 * T, tile_cap=1024)
        return j_glyph(
            Frame.from_float(rgb), ramp=cfg.ascii_ramp,
            mode_on=cfg.ascii_mode_filter, mode_radius=cfg.mode_radius,
            mode_thresh=cfg.ascii_mode_thresh, grayscale=cfg.use_grayscale)[0]

    return np.asarray(full(jnp.asarray(p), jnp.asarray(n), jnp.asarray(c),
                           sb.build(), cam))


def _port_chars():
    cfg = Config(pixel_aspect=0.5)
    backend = RasterBackend(cfg, device="cpu")
    backend.set_soup(*chip_smoke._bunny(), chip_smoke._scene("cpu"))
    frame = backend.render(0.0, chip_smoke._golden_camera(), 540, 960, 0.5)
    chars, _tint = glyph_decide(
        frame, ramp=cfg.ascii_ramp, mode_on=cfg.ascii_mode_filter,
        mode_radius=cfg.mode_radius, mode_thresh=cfg.ascii_mode_thresh,
        grayscale=cfg.use_grayscale)
    assert backend._caps[1] == 0  # lean caps adopted: the bunny has no big tris
    return chars.numpy()


def test_bunny_960x540_headline_frame():
    chars = _port_chars()
    assert chars.shape == (540, 960) and chars.dtype == np.uint8
    assert int(chars.astype(np.uint64).sum()) == chip_smoke.BUNNY_CHECKSUM
    ds = ["".join(chr(x) for x in row) for row in chars[10::20, 10::20]]
    with open(chip_smoke.GOLDEN_DS20) as f:
        assert ds == f.read().rstrip("\n").split("\n")
    np.testing.assert_array_equal(chars, _jax_golden_chars())


def test_chip_smoke_refuses_to_run_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line here."""
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
