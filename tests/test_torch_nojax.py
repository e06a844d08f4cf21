"""The port never imports jax: in a fresh interpreter where importing jax
fails, every module of ascii_renderer_tpu_torch imports and one 48x96 frame
renders (plain-torch kernel versions on the CPU) through the glyph pass."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SRC = r'''
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.modules["jaxlib"] = None
import numpy as np, torch
torch.set_num_threads(2)
import ascii_renderer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ascii import AsciiPass, chars_to_strings
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
rng = np.random.default_rng(0)
T = 500
p = torch.from_numpy(rng.uniform(-1, 1, (3 * T, 3)).astype(np.float32))
n = torch.nn.functional.normalize(torch.from_numpy(
    rng.normal(size=(3 * T, 3)).astype(np.float32)), dim=1)
c = torch.full((3 * T, 3), 0.8)
scene = SceneBuilder().set_env_light([0.2, 0.2, 0.2], 1.0).build()
cam = Camera.create(pos=(0.0, 0.5, 3.0), yaw=-1.57, pitch=-0.1)
rgb, diag = R.render_soup_diag(p, n, c, scene, cam, 48, 96, 0.5, v_cap=4096,
                               kernel="subtile8", big_cap=512)
chars, _ = AsciiPass()(Frame.from_float(rgb))
lines = chars_to_strings(chars)
assert len(lines) == 48 and len(lines[0]) == 96
assert (rgb.amax(-1) > 0).sum() > 300, int((rgb.amax(-1) > 0).sum())
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flax"))
       or m.startswith("ascii_renderer_tpu.")]
assert not [m for m in bad if sys.modules[m] is not None], bad
print("OK", len(names))
'''


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", SRC], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK")
