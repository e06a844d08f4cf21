"""The port never imports jax: in a fresh interpreter where importing jax
fails, every module of ascii_renderer_tpu_torch imports (the small- and
mid-scale raster modules, the frame step and ``entry`` among them), and a
48x96 headline raster frame (and the same frame through the subtile3,
subtile4 and subtile5 walks and the fused setup+pack), a 48x96 binned-walk
frame, the same scene through the fused-shading walk, the channel-era
subtile and subtile2 walks and visibility_subtile, one ``entry()``
frame step (96x36) and one 12x32 path-traced frame of the demo scene render
(plain-torch kernel versions on the CPU) through the glyph pass; the app
shell's modules (the CLI, terminal IO, checkpoints, the glyph atlas)
import, one offline CLI frame renders and the exactness canary passes;
two spawned gloo ranks, whose jax import fails too, build a mesh without
loading jax, and a train step and a row band run in a world of 1."""

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
for new in ("backends.raster_channels", "backends.raster_oracles",
            "ops.raster_bins", "ops.raster_subtile", "sim.ui",
            "sim.framestep", "entry", "backends.raytrace",
            "backends.rt_core", "geom.intersect", "parallel.mesh",
            "sim.accum", "app.cli", "app.termblit", "app.terminput",
            "ascii.glyphs", "ascii.overlay", "core.color", "geom.reorder",
            "utils.checkpoint", "utils.exactness", "utils.profiling",
            "diff.soft_raster", "parallel.train", "parallel.worlds",
            "ops.fp", "ops.raster_shade", "ops.rt_trace", "ops.raster_clip",
            "ops.plane_table", "ops.bin_entries", "ops.group_build",
            "tools.bin_variants", "tools.build_variants"):
    assert "ascii_renderer_tpu_torch." + new in names, new
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
scene = SceneBuilder().set_env_light([0.2, 0.2, 0.2], 1.0).build(device="cpu")
cam = Camera.create(pos=(0.0, 0.5, 3.0), yaw=-1.57, pitch=-0.1)
rgb, diag = R.render_soup_diag(p, n, c, scene, cam, 48, 96, 0.5, v_cap=4096,
                               kernel="subtile8", big_cap=512)
chars, _ = AsciiPass()(Frame.from_float(rgb))
lines = chars_to_strings(chars)
assert len(lines) == 48 and len(lines[0]) == 96
assert (rgb.amax(-1) > 0).sum() > 300, int((rgb.amax(-1) > 0).sum())
for kernel in ("subtile3", "subtile4", "subtile5", "packed"):
    R.SETUP_PACKED = kernel == "packed"
    g_rgb, _d = R.render_soup_diag(
        p, n, c, scene, cam, 48, 96, 0.5, v_cap=4096, big_cap=512,
        kernel="subtile8" if kernel == "packed" else kernel)
    R.SETUP_PACKED = False
    assert torch.equal(g_rgb, rgb), kernel
rgb2 = R.render_soup(p, n, c, scene, cam, 48, 96, 0.5, method="scatter")
assert (rgb2.amax(-1) > 0).sum() > 300
# the retired generations: fused (B8, its big_cap fixed at 64 as in the
# reference), subtile (B9b), subtile2 (B9c), and visibility_subtile (B9a)
for method in ("fused", "subtile", "subtile2"):
    o_rgb = R.render_soup(p, n, c, scene, cam, 48, 96, 0.5, method=method,
                          v_cap=4096, big_cap=512)
    assert (o_rgb.amax(-1) > 0).sum() > 300, method
    if method != "fused":
        assert (o_rgb - rgb).abs().amax(-1).gt(2e-3).sum() <= 6, method
    o_chars, _ = AsciiPass()(Frame.from_float(o_rgb))
    assert tuple(o_chars.shape) == (48, 96)
mvp = R.camera_mvp(cam, 48, 96, 0.5)
cch = R.compact_valid_ch(R.setup_screen_channels(
    R.transform_clip_channels(p, mvp), 48, 96), 4096)[0]
zbuf, eidx, tri_s, n_rows, n_pairs = R.visibility_subtile(cch, 48, 96,
                                                          big_cap=512)
assert (eidx >= 0).sum() > 300 and int(n_rows) <= 16384
from ascii_renderer_tpu_torch.entry import entry
fn, args = entry(device="cpu")
st, echars, _tint = fn(*args)
assert tuple(echars.shape) == (36, 96) and int(st.frame_idx) == 1
from ascii_renderer_tpu_torch.atlas import io as atlas_io
from ascii_renderer_tpu_torch.backends import pathtrace, registry
from ascii_renderer_tpu_torch.core.config import Config, PathTracerConfig
from ascii_renderer_tpu_torch.ops import pt_kernel
from ascii_renderer_tpu_torch.scene import demo
sb = demo.create_demo_scene()
sb.set_atlas(atlas_io.demo_atlas())
cfg = Config(path_tracer=PathTracerConfig(samples_per_batch=2, max_bounces=2),
             grid_width=32, grid_height=12)
r = registry.Renderer(cfg, "pathtrace", device="cpu")
r.set_scene(sb.build(min_pad=1, device="cpu"))
f = r.render(0.0, Camera.create(pos=(0, 2.5, 6), yaw=-1.5707963))
pchars, _ = AsciiPass(cfg)(f)
assert tuple(pchars.shape) == (12, 32)
assert int(((f.a >= 2) & (f.a <= 254)).sum()) > 5
assert pt_kernel.launches == 0 and pathtrace.PathtraceBackend
# the ray tracer, a 2-view farm and a progressive batch, without jax
from ascii_renderer_tpu_torch.backends.raytrace import render_rgb
from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras, render_views
from ascii_renderer_tpu_torch.sim.accum import ProgressivePathTracer
rts = demo.create_rt_demo_scene().build(device="cpu")
rt = registry.Renderer(Config(pixel_aspect=0.5), "rt", device="cpu")
rt.set_scene(rts)
assert rt.render(0.0, rts.camera, 12, 32).rgb.any()
farm = render_views(lambda sc, cams: render_rgb(sc, cams, 6, 10, 0.5),
                    rts, orbit_cameras(2, center=(0, 1.0, 1.0)))
assert tuple(farm.shape) == (2, 6, 10, 3)
prog = ProgressivePathTracer(cfg, sb.build(min_pad=1, device="cpu"))
_d, _a, act = prog.step(Camera.create(pos=(0, 2.5, 6), yaw=-1.5707963))
assert bool(act.all()) and pt_kernel.launches == 0
# the app shell: one offline CLI frame and the exactness canary
import contextlib, io
from ascii_renderer_tpu_torch.app.cli import main
from ascii_renderer_tpu_torch.utils import exactness
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert main(["--backend", "raster", "--rows", "12", "--cols", "32",
                 "--device", "cpu"]) == 0
cli_rows = buf.getvalue().splitlines()
assert len(cli_rows) == 12 and all(len(r) == 32 for r in cli_rows), cli_rows
assert exactness.verdict(exactness.run_checks("cpu")) == "ok"
# the distributed paths: spawned gloo ranks (whose jax import fails too,
# through the blocking package on PYTHONPATH) build a mesh and load no jax;
# a train step and a row-band frame in a world of 1 in this process
from ascii_renderer_tpu_torch.parallel.mesh import run_world
from ascii_renderer_tpu_torch.parallel.worlds import (mesh_facts,
                                                      train_trajectory)
from ascii_renderer_tpu_torch.geom import meshes
facts = run_world(mesh_facts, 2, "cpu", "cpu", (2,), ("rows",))
assert [f["jax_modules"] for f in facts] == [[], []], facts
sv, sf = meshes.uv_sphere(4, 6)
tr = run_world(train_trajectory, 1, "cpu", "cpu", (1, 1), sv,
               np.full_like(sv, 0.5), sf, orbit_cameras(1, center=(0, 0, 0),
                                                        radius=2.5),
               np.zeros((1, 8, 16, 3), np.float32), 8, 16, n_single=2)[0]
assert np.isfinite(tr["losses"]).all() and tr["losses"][1] < tr["losses"][0]
band = render_rgb(rts, rts.camera, 12, 32, 0.5, row_lo=4, n_rows=4)
assert torch.equal(band, render_rgb(rts, rts.camera, 12, 32, 0.5)[4:8])
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flax"))
       or m.startswith("ascii_renderer_tpu.")]
assert not [m for m in bad if sys.modules[m] is not None], bad
print("OK", len(names))
'''


def test_port_imports_and_renders_without_jax(tmp_path):
    shim = tmp_path / "jax"  # spawned ranks import this jax, which fails
    shim.mkdir()
    (shim / "__init__.py").write_text("raise ImportError('blocked')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", SRC], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("OK")
