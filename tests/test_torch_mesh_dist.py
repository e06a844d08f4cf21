"""The port's mesh and sharded renders over ``torch.distributed`` gloo
worlds of 2 and 4 ranks on the CPU (``parallel.mesh.run_world``: spawned
ranks, a FileStore in a temporary directory, every collective and the
world itself under a deadline), against the port's local frames and the
JAX package.

Tolerances: every sharded result equals the port's local render bit for
bit (views, row bands of the ray tracer, the path tracer's rgb and alpha,
and render_soup_rows_sharded's frame for subtile3, subtile6 and
subtile8, overflow 0). Against JAX: the row-sharded ray-traced frame
equals JAX's jitted frame bit for bit; the view farm is within 1e-4 of
JAX's vmap, the values over 1e-5 counted (VIEWS_APART);
the headline kernel's sharded frame is within JAX's frame bound (at most
6 pixels over 2e-3) of JAX's direct band calls; dryrun_multichip(4), run
where importing jax fails, reports JAX's first loss (4 decimals, as both
print it) and the glyph checksum of JAX's farm exactly."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.ascii.ascii_pass import glyph_decide as j_glyph
from ascii_renderer_tpu.backends import raster as JR
from ascii_renderer_tpu.backends import raytrace as JRT
from ascii_renderer_tpu.core.config import Config
from ascii_renderer_tpu.core.frame import Frame as JFrame
from ascii_renderer_tpu.diff import soft_raster as JS
from ascii_renderer_tpu.geom import meshes as JM
from ascii_renderer_tpu.parallel.mesh import orbit_cameras as j_orbit
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu_torch.parallel import mesh as TM
from ascii_renderer_tpu_torch.parallel.worlds import (local_renders,
                                                      mesh_facts,
                                                      sharded_renders,
                                                      soup_scene)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS = 32, 48
# rgb values of the sharded farm (2 n orbit views at ROWS x COLS) more
# than 1e-5 from JAX's vmap: every orbit view's basis is a last bit apart
# from JAX's (XLA's float32 sine of the shared pitch is not libm's,
# tests/test_torch_views.py), and a ray that grazes a sphere's silhouette
# then shades apart; all within 1e-4 (JAX's own bound for a sharded
# frame, tests/test_parallel.py:33)
VIEWS_APART = {2: 0, 4: 2}


def test_make_mesh_over_gloo_ranks():
    """make_mesh((2, 2), ("dp", "sp")) over 4 gloo ranks: named axes, each
    rank's coordinates in rank order, gloo; a "cuda" mesh over a gloo
    world refused; no rank loads jax. Outside a process group, and for a
    mesh that does not cover the world, make_mesh raises."""
    res = TM.run_world(mesh_facts, 4, "cpu", "cpu", (2, 2), ("dp", "sp"))
    for r, f in enumerate(res):
        assert f["rank"] == r and f["backend"] == "gloo"
        assert f["names"] == ("dp", "sp")
        assert f["axes"] == {"dp": (2, r // 2), "sp": (2, r % 2)}
        assert f["refused"].startswith("make_mesh:")
        assert f["jax_modules"] == []
    with pytest.raises(RuntimeError, match="no process group"):
        TM.make_mesh((1,), ("views",), "cpu")
    with pytest.raises(RuntimeError, match=r"axes \(3,\) over a world of 2"):
        TM.run_world(mesh_facts, 2, "cpu", "cpu", (3,), ("rows",))
    with pytest.raises(ValueError, match="device_type"):
        TM.run_world(mesh_facts, 2, "tpu")


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_renders_equal_local_frames(n):
    """render_views_sharded, render_rows_sharded (ray tracer; path tracer
    rgb and alpha, every pixel marked active) and render_soup_rows_sharded
    over n gloo ranks: every
    rank holds the whole result, equal to the local render bit for bit;
    then against JAX (module docstring)."""
    res = TM.run_world(sharded_renders, n, "cpu", "cpu", ROWS, COLS)
    local = local_renders("cpu", n, ROWS, COLS)
    for r in res:
        for k, want in local.items():
            np.testing.assert_array_equal(r[k], want, err_msg=k)
        for kernel in ("subtile3", "subtile6", "subtile8"):
            np.testing.assert_array_equal(r[f"over_{kernel}"],
                                          np.zeros(n, np.int32))
    assert int(((local["pt_alpha"] >= 2) & (local["pt_alpha"] <= 254))
               .sum()) > 10
    # against JAX
    js = JD.create_rt_demo_scene().build(min_pad=1)
    jframe = jax.jit(lambda s, c: JRT.render_rgb(s, c, ROWS, COLS, 0.5))
    np.testing.assert_array_equal(np.asarray(jframe(js, js.camera)),
                                  res[0]["rt_rows"])
    jviews = jax.jit(jax.vmap(lambda c: JRT.render_rgb(js, c, ROWS, COLS,
                                                       0.5)))
    d = np.abs(res[0]["views"] - np.asarray(jviews(j_orbit(
        2 * n, center=(0, 1.0, 1.0)))))
    print(f"views of {n}: {int((d > 1e-5).sum())} over 1e-5, max {d.max()}")
    assert int((d > 1e-5).sum()) <= VIEWS_APART[n] and d.max() <= 1e-4
    if n == 2:
        from ascii_renderer_tpu.core.camera import Camera as JCam
        from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
        v, i = JM.uv_sphere(12, 16, radius=1.2, center=(0.0, 1.0, 0.0))
        jsoup = tuple(jnp.asarray(x) for x in JM.mesh_to_soup(
            v, i, color=(0.8, 0.5, 0.4)))
        sb = JSB().set_env_light([0.2, 0.22, 0.25], 1.0)
        sb.add_dir_light([-0.5, -0.7, -0.6], [1, 1, 1], 0.9)
        jcam = JCam.create(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)
        caps = soup_scene("cpu")[3]
        band = ROWS // n
        fn = jax.jit(lambda lo: JR.render_soup_diag(
            *jsoup, sb.build(), jcam, ROWS, COLS, 0.5, v_cap=4096,
            kernel="subtile8", tile_cap=(band // 8) * 3 * 8, row_lo=lo,
            band_rows=band, **caps)[0])
        want = np.concatenate([np.asarray(fn(jnp.int32(b * band)))
                               for b in range(n)])
        d = np.abs(res[0]["raster_subtile8"] - want).max(-1)
        assert (d > 2e-3).sum() <= 6, int((d > 2e-3).sum())


def _jax_dryrun_expectations(n):
    """JAX's first train loss of the dryrun (the full images' loss of its
    dp views at the initial state) and the glyph checksum of JAX's farm of
    the port dryrun's 2 n views at 8 n x 32."""
    v, f = JM.uv_sphere(6, 8)
    sp = next(c for c in (4, 2, 1) if n % c == 0 and 16 % c == 0)
    cams = j_orbit(n // sp, center=(0, 0, 0), radius=2.5, height=0.0)
    gt = jnp.broadcast_to(jnp.asarray([0.9, 0.2, 0.1]), v.shape)

    def view_loss(c):
        t = JS.soft_render(jnp.asarray(v), gt, jnp.asarray(f), c, 16, 32)
        img = JS.soft_render(jnp.asarray(v), jnp.full_like(v, 0.5),
                             jnp.asarray(f), c, 16, 32)
        return JS.soft_luminance_loss(img, t)

    loss = float(jnp.sum(jax.jit(jax.vmap(view_loss))(cams)))
    cfg = Config(pixel_aspect=0.5)
    vs = JD.create_rt_demo_scene().build(min_pad=1)

    def chars(c):
        rgb = JRT.render_rgb(vs, c, 8 * n, 32, 0.5)
        return j_glyph(JFrame.from_float(rgb), ramp=cfg.ascii_ramp,
                       mode_on=cfg.ascii_mode_filter,
                       mode_radius=cfg.mode_radius,
                       mode_thresh=cfg.ascii_mode_thresh,
                       grayscale=cfg.use_grayscale)[0]

    farm = np.asarray(jax.jit(jax.vmap(chars))(j_orbit(
        2 * n, center=(0, 1.0, 1.0), radius=6.0)))
    return loss, int(farm.astype(np.int64).sum())


def test_dryrun_multichip_4_without_jax(tmp_path):
    """entry.dryrun_multichip(4) on the CPU (4 gloo ranks) in a fresh
    interpreter whose jax import fails, in the ranks too (a jax package
    that raises, first on PYTHONPATH): every check passes, and the summary
    reports JAX's first loss and farm checksum."""
    shim = tmp_path / "shim" / "jax"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text(
        "raise ImportError('jax is blocked for the port')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path / 'shim'}{os.pathsep}"
               f"{REPO}")
    env.pop("XLA_FLAGS", None)
    src = ("import sys\n"
           "from ascii_renderer_tpu_torch.entry import dryrun_multichip\n"
           "line = dryrun_multichip(4, 'cpu')\n"
           "assert not [m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'ascii_renderer_tpu')]\n")
    res = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    line = res.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: 4 cpu ranks, mesh=(1x4)")
    loss = float(re.search(r"loss ([0-9.]+) ->", line).group(1))
    checksum = int(re.search(r"8 views, checksum (\d+)", line).group(1))
    want_loss, want_sum = _jax_dryrun_expectations(4)
    assert abs(loss - want_loss) <= 5e-5, (loss, want_loss)
    assert checksum == want_sum, (checksum, want_sum)
