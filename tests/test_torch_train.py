"""Port parity for the sharded train step (``parallel/train``): the port's
step over gloo worlds of (dp, sp) ranks (``parallel.mesh.run_world``, the
ranks running ``parallel.worlds.train_trajectory`` without jax) against
JAX's ``make_train_step`` on ``make_mesh((dp, sp), ("dp", "sp"))`` over
conftest's virtual CPU devices, three steps from the same state.

Tolerances: losses rtol 1e-5, verts and colors atol 1e-5. What separates
the two beyond the soft raster's own rounding (tests/
test_torch_soft_raster.py): torch.optim.Adam blends the first moment by
lerp and divides by sqrt(v) / sqrt(1 - b2^t) + eps, with the bias
corrections in float64, where optax forms b1 m + (1 - b1) g and
m_hat / (sqrt(v_hat) + eps) in float32, and the all-reduce sums the ranks'
gradients in another order than psum. Adam's first step is lr * sign(g)
wherever |g| >> eps, so a gradient that is zero by symmetry and comes out
as rounding noise of either sign moves by +-lr in the two packages: the
bench's sphere seen from orbit cameras at its equator has such components
(15 of its 189 vertex components below 1e-6, 4 of opposite signs in the
two packages; verts 0.0257 apart after JAX's and the port's first step at
lr 5e-2, and JAX's own (1, 1) and (2, 2) meshes end 0.5% apart in loss
after three steps). The scene here is that sphere with its vertices
moved by seeded noise and seen from above the equator, so that no
gradient is zero by symmetry. ``make_train_steps(n)`` equals n single
steps exactly, and a state carried from JAX (``utils/from_jax
.train_state_from_numpy``) continues JAX's trajectory within the same
tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ascii_renderer_tpu.diff.soft_raster import soft_render as j_soft
from ascii_renderer_tpu.parallel import train as JT
from ascii_renderer_tpu.parallel.mesh import make_mesh as j_mesh
from ascii_renderer_tpu.parallel.mesh import orbit_cameras as j_orbit
from ascii_renderer_tpu_torch.geom import meshes
from ascii_renderer_tpu_torch.parallel import train as TT
from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras, run_world
from ascii_renderer_tpu_torch.parallel.worlds import train_trajectory
from ascii_renderer_tpu_torch.utils.from_jax import train_state_from_numpy

torch.set_num_threads(2)

ROWS, COLS, VIEWS = 16, 32, 4
CAM = dict(center=(0, 0, 0), radius=2.5, height=0.3)


def _scene():
    rng = np.random.default_rng(7)
    v, f = meshes.uv_sphere(6, 8)
    v = (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
    c0 = rng.uniform(0.3, 0.7, v.shape).astype(np.float32)
    gt = rng.uniform(0.1, 0.9, v.shape).astype(np.float32)
    jc = j_orbit(VIEWS, **CAM)
    targets = np.asarray(jax.vmap(lambda c: j_soft(
        jnp.asarray(v), jnp.asarray(gt), jnp.asarray(f), c, ROWS, COLS))(
            jc))
    return v, c0, f, jc, targets


def _jax_steps(sizes, v, c0, f, jc, targets, n, state=None):
    mesh = j_mesh(sizes, ("dp", "sp"))
    opt = optax.adam(1e-2)
    st = state or JT.init_train_state(v, c0, opt)
    step = JT.make_train_step(mesh, jnp.asarray(f), ROWS, COLS,
                              optimizer=opt)
    out = []
    for _ in range(n):
        st, loss = step(st, jc, jnp.asarray(targets))
        out.append((float(loss), np.asarray(st.verts),
                    np.asarray(st.colors)))
    return st, out


def _close(port, jax_out):
    losses = np.asarray([x[0] for x in jax_out])
    np.testing.assert_allclose(port["losses"], losses, rtol=1e-5)
    for k, (_l, jv, jc) in enumerate(jax_out):
        np.testing.assert_allclose(port["verts"][k], jv, atol=1e-5, rtol=0)
        np.testing.assert_allclose(port["colors"][k], jc, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sizes", [(1, 1), (2, 1), (2, 2)])
def test_train_step_matches_jax_mesh(sizes):
    """Three steps over a world of dp x sp gloo ranks against JAX's step
    on the same mesh shape; every rank ends with the same state, and the
    loss falls."""
    v, c0, f, jc, targets = _scene()
    _st, want = _jax_steps(sizes, v, c0, f, jc, targets, 3)
    res = run_world(train_trajectory, sizes[0] * sizes[1], "cpu", "cpu",
                    sizes, v, c0, f, orbit_cameras(VIEWS, **CAM), targets,
                    ROWS, COLS, lr=1e-2)
    _close(res[0], want)
    for r in res[1:]:
        np.testing.assert_array_equal(r["verts"], res[0]["verts"])
        np.testing.assert_array_equal(r["losses"], res[0]["losses"])
    assert res[0]["losses"][-1] < res[0]["losses"][0]


def test_train_steps_equal_single_steps():
    """make_train_steps(n) (the reference's lax.scan) equals n calls of
    make_train_step's step exactly, on the bench's sphere at Adam 5e-2
    (a world of 1 in this process)."""
    v, f = meshes.uv_sphere(6, 8)
    cams = orbit_cameras(2, center=(0, 0, 0), radius=2.5, height=0.0)
    from ascii_renderer_tpu_torch.diff.soft_raster import soft_render
    gt = torch.tensor([0.9, 0.2, 0.1]).expand(v.shape)
    targets = soft_render(torch.from_numpy(v), gt, f, cams, ROWS, COLS)
    r = run_world(train_trajectory, 1, "cpu", "cpu", (1, 1), v,
                  np.full_like(v, 0.5), f, cams, targets, ROWS, COLS,
                  lr=5e-2, n_single=4, n_scan=4)[0]
    np.testing.assert_array_equal(r["scan_losses"], r["losses"])
    np.testing.assert_array_equal(r["scan_verts"], r["verts"][-1])
    np.testing.assert_array_equal(r["scan_colors"], r["colors"][-1])
    assert r["losses"][-1] < r["losses"][0]


def test_carried_state_continues_jax_trajectory():
    """Two JAX steps, then the state carried to the port
    (train_state_from_numpy: verts, colors, optax's mu, nu and count as
    torch.optim.Adam's exp_avg, exp_avg_sq and step) and two port steps
    against JAX's third and fourth."""
    v, c0, f, jc, targets = _scene()
    st, _first = _jax_steps((1, 1), v, c0, f, jc, targets, 2)
    _st, want = _jax_steps((1, 1), v, c0, f, jc, targets, 2, state=st)
    adam = st.opt_state[0]
    carried = {"mu": {k: np.asarray(x) for k, x in adam.mu.items()},
               "nu": {k: np.asarray(x) for k, x in adam.nu.items()},
               "count": np.asarray(adam.count)}
    state = train_state_from_numpy(np.asarray(st.verts),
                                   np.asarray(st.colors), carried["mu"],
                                   carried["nu"], carried["count"], "cpu")
    assert float(state.opt_state["step"]) == 2.0
    assert isinstance(state, TT.TrainState)
    r = run_world(train_trajectory, 1, "cpu", "cpu", (1, 1),
                  np.asarray(st.verts), np.asarray(st.colors), f,
                  orbit_cameras(VIEWS, **CAM), targets, ROWS, COLS, lr=1e-2,
                  n_single=2, opt_state=carried)[0]
    _close(r, want)
