"""Port parity for the differentiable soft rasterizer
(``diff/soft_raster``) against the JAX package's, which the test runs
under ``jax.jit`` on its CPU backend, from the same numpy inputs.

Tolerances: ``soft_render`` and ``soft_glyph_probs`` atol 1e-5 and
``soft_luminance_loss`` rtol
1e-5 (XLA fuses the edge functions' products into their subtractions and
sums the softmax and einsum in its own order; torch rounds each operation
alone); the gradients of the loss (``jax.grad`` against
``torch.autograd``) within 1e-4 x max |g_jax| per argument (the backward
pass sums over triangles and pixels in other orders, which the
near-zero components of a symmetric scene show most); a batch of cameras
against JAX's vmap atol 1e-5 (each view's MVP is a host matrix of libm
trig, XLA's is its own polynomial: last-bit differences in the MVP). The
port's finite-difference check repeats the reference's (5%)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.diff import soft_raster as JS
from ascii_renderer_tpu.parallel.mesh import orbit_cameras as j_orbit
from ascii_renderer_tpu_torch.core.camera import Camera as TCam
from ascii_renderer_tpu_torch.diff import soft_raster as TS
from ascii_renderer_tpu_torch.geom import meshes
from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras

torch.set_num_threads(2)

SIGMA, GAMMA = 3e-3, 3e-2


def _two_tris():
    """The reference's finite-difference scene (tests/test_parallel.py):
    two triangles, seeded colours and target, a camera on +z."""
    rng = np.random.default_rng(3)
    verts = np.asarray([[-0.8, -0.5, 0.0], [0.9, -0.4, 0.2],
                        [0.0, 0.8, -0.1], [-0.5, -0.7, 0.6],
                        [0.6, -0.6, 0.5], [0.1, 0.6, 0.7]], np.float32)
    colors = rng.uniform(0.2, 0.9, (6, 3)).astype(np.float32)
    faces = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    pose = dict(pos=(0.0, 0.0, 3.0), yaw=-np.pi / 2, pitch=0.0)
    target = rng.uniform(0.0, 1.0, (16, 24, 3)).astype(np.float32)
    return (verts, colors, faces, JCam.create(**pose), TCam.create(**pose),
            target, (16, 24, 0.5), rng)


def _sphere():
    """The dryrun's train scene: a 6 x 8 sphere at 0.5 grey, one orbit
    view, the target the soft render of its ground-truth colour; default
    sigma and gamma."""
    v, f = meshes.uv_sphere(6, 8)
    gt = np.broadcast_to(np.float32([0.9, 0.2, 0.1]), v.shape)
    jc = jax.tree.map(lambda x: x[0], j_orbit(1, center=(0, 0, 0),
                                              radius=2.5, height=0.0))
    tc = orbit_cameras(1, center=(0, 0, 0), radius=2.5, height=0.0)[0]
    target = np.asarray(JS.soft_render(jnp.asarray(v), jnp.asarray(gt),
                                       jnp.asarray(f), jc, 16, 32))
    return v, np.full_like(v, 0.5), f, jc, tc, target, (16, 32, 1.0), None


SCENES = {"two triangles": _two_tris, "sphere": _sphere}


def _kw(name):
    return dict(sigma=SIGMA, gamma=GAMMA) if name == "two triangles" else {}


@pytest.mark.parametrize("name", list(SCENES))
def test_soft_render_loss_and_gradients_match_jax(name):
    verts, colors, faces, jc, tc, target, (rows, cols, pa), _r = \
        SCENES[name]()
    kw = _kw(name)

    def jloss(v, c):
        img = JS.soft_render(v, c, jnp.asarray(faces), jc, rows, cols, pa,
                             **kw)
        return JS.soft_luminance_loss(img, jnp.asarray(target))

    jimg = np.asarray(jax.jit(lambda v, c: JS.soft_render(
        v, c, jnp.asarray(faces), jc, rows, cols, pa, **kw))(verts, colors))
    jl = float(jax.jit(jloss)(verts, colors))
    gv, gc = (np.asarray(g) for g in jax.jit(jax.grad(
        jloss, argnums=(0, 1)))(verts, colors))

    v = torch.tensor(verts, requires_grad=True)
    c = torch.tensor(colors, requires_grad=True)
    img = TS.soft_render(v, c, faces, tc, rows, cols, pa, **kw)
    loss = TS.soft_luminance_loss(img, torch.from_numpy(target))
    loss.backward()
    assert tuple(img.shape) == (rows, cols, 3)
    np.testing.assert_allclose(img.detach().numpy(), jimg, atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    for got, want in ((v.grad, gv), (c.grad, gc)):
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * scale)


def test_soft_glyph_probs_match_jax():
    rng = np.random.default_rng(11)
    rgb = rng.uniform(0, 1, (12, 20, 3)).astype(np.float32)
    for ramp_len, tau in ((10, 0.05), (70, 0.2)):
        want = np.asarray(JS.soft_glyph_probs(jnp.asarray(rgb), ramp_len,
                                              tau))
        got = TS.soft_glyph_probs(torch.from_numpy(rgb), ramp_len, tau)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        # argmax is the hard rule away from bin boundaries
        hard = np.floor(rgb.mean(-1) * (ramp_len - 1) + 0.5)
        assert (got.argmax(-1).numpy() == hard).mean() > 0.95


def test_batched_cameras_match_views_and_jax_vmap():
    """A batch of 4 orbit views: one MVP a view (host), rendered in one
    pass; each view equals its own call within 1e-6 relative (the einsum
    runs as one batched product whose blocking follows the batch), and
    the batch JAX's vmap within 1e-5."""
    v, f = meshes.uv_sphere(6, 8)
    c = np.random.default_rng(2).uniform(0, 1, v.shape).astype(np.float32)
    tcams = orbit_cameras(4, center=(0, 0, 0), radius=2.5, height=0.4)
    jcams = j_orbit(4, center=(0, 0, 0), radius=2.5, height=0.4)
    tv, tc = torch.from_numpy(v), torch.from_numpy(c)
    batch = TS.soft_render(tv, tc, f, tcams, 12, 20, 0.5)
    assert tuple(batch.shape) == (4, 12, 20, 3)
    assert tuple(TS.camera_mvps(tcams, 12, 20, 0.5).shape) == (4, 4, 4)
    for i in range(4):
        one = TS.soft_render(tv, tc, f, tcams[i], 12, 20,
                             0.5)
        np.testing.assert_allclose(one.numpy(), batch[i].numpy(),
                                   rtol=1e-6, atol=0)
    want = np.asarray(jax.jit(jax.vmap(lambda cam: JS.soft_render(
        jnp.asarray(v), jnp.asarray(c), jnp.asarray(f), cam, 12, 20, 0.5)))(
            jcams))
    np.testing.assert_allclose(batch.numpy(), want, atol=1e-5, rtol=0)


def test_soft_raster_gradients_match_finite_differences():
    """The reference's check (tests/test_parallel.py:182-215) on the
    port: directional derivatives of the loss along seeded directions
    against central differences (eps 3e-3), within 5%."""
    verts, colors, faces, _jc, tc, target, (rows, cols, pa), rng = \
        _two_tris()
    tgt = torch.from_numpy(target)

    def loss(v, c):
        img = TS.soft_render(v, c, faces, tc, rows, cols, pa, sigma=SIGMA,
                             gamma=GAMMA)
        return TS.soft_luminance_loss(img, tgt)

    v = torch.tensor(verts, requires_grad=True)
    c = torch.tensor(colors, requires_grad=True)
    loss(v, c).backward()
    assert torch.isfinite(v.grad).all() and float(v.grad.abs().max()) > 0
    eps = 3e-3
    for name, g, x, arg in (("verts", v.grad, verts, 0),
                            ("colors", c.grad, colors, 1)):
        d = rng.normal(size=x.shape).astype(np.float32)
        d = d / np.linalg.norm(d)
        args_p = [torch.from_numpy(verts), torch.from_numpy(colors)]
        args_m = list(args_p)
        args_p[arg] = torch.from_numpy(x + eps * d)
        args_m[arg] = torch.from_numpy(x - eps * d)
        with torch.no_grad():
            fd = (float(loss(*args_p)) - float(loss(*args_m))) / (2 * eps)
        an = float((g * torch.from_numpy(d)).sum())
        assert abs(fd - an) <= 0.05 * max(abs(fd), abs(an), 1e-3), (
            name, fd, an)
