"""X5 and X5b's plain versions (``ops/soft_raster``: the soft rasterizer's
forward, its backward written out from the saved softmax statistics, and
the band loss with its gradient) against the JAX package and the torch
chain on the CPU, from the same seeded numpy inputs
(``tools/xla_inputs.soft_case``: the reference's two-triangle scene,
config 5's sphere at 36x96 from 1 and 4 orbit views, a degenerate
triangle, a small far sphere).

Tolerances: the forward's rgb bit for bit with ``soft_render_mvp``'s
chain (it is that chain), and within atol 1e-5 of JAX's ``soft_render``
from the triangles JAX's own projection gives (XLA fuses the edges'
products and sums the softmax in its own order; the torch projection's
last-bit differences from XLA's move config 5's 4-view rgb by up to
1.1e-5 at one of 41,472 values, the scene's conditioning, not the
raster's arithmetic). The backward, carried back through the torch
projection to verts and colours, within 1e-4 x max |g| of ``jax.vjp`` of
JAX's ``soft_render`` and, on the triangles, of ``torch.autograd``
through the chain, with the same seeded cotangent (one zero outside a
row band, as the "sp" split gives). The verts' gradients are held to
JAX's summed over the vertices at each position: uv_sphere's poles are
13 copies of one point, whose triangles have zero area at every pixel;
their collapsed edge's barycentric is exactly 0, at the simplex clamp's
bound, where torch.clamp passes the gradient and jnp.clip (a max then a
min) halves it, and 1 / 1e-9 amplifies the rest of XLA's rounding, so
the split among the copies differs from JAX's (up to 1.1e-3 x max |g| at
config 5, the chain's own autograd as much) while their sum agrees
(within 4e-7). The losses within rtol 1e-5 and their gradient within
1e-4 x max |g| of ``jax.value_and_grad`` of JAX's
``soft_luminance_loss``. On the CPU the wrappers and the autograd
Functions run the plain versions and launch nothing; the train step keeps
the chain; past the device checks a failed build or launch raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends.raster import camera_mvp as j_mvp
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.diff import soft_raster as JS
from ascii_renderer_tpu.parallel.mesh import orbit_cameras as j_orbit
from ascii_renderer_tpu_torch.diff import soft_raster as DS
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import soft_raster as SR
from ascii_renderer_tpu_torch.parallel import train as TT
from ascii_renderer_tpu_torch.parallel.mesh import make_mesh, run_world
from ascii_renderer_tpu_torch.tools.xla_inputs import (soft_camera, soft_case,
                                                       soft_cotangent)

torch.set_num_threads(2)

# every scene but "near w" (a vertex in the camera's plane: the card's
# tests hold the kernels to the plain versions there)
CASES = ("two triangles", "config 5", "config 5, 4 views", "degenerate",
         "uncovered")


def _scene(name):
    """(case, port mvps f32 [V, 4, 4], (tv, tc) with verts and colors
    leaves requiring grad, verts, colors)."""
    c = soft_case(name)
    rows, cols, pa = c["grid"]
    mvp = DS.camera_mvps(soft_camera(c["camera"]), rows, cols, pa)
    v = torch.tensor(c["verts"], requires_grad=True)
    col = torch.tensor(c["colors"], requires_grad=True)
    return c, mvp, DS.soft_triangles(v, col, c["faces"], mvp), v, col


def _kw(c):
    return dict(sigma=c["kw"].get("sigma", 1e-2),
                gamma=c["kw"].get("gamma", 1e-2))


def _jax_cams(c):
    """JAX's cameras of the case, a batch (V leading)."""
    kind, ckw = c["camera"]
    if kind == "pose":
        return jax.tree.map(lambda x: jnp.asarray(x)[None], JCam.create(**ckw))
    return j_orbit(**ckw)


def _jax_render(c):
    """(v, c) -> JAX's soft_render f32 [V, H, W, 3] of the case's views."""
    rows, cols, pa = c["grid"]
    faces = jnp.asarray(c["faces"])
    return lambda v, col: jax.vmap(lambda cam: JS.soft_render(
        v, col, faces, cam, rows, cols, pa, **c["kw"]))(_jax_cams(c))


def _jax_triangles(c):
    """tv f32 [V, T, 3, 3] as JAX's soft_render projects and gathers it
    (its lines before the edges, on JAX's own MVP)."""
    rows, cols, pa = c["grid"]
    faces = jnp.asarray(c["faces"])

    def proj(v, cam):
        clip = jnp.concatenate([v, jnp.ones_like(v[:, :1])], axis=1) \
            @ j_mvp(cam, rows, cols, pa).T
        return (clip[:, :3] / jnp.maximum(clip[:, 3:4], 1e-6))[faces]

    return np.asarray(jax.jit(jax.vmap(proj, in_axes=(None, 0)))(
        c["verts"], _jax_cams(c)))


def _by_position(g, verts):
    """g f32 [N, 3] summed over the vertices at each position, to 1e-6
    (uv_sphere's copies of a pole lie 1e-16 apart)."""
    _u, inv = np.unique(np.round(verts.astype(np.float64), 6), axis=0,
                        return_inverse=True)
    out = np.zeros((len(_u), 3), np.float64)
    np.add.at(out, inv.reshape(-1), g)
    return out


@pytest.mark.parametrize("name", CASES + ("near w",))
def test_fwd_ref_is_the_chain(name):
    """soft_raster_fwd_ref's rgb is soft_render_mvp's (the CPU route) bit
    for bit; its statistics are the T + 1 logits' max and sum of
    exponentials."""
    c, mvp, (tv, tc), v, col = _scene(name)
    rows, cols, _pa = c["grid"]
    kw = _kw(c)
    want = DS.soft_render_mvp(v, col, c["faces"], mvp, rows, cols, **kw)
    rgb, stats = SR.soft_raster_fwd_ref(tv.detach(), tc.detach(), rows, cols,
                                        **kw)
    assert torch.equal(rgb.view(torch.int32), want.detach().view(torch.int32))
    _rgb, logits = SR.soft_raster_chain(tv.detach(), tc.detach(), rows, cols,
                                        **kw)
    assert torch.equal(stats[..., 0], logits.max(dim=1).values)
    assert tuple(stats.shape) == (tv.shape[0], rows, cols, 2)
    assert bool((stats[..., 1] >= 1.0).all())


@pytest.mark.parametrize("name", CASES)
def test_fwd_ref_matches_jax(name):
    """soft_raster_fwd_ref on the triangles JAX projects, against JAX's
    soft_render."""
    c = soft_case(name)
    rows, cols, _pa = c["grid"]
    want = np.asarray(jax.jit(_jax_render(c))(c["verts"], c["colors"]))
    tv = torch.from_numpy(_jax_triangles(c))
    tc = torch.from_numpy(c["colors"][c["faces"]])
    rgb, _s = SR.soft_raster_fwd_ref(tv, tc, rows, cols, **_kw(c))
    np.testing.assert_allclose(rgb.numpy(), want, atol=1e-5, rtol=0)


def _close(got, want):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_bwd_ref_matches_jax_vjp_and_autograd(name, band):
    """The written-out backward carried through the torch projection to
    verts and colours, against jax.vjp of soft_render and against
    torch.autograd through the chain, the same seeded cotangent (the
    verts' gradients summed at each position: the module docstring)."""
    c, _mvp, (tv, tc), v, col = _scene(name)
    rows, cols, _pa = c["grid"]
    kw = _kw(c)
    V = tv.shape[0]
    cot = soft_cotangent((V, rows, cols, 3), seed=len(name),
                         band=(rows // 4, rows // 2) if band else None)
    rgb, stats = SR.soft_raster_fwd_ref(tv.detach(), tc.detach(), rows, cols,
                                        **kw)
    gtv, gtc = SR.soft_raster_bwd_ref(tv.detach(), tc.detach(), rgb, stats,
                                      torch.from_numpy(cot), rows, cols, **kw)
    gv, gc = torch.autograd.grad((tv, tc), (v, col), (gtv, gtc))
    _out, vjp = jax.vjp(_jax_render(c), c["verts"], c["colors"])
    jv, jc = (np.asarray(g) for g in jax.jit(vjp)(cot))
    _close(_by_position(gv.numpy(), c["verts"]),
           _by_position(jv, c["verts"]))
    _close(gc.numpy(), jc)
    # the chain under autograd, at the projected triangles
    tva, tca = tv.detach().requires_grad_(), tc.detach().requires_grad_()
    chain, _l = SR.soft_raster_chain(tva, tca, rows, cols, **kw)
    atv, atc = torch.autograd.grad(chain, (tva, tca), torch.from_numpy(cot))
    _close(gtv.numpy(), atv.numpy())
    _close(gtc.numpy(), atc.numpy())


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_loss_ref_matches_jax(name, band):
    """soft_loss_ref's per-view losses over a row band and their gradient
    against jax.value_and_grad of JAX's soft_luminance_loss of the band,
    view by view; zero gradient outside the band."""
    c, _mvp, (tv, tc), _v, _c = _scene(name)
    rows, cols, _pa = c["grid"]
    rgb, _s = SR.soft_raster_fwd_ref(tv.detach(), tc.detach(), rows, cols,
                                     **_kw(c))
    V = rgb.shape[0]
    lo, n = (rows // 3, rows // 3) if band else (0, rows)
    rng = np.random.default_rng(V + lo)
    target = rng.uniform(0.0, 1.0, (V, n, cols, 3)).astype(np.float32)
    losses, grad = SR.soft_loss_ref(rgb, torch.from_numpy(target), lo)
    x = rgb.numpy()
    for k in range(V):
        jl, jg = jax.jit(jax.value_and_grad(lambda r: JS.soft_luminance_loss(
            r[lo:lo + n], jnp.asarray(target[k]))))(x[k])
        np.testing.assert_allclose(float(losses[k]), float(jl), rtol=1e-5)
        _close(grad[k].numpy(), np.asarray(jg))
    assert not bool(grad[:, :lo].any()) and not bool(grad[:, lo + n:].any())


@pytest.mark.parametrize("name", ("two triangles", "config 5, 4 views"))
def test_functions_on_the_cpu_run_the_plain_versions(name):
    """SoftRaster and SoftLoss on CPU tensors: the plain versions' values
    and gradients (the per-view scale of SoftLoss's backward included),
    against autograd through the chain and the chain's loss; no launch."""
    c, _mvp, (tv, tc), _v, _c = _scene(name)
    rows, cols, _pa = c["grid"]
    kw = _kw(c)
    n0 = (SR.launches, SR.launches_bwd, SR.launches_loss)
    tva, tca = tv.detach().requires_grad_(), tc.detach().requires_grad_()
    rgb = SR.SoftRaster.apply(tva, tca, rows, cols, kw["sigma"],
                              kw["gamma"], (0.0, 0.0, 0.0))
    V = rgb.shape[0]
    lo, n = rows // 4, rows // 2
    target = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (V, n, cols, 3)).astype(np.float32))
    scale = torch.arange(1.0, V + 1.0)
    loss = (SR.SoftLoss.apply(rgb, target, lo, 10, 0.05, 0.1) * scale).sum()
    gtv, gtc = torch.autograd.grad(loss, (tva, tca))
    tvb, tcb = tv.detach().requires_grad_(), tc.detach().requires_grad_()
    chain, _l = SR.soft_raster_chain(tvb, tcb, rows, cols, **kw)
    assert torch.equal(rgb.detach(), chain.detach())
    want = (DS.soft_band_losses(chain, target, lo) * scale).sum()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    wtv, wtc = torch.autograd.grad(want, (tvb, tcb))
    _close(gtv.numpy(), wtv.numpy())
    _close(gtc.numpy(), wtc.numpy())
    assert (SR.launches, SR.launches_bwd, SR.launches_loss) == n0


def test_cpu_train_step_takes_the_chain(monkeypatch):
    """make_train_step on the CPU: the chain a view, no kernel launch, no
    autograd Function; the loss is the chain's."""
    c = soft_case("config 5")
    rows, cols, _pa = c["grid"]
    calls = []
    real = DS.soft_raster_chain

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    for fn in ("forward", "backward"):
        for cls in (SR.SoftRaster, SR.SoftLoss):
            monkeypatch.setattr(cls, fn, staticmethod(
                lambda *a: pytest.fail("an autograd Function ran")))
    monkeypatch.setattr(DS, "soft_raster_chain", spy)
    n0 = (SR.launches, SR.launches_bwd, SR.launches_loss)
    res = run_world(_one_step, 1, "cpu", c, rows, cols)[0]  # in process
    assert (SR.launches, SR.launches_bwd, SR.launches_loss) == n0
    assert np.isfinite(res["loss"])
    cams = soft_camera(c["camera"])
    img = real(*DS.soft_triangles(torch.from_numpy(c["verts"]),
                                  torch.from_numpy(c["colors"]), c["faces"],
                                  DS.camera_mvps(cams, rows, cols)),
               rows, cols, sigma=1e-2, gamma=1e-2)[0]
    want = DS.soft_luminance_loss(img[0], res["targets"][0])
    assert res["loss"] == float(want)
    assert len(calls) == 1 and tuple(calls[0]) == (1, 192, 3, 3)


def _one_step(c, rows, cols):
    """One CPU train step of config 5's scene from its seeded colours,
    the targets a constant grey."""
    mesh = make_mesh((1, 1), ("dp", "sp"), "cpu")
    step = TT.make_train_step(mesh, c["faces"], rows, cols)
    state = TT.init_train_state(c["verts"], c["colors"], device="cpu")
    targets = torch.full((1, rows, cols, 3), 0.4)
    _s, loss = step(state, soft_camera(c["camera"]), targets)
    return {"loss": float(loss), "targets": targets}


class _FailingLib:
    """A kernel library whose every launch reports a CUDA error."""

    def __getattr__(self, name):
        return lambda *args: 700  # cudaErrorIllegalAddress


def test_wrappers_raise_past_the_device_checks(monkeypatch):
    """Meta tensors past the device checks: a failed build or launch
    raises out of each wrapper, which never reaches its plain version;
    bad shapes raise ValueError."""
    tv = torch.zeros((2, 5, 3, 3), device="meta")
    tc = torch.zeros((5, 3, 3), device="meta")
    rgb = torch.zeros((2, 4, 6, 3), device="meta")
    stats = torch.zeros((2, 4, 6, 2), device="meta")
    plain = []
    for ref in ("soft_raster_fwd_ref", "soft_raster_bwd_ref",
                "soft_loss_ref"):
        monkeypatch.setattr(SR, ref, lambda *a, **k: plain.append(a))
    monkeypatch.setattr(_build, "require_device", lambda *t, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)

    def no_build():
        raise RuntimeError("nvcc failed")

    kw = dict(sigma=1e-2, gamma=1e-2)
    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        with pytest.raises(RuntimeError, match=match):
            SR.soft_raster_fwd(tv, tc, 4, 6, **kw)
        with pytest.raises(RuntimeError, match=match):
            SR.soft_raster_bwd(tv, tc, rgb, stats, rgb, 4, 6, **kw)
        with pytest.raises(RuntimeError, match=match):
            SR.soft_loss(rgb, rgb[:, 1:3], 1)
    assert plain == []
    with pytest.raises(ValueError):
        SR.soft_raster_fwd(tv[..., :2], tc, 4, 6, **kw)
    with pytest.raises(ValueError):
        SR.soft_raster_bwd(tv, tc, rgb, stats, rgb[:, :3], 4, 6, **kw)
    with pytest.raises(ValueError):
        SR.soft_loss(rgb, rgb[:, 1:3], 3)
