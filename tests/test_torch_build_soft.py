"""X5 and X5b on the card (``ops/soft_raster``, ``csrc/soft_raster.cu``):
the soft rasterizer's forward and backward and the band loss with its
gradient, each held to its plain version on the scenes of
``tools/xla_inputs.soft_case`` (the two-triangle scene, config 5 from 1
and 4 views, a degenerate triangle, a far sphere with most pixels outside
every triangle, a triangle with a vertex in the camera's plane).

Tolerances: rgb atol 1e-5 and the softmax statistics' maxima atol 1e-5,
sums rtol 1e-5, against ``soft_raster_fwd_ref`` on CPU copies (the
kernel rounds each site as the CPU chain does; expf and logf, and the
order of the sums over the triangles, stand apart); the gradients within
1e-4 x max |g| of ``soft_raster_bwd_ref`` and of ``torch.autograd``
through the chain at every triangle, on CPU copies, and, carried back
through the torch projection, of that projection's vjp of the kernel's
own gradient; the losses rtol 1e-5 and their gradient 1e-4 x max |g|
against ``soft_loss_ref``. Two calls of each kernel give the same bits;
``LAUNCHES_PER_CALL`` matches the profiler; the autograd Functions and
the train step's loss route CUDA tensors through the kernels; a failed
build or launch raises.
Tests marked ``cuda`` skip without a card; this file imports no JAX:

    python -m pytest tests/test_torch_build_soft.py -m cuda --noconftest

The CPU twin (the plain versions against JAX) is
``tests/test_torch_soft_kernel.py``."""

import numpy as np
import pytest
import torch

from ascii_renderer_tpu_torch.diff import soft_raster as DS
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import soft_raster as SR
from ascii_renderer_tpu_torch.tools.xla_inputs import (SOFT_CASES,
                                                       soft_camera, soft_case,
                                                       soft_cotangent)

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _kw(c):
    return dict(sigma=c["kw"].get("sigma", 1e-2),
                gamma=c["kw"].get("gamma", 1e-2))


def _triangles(name, dev):
    """(case, tv, tc) on ``dev``: the scene projected by the torch chain
    on the CPU, so that every device sees the same triangles."""
    c = soft_case(name)
    rows, cols, pa = c["grid"]
    mvp = DS.camera_mvps(soft_camera(c["camera"]), rows, cols, pa)
    tv, tc = DS.soft_triangles(torch.from_numpy(c["verts"]),
                               torch.from_numpy(c["colors"]), c["faces"], mvp)
    return c, tv.to(dev), tc.to(dev)


def _close(got, want, what):
    got, want = got.cpu().double(), want.cpu().double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert scale > 0 and err <= 1e-4 * scale, (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SOFT_CASES)
def test_x5_forward_equals_plain(cuda_device, name):
    c, tv, tc = _triangles(name, cuda_device)
    rows, cols, _pa = c["grid"]
    n0 = SR.launches
    rgb, stats = SR.soft_raster_fwd(tv, tc, rows, cols, **_kw(c))
    torch.cuda.synchronize()
    assert SR.launches == n0 + 1
    want, wstats = SR.soft_raster_fwd_ref(tv.cpu(), tc.cpu(), rows, cols,
                                          **_kw(c))
    assert bool(torch.isfinite(rgb).all())
    assert float((rgb.cpu() - want).abs().max()) <= 1e-5
    assert float((stats[..., 0].cpu() - wstats[..., 0]).abs().max()) <= 1e-5
    s, ws = stats[..., 1].cpu(), wstats[..., 1]
    assert float(((s - ws) / ws).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("name", SOFT_CASES)
def test_x5_backward_equals_autograd(cuda_device, name, band):
    """X5's backward through SoftRaster, a seeded cotangent (zero outside
    a row band, or not): one backward of the card's graph gives the
    gradient at the projected triangles and at verts and colours. At the
    triangles it is held to torch.autograd through the chain and to
    soft_raster_bwd_ref, both on CPU copies of the same triangles: the
    rounding the kernels copy site by site. (The chain on the card divides
    by a Python float as a product by its reciprocal, which moves its own
    gradient 5e-4 x max |g| from the CPU chain's on "uncovered"; and at
    "near w", whose NDC coordinates reach 4.8e5, the projection's backward
    turns the triangles' last-bit differences into 0.1 x max |g| at the
    verts even between the two CPU computations: ROADMAP C6.) At verts and
    colours it is held to the torch projection's vjp of the kernel's own
    gradient at the triangles."""
    c = soft_case(name)
    rows, cols, pa = c["grid"]
    kw = _kw(c)
    mvp = DS.camera_mvps(soft_camera(c["camera"]), rows, cols, pa)
    v = torch.tensor(c["verts"], device=cuda_device, requires_grad=True)
    col = torch.tensor(c["colors"], device=cuda_device, requires_grad=True)
    tv, tc = DS.soft_triangles(v, col, torch.as_tensor(c["faces"],
                                                       device=cuda_device),
                               mvp)
    cot = torch.from_numpy(soft_cotangent(
        (tv.shape[0], rows, cols, 3), seed=len(name),
        band=(rows // 4, rows // 2) if band else None))
    n0 = (SR.launches, SR.launches_bwd)
    rgb = SR.SoftRaster.apply(tv, tc, rows, cols, kw["sigma"], kw["gamma"],
                              (0.0, 0.0, 0.0))
    gv, gc, gtv, gtc = torch.autograd.grad(rgb, (v, col, tv, tc),
                                           cot.to(cuda_device),
                                           retain_graph=True)
    torch.cuda.synchronize()
    assert (SR.launches, SR.launches_bwd) == (n0[0] + 1, n0[1] + 1)
    pv, pc = torch.autograd.grad((tv, tc), (v, col), (gtv, gtc))
    _close(gv, pv, "verts vs the projection's vjp")
    _close(gc, pc, "colors vs the projection's vjp")
    # the triangles, on CPU copies
    tva = tv.detach().cpu().requires_grad_()
    tca = tc.detach().cpu().requires_grad_()
    chain, _l = SR.soft_raster_chain(tva, tca, rows, cols, **kw)
    atv, atc = torch.autograd.grad(chain, (tva, tca), cot)
    _close(gtv, atv, "tv vs autograd")
    _close(gtc, atc, "tc vs autograd")
    want, wstats = SR.soft_raster_fwd_ref(tva.detach(), tca.detach(), rows,
                                          cols, **kw)
    rtv, rtc = SR.soft_raster_bwd_ref(tva.detach(), tca.detach(), want,
                                      wstats, cot, rows, cols, **kw)
    _close(gtv, rtv, "tv vs plain")
    _close(gtc, rtc, "tc vs plain")


@pytest.mark.cuda
@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("name", SOFT_CASES)
def test_x5b_loss_equals_plain(cuda_device, name, band):
    c, tv, tc = _triangles(name, cuda_device)
    rows, cols, _pa = c["grid"]
    rgb, _s = SR.soft_raster_fwd(tv, tc, rows, cols, **_kw(c))
    V = rgb.shape[0]
    lo, n = (rows // 3, rows // 3) if band else (0, rows)
    target = torch.from_numpy(np.random.default_rng(V + lo).uniform(
        0.0, 1.0, (V, n, cols, 3)).astype(np.float32)).to(cuda_device)
    n0 = SR.launches_loss
    losses, grad = SR.soft_loss(rgb, target, lo)
    torch.cuda.synchronize()
    assert SR.launches_loss == n0 + 1
    wl, wg = SR.soft_loss_ref(rgb.cpu(), target.cpu(), lo)
    assert float(((losses.cpu() - wl) / wl).abs().max()) <= 1e-5
    _close(grad, wg, "d loss / d rgb")
    assert not bool(grad[:, :lo].any()) and not bool(grad[:, lo + n:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("config 5", "config 5, 4 views"))
def test_two_calls_same_bits(cuda_device, name):
    c, tv, tc = _triangles(name, cuda_device)
    rows, cols, _pa = c["grid"]
    kw = _kw(c)
    cot = torch.from_numpy(soft_cotangent((tv.shape[0], rows, cols, 3),
                                          seed=2)).to(cuda_device)
    outs = []
    for _ in range(2):
        rgb, stats = SR.soft_raster_fwd(tv, tc, rows, cols, **kw)
        gtv, gtc = SR.soft_raster_bwd(tv, tc, rgb, stats, cot, rows, cols,
                                      **kw)
        losses, grad = SR.soft_loss(rgb, rgb.flip(1), 0)
        outs.append([x.clone() for x in (rgb, stats, gtv, gtc, losses,
                                         grad)])
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_launches_per_call_match_the_profiler(cuda_device):
    """One call of each wrapper: the profiler's kernel rows of its name,
    LAUNCHES_PER_CALL of them, and no other kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    c, tv, tc = _triangles("config 5, 4 views", cuda_device)
    rows, cols, _pa = c["grid"]
    kw = _kw(c)
    rgb, stats = SR.soft_raster_fwd(tv, tc, rows, cols, **kw)
    cot = torch.ones_like(rgb)
    target = rgb.flip(1).contiguous()
    calls = {"soft_raster_fwd": lambda: SR.soft_raster_fwd(
                 tv, tc, rows, cols, **kw),
             "soft_raster_bwd": lambda: SR.soft_raster_bwd(
                 tv, tc, rgb, stats, cot, rows, cols, **kw),
             "soft_loss": lambda: SR.soft_loss(rgb, target, 0)}
    torch.cuda.synchronize()
    for name, fn in calls.items():
        for _attempt in range(5):  # the profiler now and then drops rows
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(8):
                    torch.cuda._sleep(1000)
                fn()
                for _ in range(8):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "spin_kernel" not in e.name]
            if names:
                break
        assert len(names) == SR.LAUNCHES_PER_CALL[name], (name, names)
        assert all(f"{name}_kernel" in n for n in names), (name, names)


@pytest.mark.cuda
def test_render_and_loss_route_through_the_kernels(cuda_device):
    """soft_render_mvp, soft_band_losses and soft_luminance_loss on CUDA
    tensors launch X5's forward, X5b and, backward, X5's backward once
    each, never the chain; their values and gradients to verts and colours
    match the CPU route's within 1e-5 (values) and 1e-4 x max |g|."""
    c = soft_case("config 5, 4 views")
    rows, cols, pa = c["grid"]
    mvp = DS.camera_mvps(soft_camera(c["camera"]), rows, cols, pa)
    target = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (4, rows // 2, cols, 3)).astype(np.float32))
    res = {}
    for dev in ("cpu", cuda_device):
        v = torch.tensor(c["verts"], device=dev, requires_grad=True)
        col = torch.tensor(c["colors"], device=dev, requires_grad=True)
        n0 = (SR.launches, SR.launches_bwd, SR.launches_loss)
        img = DS.soft_render_mvp(v, col, torch.as_tensor(c["faces"],
                                                         device=dev),
                                 mvp, rows, cols)
        loss = DS.soft_band_losses(img, target.to(dev), rows // 4).sum() \
            + DS.soft_luminance_loss(img[1], img[2].detach())
        gv, gc = torch.autograd.grad(loss, (v, col))
        n1 = (SR.launches, SR.launches_bwd, SR.launches_loss)
        res[str(dev)] = (float(loss), gv.cpu(), gc.cpu(),
                         tuple(b - a for a, b in zip(n0, n1)))
    cpu, card = res["cpu"], res[str(cuda_device)]
    assert cpu[3] == (0, 0, 0) and card[3] == (1, 1, 2), (cpu[3], card[3])
    assert abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    _close(card[1], cpu[1], "verts")
    _close(card[2], cpu[2], "colors")


class _FailingLib:
    """A kernel library whose every launch reports a CUDA error."""

    def __getattr__(self, name):
        return lambda *args: 700  # cudaErrorIllegalAddress


@pytest.mark.cuda
def test_kernels_raise_on_build_or_launch_failure(cuda_device, monkeypatch):
    """A failed build and a failed launch each raise out of the wrappers,
    which never reach their plain versions."""
    c, tv, tc = _triangles("two triangles", cuda_device)
    rows, cols, _pa = c["grid"]
    kw = _kw(c)
    rgb, stats = SR.soft_raster_fwd(tv, tc, rows, cols, **kw)
    plain = []
    for ref in ("soft_raster_fwd_ref", "soft_raster_bwd_ref",
                "soft_loss_ref", "soft_raster_chain"):
        monkeypatch.setattr(SR, ref, lambda *a, **k: plain.append(a))

    def no_build():
        raise RuntimeError("nvcc failed")

    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        with pytest.raises(RuntimeError, match=match):
            SR.soft_raster_fwd(tv, tc, rows, cols, **kw)
        with pytest.raises(RuntimeError, match=match):
            SR.soft_raster_bwd(tv, tc, rgb, stats, rgb, rows, cols, **kw)
        with pytest.raises(RuntimeError, match=match):
            SR.soft_loss(rgb, rgb, 0)
    assert plain == []
