"""The soft rasterizer's forward and backward (X5, ``csrc/soft_raster.cu``:
one launch each) and the train step's glyph loss with its gradient (X5b,
one launch), with their plain versions.

Stands for XLA code, not a Pallas kernel: the reference differentiates
``soft_render`` and ``soft_luminance_loss``
(``ascii_renderer_tpu/diff/soft_raster.py:30``, ``:118``) with
``jax.value_and_grad`` inside its jitted train step
(``ascii_renderer_tpu/parallel/train.py:61-84``). The port's plain version
is the torch chain of ``diff/soft_raster``, differentiated by autograd:
about 70 launches over [V, T, H, W] forward, twice that backward, and
~60 a view for the loss.

The functions here take the projected triangles: ``tv`` f32 [V, T, 3, 3]
(each view's vertices' NDC x, y, z) and ``tc`` f32 [T, 3, 3] (the
vertices' colours).

- ``soft_raster_chain`` is the chain itself (``soft_render_mvp`` after
  its gather); ``soft_raster_fwd_ref`` returns its rgb and, for each
  pixel, the softmax's maximum logit and sum of exponentials, f32
  [V, H, W, 2]; ``soft_raster_bwd_ref`` is the backward written out step
  by step from those statistics, as the kernel computes it (no autograd):
  (d tv, d tc), d tc summed over the views; ``soft_loss_ref`` the loss of
  each view's row band and its gradient written out.
- ``soft_raster_fwd`` / ``soft_raster_bwd`` / ``soft_loss`` are the
  wrappers: CPU tensors take the plain versions, CUDA tensors launch the
  kernels or raise.
- ``SoftRaster`` and ``SoftLoss`` are the ``torch.autograd.Function``s
  that ``diff/soft_raster`` and ``parallel/train`` route CUDA tensors
  through; the CPU route is the chain under autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from ascii_renderer_tpu_torch.ops import _build

launches = 0       # kernel launches by soft_raster_fwd
launches_bwd = 0   # by soft_raster_bwd
launches_loss = 0  # by soft_loss
LAUNCHES_PER_CALL = {"soft_raster_fwd": 1, "soft_raster_bwd": 1,
                     "soft_loss": 1}
_THIRD = float(np.float32(1.0) / np.float32(3.0))  # XLA's 1/3 for mean/3
_LUM_HI = float(np.float32(1.0 - 1e-6))  # the luminance clamp's upper bound


def _terms(tv, tc, rows: int, cols: int, sigma: float, gamma: float):
    """Every (view, triangle, pixel) term of the chain before its softmax,
    [V, T, H, W] each (cpix [V, T, H, W, 3]), computed op by op as
    ``soft_render_mvp`` computes them."""
    dev = tv.device
    # pixel centres in NDC
    xs = (torch.arange(cols, dtype=torch.float32, device=dev) + 0.5) \
        / cols * 2.0 - 1.0
    ys = 1.0 - (torch.arange(rows, dtype=torch.float32, device=dev) + 0.5) \
        / rows * 2.0
    px = xs[None, :]                                   # [1, W]
    py = ys[:, None]                                   # [H, 1]

    def at(k, c):  # vertex k's coordinate c, [V, T, 1, 1]
        return tv[:, :, k, c, None, None]

    def edge(a, b):
        # cross(b - a, p - a) over the pixel grid -> [V, T, H, W]
        ax, ay, bx, by = at(a, 0), at(a, 1), at(b, 0), at(b, 1)
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    w = (edge(1, 2), edge(2, 0), edge(0, 1))
    area = w[0] + w[1] + w[2]
    area_safe = torch.where(area.abs() < 1e-9, 1e-9, area)
    b = tuple(wk / area_safe for wk in w)

    margin = torch.minimum(torch.minimum(b[0], b[1]), b[2])  # > 0 inside
    cov = torch.sigmoid(torch.sign(margin) * margin ** 2 / sigma)

    # screen-space interpolation with the barycentrics clamped to the
    # simplex, so attributes stay in the hull of the vertex values
    cl = tuple(torch.clamp(bk, 0.0, 1.0) for bk in b)
    nsum = cl[0] + cl[1] + cl[2]
    norm = torch.clamp(nsum, min=1e-6)
    c = tuple(ck / norm for ck in cl)
    zpix = c[0] * at(0, 2) + c[1] * at(1, 2) + c[2] * at(2, 2)   # ndc z
    cpix = (c[0][..., None] * tc[None, :, None, None, 0]
            + c[1][..., None] * tc[None, :, None, None, 1]
            + c[2][..., None] * tc[None, :, None, None, 2])  # [V, T, H, W, 3]

    # softmax over the triangles and a background slot at the far plane
    zinv = (1.0 - torch.clamp(zpix, -1.0, 1.0)) * 0.5      # 1 near, 0 far
    logits = zinv / gamma + torch.log(torch.clamp(cov, 1e-12, 1.0))
    return dict(px=px, py=py, w=w, area=area, area_safe=area_safe, b=b,
                margin=margin, cov=cov, cl=cl, nsum=nsum, norm=norm, c=c,
                zpix=zpix, cpix=cpix, logits=logits)


def soft_raster_chain(tv, tc, rows: int, cols: int, *, sigma: float,
                      gamma: float, bg_color=(0.0, 0.0, 0.0)):
    """The chain of ``soft_render_mvp`` after its gather: (rgb f32
    [V, rows, cols, 3], the logits of the T + 1 slots f32 [V, T + 1, rows,
    cols], the background's last). Differentiable by autograd."""
    t = _terms(tv, tc, rows, cols, sigma, gamma)
    logits, cpix = t["logits"], t["cpix"]
    V = logits.shape[0]
    all_logits = torch.cat([logits, torch.zeros_like(logits[:, :1])], dim=1)
    wgt = torch.softmax(all_logits, dim=1)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=tv.device)
    all_colors = torch.cat([cpix, bg.expand(V, 1, rows, cols, 3)], dim=1)
    # the reference's einsum("thw,thwc->hwc") as a product and a sum over
    # the slots: one reduction, where einsum's batched product runs a
    # 1 x (T + 1) matrix product a pixel
    return (wgt[..., None] * all_colors).sum(dim=1), all_logits


def soft_raster_fwd_ref(tv, tc, rows: int, cols: int, *, sigma: float,
                        gamma: float, bg_color=(0.0, 0.0, 0.0)):
    """The chain's rgb f32 [V, rows, cols, 3] and each pixel's softmax
    statistics f32 [V, rows, cols, 2]: the largest of the T + 1 logits
    and the sum of their exponentials less it."""
    with torch.no_grad():
        rgb, all_logits = soft_raster_chain(tv, tc, rows, cols, sigma=sigma,
                                            gamma=gamma, bg_color=bg_color)
        mx = all_logits.max(dim=1).values
        s = torch.exp(all_logits - mx[:, None]).sum(dim=1)
        return rgb, torch.stack([mx, s], dim=-1)


def _split_min(g, a, b):
    """torch.minimum(a, b)'s gradient to a and to b: all of it to the
    smaller, half each on a tie."""
    tie = g * 0.5
    zero = torch.zeros_like(g)
    return (torch.where(a < b, g, torch.where(a == b, tie, zero)),
            torch.where(b < a, g, torch.where(a == b, tie, zero)))


def soft_raster_bwd_ref(tv, tc, rgb, stats, grad_rgb, rows: int, cols: int,
                        *, sigma: float, gamma: float):
    """The gradient of the chain's rgb, written out from the saved rgb and
    statistics as the kernel computes it: (d tv f32 [V, T, 3, 3], d tc f32
    [T, 3, 3] summed over the views) for the cotangent ``grad_rgb`` f32
    [V, rows, cols, 3]. Each site follows the chain's autograd rule:
    clamp passes the gradient at its bounds, minimum splits a tie in
    halves, sign has none, where sends it to the branch it took, and the
    coverage's clamp at 1e-12 stops it below. The background colour
    reaches the gradient through rgb alone."""
    with torch.no_grad():
        t = _terms(tv, tc, rows, cols, sigma, gamma)
        b, c, cov, zpix = t["b"], t["c"], t["cov"], t["zpix"]
        mx, s = stats[..., 0][:, None], stats[..., 1][:, None]
        g = grad_rgb.to(torch.float32)[:, None]            # [V, 1, H, W, 3]
        r = rgb[:, None]
        # the softmax and the weighted sum
        wt = torch.exp(t["logits"] - mx) / s               # [V, T, H, W]
        gdot = (g[..., 0] * r[..., 0] + g[..., 1] * r[..., 1]) \
            + g[..., 2] * r[..., 2]
        cp = t["cpix"]
        gcol = (g[..., 0] * cp[..., 0] + g[..., 1] * cp[..., 1]) \
            + g[..., 2] * cp[..., 2]
        gl = wt * (gcol - gdot)
        gcp = wt[..., None] * g                            # [V, T, H, W, 3]
        # the coverage: log(clamp(cov, 1e-12, 1)), sigmoid, sign(m) m^2
        covc = torch.clamp(cov, 1e-12, 1.0)
        gcov = torch.where((cov >= 1e-12) & (cov <= 1.0), gl / covc, 0.0)
        gq = gcov * ((1.0 - cov) * cov)
        m = t["margin"]
        gm = gq / sigma * torch.sign(m) * (2.0 * m)
        # the depth: (1 - clamp(zpix, -1, 1)) * 0.5 / gamma
        gz = torch.where((zpix >= -1.0) & (zpix <= 1.0),
                         -(gl / gamma * 0.5), 0.0)
        # the renormalised barycentrics
        gc = [gz * tv[:, :, k, 2, None, None]
              + ((gcp[..., 0] * tc[None, :, k, 0, None, None]
                  + gcp[..., 1] * tc[None, :, k, 1, None, None])
                 + gcp[..., 2] * tc[None, :, k, 2, None, None])
              for k in range(3)]
        norm = t["norm"]
        gnorm = -(((gc[0] * c[0] + gc[1] * c[1]) + gc[2] * c[2]) / norm)
        gnsum = torch.where(t["nsum"] >= 1e-6, gnorm, 0.0)
        gb = [torch.where((b[k] >= 0.0) & (b[k] <= 1.0), gc[k] / norm + gnsum,
                          0.0) for k in range(3)]
        # the margin min(min(b0, b1), b2)
        m01 = torch.minimum(b[0], b[1])
        gm01, g2 = _split_min(gm, m01, b[2])
        g0, g1 = _split_min(gm01, b[0], b[1])
        gb = [gb[0] + g0, gb[1] + g1, gb[2] + g2]
        # b_k = w_k / area_safe
        asafe = t["area_safe"]
        gas = -(((gb[0] * b[0] + gb[1] * b[1]) + gb[2] * b[2]) / asafe)
        garea = torch.where(t["area"].abs() < 1e-9, 0.0, gas)
        G = [gb[k] / asafe + garea for k in range(3)]
        # the edges: w_e = (xb - xa) (py - ya) - (yb - ya) (px - xa)
        px, py = t["px"], t["py"]
        gx = [None] * 3
        gy = [None] * 3
        for e, (a, bb) in enumerate(((1, 2), (2, 0), (0, 1))):
            ax, ay = tv[:, :, a, 0, None, None], tv[:, :, a, 1, None, None]
            bx, by = tv[:, :, bb, 0, None, None], tv[:, :, bb, 1, None, None]
            A, B, C, D = bx - ax, py - ay, by - ay, px - ax
            GB = G[e] * B
            gxa, gya = G[e] * C - GB, G[e] * D - G[e] * A
            gxb, gyb = GB, -(G[e] * D)
            # vertex a's own edge is e, vertex b's the edge after it
            gx[a] = gxa if gx[a] is None else gx[a] + gxa
            gy[a] = gya if gy[a] is None else gy[a] + gya
            gx[bb] = gxb if gx[bb] is None else gxb + gx[bb]
            gy[bb] = gyb if gy[bb] is None else gyb + gy[bb]
        gtv = torch.stack([torch.stack([gx[k], gy[k], gz * c[k]], dim=-1)
                           for k in range(3)], dim=2)   # [V, T, 3, H, W, 3]
        gtv = gtv.sum(dim=(3, 4))
        gtc = torch.stack([gcp * c[k][..., None] for k in range(3)], dim=2)
        gtc = gtc.sum(dim=(0, 3, 4))                      # [T, 3, 3]
        return gtv.contiguous(), gtc.contiguous()


def soft_loss_ref(rgb, target, row_lo: int = 0, *, ramp_len: int = 10,
                  tau: float = 0.05, glyph_weight: float = 0.1):
    """Each view's loss over its row band, written out: ``rgb`` f32
    [V, H, W, 3], ``target`` f32 [V, band, W, 3] for rows row_lo to row_lo
    + band. Returns (losses f32 [V], d losses[v] / d rgb[v] f32
    [V, H, W, 3], zero outside the band). A loss is
    ``diff/soft_raster.soft_luminance_loss`` of the band: the pixel MSE
    plus glyph_weight x the cross-entropy of the soft glyph distribution
    against the target's hard glyph index; its gradient follows the
    chain's autograd rules (the clamps pass it at their bounds)."""
    V, H, W, _ = rgb.shape
    band = target.shape[1]
    L = ramp_len
    with torch.no_grad():
        x = rgb[:, row_lo:row_lo + band]
        d = x - target
        n1 = band * W
        n3 = n1 * 3
        mse = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
               + d[..., 2] * d[..., 2]).sum(dim=(1, 2)) / n3
        lum = ((x[..., 0] + x[..., 1]) + x[..., 2]) * _THIRD
        xv = torch.clamp(lum, 0.0, _LUM_HI) * (L - 1)
        k = torch.arange(L, dtype=torch.float32, device=rgb.device)
        dk = xv[..., None] - k
        sk = -(dk * dk) / tau
        p = torch.softmax(sk, dim=-1)
        tl = ((target[..., 0] + target[..., 1]) + target[..., 2]) * _THIRD
        tx = torch.clamp(tl, 0.0, _LUM_HI) * (L - 1)
        tidx = torch.clamp(torch.floor(tx + 0.5), 0, L - 1).long()
        pt = p.gather(-1, tidx[..., None])[..., 0]
        ptc = torch.clamp(pt, 1e-12, 1.0)
        ce = -(torch.log(ptc).sum(dim=(1, 2)) / n1)
        losses = mse + glyph_weight * ce
        # the gradient, a pixel at a time
        gw = float(np.float32(-np.float32(glyph_weight) / np.float32(n1)))
        gpt = torch.where((pt >= 1e-12) & (pt <= 1.0), gw / ptc, 0.0)
        onehot = torch.nn.functional.one_hot(tidx, L).to(torch.bool)
        gs = p * (torch.where(onehot, gpt[..., None], 0.0)
                  - (gpt * pt)[..., None])
        gx = (-(gs / tau) * (2.0 * dk)).sum(dim=-1)
        glum = torch.where((lum >= 0.0) & (lum <= _LUM_HI), gx * (L - 1), 0.0)
        gch = glum * _THIRD
        grad = torch.zeros_like(rgb)
        grad[:, row_lo:row_lo + band] = 2.0 * d / n3 + gch[..., None]
        return losses, grad


def _f32(t, what, shape, dev):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or t.device != dev:
        raise ValueError(f"soft_raster: {what} must be float32 {list(shape)}"
                         f" on {dev}, got {t.dtype} {list(t.shape)} on "
                         f"{t.device}")
    return t if t.is_contiguous() else t.contiguous()


def _geometry(tv, tc, rows, cols):
    if tv.dim() != 4 or tuple(tv.shape[2:]) != (3, 3):
        raise ValueError(f"soft_raster: tv must be [V, T, 3, 3], got "
                         f"{list(tv.shape)}")
    if rows <= 0 or cols <= 0:
        raise ValueError(f"soft_raster: a {rows} x {cols} grid")
    V, T = tv.shape[:2]
    dev = tv.device
    return (V, T, _f32(tv, "tv", (V, T, 3, 3), dev),
            _f32(tc, "tc", (T, 3, 3), dev))


def _bg(bg_color):
    return [float(np.float32(x)) for x in bg_color]


def soft_raster_fwd(tv, tc, rows: int, cols: int, *, sigma: float,
                    gamma: float, bg_color=(0.0, 0.0, 0.0)):
    """Twin of ``soft_raster_fwd_ref``: CPU tensors run it; CUDA tensors
    launch the forward kernel once (a pixel's 8 lanes split the
    triangles)."""
    if tv.device.type == "cpu":
        return soft_raster_fwd_ref(tv, tc, rows, cols, sigma=sigma,
                                   gamma=gamma, bg_color=bg_color)
    global launches
    _build.require_device(tv, tc, what="soft_raster_fwd")
    V, T, tv, tc = _geometry(tv, tc, rows, cols)
    rgb = torch.empty((V, rows, cols, 3), dtype=torch.float32,
                      device=tv.device)
    stats = torch.empty((V, rows, cols, 2), dtype=torch.float32,
                        device=tv.device)
    err = _build.lib().soft_raster_fwd_launch(
        tv.data_ptr(), tc.data_ptr(), rgb.data_ptr(), stats.data_ptr(), V, T,
        rows, cols, sigma, gamma, *_bg(bg_color), _build.stream_ptr(tv.device))
    launches += 1
    _build.check(err, "soft_raster_fwd_launch")
    return rgb, stats


def soft_raster_bwd(tv, tc, rgb, stats, grad_rgb, rows: int, cols: int, *,
                    sigma: float, gamma: float):
    """Twin of ``soft_raster_bwd_ref``: CPU tensors run it; CUDA tensors
    launch the backward kernel once (a block a triangle over every view
    and pixel, its sums folded in a fixed order: the same bits from call
    to call)."""
    if tv.device.type == "cpu":
        return soft_raster_bwd_ref(tv, tc, rgb, stats, grad_rgb, rows, cols,
                                   sigma=sigma, gamma=gamma)
    global launches_bwd
    _build.require_device(tv, tc, rgb, stats, grad_rgb,
                          what="soft_raster_bwd")
    V, T, tv, tc = _geometry(tv, tc, rows, cols)
    dev = tv.device
    rgb = _f32(rgb, "rgb", (V, rows, cols, 3), dev)
    stats = _f32(stats, "stats", (V, rows, cols, 2), dev)
    grad_rgb = _f32(grad_rgb, "grad_rgb", (V, rows, cols, 3), dev)
    gtv = torch.empty((V, T, 3, 3), dtype=torch.float32, device=dev)
    gtc = torch.empty((T, 3, 3), dtype=torch.float32, device=dev)
    err = _build.lib().soft_raster_bwd_launch(
        tv.data_ptr(), tc.data_ptr(), rgb.data_ptr(), stats.data_ptr(),
        grad_rgb.data_ptr(), gtv.data_ptr(), gtc.data_ptr(), V, T, rows,
        cols, sigma, gamma, _build.stream_ptr(dev))
    launches_bwd += 1
    _build.check(err, "soft_raster_bwd_launch")
    return gtv, gtc


def soft_loss(rgb, target, row_lo: int = 0, *, ramp_len: int = 10,
              tau: float = 0.05, glyph_weight: float = 0.1):
    """Twin of ``soft_loss_ref``: CPU tensors run it; CUDA tensors launch
    the loss kernel once (a block a view: the losses folded in a fixed
    order, the gradient written a pixel a thread, zeros outside the
    band)."""
    if rgb.device.type == "cpu":
        return soft_loss_ref(rgb, target, row_lo, ramp_len=ramp_len, tau=tau,
                             glyph_weight=glyph_weight)
    global launches_loss
    _build.require_device(rgb, target, what="soft_loss")
    if rgb.dim() != 4 or rgb.shape[-1] != 3 or target.dim() != 4:
        raise ValueError(f"soft_loss: rgb [V, H, W, 3] and target [V, band,"
                         f" W, 3], got {list(rgb.shape)}, "
                         f"{list(target.shape)}")
    V, H, W, _ = rgb.shape
    band = target.shape[1]
    if not 0 <= row_lo <= row_lo + band <= H or ramp_len < 1:
        raise ValueError(f"soft_loss: rows {row_lo} to {row_lo + band} of "
                         f"{H}, ramp of {ramp_len}")
    dev = rgb.device
    rgb = _f32(rgb, "rgb", (V, H, W, 3), dev)
    target = _f32(target, "target", (V, band, W, 3), dev)
    losses = torch.empty(V, dtype=torch.float32, device=dev)
    grad = torch.empty_like(rgb)
    err = _build.lib().soft_loss_launch(
        rgb.data_ptr(), target.data_ptr(), grad.data_ptr(), losses.data_ptr(),
        V, H * W, row_lo * W, band * W, ramp_len, tau, glyph_weight, _THIRD,
        _LUM_HI, _build.stream_ptr(dev))
    launches_loss += 1
    _build.check(err, "soft_loss_launch")
    return losses, grad


class SoftRaster(torch.autograd.Function):
    """rgb f32 [V, rows, cols, 3] of the projected triangles ``tv``, ``tc``
    by X5's forward kernel; its backward is X5's backward kernel, from the
    saved rgb and softmax statistics."""

    @staticmethod
    def forward(ctx, tv, tc, rows, cols, sigma, gamma, bg_color):
        rgb, stats = soft_raster_fwd(tv, tc, rows, cols, sigma=sigma,
                                     gamma=gamma, bg_color=bg_color)
        ctx.save_for_backward(tv, tc, rgb, stats)
        ctx.args = (rows, cols, sigma, gamma)
        return rgb

    @staticmethod
    def backward(ctx, grad_rgb):
        tv, tc, rgb, stats = ctx.saved_tensors
        rows, cols, sigma, gamma = ctx.args
        gtv, gtc = soft_raster_bwd(tv, tc, rgb, stats, grad_rgb, rows, cols,
                                   sigma=sigma, gamma=gamma)
        return gtv, gtc, None, None, None, None, None


class SoftLoss(torch.autograd.Function):
    """Each view's band loss f32 [V] by X5b's kernel, which writes d loss /
    d rgb in the same launch; the backward scales it by each view's
    incoming gradient."""

    @staticmethod
    def forward(ctx, rgb, target, row_lo, ramp_len, tau, glyph_weight):
        losses, grad = soft_loss(rgb, target, row_lo, ramp_len=ramp_len,
                                 tau=tau, glyph_weight=glyph_weight)
        ctx.save_for_backward(grad)
        return losses

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return grad * g.reshape(-1, 1, 1, 1), None, None, None, None, None
