"""2-D homogeneous triangle setup: the CUDA kernel ``csrc/setup2dh.cu``
(replaces the Pallas ``ascii_renderer_tpu/ops/setup2dh.py:_setup_kernel``)
and its plain-torch version.

  in : pos9 f32 [9, T], attrs_t f32 [3A, T], mvp f32 [4, 4]
  out: cm f32 [16+3A+3, Tp/128, 128] channel-major, rows =
       0..11   walk-entry planes e0a..e2c, zx, zy, zc
       12      triangle id (f32)
       13..15  zeros (entry-row padding)
       16..    shade planes p{j}{a,b,c} + dna, dnb, dnc
       bbox    dict of [Tp] channels bx0/bx1/by0/by1 + bool valid
Tp is T padded to a multiple of 1024; pad slots are all-zero triangles,
which never validate, and carry ids >= T.

Every plane is one float32 chain in the JAX order
(``ascii_renderer_tpu/backends/raster.py:setup_2dh``), with the products
fused where the reference's compiler fuses them (core/fp.py) and IEEE
division: the kernel (explicit ``fmaf``, built with ``-fmad=false``) equals
the plain version bit for bit, and both equal the JAX setup.
"""

from __future__ import annotations

import ctypes

import torch

from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.ops import _build

BT = 1024           # triangles per padding quantum
EPS_W = 1e-4        # near-guard for projections used only by binning bboxes

launches = 0        # kernel launches by setup_2dh_fused (not by the ref)


def n_channels(n_attrs: int) -> int:
    """Channels of the cm block (walk entry + shade planes) for A attrs."""
    return 16 + 3 * n_attrs + 3


def _diff2(a, b, c, d):
    """a*b - c*d, the left product fused: fma(a, b, -(c*d))."""
    return fma32(a, b, -(c * d))


def _dot3(a0, b0, a1, b1, a2, b2):
    """a0*b0 + a1*b1 + a2*b2 as fma(a2, b2, fma(a0, b0, a1*b1))."""
    return fma32(a2, b2, fma32(a0, b0, a1 * b1))


def setup_channels(pos9: torch.Tensor, attrs_t: torch.Tensor,
                   mvp: torch.Tensor, rows: int, cols: int) -> dict:
    """The setup math on [T] channels (plain torch): e{k}{a,b,c} edge
    planes (inside <=> value <= 0), zx/zy/zc the screen-z plane,
    p{j}{a,b,c} attribute planes, dna/dnb/dnc the denominator plane,
    bx0/bx1/by0/by1 the binning bbox and bool valid. Same formulas and op
    order as the JAX ``setup_2dh``."""
    A3, T = attrs_t.shape
    A = A3 // 3
    m = mvp.detach().cpu().to(torch.float32).tolist()
    vs = {}
    for i, s in enumerate("abc"):
        px, py, pz = pos9[3 * i], pos9[3 * i + 1], pos9[3 * i + 2]
        # r0*px + r1*py + r2*pz + r3: the first two products fuse
        xc, yc, zc, wc = (
            fma32(r[2], pz, fma32(r[0], px, r[1] * py)) + r[3] for r in m)
        vs[f"x{s}"] = (xc + wc) * (0.5 * cols)
        vs[f"y{s}"] = (wc - yc) * (0.5 * rows)
        vs[f"z{s}"] = (zc + wc) * 0.5
        vs[f"w{s}"] = wc

    def cross3(s1, s2):
        x1, y1, w1 = vs[f"x{s1}"], vs[f"y{s1}"], vs[f"w{s1}"]
        x2, y2, w2 = vs[f"x{s2}"], vs[f"y{s2}"], vs[f"w{s2}"]
        return (_diff2(y1, w2, w1, y2), _diff2(w1, x2, x1, w2),
                _diff2(x1, y2, y1, x2))

    e0 = cross3("b", "c")
    e1 = cross3("c", "a")
    e2 = cross3("a", "b")
    det = _dot3(vs["xa"], e0[0], vs["ya"], e0[1], vs["wa"], e0[2])
    det_safe = torch.where(det.abs() < 1e-30, -1e-30, det)
    ninv = torch.reciprocal(det_safe)  # negative for front faces
    inv = -ninv                        # positive scale: inside <=> <= 0

    ch = {}
    for k, e in enumerate((e0, e1, e2)):
        ch[f"e{k}a"], ch[f"e{k}b"], ch[f"e{k}c"] = (
            e[0] * inv, e[1] * inv, e[2] * inv)
    for nm, j in (("zx", 0), ("zy", 1), ("zc", 2)):
        ch[nm] = _dot3(vs["za"], e0[j], vs["zb"], e1[j], vs["zc"],
                       e2[j]) * ninv
    for jj in range(A):
        aa, ab, ac = attrs_t[jj], attrs_t[A + jj], attrs_t[2 * A + jj]
        for c_i, sfx in enumerate("abc"):
            ch[f"p{jj}{sfx}"] = _dot3(aa, e0[c_i], ab, e1[c_i], ac,
                                      e2[c_i]) * ninv
    for c_i, sfx in enumerate("abc"):
        ch[f"dn{sfx}"] = (e0[c_i] + e1[c_i] + e2[c_i]) * ninv

    # ---- binning bbox over projectable candidates ----
    big = torch.full_like(det, 1e9)
    x0, x1, y0, y1 = big, -big, big, -big

    def fold(mask, xq, yq, x0, x1, y0, y1):
        return (torch.where(mask, torch.minimum(x0, xq), x0),
                torch.where(mask, torch.maximum(x1, xq), x1),
                torch.where(mask, torch.minimum(y0, yq), y0),
                torch.where(mask, torch.maximum(y1, yq), y1))

    front = {}
    for s in "abc":
        w = vs[f"w{s}"]
        front[s] = w > EPS_W
        iw = torch.reciprocal(torch.where(front[s], w, 1.0))
        x0, x1, y0, y1 = fold(front[s], vs[f"x{s}"] * iw, vs[f"y{s}"] * iw,
                              x0, x1, y0, y1)
    inv_eps = 1.0 / EPS_W
    for s1, s2 in (("a", "b"), ("b", "c"), ("c", "a")):
        w1, w2 = vs[f"w{s1}"], vs[f"w{s2}"]
        crossing = front[s1] != front[s2]
        t = (w1 - EPS_W) / torch.where(crossing, w1 - w2, 1.0)
        xq = fma32(t, vs[f"x{s2}"] - vs[f"x{s1}"], vs[f"x{s1}"]) * inv_eps
        yq = fma32(t, vs[f"y{s2}"] - vs[f"y{s1}"], vs[f"y{s1}"]) * inv_eps
        x0, x1, y0, y1 = fold(crossing, xq, yq, x0, x1, y0, y1)
    ch["bx0"], ch["bx1"], ch["by0"], ch["by1"] = x0, x1, y0, y1

    # ---- validity ----
    all_front = front["a"] & front["b"] & front["c"]
    iw3 = tuple(torch.reciprocal(torch.where(front[s], vs[f"w{s}"], 1.0))
                for s in "abc")
    a2h = det * iw3[0] * iw3[1] * iw3[2]
    sz = tuple(vs[f"z{s}"] * iw3[i] for i, s in enumerate("abc"))
    szmin = torch.minimum(torch.minimum(sz[0], sz[1]), sz[2])
    szmax = torch.maximum(torch.maximum(sz[0], sz[1]), sz[2])
    valid_front = ((a2h < 0.0) & (a2h.abs() > 1e-12)
                   & (szmax >= 0.0) & (szmin <= 1.0))
    valid_cross = det < -1e-20
    ch["valid"] = torch.where(all_front, valid_front, valid_cross)
    return ch


def _plane_keys(n_attrs: int):
    return ([f"p{j}{s}" for j in range(n_attrs) for s in "abc"]
            + ["dna", "dnb", "dnc"])


def _split(out: torch.Tensor, n_g: int):
    tp = out.shape[1]
    bbox = {"bx0": out[n_g], "bx1": out[n_g + 1], "by0": out[n_g + 2],
            "by1": out[n_g + 3], "valid": out[n_g + 4] > 0.5}
    return out[:n_g].view(n_g, tp // 128, 128), bbox


def setup_2dh_fused_ref(pos9: torch.Tensor, attrs_t: torch.Tensor,
                        mvp: torch.Tensor, rows: int, cols: int):
    """Plain-torch version of ``setup_2dh_fused`` (same outputs)."""
    A3, T = attrs_t.shape
    A = A3 // 3
    tp = -(-T // BT) * BT
    if tp > T:
        pos9 = torch.cat([pos9, pos9.new_zeros((9, tp - T))], dim=1)
        attrs_t = torch.cat([attrs_t, attrs_t.new_zeros((A3, tp - T))], dim=1)
    ch = setup_channels(pos9, attrs_t, mvp, rows, cols)
    ids = torch.arange(tp, dtype=torch.float32, device=pos9.device)
    zero = torch.zeros_like(ids)
    names = ["e0a", "e0b", "e0c", "e1a", "e1b", "e1c", "e2a", "e2b", "e2c",
             "zx", "zy", "zc"]
    out = torch.stack([ch[k] for k in names] + [ids, zero, zero, zero]
                      + [ch[k] for k in _plane_keys(A)]
                      + [ch["bx0"], ch["bx1"], ch["by0"], ch["by1"],
                         ch["valid"].to(torch.float32)])
    return _split(out, n_channels(A))


def setup_2dh_fused(pos9: torch.Tensor, attrs_t: torch.Tensor,
                    mvp: torch.Tensor, rows: int, cols: int):
    """(pos9 [9, T], attrs_t [3A, T], mvp [4,4]) -> (cm f32 [16+3A+3,
    Tp/128, 128], bbox dict of [Tp] channels bx0/bx1/by0/by1/valid).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (one thread per triangle). The mvp is read on the host and passed to
    the kernel by value."""
    if pos9.device.type == "cpu":
        return setup_2dh_fused_ref(pos9, attrs_t, mvp, rows, cols)
    global launches
    _build.require_cuda(pos9, attrs_t, what="setup_2dh_fused")
    if pos9.dtype != torch.float32 or attrs_t.dtype != torch.float32:
        raise ValueError("setup_2dh_fused: expected float32 inputs")
    A3, T = attrs_t.shape
    if pos9.shape != (9, T) or A3 % 3 != 0 or tuple(mvp.shape) != (4, 4):
        raise ValueError(f"setup_2dh_fused: bad shapes {tuple(pos9.shape)} "
                         f"{tuple(attrs_t.shape)} {tuple(mvp.shape)}")
    A = A3 // 3
    tp = -(-T // BT) * BT
    n_g = n_channels(A)
    out = torch.empty((n_g + 5, tp), dtype=torch.float32, device=pos9.device)
    m16 = (ctypes.c_float * 16)(*mvp.detach().cpu().to(torch.float32)
                                .reshape(-1).tolist())
    err = _build.lib().setup2dh_launch(
        pos9.data_ptr(), attrs_t.data_ptr(), m16, out.data_ptr(), T, tp, A,
        rows, cols, _build.stream_ptr(pos9.device))
    launches += 1
    _build.check(err, "setup2dh_launch")
    return _split(out, n_g)
