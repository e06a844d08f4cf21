"""The host's float32 chains on Python floats and numpy arrays, bit for
bit against the tensor forms they replace: ``core/fp.fma32_scalar`` and
``fma32_np`` against ``fma32_f64`` (double-rounding ties, signed zeros,
subnormals, sums past FLT_MAX, infinities and NaN; hypothesis too);
``backends/raster.camera_mvp`` against a copy of its tensor chain on 600
seeded poses and the golden cameras; ``core/camera.camera_bases`` at 1, 8
and 1,024 views in both of its forms (Python floats, numpy arrays)
against a copy of its tensor chain, the pitch limits and the looks
straight up and down (``nu < 1e-3``) included. No JAX here: the JAX side
of the MVP and the basis is ``tests/test_torch_sqrt.py`` and
``tests/test_torch_camera_exact.py``."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.core.fp import (fma32_f64, fma32_np,
                                              fma32_scalar, libm32, round32,
                                              sqrt32)
from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras

torch.set_num_threads(2)

F32_MAX = float(np.finfo(np.float32).max)
ULP = 2.0 ** -23
SUB = 2.0 ** -149  # the least float32 subnormal


def _bits(a):
    """int32 view, NaNs made equal."""
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def _special_triples():
    """Triples at the edges: double-rounding ties (test_torch_fp.TIES),
    signed zeros, subnormal products and sums, sums past FLT_MAX that round
    to it or to infinity, infinities and NaN."""
    t = list(zip((1 + ULP, 1 - ULP, 1 + ULP, -(1 + ULP)),
                 (2.0 ** -24 * (1 - ULP), 2.0 ** -24 * (1 + ULP),
                  2.0 ** -14 * (1 - ULP), 2.0 ** -24 * (1 - ULP)),
                 (1 + ULP, 1 + ULP, 1024 * (1 + ULP), -(1 + ULP))))
    for sa in (0.0, -0.0):
        for sb in (1.5, -1.5):
            for sc in (0.0, -0.0):
                t.append((sa, sb, sc))
    t += [(SUB, 0.5, 0.0), (SUB * 3, 0.5, -0.0), (SUB, SUB, -SUB),
          (2.0 ** -75, 2.0 ** -75, SUB), (2.0 ** -126, 0.5, SUB),
          (-(2.0 ** -126), 1 - ULP, 2.0 ** -126), (1e-20, 1e-20, -SUB)]
    # past FLT_MAX: below, at and above the midpoint to 2^128
    t += [(F32_MAX, 1.0, F32_MAX * 2.0 ** -24),
          (F32_MAX, 1.0, 2.0 ** 103), (F32_MAX, 1.0 + ULP, 0.0),
          (F32_MAX, 1.0, 2.0 ** 102), (-F32_MAX, 1.0, -(2.0 ** 103)),
          (2.0 ** 64, 2.0 ** 64, -1.0), (2.0 ** 100, 2.0 ** 100, 1.0),
          (F32_MAX, 2.0, -F32_MAX), (2.0 ** 127, 2.0, -(2.0 ** 104))]
    t += [(math.inf, 1.0, 1.0), (math.inf, 0.0, 1.0),
          (math.inf, 1.0, -math.inf), (1.0, 1.0, math.inf),
          (math.nan, 1.0, 0.0), (1.0, 2.0, math.nan),
          (-math.inf, -2.0, 3.0)]
    return [tuple(float(np.float32(x)) for x in v) for v in t]


def _f64_ref(a, b, c):
    return fma32_f64(*(torch.tensor(np.asarray(x, np.float32))
                       for x in (a, b, c))).numpy()


def test_fma32_scalar_and_np_special_cases():
    trip = _special_triples()
    a, b, c = (np.array([t[k] for t in trip], np.float32) for k in range(3))
    want = _bits(_f64_ref(a, b, c))
    got = _bits([fma32_scalar(*t) for t in trip])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_bits(fma32_np(a, b, c)), want)
    # the cases reach what they name: a tie the float64 sum gets wrong, a
    # sum that rounds to infinity and one that rounds down to FLT_MAX
    naive = (a[:4].astype(np.float64) * b[:4] + c[:4]).astype(np.float32)
    assert (naive != fma32_np(a, b, c)[:4]).all()
    got = np.array([fma32_scalar(*t) for t in trip])
    assert np.isposinf(got).any() and np.isneginf(got).any()
    assert (got == F32_MAX).any() and np.isnan(got).any()
    assert (np.signbit(got) & (got == 0)).any()


@pytest.mark.parametrize("scale", ["unit", "wide", "cancel"])
def test_fma32_scalar_and_np_seeded(scale):
    rng = np.random.default_rng({"unit": 1, "wide": 2, "cancel": 3}[scale])
    n = 20_000
    a, b, c = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    if scale == "wide":
        a *= np.float32(2.0) ** rng.integers(-140, 120, n).astype(np.float32)
        b *= np.float32(2.0) ** rng.integers(-30, 30, n).astype(np.float32)
        c *= np.float32(2.0) ** rng.integers(-149, 127, n).astype(np.float32)
    elif scale == "cancel":
        with np.errstate(all="ignore"):
            c = -(a * b) * (1 + np.float32(ULP) * rng.integers(-3, 4, n))
        c = c.astype(np.float32)
    want = _bits(_f64_ref(a, b, c))
    np.testing.assert_array_equal(_bits(fma32_np(a, b, c)), want)
    got = [fma32_scalar(float(x), float(y), float(z))
           for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(_bits(got), want)


F32 = st.floats(width=32, allow_nan=True, allow_infinity=True)


@settings(max_examples=400, deadline=None, derandomize=True,
          database=None)
@given(F32, F32, F32)
def test_fma32_scalar_hypothesis(a, b, c):
    want = _bits(_f64_ref([a], [b], [c]))
    np.testing.assert_array_equal(_bits([fma32_scalar(a, b, c)]), want)
    np.testing.assert_array_equal(_bits(fma32_np(a, b, c)), want)


@settings(max_examples=200, deadline=None, derandomize=True,
          database=None)
@given(st.floats(allow_nan=True, allow_infinity=True))
def test_round32_is_numpy_nearest_even_without_warnings(x):
    with np.errstate(over="raise"):
        if abs(x) < 2.0 ** 128 - 2.0 ** 103 or x != x:
            want = np.float32(x)
        else:
            want = np.float32(math.copysign(math.inf, x))
        assert _bits([round32(x)]) == _bits([want])


# ---------------------------------------------------------------------------
# camera_mvp against its tensor chain
# ---------------------------------------------------------------------------
def _perspective_t(fovy_rad, aspect, near=R.NEAR, far=R.FAR):
    fovy = torch.as_tensor(fovy_rad, dtype=torch.float32).cpu()
    f = torch.reciprocal(libm32(math.tan, torch.clamp(fovy * 0.5, min=1e-6)))
    nf = 1.0 / (near - far)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = f * torch.reciprocal(torch.tensor(aspect, dtype=torch.float32))
    m[1, 1] = f
    m[2, 2] = (far + near) * nf
    m[2, 3] = 2 * far * near * nf
    m[3, 2] = -1.0
    return m


def _cross_t(a, b):
    return torch.stack([fma32_f64(a[i], b[j], -(a[j] * b[i]))
                        for i, j in ((1, 2), (2, 0), (0, 1))])


def _matmul_t(p, q):
    acc = p[:, :1] * q[:1, :]
    for k in range(1, p.shape[1]):
        acc = fma32_f64(p[:, k:k + 1], q[k:k + 1, :], acc)
    return acc


def _normalize_t(v):
    return v / sqrt32(_matmul_t(v[None, :], v[:, None])[0, 0])


def _look_at_t(eye, center, up):
    f = _normalize_t(center - eye)
    s = _normalize_t(_cross_t(f, up))
    u = _cross_t(s, f)
    m = torch.stack([s, u, -f])
    t = _matmul_t(-m, eye[:, None])
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32)
    return torch.cat([torch.cat([m, t], dim=1), bottom], dim=0)


def _camera_mvp_t(cam, rows, cols, pixel_aspect):
    """camera_mvp as it was: the chain on 0-d and [3] CPU tensors."""
    cp, sp = libm32(math.cos, cam.pitch), libm32(math.sin, cam.pitch)
    cy, sy = libm32(math.cos, cam.yaw), libm32(math.sin, cam.yaw)
    aspect = max(1e-6, (cols / max(1, rows)) * pixel_aspect)
    proj = _perspective_t(cam.fov_y, aspect)
    pos = cam.pos.cpu()
    center = torch.stack([fma32_f64(cp, cy, pos[0]), pos[1] + sp,
                          fma32_f64(cp, sy, pos[2])])
    view = _look_at_t(pos, center,
                      torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32))
    return _matmul_t(proj, view)


GOLDEN_CAMS = (  # the bunny headline's, the PT poster's, the goldens' rooms
    dict(pos=(2.4, 1.4, 2.8), yaw=float(np.arctan2(-2.8, -2.4)), pitch=-0.3),
    dict(pos=(0.0, 2.5, 6.0), yaw=-math.pi / 2),
    dict(pos=(0.0, 0.2, 0.3), yaw=-math.pi / 2, pitch=-0.1),
    dict(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3),
    dict(pos=(0.0, 0.0, 5.0)),
    dict(pos=(1.0, 2.0, 3.0), yaw=0.0, pitch=math.pi / 2),  # straight up
)
GRIDS = ((540, 960, 0.5), (36, 96, 0.5), (24, 80, 0.5), (135, 240, 1.0),
         (1, 1, 1.0), (0, 7, 2.0))


def _seeded_cams(n=600):
    rng = np.random.default_rng(21)
    lim = math.pi * 0.5 - 0.1
    out = []
    for i in range(n):
        out.append(dict(
            pos=tuple(rng.uniform(-50, 50, 3) * 10.0 ** rng.integers(-3, 2)),
            yaw=float(rng.uniform(-math.pi, math.pi)),
            pitch=float(rng.uniform(-lim, lim)) if i % 7 else
            float(rng.choice([lim, -lim, 0.0, math.pi / 2])),
            fov_y_deg=float(rng.uniform(1.0, 170.0))))
    return out


@pytest.mark.parametrize("which", ["golden", "seeded"])
def test_camera_mvp_equals_tensor_chain(which):
    cams = GOLDEN_CAMS if which == "golden" else _seeded_cams()
    n = 0
    for i, kw in enumerate(cams):
        cam = Camera.create(**kw)
        grids = GRIDS if which == "golden" else (GRIDS[i % len(GRIDS)],)
        for rows, cols, pa in grids:
            got = R.camera_mvp(cam, rows, cols, pa)
            assert got.dtype == torch.float32 and got.shape == (4, 4)
            assert got.device.type == "cpu"
            np.testing.assert_array_equal(
                _bits(got), _bits(_camera_mvp_t(cam, rows, cols, pa)),
                err_msg=f"{kw} at {rows}x{cols}")
            n += 1
    assert n >= (36 if which == "golden" else 600)


def test_look_at_and_perspective_keep_their_tensor_signatures():
    rng = np.random.default_rng(5)
    up = torch.tensor([0.0, 1.0, 0.0])
    for _ in range(200):
        eye, cen = (torch.from_numpy(rng.uniform(-5, 5, 3).astype(np.float32))
                    for _ in range(2))
        np.testing.assert_array_equal(_bits(R.look_at(eye, cen, up)),
                                      _bits(_look_at_t(eye, cen, up)))
    for fovy in (0.0, 1e-9, 0.3, 1.3962634, 3.1):
        for aspect in (1e-6, 0.4, 2.6666667, 1e4):
            np.testing.assert_array_equal(
                _bits(R.perspective(fovy, aspect)),
                _bits(_perspective_t(fovy, aspect)))


# ---------------------------------------------------------------------------
# camera_bases against its tensor chain, in both forms
# ---------------------------------------------------------------------------
def _bases_t(yaw, pitch, fov_y):
    """camera_bases as it was: the chain on [V] CPU tensors."""
    def trig(fn, x):
        return torch.tensor([fn(v) for v in x.reshape(-1).tolist()],
                            dtype=torch.float32)

    cp, sp = trig(math.cos, pitch), trig(math.sin, pitch)
    cy, sy = trig(math.cos, yaw), trig(math.sin, yaw)
    zero, one = torch.zeros_like(cp), torch.ones_like(cp)
    ww = torch.stack([cp * cy, sp, cp * sy])
    ww = ww / TC._norm3(ww)
    uu = TC._cross(ww, torch.stack([zero, one, zero]))
    nu = TC._norm3(uu)
    x_axis = torch.stack([one, zero, zero])
    uu = torch.where(nu < 1e-3, x_axis, uu / torch.clamp(nu, min=1e-20))
    vv = TC._cross(uu, ww)
    vv = vv / TC._norm3(vv)
    half = trig(math.tan, 0.5 * fov_y.reshape(-1))
    focal = one / torch.clamp(half, min=1e-6)
    return uu.t(), vv.t(), ww.t(), focal


def _pose_batch(v, seed):
    """v seeded poses, the edges first: the pitch limits, straight up and
    down (nu < 1e-3: the x axis), the axes, tiny and wide fields of view."""
    rng = np.random.default_rng(seed)
    lim = math.pi * 0.5 - 0.1
    yaw = rng.uniform(-math.pi, math.pi, v)
    pitch = rng.uniform(-lim, lim, v)
    fov = np.radians(rng.uniform(1.0, 179.0, v))
    edges = [(0.0, math.pi / 2, 1.2), (0.7, -math.pi / 2, 0.9),
             (1.0, lim, 1e-7), (-2.0, -lim, 3.1), (math.pi, 0.0, 1.0),
             (-0.0, -0.0, math.pi / 2), (1e-7, 1.5707, 0.5),
             (-math.pi / 2, 1.5708, 2.0)]
    for i, (y, p, f) in enumerate(edges[:v]):
        yaw[i], pitch[i], fov[i] = y, p, f
    return tuple(torch.from_numpy(np.asarray(x, np.float32))
                 for x in (yaw, pitch, fov))


@pytest.mark.parametrize("form", ["floats", "numpy"])
@pytest.mark.parametrize("views", [1, 8, 1024])
def test_camera_bases_equal_tensor_chain(monkeypatch, views, form):
    monkeypatch.setattr(TC, "SCALAR_VIEWS",
                        1 << 30 if form == "floats" else 0)
    poses = _pose_batch(views, seed=views)
    got = TC.camera_bases(*poses)
    want = _bases_t(*poses)
    for g, w, name in zip(got, want, ("uu", "vv", "ww", "focal")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
    # the looks straight up and down, and within 1e-4 of it, take the x
    # axis: edges 0, 1, 6 and 7
    n_axis = int((got[0] == torch.tensor([1.0, 0.0, 0.0])).all(1).sum())
    assert n_axis == (1 if views == 1 else 4)


def test_camera_bases_of_the_farm_poses_in_both_forms(monkeypatch):
    cams = orbit_cameras(1024, center=(0, 1.0, 1.0), radius=6.0)
    poses = (cams.yaw, cams.pitch, cams.fov_y)
    want = _bases_t(*poses)
    for scalar in (0, 1 << 30):
        monkeypatch.setattr(TC, "SCALAR_VIEWS", scalar)
        for g, w in zip(TC.camera_bases(*poses), want):
            np.testing.assert_array_equal(_bits(g), _bits(w))
