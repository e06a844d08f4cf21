"""Camera state and controls (torch port of
``ascii_renderer_tpu/core/camera.py``; ref: js/camera.js).

Camera convention (identical across all backends):
  look = (cos p * cos y,  sin p,  cos p * sin y)      up = (0,1,0)
  focal = 1 / tan(fovY/2),  fovY default 80 deg

The camera is a handful of scalars; it lives on the host (``device``
defaults to the CPU) so the MVP it yields is the same float32 matrix
whichever device renders the frame.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ascii_renderer_tpu_torch.core.fp import (div32, fma32, fma32_np,
                                              fma32_scalar, libm32, round32,
                                              sqrt32, sqrt32_scalar)

_PITCH_LIMIT = math.pi * 0.5 - 0.1  # just shy of +/-90 deg (js/camera.js:34)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: torch.Tensor  # f32 [3]
    yaw: torch.Tensor  # f32 scalar
    pitch: torch.Tensor  # f32 scalar
    fov_y: torch.Tensor  # f32 scalar (radians)
    speed: torch.Tensor  # f32 scalar, units/sec (js/camera.js:11)
    sensitivity: torch.Tensor  # f32 scalar, rad/sec (js/camera.js:12)

    @staticmethod
    def create(pos=(0.0, 0.0, 5.0), yaw=0.0, pitch=0.0, fov_y_deg=80.0,
               speed=2.5, sensitivity=1.5, device="cpu") -> "Camera":
        return Camera(
            pos=_f32([float(v) for v in pos], device),
            yaw=_f32(float(yaw), device),
            pitch=_f32(float(pitch), device),
            fov_y=_f32(fov_y_deg * math.pi / 180.0, device),
            speed=_f32(float(speed), device),
            sensitivity=_f32(float(sensitivity), device),
        )

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def __getitem__(self, key) -> "Camera":
        """View ``key`` (an index or a slice) of a batch of cameras."""
        return Camera(**{f.name: getattr(self, f.name)[key]
                         for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class CameraInputs:
    """Per-frame input snapshot (keysPressed plus pointer-look deltas)."""

    forward: torch.Tensor  # W
    back: torch.Tensor  # S
    left: torch.Tensor  # A
    right: torch.Tensor  # D
    up: torch.Tensor  # Space
    down: torch.Tensor  # Shift
    look_up: torch.Tensor  # ArrowUp
    look_down: torch.Tensor  # ArrowDown
    look_left: torch.Tensor  # ArrowLeft
    look_right: torch.Tensor  # ArrowRight
    mouse_dx: torch.Tensor  # pointer-look delta (pixels this frame)
    mouse_dy: torch.Tensor

    @staticmethod
    def from_keys(keys=(), mouse_dx=0.0, mouse_dy=0.0,
                  device="cpu") -> "CameraInputs":
        keys = {str(k).lower() for k in keys}

        def b(k):
            return _f32(1.0 if k in keys else 0.0, device)

        return CameraInputs(
            forward=b("w"), back=b("s"), left=b("a"), right=b("d"),
            up=b(" "), down=b("shift"),
            look_up=b("arrowup"), look_down=b("arrowdown"),
            look_left=b("arrowleft"), look_right=b("arrowright"),
            mouse_dx=_f32(float(mouse_dx), device),
            mouse_dy=_f32(float(mouse_dy), device),
        )


def update_camera(cam: Camera, inputs: CameraInputs, dt) -> Camera:
    """Pure integrator, semantics of js/camera.js:23-53 plus the pointer-look
    path of js/main.js:108-118 (same op order as the JAX twin). Rounds as
    the reference's compiled (jitted) integrator, which every frame step
    runs: each product fused into the add it feeds (core/fp.py), cos / sin
    of the float32 yaw correctly rounded through Python's libm."""
    dt = _f32(float(dt), cam.yaw.device)
    look_step = cam.sensitivity * dt
    mouse_sens = cam.sensitivity * 0.002

    pitch = fma32(look_step, inputs.look_up - inputs.look_down, cam.pitch)
    yaw = fma32(look_step, inputs.look_right - inputs.look_left, cam.yaw)
    yaw = fma32(inputs.mouse_dx, mouse_sens, yaw)
    pitch = fma32(-inputs.mouse_dy, mouse_sens, pitch)

    pitch = torch.clamp(pitch, -_PITCH_LIMIT, _PITCH_LIMIT)
    pi = _f32(math.pi, yaw.device)
    yaw = torch.where(yaw > pi, yaw - 2 * pi, yaw)
    yaw = torch.where(yaw < -pi, yaw + 2 * pi, yaw)

    move = cam.speed * dt
    zero = torch.zeros_like(yaw)
    cy = libm32(math.cos, yaw, yaw.device)
    sy = libm32(math.sin, yaw, yaw.device)
    fwd = torch.stack([cy, zero, sy])
    right = torch.stack([sy, zero, -cy])
    pos = fma32(fwd, move * (inputs.forward - inputs.back), cam.pos)
    pos = fma32(right, move * (inputs.left - inputs.right), pos)
    pos = pos + torch.stack([zero, move * (inputs.up - inputs.down), zero])

    return cam.replace(pos=pos, yaw=yaw, pitch=pitch)


def _cross(a, b) -> torch.Tensor:
    """jnp.cross as XLA fuses it: a1*b2 - a2*b1 -> fma(a1, b2, -(a2*b1))."""
    return torch.stack([fma32(a[1], b[2], -(a[2] * b[1])),
                        fma32(a[2], b[0], -(a[0] * b[2])),
                        fma32(a[0], b[1], -(a[1] * b[0]))])


def _norm3(a) -> torch.Tensor:
    """jnp.linalg.norm over the three components a[0..2] (tensors of one
    shape) as XLA fuses its sum of squares: x*x, then fma(y, y, .), then
    fma(z, z, .); the root correctly rounded."""
    return sqrt32(fma32(a[2], a[2], fma32(a[1], a[1], a[0] * a[0])))


def cross3(a, b) -> list:
    """``_cross`` on three Python floats each (float32 values): the left
    product of each component fused, the right one rounded."""
    return [fma32_scalar(a[1], b[2], -round32(a[2] * b[1])),
            fma32_scalar(a[2], b[0], -round32(a[0] * b[2])),
            fma32_scalar(a[0], b[1], -round32(a[1] * b[0]))]


def norm3(a) -> float:
    """``_norm3`` of three Python floats (float32 values)."""
    return sqrt32_scalar(fma32_scalar(a[2], a[2], fma32_scalar(
        a[1], a[1], round32(a[0] * a[0]))))


class HostBasis(NamedTuple):
    """One view's camera frame on Python floats (float32 values), as
    ``_basis_scalar`` forms it: ``camera_basis``'s values, kept off
    tensors for a launch that takes them by value."""
    uu: tuple
    vv: tuple
    ww: tuple
    focal: float
    nine: tuple  # uu, vv, focal * ww (rounded): a ray launch's 9 floats

    def tensors(self):
        """``camera_basis``'s tuple: uu, vv, ww f32 [3], focal f32 0-d
        (CPU tensors)."""
        return tuple(torch.tensor(v, dtype=torch.float32) for v in self[:4])


def camera_floats(cam: Camera) -> list:
    """The camera's position, yaw, pitch and fov_y as 6 Python floats (its
    float32 values), read in one copy from a camera on the card, none from
    one on the host."""
    parts = (cam.pos, cam.yaw, cam.pitch, cam.fov_y)
    if all(t.device.type == "cpu" for t in parts):
        return [*cam.pos.tolist(), cam.yaw.item(), cam.pitch.item(),
                cam.fov_y.item()]
    return torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in parts]).tolist()


def camera_basis_floats(yaw: float, pitch: float, fov_y: float) -> HostBasis:
    """``camera_basis`` of one pose given as Python floats, on Python
    floats: bit for bit its tensors (``bases_floats`` makes them from the
    same ``_basis_scalar``). Cached by pose, the signs of zeros included:
    a still or translating camera's frames form it once."""
    return _basis_floats(yaw, pitch, fov_y,
                         *(math.copysign(1.0, x) for x in (yaw, pitch,
                                                           fov_y)))


@functools.lru_cache(maxsize=64)
def _basis_floats(yaw, pitch, fov_y, *_signs) -> HostBasis:
    uu, vv, ww, focal = _basis_scalar(yaw, pitch, fov_y)
    return HostBasis(tuple(uu), tuple(vv), tuple(ww), focal,
                     (*uu, *vv, *(round32(focal * w) for w in ww)))


def camera_basis(yaw, pitch, fov_y):
    """Orthonormal camera frame used by every backend (contract 4), on the
    host like the rest of the camera: float32 tensors on ``yaw``'s device
    (``camera_bases`` of the one pose).

    Returns (uu, vv, ww, focal): ww = look dir, uu = right, vv = up,
    focal = 1/tan(fovY/2) (ref: pathtrace_shader.js:195-201)."""
    bases = camera_bases(*(t.reshape(1).cpu() for t in (yaw, pitch, fov_y)))
    return tuple(b[0].to(yaw.device) for b in bases)


# camera_bases evaluates up to this many views on Python floats, more as
# numpy arrays: on floats a view costs ~0.05 ms, on arrays a call costs
# ~0.3 ms whatever its views up to a few dozen (``kernel_ab --only glyph``
# times both forms at 1, 8, 16 and 1,024 poses)
SCALAR_VIEWS = 8
_F32_1EM3, _F32_1EM6, _F32_1EM20 = (round32(x) for x in (1e-3, 1e-6, 1e-20))


def _basis_scalar(yaw: float, pitch: float, fov_y: float):
    """One view's (uu, vv, ww, focal) on Python floats."""
    cp, sp = round32(math.cos(pitch)), round32(math.sin(pitch))
    cy, sy = round32(math.cos(yaw)), round32(math.sin(yaw))
    ww = [round32(cp * cy), sp, round32(cp * sy)]
    n = norm3(ww)
    ww = [div32(x, n) for x in ww]
    uu = cross3(ww, (0.0, 1.0, 0.0))
    nu = norm3(uu)
    if nu < _F32_1EM3:
        uu = [1.0, 0.0, 0.0]
    else:
        d = max(nu, _F32_1EM20)  # clamp(min=1e-20): NaN stays
        uu = [div32(x, d) for x in uu]
    vv = cross3(uu, ww)
    n = norm3(vv)
    vv = [div32(x, n) for x in vv]
    half = round32(math.tan(round32(0.5 * fov_y)))
    return uu, vv, ww, div32(1.0, max(half, _F32_1EM6))


def bases_floats(yaw: list, pitch: list, fov_y: list):
    """``camera_bases`` of the views (Python floats), each on Python
    floats (``_basis_scalar``)."""
    views = [_basis_scalar(*v) for v in zip(yaw, pitch, fov_y)]
    uu, vv, ww = (torch.tensor([v[k] for v in views],
                               dtype=torch.float32).reshape(-1, 3)
                  for k in range(3))
    return uu, vv, ww, torch.tensor([v[3] for v in views],
                                    dtype=torch.float32)


def bases_from_trig(cp, sp, cy, sy, half):
    """``_basis_scalar``'s chain after its trig, on numpy float32 arrays
    [V] of the views' cos / sin of pitch and of yaw and tan(fov_y / 2):
    (uu, vv, ww f32 [3, V] (a vector's three components stacked), focal
    f32 [V]), each operation rounded once (the fused ones through
    ``fma32_np``). The plain version of the bases K3's grid form forms on
    the card (``ops/rt_trace``, ``csrc/ray_dir.cuh``'s ``view_basis``)."""
    f32 = np.float32
    rot1, rot2 = [1, 2, 0], [2, 0, 1]

    def norm(a):
        d = fma32_np(a[2], a[2], fma32_np(a[1], a[1], a[0] * a[0]))
        return np.sqrt(d.astype(np.float64)).astype(f32)

    def cross(a, b):  # component k: fma(a[k+1], b[k+2], -(a[k+2] b[k+1]))
        return fma32_np(a[rot1], b[rot2], -(a[rot2] * b[rot1]))

    cp, sp, cy, sy, half = (np.asarray(x, f32) for x in (cp, sp, cy, sy,
                                                        half))
    with np.errstate(all="ignore"):
        zero, one = np.zeros_like(cp), np.ones_like(cp)
        ww = np.stack([cp * cy, sp, cp * sy])
        ww = ww / norm(ww)
        uu = cross(ww, np.stack([zero, one, zero]))
        nu = norm(uu)
        uu = np.where(nu < f32(1e-3), np.stack([one, zero, zero]),
                      uu / np.maximum(nu, f32(1e-20)))  # NaN stays
        vv = cross(uu, ww)
        vv = vv / norm(vv)
        focal = one / np.maximum(half, f32(1e-6))
    return uu, vv, ww, focal


def bases_arrays(yaw: list, pitch: list, fov_y: list):
    """``camera_bases`` of the views (Python floats) on numpy float32
    arrays: the trig through libm, a call a view and function, then
    ``bases_from_trig``."""
    f32 = np.float32

    def trig(fn, xs):
        return np.fromiter(map(fn, xs), np.float64, len(xs)).astype(f32)

    with np.errstate(all="ignore"):
        half = trig(math.tan, (f32(0.5) * np.array(fov_y, f32)).tolist())
        uu, vv, ww, focal = bases_from_trig(
            trig(math.cos, pitch), trig(math.sin, pitch),
            trig(math.cos, yaw), trig(math.sin, yaw), half)
    return (*(torch.from_numpy(np.ascontiguousarray(v.T))
              for v in (uu, vv, ww)), torch.from_numpy(focal))


def _libm_once(x: np.ndarray, *fns) -> list:
    """Each of ``fns`` (``math`` functions) of each float32 of ``x``
    through Python's libm in float64, rounded once to float32: one call a
    function and distinct value (by its bits, so -0.0 and 0.0 apart)."""
    bits, inv = np.unique(x.view(np.uint32), return_inverse=True)
    xs = bits.view(np.float32).tolist()
    inv = inv.reshape(-1)
    return [np.fromiter(map(fn, xs), np.float64, len(xs)).astype(
        np.float32)[inv] for fn in fns]


def view_trig(pos, yaw, pitch, fov_y) -> np.ndarray:
    """The grid form's floats of a batch of views (``pos`` f32 [V, 3],
    ``yaw``, ``pitch``, ``fov_y`` f32 [V] CPU tensors or arrays): f32
    [V, 8], each view's origin, cos and sin of its pitch, cos and sin of
    its yaw, and tan(fov_y / 2) (the half angle rounded to float32 first),
    through Python's libm in float64, rounded once, one call a distinct
    argument (an orbit's views share their pitch and fov_y). K3 forms each
    view's basis from them on the card (``bases_from_trig`` on the host is
    its plain version): the host's work does not grow with a view's
    chain."""
    f32 = np.float32

    def host(x):  # a float32 numpy view of a tensor or array, on the host
        if isinstance(x, torch.Tensor):
            # a host float32 tensor is viewed as it is: no torch op
            x = x.numpy() if x.device.type == "cpu" and not (
                x.requires_grad) else x.detach().cpu().numpy()
        return np.ascontiguousarray(x, f32).reshape(-1)

    p, y, f = (host(x) for x in (pitch, yaw, fov_y))
    out = np.empty((y.shape[0], 8), f32)
    out[:, :3] = host(pos).reshape(-1, 3)
    with np.errstate(all="ignore"):
        out[:, 3], out[:, 4] = _libm_once(p, math.cos, math.sin)
        out[:, 5], out[:, 6] = _libm_once(y, math.cos, math.sin)
        out[:, 7], = _libm_once(f32(0.5) * f, math.tan)
    return out


def camera_bases(yaw, pitch, fov_y):
    """The camera frames of a batch of views (yaw, pitch, fov_y f32 [V] on
    the host): (uu, vv, ww f32 [V, 3], focal f32 [V]) CPU tensors. Rounds
    as the reference's calls, whose norms and cross products are jitted
    helpers (``_norm3``, ``_cross``): up to SCALAR_VIEWS views on Python
    floats (``cross3``, ``norm3``), more as numpy arrays; cos, sin and tan
    through Python's libm, one call a view (``core/fp.libm32``'s
    rounding)."""
    ys, ps, fs = (x.reshape(-1).tolist() for x in (yaw, pitch, fov_y))
    form = bases_floats if len(ys) <= SCALAR_VIEWS else bases_arrays
    return form(ys, ps, fs)


def band_of(rows: int, row_lo: int = 0, n_rows: int | None = None) -> int:
    """The height of the row band [row_lo, row_lo + n_rows) of a grid of
    ``rows`` rows (all of them when n_rows is None). Raises ValueError for
    a band that does not lie inside the grid, and for a row_lo without
    n_rows (the reference ignores it there and renders the full grid)."""
    if n_rows is None and row_lo != 0:
        raise ValueError(f"row_lo {row_lo} without n_rows")
    band = rows if n_rows is None else n_rows
    if row_lo < 0 or band < 0 or row_lo + band > rows:
        raise ValueError(f"row band [{row_lo}, {row_lo + band}) outside "
                         f"the {rows} rows of the grid")
    return band


def _band_rows(rows: int, row_lo: int, band: int, device) -> torch.Tensor:
    """GL rows (rows - 1 - r) of the grid's rows r in [row_lo, row_lo +
    band), f32 [band]: a slice of the full grid's, computed exactly."""
    r = torch.arange(row_lo, row_lo + band, dtype=torch.float32,
                     device=device)
    return float(rows - 1) - r


def grid_aspect(rows: int, cols: int, pixel_aspect: float) -> float:
    """The grid's x scale, the float32 (cols / rows) * pixel_aspect, as a
    Python float."""
    return float(np.float32(cols / rows) * np.float32(pixel_aspect))


def ndc_grid(rows: int, cols: int, pixel_aspect: float, device,
             row_lo: int = 0, n_rows: int | None = None):
    """NDC centres (px, py) f32 [band, cols] of the rows x cols cell grid's
    row band [row_lo, row_lo + n_rows) (all rows by default), row 0 = top
    (GL fragCoord has y = 0 at the bottom; the readback is Y-flipped, so
    top row r maps to gl y = rows-1-r):

      p = -1 + 2 * (pix + 0.5) / res;   p.x *= (cols/rows) * pixel_aspect

    A band keeps the full grid's aspect and mapping, so it equals those
    rows of the full grid bit for bit. Returns (px, py, aspect), aspect
    the float32 (cols/rows) * pixel_aspect as a Python float."""
    band = band_of(rows, row_lo, n_rows)
    aspect = grid_aspect(rows, cols, pixel_aspect)
    x = torch.arange(cols, dtype=torch.float32, device=device) + 0.5
    x = x / torch.tensor(float(cols), device=device)
    y_gl = _band_rows(rows, row_lo, band, device)
    y_gl = (y_gl + 0.5) / torch.tensor(float(rows), device=device)
    px = ((-1.0 + 2.0 * x) * aspect).expand(band, cols)
    py = (-1.0 + 2.0 * y_gl)[:, None].expand(band, cols)
    return px, py, aspect


def jit_grid_consts(rows: int, cols: int, pixel_aspect: float):
    """(sx, sy, aspect) of the jitted grid: 2 / cols, 2 / rows and
    (cols / rows) * pixel_aspect, each a float32 value (as Python floats),
    as ``ndc_grid_jit`` and the kernels that compute its rays take them."""
    return (float(np.float32(2.0 / cols)), float(np.float32(2.0 / rows)),
            float(np.float32(cols / rows) * np.float32(pixel_aspect)))


def ndc_grid_jit(rows: int, cols: int, pixel_aspect: float, device,
                 row_lo: int = 0, n_rows: int | None = None):
    """ndc_grid as the reference's jitted program rounds it: XLA turns
    the divisions by the grid size into products with 2 / res, which fuse
    into the -1: p = fma(pix + 0.5, 2 / res, -1), then p.x *= aspect.
    Returns (px, py) f32 [band, cols] on ``device``, the row band
    [row_lo, row_lo + n_rows) of the full grid (all rows by default)."""
    band = band_of(rows, row_lo, n_rows)
    sx, sy, aspect = jit_grid_consts(rows, cols, pixel_aspect)
    x = torch.arange(cols, dtype=torch.float32, device=device) + 0.5
    y = _band_rows(rows, row_lo, band, device) + 0.5
    px = fma32(x, sx, -1.0) * aspect
    py = fma32(y, sy, -1.0)
    return px.expand(band, cols), py[:, None].expand(band, cols)


def ray_dirs_jit(px, py, bases) -> torch.Tensor:
    """normalize(px*uu + py*vv + focal*ww) as the reference's jitted grid
    rounds it, for a batch of views: f32 [V, *px.shape, 3]. There
    px*uu + py*vv fuses (the left product, fma(px, uu, py*vv)), while
    focal*ww, the same for every ray, is formed apart and added; the norm
    fuses as ``_norm3``. ``bases``: camera_bases' tuple (uu, vv, ww
    [V, 3], focal [V]), on px's device."""
    uu, vv, ww, focal = bases
    fw = focal[:, None] * ww
    lead = (-1,) + (1,) * px.dim()
    comps = [fma32(px, uu[:, k].reshape(lead), py * vv[:, k].reshape(lead))
             + fw[:, k].reshape(lead) for k in range(3)]
    n = _norm3(comps)
    return torch.stack([c / n for c in comps], dim=-1)


def ray_dirs(px, py, basis) -> torch.Tensor:
    """normalize(px*uu + py*vv + focal*ww) -> f32 [*px.shape, 3] as the
    reference's eager grid rounds it: each component in its order with
    one IEEE float32 operation at a time, over the fused norm of
    ``jnp.linalg.norm`` (``_norm3``), so the CPU and CUDA grids agree bit
    for bit. ``basis`` is camera_basis's tuple (host tensors)."""
    uu, vv, ww, focal = basis
    fw = focal * ww
    comps = [px * uu[i].item() + py * vv[i].item() + fw[i].item()
             for i in range(3)]
    n = _norm3(comps)
    return torch.stack([c / n for c in comps], dim=-1)


def primary_ray_dirs(cam: Camera, rows: int, cols: int, pixel_aspect: float,
                     jitter: torch.Tensor | None = None, row_lo: int = 0,
                     n_rows: int | None = None, device="cuda"):
    """Per-cell primary ray directions, f32 [rows, cols, 3] on ``device``,
    row 0 = top (pathtrace_shader.js:187-201, raytrace_shader.js:198-210).
    The basis is computed on the host; the grid is built on the device.
    ``jitter`` (optional, [band, cols, 2]) is added to p (anti-aliasing
    offsets, already scaled by the caller). ``row_lo`` / ``n_rows`` select
    the row band [row_lo, row_lo + n_rows) of the global grid
    (``parallel.mesh.render_rows_sharded``): f32 [n_rows, cols, 3], equal
    to those rows of the full grid bit for bit."""
    basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    px, py, _aspect = ndc_grid(rows, cols, pixel_aspect, device, row_lo,
                               n_rows)
    if jitter is not None:
        px = px + jitter[..., 0]
        py = py + jitter[..., 1]
    return ray_dirs(px, py, basis)
