"""Inputs of the kernels that stand for XLA code (``ops/fp``,
``ops/raster_shade``, ``ops/rt_trace``, ``ops/raster_clip``,
``ops/plane_table``, ``ops/bin_entries``, ``ops/frame_bytes`` and the
glyph tail), made from seeds: operands of
``fma32`` (random, constructed float32 midpoint ties, subnormal and
special values, each operand form the wrapper packs), scenes and shade
tables for the deferred shade, the ray tracer's test scenes, triangle
soups at the near plane for the clip and the plane table, screen
channel dicts for the bin entries' tile keys and bbox dicts for their bin
keys, float frames with alpha and UI planes for the glyph tail, single
ripples with the reference march's cells for X12a's UI form, the path
tracer's megakernel outputs for its batch fold (``ops/pt_reduce``),
stream orders for its sample rays (``ops/ray_grid.pt_rays``), the
progressive tracer's statistics planes (``ops/accum``) and the soft
rasterizer's scenes and cotangents (``ops/soft_raster``). The kernels'
tests and ``chip_smoke.py``'s checks build their inputs here."""

import numpy as np
import torch

from ascii_renderer_tpu_torch.scene.builder import MaterialIds as TM
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder as TSB
from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene


def fma_ties(seed=11):
    """(a, b, c) float32: (1 + m 2^-12)^2 2^2e is a float32 midpoint (odd
    m < 1,400), and c = +-2^(2e - k) puts the exact sum a hair either side
    of it or on it (k = 0: c = 0); the float64 sum rounds onto the
    midpoint for k = 70."""
    rng = np.random.default_rng(seed)
    a, c = [], []
    for m in rng.integers(0, 700, 60) * 2 + 1:
        for e in (-20, 0, 17):
            x = np.float32((1 + int(m) * 2.0 ** -12) * 2.0 ** e)
            for k in (0, 40, 70):
                for sgn in (1, -1):
                    a.append(x)
                    c.append(np.float32(sgn * 2.0 ** (2 * e - k))
                             if k else np.float32(0.0))
    a = np.asarray(a, np.float32)
    return a, a.copy(), np.asarray(c, np.float32)


def fma_specials():
    """(a, b, c) float32: subnormal products and sums, exact
    cancellation to +-0, infinities, NaN and sums past FLT_MAX."""
    rng = np.random.default_rng(12)
    a = list(rng.uniform(1, 2, 200) * 2.0 ** -70)
    b = list(rng.uniform(-2, 2, 200) * 2.0 ** -62)
    c = list(rng.uniform(-1, 1, 200) * 2.0 ** -130)
    x, y = rng.normal(size=(2, 200)).astype(np.float32)
    a += list(x)  # c = -(x*y) rounded: exact cancellation where x*y is
    b += list(y)
    c += list(-(x * y))
    big = float(np.finfo(np.float32).max)
    for t in ((0.0, 1.0, 0.0), (-0.0, 1.0, 0.0), (-0.0, 1.0, -0.0),
              (0.0, -1.0, -0.0), (2.0, 3.0, -6.0), (-2.0, 3.0, 6.0),
              (np.inf, 1.0, 0.0), (np.inf, 0.0, 1.0), (np.inf, 1.0, -np.inf),
              (1.0, 1.0, np.inf), (np.nan, 1.0, 1.0), (1.0, 1.0, np.nan),
              (2.0 ** 64, 2.0 ** 64, -1.0), (2.0 ** 64, 2.0 ** 64, 1.0),
              (-(2.0 ** 64), 2.0 ** 64, 1.0), (big, 1.0, 2.0 ** 103),
              (big, 1.0, 2.0 ** 103 - 2.0 ** 79), (big, -1.0, -(2.0 ** 102))):
        a.append(t[0]), b.append(t[1]), c.append(t[2])
    return tuple(np.asarray(v, np.float32) for v in (a, b, c))


def fma_operands(case, device, seed=5):
    """Operands of each form fma32 takes: broadcast shapes, strided views
    (a permutation, a transpose, an expanded column), Python floats, 0-d
    tensors (a CPU one of float64: a scalar; a device one: a tensor),
    other dtypes."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)

    return {"broadcast": (r(6, 1, 4), r(5, 1), r(1, 1, 1, 4)),
            "five_dims": (r(3, 4, 1, 8, 16)[..., ::2].transpose(0, 1),
                          r(1, 3, 2, 1, 1), r(1, 8, 8)),
            "strided": (r(6, 5, 4).permute(2, 0, 1), r(5, 6).t()[None],
                        r(4, 3)[:, 1][:, None, None].expand(4, 6, 5)),
            "scalars": (r(3, 7), 0.1, 1e-3),
            "zero_d": (r(2, 3), r(1).reshape(()),
                       torch.tensor(-1.25, dtype=torch.float64)),
            "dtype": (r(2, 3).double(),
                      torch.arange(3, dtype=torch.int32, device=device),
                      torch.tensor([True, False, True], device=device))}[case]


FMA_CASES = ("broadcast", "five_dims", "strided", "scalars", "zero_d",
             "dtype")


def shade_builder(builder, dir_light, n_pts):
    """A scene for the deferred shade: a directional light or none (the
    default direction), ``n_pts`` point lights (the builder pads their
    slots to 8; none, no slot)."""
    sb = builder()
    sb.set_env_light([0.3, 0.35, 0.45], 0.8)
    if dir_light:
        sb.add_dir_light([0.4, -0.8, -0.3], [1.0, 0.95, 0.9], 0.9)
    for i in range(n_pts):
        sb.add_point_light([1.5 * i - 3.0, 2.0 + 0.3 * i, 1.0 - i],
                           [1.0, 0.8 + 0.02 * i, 0.6], 1.5 + 0.2 * i)
    return sb


def shade_inputs(n_attrs, shape, n_tris=40, seed=1):
    """(table [n_tris + 1, W] with a trailing zero row, f32 ids of
    ``shape`` with -1 where no hit, px, py) for a shade: planes whose
    denominator stays near 1, colours in [0, 1], world positions in a
    room."""
    rng = np.random.default_rng(seed)
    t = np.zeros((n_tris + 1, 3 * n_attrs + 3), np.float32)
    for j in range(n_attrs + 1):
        t[:n_tris, 3 * j:3 * j + 2] = rng.uniform(-2e-3, 2e-3, (n_tris, 2))
        lo, hi = {3: (0.0, 1.0), 4: (0.0, 1.0), 5: (0.0, 1.0),
                  6: (-3, 3), 7: (0, 3), 8: (-3, 3),
                  n_attrs: (0.8, 1.2)}.get(j, (-1.0, 1.0))
        t[:n_tris, 3 * j + 2] = rng.uniform(lo, hi, n_tris)
    ids = rng.integers(-1, n_tris, shape).astype(np.float32)
    px = rng.uniform(0, 96, shape).astype(np.float32)
    py = rng.uniform(0, 36, shape).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (t, ids, px, py))


def rt_scene(name, device):
    """The ray tracer's test scenes: rt_demo (as its golden renders it,
    every slot padded to 8), the triangle, quad and mirror scene of
    tests/test_torch_raytrace.py, rt_demo with two lights of each kind
    (exact primitive slots; two directional lights, so the first two light
    terms meet in one fused add), and a mirror floor under one sphere slot
    (where the primary rays of a batch round the sphere's c apart)."""
    if name == "rt_demo":
        return create_rt_demo_scene().build(device=device)
    sb = TSB()
    if name == "tris_quad":
        sb.add_plane([0, 1, 0], 0.0, TM.MIRROR)
        sb.add_sphere([0, 1, -1], 0.8, TM.RED)
        sb.add_triangle([-2, 0.2, -2], [2, 0.3, -2.5], [0, 2.5, -3],
                        TM.GREEN)
        sb.add_quad([-3, 0.1, 1], [-1, 0.1, 1], [-1, 1.5, 0.5],
                    [-3, 1.5, 0.5], TM.WHITE)
        sb.add_dir_light([0.3, -1, -0.2], [1, 1, 1], 1.0)
        sb.add_point_light([1, 3, 2], [1, 0.9, 0.8], 2.0)
        sb.set_env_light([0.2, 0.3, 0.5], 1.0)
        sb.set_camera_pose([0.0, 1.5, 5.0], yaw=-1.5707963, pitch=-0.1)
        return sb.build(device=device)
    if name == "two_lights":
        sb = create_rt_demo_scene()
        sb.add_dir_light([-0.5, -0.7, 0.2], [0.5, 0.6, 0.9], 0.7)
        sb.add_point_light([-2.0, 2.5, 3.0], [0.9, 0.5, 0.4], 2.0)
        return sb.build(min_pad=1, device=device)
    sb.add_plane([0, 1, 0], 0.0, TM.MIRROR)
    sb.add_sphere([0, 1, -1], 0.8, TM.RED)
    sb.add_point_light([1, 3, 2], [1, 0.9, 0.8], 2.0)
    sb.set_env_light([0.2, 0.3, 0.5], 1.0)
    sb.set_camera_pose([0.0, 1.5, 4.0], yaw=-1.5707963, pitch=-0.2)
    return sb.build(min_pad=1, device=device)


RT_SCENES = ("rt_demo", "tris_quad", "two_lights", "one_sphere")


# the camera of front_soup: at the near plane of the soup's triangles
FRONT_CAM = dict(pos=(0.0, 0.2, 0.3), yaw=-np.pi / 2, pitch=-0.1)


def front_soup(T, mvp, seed):
    """T random triangles straddling the near plane, with attributes
    [3T, 9]; triangles 0-9 are a point and 10-19 are collinear
    (degenerate), 20-29 lie on the camera's w = 0 plane (w near 0 once
    rounded) and 30-39 have one vertex there, 40-44 lie at the eye and
    45-49 have one vertex there (those of them below T)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2, 2, (3 * T, 3))
    p[:, 2] = rng.uniform(-1.5, 1.0, 3 * T)
    for t in range(min(T, 10)):
        p[3 * t + 1] = p[3 * t + 2] = p[3 * t]
    for t in range(10, min(T, 20)):
        p[3 * t + 2] = 2.0 * p[3 * t + 1] - p[3 * t]
    m = np.asarray(mvp, np.float64)
    for t in range(20, min(T, 40)):  # z on w = m30 x + m31 y + m32 z + m33
        for i in range(3) if t < 30 else (t % 3,):
            v = p[3 * t + i]
            v[2] = -(m[3, 0] * v[0] + m[3, 1] * v[1] + m[3, 3]) / m[3, 2]
    for t in range(40, min(T, 50)):
        for i in range(3) if t < 45 else (t % 3,):
            p[3 * t + i] = FRONT_CAM["pos"]
    attrs = rng.uniform(-1, 1, (3 * T, 9)).astype(np.float32)
    return p.astype(np.float32), attrs


def front_inputs(T, seed, device, rows=36, cols=96):
    """(positions f32 [3T, 3], attrs f32 [3T, 9] on ``device``, mvp) of
    front_soup, the MVP the port's camera_mvp at FRONT_CAM (pixel aspect
    0.5, rows x cols)."""
    from ascii_renderer_tpu_torch.backends.raster import camera_mvp
    from ascii_renderer_tpu_torch.core.camera import Camera
    mvp = camera_mvp(Camera.create(**FRONT_CAM), rows, cols, 0.5)
    p, a = front_soup(T, mvp.numpy(), seed)
    return torch.from_numpy(p).to(device), torch.from_numpy(a).to(device), mvp


# the bin entries' test soups: (rows, cols, triangles, big triangles) of
# each; "one_tile" is a grid one tile wide, "hd" the 544-tile grid of the
# mid-scale HD arm (960x540), "many_big" holds more big triangles than the
# cap of 64, "edge" adds off-screen, degenerate, huge and NaN triangles,
# "all_invalid" has no valid slot (the reference takes T >= big_cap)
BIN_SOUPS = {"one_tile": (36, 96, 300, 6), "hd": (540, 960, 120, 8),
             "many_big": (72, 512, 260, 90), "edge": (40, 300, 200, 10),
             "all_invalid": (36, 96, 80, 5)}


def bin_soup(name, seed=3):
    """A screen channel dict (sxa .. szc float32, valid bool, each [T];
    numpy arrays) and its grid (rows, cols) for ``binned_entries``: small
    triangles scattered over the grid (some across a tile boundary), big
    ones over several tiles, 10% invalid slots; see BIN_SOUPS."""
    rows, cols, T, n_big = BIN_SOUPS[name]
    rng = np.random.default_rng(seed + len(name))
    hd = name == "hd"
    # small: a few pixels across; in the HD grid kept to a corner of tiles
    # so that the plain walk stays small
    cx = rng.uniform(0, min(cols, 400) if hd else cols, T)
    cy = rng.uniform(0, min(rows, 64) if hd else rows, T)
    size = rng.uniform(0.5, 10.0, T)[:, None]
    x = cx[:, None] + rng.uniform(-1, 1, (T, 3)) * size
    y = cy[:, None] + rng.uniform(-1, 1, (T, 3)) * size * 0.5
    big = np.arange(T) % max(1, T // n_big) == 0
    big &= np.cumsum(big) <= n_big
    nb = int(big.sum())
    span_x = rng.uniform(40, 400 if hd else max(cols, 160), nb)
    span_y = rng.uniform(12, 40 if hd else rows, nb)
    x[big] = cx[big, None] + rng.uniform(-1, 1, (nb, 3)) * span_x[:, None]
    y[big] = cy[big, None] + rng.uniform(-1, 1, (nb, 3)) * span_y[:, None]
    z = rng.uniform(-0.05, 1.05, (T, 3))
    valid = rng.random(T) >= 0.1
    if name == "edge":
        x[0:5] += 1e4  # off-screen right, below, left, above
        y[5:10] += 1e4
        x[10:15] -= 1e4
        y[15:20] -= 1e4
        x[20:25], y[20:25] = x[20:25, :1], y[20:25, :1]  # a point
        x[25:30, 2] = 2 * x[25:30, 1] - x[25:30, 0]  # collinear
        y[25:30, 2] = 2 * y[25:30, 1] - y[25:30, 0]
        x[30:33, 0] = [3e9, -3e9, 1e30]  # near-plane sized bboxes
        y[33:36, 1] = [3e9, -1e38, 1e38]
        x[36, 0], y[37, 2], z[38, 1] = np.nan, np.nan, np.nan
        x[39, 1], y[40, 0] = np.inf, -np.inf
        valid[0:41] = True
    if name == "all_invalid":
        valid[:] = False
    ch = {}
    for i, v in enumerate("abc"):
        ch[f"sx{v}"] = x[:, i].astype(np.float32)
        ch[f"sy{v}"] = y[:, i].astype(np.float32)
        ch[f"sz{v}"] = z[:, i].astype(np.float32)
    ch["valid"] = valid
    return ch, rows, cols


def bbox_soup(name, seed=3):
    """The bbox dict (bx0 bx1 by0 by1 float32, valid bool, each [T]; numpy
    arrays) of ``bin_soup(name)``'s triangles, as the setup forms it (min
    and max of the three corners, a NaN corner giving a NaN bound), and its
    grid: bins keys' inputs with off-screen, huge (near-plane sized), NaN
    and infinite bounds where the soup has them."""
    ch, rows, cols = bin_soup(name, seed)
    x = np.stack([ch[f"sx{v}"] for v in "abc"])
    y = np.stack([ch[f"sy{v}"] for v in "abc"])
    with np.errstate(invalid="ignore"):
        bb = {"bx0": np.min(x, 0), "bx1": np.max(x, 0),
              "by0": np.min(y, 0), "by1": np.max(y, 0)}
    bb = {k: v.astype(np.float32) for k, v in bb.items()}
    bb["valid"] = ch["valid"]
    return bb, rows, cols


def mesh_soup(name):
    """Soup of bench config 2 (teapot) or the mid-scale HD arm
    (bunny-class, 14,884 triangles) as numpy arrays, and its camera, as
    chip_smoke._mesh makes them (which keeps its own copy: tools/kernel_ab
    runs chip_smoke.py against the package of another checkout)."""
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.geom import meshes
    if name == "teapot":
        v, i = meshes.teapot_like(1024)
        return meshes.mesh_to_soup(v, i, color=(0.9, 0.9, 0.9)), \
            Camera.create(pos=(1.9, 1.3, 2.7),
                          yaw=float(np.arctan2(-2.7, -1.9)), pitch=-0.4)
    v, i = meshes.bunny_like(15000)
    return meshes.mesh_to_soup(v, i, color=(0.8, 0.78, 0.75)), \
        Camera.create(pos=(2.4, 1.4, 2.8), yaw=float(np.arctan2(-2.8, -2.4)),
                      pitch=-0.3)


def bin_calls(device):
    """{label: (channel dict, rows, cols)} of binned_entries' callers at
    the pixel aspect 0.5: the entry() room's uncompacted clip dict (96x36),
    the teapot's (240x135) and the mid-scale HD arm's (960x540) compacted
    dicts at the caps their first frame's counts suggest, and a seeded
    20,000-triangle soup at the near plane (480x270, compacted)."""
    from ascii_renderer_tpu_torch.backends import raster as R
    from ascii_renderer_tpu_torch.geom.tessellate import tessellate_scene
    from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
    scene = create_demo_scene().build(device=device)
    p = torch.from_numpy(tessellate_scene(scene)[0]).to(device)
    calls = {"room 96x36": (R.clip_screen_channels(
        p, R.camera_mvp(scene.camera, 36, 96, 0.5), 36, 96), 36, 96)}
    for label, name, (rows, cols) in (("teapot 240x135", "teapot",
                                       (135, 240)),
                                      ("mid-scale HD 960x540", "mid",
                                       (540, 960))):
        soup, cam = mesh_soup(name)
        p = torch.from_numpy(soup[0]).to(device)
        ch = R.clip_screen_channels(None, R.camera_mvp(cam, rows, cols, 0.5),
                                    rows, cols, pos9=R.positions_to_pos9(p))
        n2t = p.shape[0] // 3 * 2
        cch, _cidx, n_valid = R.compact_valid_ch(dict(ch), n2t)
        caps = R.suggest_caps(int(n_valid), int(R.count_big_small(
            cch, rows, cols)[1]))
        calls[label] = (R.compact_valid_ch(dict(ch), caps[0])[0], rows, cols)
    p, _a, mvp = front_inputs(20000, 16, device, 270, 480)
    ch = R.clip_screen_channels(p, mvp, 270, 480)
    calls["near-plane soup 480x270"] = (R.compact_valid_ch(
        dict(ch), 40000)[0], 270, 480)
    return calls


# ramps of the glyph tail's checks: one code, the default's ten, and a
# hundred
GLYPH_RAMPS = ("#", "@%#*+=-:. ",
               "".join(chr(32 + (i * 37) % 95) for i in range(100)))


def glyph_frame(shape, seed=0):
    """Inputs of a frame's glyph tail, numpy, for a grid ``shape`` ((H, W)
    or (V, H, W)): (rgb float32 [*shape, 3], alpha u8, ui_chars u8,
    ui_mask bool, each [*shape]). The floats reach outside [0, 1]; a
    quarter of the cells hold k / 255 or a float32 either side of it, and
    a quarter (k + 0.5) / 255 or a float32 either side of it, where the
    byte's rounding turns. The alpha plane is mostly 1 or 255 (no
    override), 10% overrides in 2..254, and its protocol edges 0, 1, 2,
    254, 255 in the first cells; the UI mask covers 5% of the cells."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    rgb = rng.uniform(-0.25, 1.25, n * 3).astype(np.float32)
    k = rng.integers(0, 256, n * 3)
    edge = np.where(rng.random(n * 3) < 0.5, k / 255.0,
                    np.minimum(k + 0.5, 255.0) / 255.0).astype(np.float32)
    step = rng.integers(-1, 2, n * 3)  # the float32 below, it, above
    edge = np.where(step < 0, np.nextafter(edge, np.float32(-1)),
                    np.where(step > 0, np.nextafter(edge, np.float32(2)),
                             edge))
    pick = rng.random(n * 3) < 0.5
    rgb = np.where(pick, edge, rgb).astype(np.float32).reshape(*shape, 3)
    alpha = np.where(rng.random(n) < 0.5, 1, 255).astype(np.uint8)
    ovr = rng.random(n) < 0.1
    alpha[ovr] = rng.integers(2, 255, int(ovr.sum()))
    alpha[:5] = (0, 1, 2, 254, 255)[:n]
    ui_chars = rng.integers(32, 127, n).astype(np.uint8)
    ui_mask = rng.random(n) < 0.05
    return (rgb, alpha.reshape(shape), ui_chars.reshape(shape),
            ui_mask.reshape(shape))


def ripple_case(r: int):
    """(``sim/ui.UiParams``, want bool [n, n]) of one ripple of radius r at
    the centre of an n x n grid that holds its box and two cells more on
    each side (n = 2 r + 5): the cells of the reference march
    (``sim/ui._bresenham_np``: the JS err rule, 8 octants, 128 steps at
    most), which X12a's UI form must draw as '*'."""
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.sim import ui as U
    h = r + 2
    n = 2 * h + 1
    px, py, on = U._bresenham_np(*(np.array([v], np.int32)
                                   for v in (h, h, r)))
    want = np.zeros((n, n), bool)
    want[py[on], px[on]] = True
    return U.UiParams(n, n, Config().pi_digits, *U._fps_digits(0.0, n),
                      ((h, h, r),)), want

def pt_outputs(n_rays: int, seed=0, p_override=0.04):
    """The megakernel's five outputs (lor, log, lob, ov, fet) for n_rays
    rays, f32 numpy: radiance in [0, 3) with 0.5% NaN and 1% zeros; the
    override 0 for most rays, a glyph code (1-255) for a share
    ``p_override``, a tie of rint (0.5, 1.5, 2.5, 254.5) for a quarter of
    that; fet 1 for 30% and NaN for 1%."""
    rng = np.random.default_rng(seed)
    rad = []
    for _ in range(3):
        c = rng.uniform(0.0, 3.0, n_rays).astype(np.float32)
        u = rng.random(n_rays)
        c[u < 0.01] = 0.0
        c[u > 0.995] = np.nan
        rad.append(c)
    ov = np.zeros(n_rays, np.float32)
    u = rng.random(n_rays)
    codes = rng.integers(1, 256, n_rays).astype(np.float32)
    ov[u < p_override] = codes[u < p_override]
    ties = np.asarray([0.5, 1.5, 2.5, 254.5], np.float32)
    tie = (u >= p_override) & (u < 1.25 * p_override)
    ov[tie] = ties[rng.integers(0, 4, int(tie.sum()))]
    fet = (rng.random(n_rays) < 0.3).astype(np.float32)
    fet[rng.random(n_rays) < 0.01] = np.nan
    return (*rad, ov, fet)


def pixel_order(rows: int, cols: int, frac: float, seed=0):
    """A seeded active mask bool [rows, cols] (about ``frac`` of the
    pixels) and its stable partition, active first, int32 [rows * cols]:
    the stream order ``render_pt(pixel_active=)`` gives the pixels."""
    rng = np.random.default_rng(seed)
    act = rng.random((rows, cols)) < frac
    flat = act.reshape(-1)
    order = np.concatenate([np.flatnonzero(flat), np.flatnonzero(~flat)])
    return act, order.astype(np.int32)


# X13's channel cases (ops/partition.compact_channels): (slots, mask rule,
# v_cap) each; a rule is "all", "none", "alternating", "one" or the share
# of set flags of a seeded random mask. "overflow" keeps more valid slots
# than its cap; "v_cap above 2T" is the teapot's own (2,048 slots, v_cap
# 8,192)
PARTITION_CASES = {"all": (600, "all", 640), "none": (600, "none", 256),
                   "alternating": (1000, "alternating", 512),
                   "one": (1025, "one", 64), "random": (5000, 0.3, 2048),
                   "overflow": (3000, 0.6, 1024),
                   "v_cap above 2T": (2048, 0.3, 8192)}


def partition_mask(n: int, rule, seed=0) -> np.ndarray:
    """A bool [n] flag vector by ``rule`` (see PARTITION_CASES)."""
    if rule == "all":
        return np.ones(n, bool)
    if rule == "none":
        return np.zeros(n, bool)
    if rule == "alternating":
        return np.arange(n) % 2 == 0
    if rule == "one":
        return np.arange(n) == n // 2
    return np.random.default_rng(seed).random(n) < rule


def partition_channels(n: int, rule, seed=0) -> dict:
    """A channel dict for the compaction: the 13 screen channels (float32
    [n]: normal values with NaNs, infinities, signed zeros and subnormals
    among them) and ``valid`` (``partition_mask``); numpy arrays."""
    from ascii_renderer_tpu_torch.ops.partition import COMPACT_KEYS
    rng = np.random.default_rng(seed + 1)
    special = np.asarray([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-45,
                          -3e-39], np.float32)
    ch = {}
    for k in COMPACT_KEYS:
        v = rng.standard_normal(n).astype(np.float32) * 100
        pick = rng.random(n) < 0.02
        v[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
        ch[k] = v
    ch["valid"] = partition_mask(n, rule, seed)
    return ch


def accum_case(shape, seed=0, max_samples=64, edges=True,
               subnormals=True) -> dict:
    """Inputs of the progressive statistics step (``ops/accum``): the old
    state's planes (count, mean, m2, mean_y, m2_y, alpha), a batch's
    sample rgb and alpha (numpy). Counts from 0 to max_samples, many at
    max_samples - 1; variances from converged to far from it, so that
    both masks hold both values; with ``edges`` 2% of each float plane
    NaN, infinities, signed zeros, negative values and (``subnormals``;
    XLA's CPU code flushes them to zero, CUDA and torch keep them)
    subnormals."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    counts = np.asarray([0, 1, 2, 3, 10, max_samples - 1, max_samples - 1,
                         max_samples], f32)
    count = counts[rng.integers(0, len(counts), shape)]
    mean = rng.uniform(0, 1, shape + (3,)).astype(f32)
    var = 10.0 ** rng.uniform(-9, -1, shape + (3,))
    m2 = (var * np.maximum(count - 1, 0)[..., None]).astype(f32)
    mean_y = (mean @ np.asarray([0.3, 0.59, 0.11])).astype(f32)
    m2_y = (var[..., 0] * np.maximum(count - 1, 0)).astype(f32)
    sample = rng.uniform(0, 1.5, shape + (3,)).astype(f32)
    planes = dict(count=count, mean=mean, m2=m2, mean_y=mean_y, m2_y=m2_y,
                  sample=sample)
    if edges:
        special = np.asarray([np.nan, np.inf, -np.inf, -0.0, 0.0, -0.5]
                             + [1e-45, -3e-39] * subnormals, f32)
        for v in planes.values():
            pick = rng.random(v.shape) < 0.02
            v[pick] = special[rng.integers(0, len(special),
                                           int(pick.sum()))]
    planes["alpha"] = rng.integers(0, 256, shape).astype(np.uint8)
    planes["sample_alpha"] = rng.integers(0, 256, shape).astype(np.uint8)
    return planes


# the soft rasterizer's scenes (soft_case)
SOFT_CASES = ("two triangles", "config 5", "config 5, 4 views", "degenerate",
              "uncovered", "near w")


def soft_case(name: str) -> dict:
    """A scene of the soft rasterizer: verts f32 [N, 3], colors f32 [N, 3],
    faces int32 [T, 3], ``camera`` (("pose", Camera.create's keywords) or
    ("orbit", orbit_cameras' keywords)), ``grid`` (rows, cols,
    pixel_aspect) and ``kw`` (sigma, gamma). "two triangles" is the
    reference's finite-difference scene (sigma 3e-3, gamma 3e-2);
    "degenerate" adds a triangle 1e-5 wide (|area| < 1e-9 at every pixel);
    "near w" one with a vertex in the camera's plane (w clamped to 1e-6);
    "config 5" is bench config 5's uv_sphere(8, 12) at 36x96 from 1 or 4
    orbit views at the equator, seeded colours; "uncovered" a small sphere
    far off, most pixels outside every triangle."""
    from ascii_renderer_tpu_torch.geom import meshes
    rng = np.random.default_rng(3)
    if name in ("two triangles", "degenerate", "near w"):
        verts = [[-0.8, -0.5, 0.0], [0.9, -0.4, 0.2], [0.0, 0.8, -0.1],
                 [-0.5, -0.7, 0.6], [0.6, -0.6, 0.5], [0.1, 0.6, 0.7]]
        colors = rng.uniform(0.2, 0.9, (6, 3))
        faces = [[0, 1, 2], [3, 4, 5]]
        extra = {"degenerate": [[0.2, 0.1, 0.3], [0.2 + 1e-5, 0.1, 0.3],
                                [0.2, 0.1 + 1e-5, 0.3]],
                 "near w": [[-0.3, 0.1, 0.4], [0.4, 0.5, 0.4],
                            [0.3, 0.2, 3.0]]}.get(name)
        if extra is not None:
            verts += extra
            colors = np.concatenate([colors, rng.uniform(0.2, 0.9, (3, 3))])
            faces.append([6, 7, 8])
        camera = ("pose", dict(pos=(0.0, 0.0, 3.0), yaw=-np.pi / 2,
                               pitch=0.0))
        grid, kw = (16, 24, 0.5), dict(sigma=3e-3, gamma=3e-2)
    else:
        far = name == "uncovered"
        verts, faces = meshes.uv_sphere(6, 8) if far else meshes.uv_sphere(
            8, 12)
        colors = rng.uniform(0.2, 0.9, verts.shape)
        camera = ("orbit", dict(n=4 if name.endswith("4 views") else 1,
                                center=(0, 0, 0), radius=9.0 if far else 2.5,
                                height=0.0))
        grid, kw = (36, 96, 1.0), {}
    return dict(verts=np.asarray(verts, np.float32),
                colors=np.asarray(colors, np.float32),
                faces=np.asarray(faces, np.int32), camera=camera, grid=grid,
                kw=kw)


def soft_camera(spec):
    """The port's Camera of a soft_case ``camera``."""
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras
    kind, kw = spec
    return Camera.create(**kw) if kind == "pose" else orbit_cameras(**kw)


def soft_cotangent(shape, seed=0, band=None):
    """A seeded cotangent f32 ``shape`` [V, H, W, 3]; with ``band`` (lo,
    n) zero outside rows lo to lo + n, as a row band's loss gives."""
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if band is not None:
        lo, n = band
        g[:, :lo] = 0.0
        g[:, lo + n:] = 0.0
    return g
