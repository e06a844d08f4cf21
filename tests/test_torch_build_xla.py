"""The kernels that stand for XLA code of the reference, on the card: the
fused multiply-add ``fma32`` (``ops/fp``), the raster's deferred shade
(``ops/raster_shade``), the ray tracer's frame (``ops/rt_trace``, K3, in
every form: 1-32 lanes a ray, the valid slots staged or read from the
global arrays, its rays read from rd3 or computed from the jitted grid;
``render_rgb`` one launch a call), the small and mid raster paths' clip
with its screen setup (``ops/raster_clip``, X4, and its table form: the
clip and the plane table in one launch), their plane table
(``ops/plane_table``, X3) and
their bin entries (``ops/bin_entries``, X9), and the path tracer's sample
rays (``ops/ray_grid.pt_rays``, X7, every split of a batch's samples
among threads) and batch fold (``ops/pt_reduce``, X14, both forms), and
the megakernel's frame form (``ops/pt_kernel.trace_frame``), and the
stable partition (``ops/partition``, X13: the mid path's compaction and
the path tracer's compacted stream; two calls back to back and a CUDA
graph's replays too), each held to its plain version bit for bit; a
frame's set-up held to one launch and no copy to the card (a compacted
one to X13's launch, which zeroes the ray counters), the mid path's
``n_big`` to X9's counts. Tests marked ``cuda`` skip without
a card; this file imports no JAX, so they run where there is none:

    python -m pytest tests/test_torch_build_xla.py -m cuda --noconftest

The inputs come from ``ascii_renderer_tpu_torch/tools/xla_inputs``, which
the CPU tests of ``tests/test_torch_xla_kernels.py`` and ``chip_smoke.py``'s
checks of the same kernels use too."""

import numpy as np
import pytest
import torch

from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_channels as RCH
from ascii_renderer_tpu_torch.backends import raster_common as RCM
from ascii_renderer_tpu_torch.backends import raster_oracles as RO
from ascii_renderer_tpu_torch.backends import raytrace as RT
from ascii_renderer_tpu_torch.backends import rt_core as RC
from ascii_renderer_tpu_torch.core.camera import band_of, camera_bases
from ascii_renderer_tpu_torch.core.fp import fma32, fma32_f64
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import bin_entries as BE
from ascii_renderer_tpu_torch.ops import fp as KFP
from ascii_renderer_tpu_torch.ops import group_build as GB
from ascii_renderer_tpu_torch.ops import ray_grid as RYG
from ascii_renderer_tpu_torch.ops import plane_table as PT
from ascii_renderer_tpu_torch.ops import raster_clip as RCL
from ascii_renderer_tpu_torch.ops import raster_shade as RSH
from ascii_renderer_tpu_torch.ops import rt_trace as RTK
from ascii_renderer_tpu_torch.ops.ray_grid import ray_grid_jit
from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder as TSB
from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
from ascii_renderer_tpu_torch.ops import pt_reduce as PR
from ascii_renderer_tpu_torch.tools.xla_inputs import (
    BIN_SOUPS, FMA_CASES, RT_SCENES, bbox_soup, bin_calls, bin_soup,
    fma_operands,
    fma_specials, fma_ties, front_inputs, pixel_order, pt_outputs, rt_scene,
    shade_builder, shade_inputs)

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _same_bits(got, want) -> None:
    """Bit for bit, NaN payloads aside: NaN in the same places."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------
def shade_calls(device, n_attrs=9, dir_light=True, n_pts=3):
    """The three callers of the shade at small sizes on ``device``, each a
    function of no argument returning its rgb: the headline's grouped
    tiles (f32 ids [3, 8, 128], lane centres, the table a column slice of
    a wide pack), the mid path's plane table (i32 ids [16, 96]) and the
    retired generations' compacted tiles (2 tiles of 8 x 128)."""
    scene = shade_builder(TSB, dir_light, n_pts).build(device=device)
    table, ids, _px, _py = (t.to(device) for t in shade_inputs(
        n_attrs, (3, 8, 128), n_tris=60))
    W = table.shape[1]
    wide = torch.zeros((table.shape[0], 64), device=device)
    wide[:, 16:16 + W] = table
    xl = (torch.from_numpy(np.random.default_rng(2).integers(
        0, 4, (3, 128)).astype(np.float32)) * 128
        + torch.arange(128.0) + 0.5).to(device)
    yl = torch.tensor([[0.0], [8.0], [16.0]], device=device).expand(3, 128)
    tid = ids[:2].reshape(16, 128)[:, :96].to(torch.int32).contiguous()
    nonempty = torch.tensor([True, True], device=device)
    return {
        "groups": lambda: R.shade_groups(ids, xl, yl, wide[:, 16:16 + W],
                                         scene, n_attrs),
        "table": lambda: RCM.shade_from_table(tid, table, scene, 16, 96,
                                              n_attrs),
        "compact": lambda: RO.shade_tiles_compact(ids[:2].clone(), nonempty,
                                                  table, scene, 8, 256, 2,
                                                  n_attrs)}


def _plain_trace(monkeypatch):
    """Route raytrace.trace to its plain version on any device."""
    monkeypatch.setattr(RT, "trace", RT.trace_rgb)


# --------------------------------------------------------------------------
# fma32
# --------------------------------------------------------------------------
@pytest.mark.cuda
def test_fma32_kernel_equals_the_float64_form(cuda_device):
    """One launch of __fmaf_rn equals the float64 form bit for bit on 2^21
    random bit patterns (every exponent, subnormals, infinities, NaN), on
    products and sums of one scale, on constructed midpoint ties and on
    the special values (NaN in the same places)."""
    rng = np.random.default_rng(3)
    sets = [tuple(rng.integers(0, 2 ** 32, 2 ** 21, dtype=np.uint64).astype(
        np.uint32).view(np.float32) for _ in range(3)),
        tuple((rng.normal(size=2 ** 21) * 4).astype(np.float32)
              for _ in range(3)), fma_ties(), fma_specials()]
    for a, b, c in sets:
        a, b, c = (torch.from_numpy(x).to(cuda_device) for x in (a, b, c))
        n0 = KFP.launches
        got = fma32(a, b, c)
        assert KFP.launches == n0 + 1
        _same_bits(got, fma32_f64(a, b, c))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FMA_CASES)
def test_fma32_kernel_broadcast_and_strided_operands(cuda_device, case):
    """Broadcast and strided views, Python floats and 0-d tensors reach
    the kernel as strides and scalars: one launch, the float64 form's
    result bit for bit."""
    ops = fma_operands(case, cuda_device)
    n0 = KFP.launches
    got = fma32(*ops)
    assert KFP.launches == n0 + 1
    assert got.device.type == "cuda" and got.is_contiguous()
    _same_bits(got, fma32_f64(*ops))


@pytest.mark.cuda
def test_fma32_kernel_refuses_gradients_and_seven_dims(cuda_device):
    x = torch.ones((1, 1, 1, 1, 1, 1, 2), device=cuda_device)
    with pytest.raises(ValueError):
        fma32(x, 1.0, 2.0)
    with pytest.raises(ValueError):
        fma32(torch.ones(2, device=cuda_device, requires_grad=True), 1.0,
              2.0)
    assert fma32(torch.ones((0, 3), device=cuda_device), 1.0,
                 2.0).shape == (0, 3)


# --------------------------------------------------------------------------
# the deferred shade
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("n_attrs,dir_light,n_pts", [
    (9, True, 3), (9, False, 5), (6, True, 0), (6, False, 0)],
    ids=["9_dl_3pt", "9_no_dl_5pt", "6_dl", "6_no_dl"])
def test_shade_kernel_equals_plain_for_each_caller(cuda_device, monkeypatch,
                                                    n_attrs, dir_light,
                                                    n_pts):
    """Each caller's frame through the kernel (one launch) equals the same
    call with the plain version, bit for bit."""
    calls = shade_calls(cuda_device, n_attrs, dir_light, n_pts)
    got = {}
    for name, fn in calls.items():
        n0 = RSH.launches
        got[name] = fn()
        assert RSH.launches == n0 + 1, name
    monkeypatch.setattr(RSH, "shade", RSH.shade_ref)
    for name, fn in calls.items():
        want = fn()
        _same_bits(got[name], want)
        assert (want > 0).any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["groups_f32", "table_i32",
                                    "unaligned_rows"])
@pytest.mark.parametrize("n_attrs,n_pts", [(9, 3), (6, 0)],
                         ids=["9_3pt", "6"])
def test_shade_kernel_every_form_equals_plain(cuda_device, layout, n_attrs,
                                              n_pts):
    """The kernel equals the plain version bit for bit: f32 ids over
    grouped tiles with lane centres, i32 ids over a 2-D grid, and a table
    whose rows cannot be read as float4; ids of -0.0 and past the table
    included (NaN rgb in the same places)."""
    scene = shade_builder(TSB, True, n_pts).build(device=cuda_device)
    table, ids, px, py = (t.to(cuda_device) for t in shade_inputs(
        n_attrs, (5, 8, 128), n_tris=90))
    ids.view(-1)[::11] = -0.0
    ids.view(-1)[5::97] = float(table.shape[0] + 3)
    if layout == "table_i32":
        ids = ids.reshape(40, 128).to(torch.int32)
        px = (torch.arange(128.0, device=cuda_device) + 0.5)[None]
        py = (torch.arange(40.0, device=cuda_device) + 0.5)[:, None]
    else:  # rows of the pack's width (float4 reads), or misaligned ones
        px = px[:, :1, :]
        W = table.shape[1]
        wide = torch.zeros((table.shape[0], -(-W // 8) * 8 + 8),
                           device=cuda_device)
        if layout == "unaligned_rows":
            wide[:, 1:1 + W] = table
            table = wide[:, 1:1 + W]
        else:
            wide[:, :W] = table
            table = wide[:, :-(-W // 8) * 8]
    want = RSH.shade_ref(table, ids.clamp(max=table.shape[0] - 1), px, py,
                         scene, n_attrs)
    past = ids >= table.shape[0]
    want[past.expand(want.shape[:-1])] = float("nan")
    n0 = RSH.launches
    got = RSH.shade(table, ids, px, py, scene, n_attrs)
    assert RSH.launches == n0 + 1
    _same_bits(got, want)
    assert bool(torch.isnan(got).any()) and (want > 0).any()


# --------------------------------------------------------------------------
# the ray tracer's frame
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("name", RT_SCENES)
def test_trace_kernel_equals_plain_frames(cuda_device, monkeypatch, name):
    """render_rgb through the kernel (one launch a call) equals the plain
    version bit for bit: one camera at 36x96, a batch of 16 orbit views
    at 24x40, and a band of 12 rows, which also equals its frame's rows."""
    scene = rt_scene(name, cuda_device)
    pr = RT.ScenePrims(scene)
    orbit = orbit_cameras(16, center=(0, 1.0, 0.0), radius=5.5)
    runs = {"frame": lambda: RT.render_rgb(scene, scene.camera, 36, 96, 0.5,
                                           prims=pr),
            "views": lambda: RT.render_rgb(scene, orbit, 24, 40, 0.5,
                                           prims=pr),
            "band": lambda: RT.render_rgb(scene, scene.camera, 36, 96, 0.5,
                                          row_lo=12, n_rows=12, prims=pr)}
    got = {}
    for k, fn in runs.items():
        n0 = RTK.launches
        got[k] = fn()
        assert RTK.launches == n0 + 1, k
    assert torch.equal(got["band"], got["frame"][12:24])
    _plain_trace(monkeypatch)
    for k, fn in runs.items():
        _same_bits(got[k], fn())
    lit = got["frame"].amax(-1)
    assert (lit > 0.05).float().mean() > 0.3 and got["views"].std() > 0.05


# --------------------------------------------------------------------------
# the clip with its screen setup (X4) and the plane table (X3)
# --------------------------------------------------------------------------
def _same_dict(got, want) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        if w.dtype == torch.float32:
            _same_bits(got[k], w)
        else:
            assert got[k].dtype == w.dtype and torch.equal(got[k].cpu(),
                                                           w.cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("T", [300, 5000, 68644])
@pytest.mark.parametrize("pos9", [False, True], ids=["positions", "pos9"])
def test_clip_kernel_equals_plain(cuda_device, T, pos9):
    """One launch of X4 gives the plain version's dict, keys in order,
    dtypes and bits (NaN in the same places), on a soup at the near plane
    (every clip case, back faces, degenerate triangles, w near 0); 68,644
    slots is the bunny's fused call's size."""
    p, _a, mvp = front_inputs(T, T, cuda_device)
    src = R.positions_to_pos9(p) if pos9 else p
    n0 = RCL.launches
    got = RCL.clip_screen(src, mvp, 36, 96, pos9=pos9)
    assert RCL.launches == n0 + 1
    want = RCL.clip_screen_ref(src, mvp, 36, 96, pos9=pos9)
    _same_dict(got, want)
    assert {0, 1, 2, 3} <= set(want["n_in"].tolist())
    assert 0 < int(want["valid"].sum()) < 2 * T


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 255, 256, 300, 812, 5000],
                         ids=["T1", "T255", "2T_512", "T300", "room",
                              "T5000"])
@pytest.mark.parametrize("pos9", [False, True], ids=["positions", "pos9"])
def test_clip_table_kernel_equals_plain(cuda_device, T, pos9):
    """One launch of X4's table form gives its plain version's dict
    (clip_screen_ref's) and [2T + 1, 32] table (plane_table_ref's over
    [normals, colors, positions], with its zero row), bit for bit, NaN in
    the same places; 812 slots is the entry() room's size, 256 makes 2T a
    multiple of 512."""
    p, attrs, mvp = front_inputs(T, T + 3, cuda_device)
    n, c = attrs[:, :3].contiguous(), attrs[:, 3:6].contiguous()
    src = R.positions_to_pos9(p) if pos9 else p
    n0 = (RCL.launches, RCL.launches_table, PT.launches)
    got_ch, got = RCL.clip_screen_table(src, n, c, mvp, 36, 96, pos9=pos9)
    assert (RCL.launches, RCL.launches_table, PT.launches) == (
        n0[0] + 1, n0[1] + 1, n0[2])
    want_ch, want = RCL.clip_screen_table_ref(src, n, c, mvp, 36, 96,
                                              pos9=pos9)
    _same_dict(got_ch, want_ch)
    _same_bits(got, want)
    assert got.shape == (2 * T + 1, 32)
    assert not torch.signbit(got[-1]).any() and not got[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 300, 5000, 68644],
                         ids=["T1", "T300", "T5000", "bunny"])
@pytest.mark.parametrize("pos9", [False, True], ids=["positions", "pos9"])
def test_clip_slots_kernel_equals_plain(cuda_device, T, pos9):
    """One launch of X4's slots form gives its plain version's dict
    (clip_screen_ref's) and 3 x 9 attribute slots [2T]
    (clip_attrs_channel_lists' over [normals, colors, positions]), bit for
    bit, NaN in the same places, on a soup at the near plane (every clip
    case); 68,644 slots is the bunny's fused call's size. The dict and the
    slots are row views of one [52, 2T] buffer."""
    p, attrs, mvp = front_inputs(T, T + 5, cuda_device)
    n, c = attrs[:, :3].contiguous(), attrs[:, 3:6].contiguous()
    src = R.positions_to_pos9(p) if pos9 else p
    n0 = (RCL.launches, RCL.launches_slots, RCL.launches_table)
    got_ch, got = RCL.clip_screen_slots(src, n, c, mvp, 36, 96, pos9=pos9)
    assert (RCL.launches, RCL.launches_slots, RCL.launches_table) == (
        n0[0] + 1, n0[1] + 1, n0[2])
    want_ch, want = RCL.clip_screen_slots_ref(src, n, c, mvp, 36, 96,
                                              pos9=pos9)
    _same_dict(got_ch, want_ch)
    base = got_ch["xa"].untyped_storage().data_ptr()
    for s in range(3):
        for j in range(9):
            _same_bits(got[s][j], want[s][j])
            assert got[s][j].untyped_storage().data_ptr() == base
    if T >= 300:
        assert {0, 1, 2, 3} <= set(want_ch["n_in"].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("n_attrs", [9, 6])
@pytest.mark.parametrize("form,T,v_cap", [
    ("uncompacted", 256, None), ("uncompacted", 300, None),
    ("compacted", 300, 512), ("compacted", 300, 520),
    ("compacted", 30000, 40960)],
    ids=["2T_512", "2T_600", "cap_512", "cap_520", "cap_40960"])
def test_plane_table_kernel_equals_plain(cuda_device, n_attrs, form, T,
                                         v_cap):
    """One launch of X3 gives the plain version's table (the B7 pack's
    layout at a multiple of 512 rows, stacked and padded otherwise) with
    its zero row, bit for bit, uncompacted and at a compaction's cidx
    (40,960 rows: more than 300 blocks of rows, fill ids included)."""
    p, attrs, mvp = front_inputs(T, 7, cuda_device)
    a = attrs[:, :n_attrs].contiguous()
    ch = RCL.clip_screen(p, mvp, 36, 96)
    if form == "compacted":
        cch, cidx, _n = R.compact_valid_ch(dict(ch), v_cap)
        assert (cidx == 2 * T).any()  # fill ids, which read slot 0
        args = (cch, ch, a, cidx)
    else:
        args = (ch, ch, a)
    n0 = PT.launches
    got = PT.plane_table(*args)
    assert PT.launches == n0 + 1
    want = PT.plane_table_ref(*args)
    _same_bits(got, want)
    assert got.shape == (args[0]["sxa"].shape[0] + 1,
                         PT.table_width(n_attrs))


@pytest.mark.cuda
@pytest.mark.parametrize("method,v_cap", [
    ("scatter", None), ("scatter", 1024), ("fused", None),
    ("subtile", 1024)], ids=["scatter", "mm", "fused", "subtile"])
def test_front_kernels_frames_equal_plain(cuda_device, monkeypatch, method,
                                          v_cap):
    """render_soup's frames through X4, X3 and X9 equal the same frames
    with the plain versions in their place, bit for bit. The binned walk's
    frame takes its clip, setup and table from one launch of X4's table
    form and launches no X3; the fused frame its clip and attribute slots
    from one launch of X4's slots form, and no fma32."""
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.tools.xla_inputs import FRONT_CAM
    p, attrs, _mvp = front_inputs(600, 4, cuda_device)
    n = torch.nn.functional.normalize(attrs[:, :3], dim=1)
    c = attrs[:, 3:6].abs()
    scene = shade_builder(TSB, True, 2).build(device=cuda_device)
    cam = Camera.create(**FRONT_CAM)

    def frame():
        return R.render_soup(p, n, c, scene, cam, 36, 96, 0.5,
                             method=method, v_cap=v_cap, big_cap=512)

    n0 = (RCL.launches, RCL.launches_table, PT.launches, BE.launches,
          RCL.launches_slots, KFP.launches)
    got = frame()
    table_form = method == "scatter" and v_cap is None
    assert RCL.launches == n0[0] + 1
    assert RCL.launches_table == n0[1] + table_form
    assert PT.launches == n0[2] + (method != "fused" and not table_form)
    assert BE.launches == n0[3] + (method == "scatter")
    assert RCL.launches_slots == n0[4] + (method == "fused")
    if method == "fused":
        assert KFP.launches == n0[5]
    monkeypatch.setattr(RCL, "clip_screen", RCL.clip_screen_ref)
    monkeypatch.setattr(RCL, "clip_screen_table", RCL.clip_screen_table_ref)
    monkeypatch.setattr(RCL, "clip_screen_slots", RCL.clip_screen_slots_ref)
    monkeypatch.setattr(PT, "plane_table", PT.plane_table_ref)
    monkeypatch.setattr(RCH, "binned_entries", BE.binned_entries_ref)
    _same_bits(got, frame())
    assert (got.amax(-1) > 0).sum() > 200



@pytest.mark.cuda
@pytest.mark.parametrize("T", [1000, 5000])
def test_subtile2_frame_through_b2_equals_plain(cuda_device, monkeypatch, T):
    """Generation 2's frame takes its setup from one B2 launch and its
    pack from one B7 launch over B2's rows (no fma32), and equals the same
    frame with B2 and the pack in their plain versions, bit for bit, its
    diag counts too (T = 1,000 and 5,000: B2 pads to 1,024 and 5,120)."""
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.ops import pack as PK
    from ascii_renderer_tpu_torch.ops import setup2dh as S
    rng = np.random.default_rng(T)
    p = torch.from_numpy(rng.uniform(-2, 2, (3 * T, 3)).astype(
        np.float32)).to(cuda_device)
    n = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
        size=(3 * T, 3)).astype(np.float32)), dim=1).to(cuda_device)
    c = torch.from_numpy(rng.uniform(0.2, 1.0, (3 * T, 3)).astype(
        np.float32)).to(cuda_device)
    scene = shade_builder(TSB, True, 2).build(device=cuda_device)
    cam = Camera.create(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)
    caps = dict(v_cap=16384, big_cap=1024, r_cap=65536,
                pair_cap=8 * T + 1024 * 48 * 8)

    def frame():
        return R.render_soup_diag(p, n, c, scene, cam, 48, 96, 0.5,
                                  kernel="subtile2", **caps)

    n0 = (S.launches, PK.launches_channels, KFP.launches)
    got, diag = frame()
    assert (S.launches, PK.launches_channels, KFP.launches) == (
        n0[0] + 1, n0[1] + 1, n0[2])
    monkeypatch.setattr(S, "setup_2dh_fused", S.setup_2dh_fused_ref)
    monkeypatch.setattr(RO, "pack_channels", PK.pack_channels_ref)
    want, want_diag = frame()
    _same_bits(got, want)
    assert {k: int(v) for k, v in diag.items()} == {
        k: int(v) for k, v in want_diag.items()}
    assert (got.amax(-1) > 0).sum() > 500


# --------------------------------------------------------------------------
# K3 in every form, and X9
# --------------------------------------------------------------------------
def _rt_args(scene, pr, cams, rows, cols, row_lo=0, n_rows=None):
    """(scene, pr, cam [V, 3], rd3 [V, R, 3], sphere_c) of render_rgb's
    trace on the card: the jitted grid's rays, raytrace.trace's fuse
    decisions."""
    yaw, pitch, fov = (getattr(cams, f).reshape(-1)
                       for f in ("yaw", "pitch", "fov_y"))
    rows_out = band_of(rows, row_lo, n_rows)
    dev = scene.sph_pos.device
    V = yaw.shape[0]
    rd3 = ray_grid_jit(camera_bases(yaw, pitch, fov), rows, cols, 0.5, dev,
                       row_lo, rows_out).reshape(V, rows_out * cols, 3)
    cam = cams.pos.reshape(-1, 3).to(dev, torch.float32)
    R_ = rd3.shape[1]
    return (scene, pr, cam, rd3, (RC.sphere_c_fused((V, 1, 1), pr.n_sph),
                                  RC.sphere_c_fused((V, 1, R_), pr.n_sph)))


def _rt_grid_args(scene, pr, cams, rows, cols, row_lo=0, n_rows=None):
    """(scene, pr, cam [V, 3] on the host, sphere_c, grid) of render_rgb's
    trace on the card, and the plain version's rays and origins on the
    scene's device (``rt_trace.grid_rays``)."""
    yaw, pitch, fov = (getattr(cams, f).reshape(-1)
                       for f in ("yaw", "pitch", "fov_y"))
    grid = RTK.Grid(camera_bases(yaw, pitch, fov), rows, cols, 0.5, row_lo,
                    band_of(rows, row_lo, n_rows))
    dev = scene.sph_pos.device
    cam = cams.pos.reshape(-1, 3).to(torch.float32)
    rd3 = RTK.grid_rays(grid, dev)
    V, R_ = rd3.shape[:2]
    fuse = (RC.sphere_c_fused((V, 1, 1), pr.n_sph),
            RC.sphere_c_fused((V, 1, R_), pr.n_sph))
    return (scene, pr, cam, fuse, grid), (cam.to(dev), rd3)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["staged", "global"])
@pytest.mark.parametrize("lanes", RTK.LANES)
@pytest.mark.parametrize("name", RT_SCENES)
def test_trace_kernel_grid_form_every_form_equals_plain(cuda_device, name,
                                                        lanes, stage):
    """K3's grid form (the kernel computes its rays from the views'
    bases) with L lanes a ray, staged or global (one launch each, no grid
    launch) gives trace_rgb's bits over the plain grid (ndc_grid_jit +
    ray_dirs_jit): one camera at 36x96, 16 orbit views at 24x40, bands of
    12 rows."""
    scene = rt_scene(name, cuda_device)
    pr = RT.ScenePrims(scene)
    orbit = orbit_cameras(16, center=(0, 1.0, 0.0), radius=5.5)
    for cams, rows, cols, kw in ((scene.camera, 36, 96, {}),
                                 (orbit, 24, 40, {}),
                                 (scene.camera, 36, 96,
                                  dict(row_lo=12, n_rows=12)),
                                 (orbit, 24, 40, dict(row_lo=12, n_rows=12))):
        (sc, pr_, cam, fuse, grid), (cam_d, rd3) = _rt_grid_args(
            scene, pr, cams, rows, cols, **kw)
        n0 = (RTK.launches, RYG.jit_launches)
        got = RTK.trace(sc, pr_, cam, None, fuse, grid=grid, lanes=lanes,
                        stage=stage)
        assert (RTK.launches, RYG.jit_launches) == (n0[0] + 1, n0[1])
        _same_bits(got, RT.trace_rgb(scene, pr, cam_d, rd3))


@pytest.mark.cuda
def test_trace_kernel_grid_form_farm_every_form_equals_plain(cuda_device):
    """The farm's 1,024 orbit views of rt_demo (3,538,944 rays) through K3's
    grid form in every form and the launch's own give trace_rgb's bits
    over the plain grid, and render_rgb's; its bands of 12 rows equal
    those rows."""
    scene = create_rt_demo_scene().build(min_pad=1, device=cuda_device)
    pr = RT.ScenePrims(scene)
    cams = orbit_cameras(1024, center=(0, 1.0, 1.0))
    (sc, pr_, cam, fuse, grid), (cam_d, rd3) = _rt_grid_args(
        scene, pr, cams, 36, 96)
    want = RT.trace_rgb(scene, pr, cam_d, rd3)
    for stage in ("staged", "global"):
        for lanes in RTK.LANES:
            _same_bits(RTK.trace(sc, pr_, cam, None, fuse, grid=grid,
                                 lanes=lanes, stage=stage), want)
    _same_bits(RTK.trace(sc, pr_, cam, None, fuse, grid=grid), want)
    full = RT.render_rgb(scene, cams, 36, 96, 0.5, prims=pr)
    _same_bits(full.reshape(want.shape), want)
    for lo in (0, 12, 24):
        _same_bits(RT.render_rgb(scene, cams, 36, 96, 0.5, row_lo=lo,
                                 n_rows=12, prims=pr), full[:, lo:lo + 12])


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["16 views", "16 views, a band",
                                  "9 views of 2x3", "farm 1,024",
                                  "farm 1,024, a band"])
def test_trace_kernel_trig_form_equals_plain(cuda_device, call):
    """K3's trig form (each view's origin and trig from
    core/camera.view_trig; the kernel forms its bases, once a block in
    shared memory, or a ray where a block spans more views, and its
    rays) gives the bases grid's K3 output
    and trace_rgb's over the plain grid bit for bit, one launch, in the
    launch's own form and at 1 and 32 lanes, staged and global: 16 orbit
    views at 24x40 and a band of 12 rows, 9 views of 2x3 (a block spans
    more views than it forms in shared memory: its rays form their own),
    the farm's 1,024 at 36x96 and a band of 12 rows."""
    from ascii_renderer_tpu_torch.core.camera import view_trig
    scene = create_rt_demo_scene().build(min_pad=1, device=cuda_device)
    pr = RT.ScenePrims(scene)
    views, rows, cols = {"16": (16, 24, 40), "9": (9, 2, 3),
                         "farm": (1024, 36, 96)}[call.split()[0]]
    kw = dict(row_lo=12, n_rows=12) if "band" in call else {}
    cams = orbit_cameras(views, center=(0, 1.0, 1.0))
    (sc, pr_, cam, fuse, grid), (cam_d, rd3) = _rt_grid_args(
        scene, pr, cams, rows, cols, **kw)
    tgrid = grid._replace(bases=None, trig=view_trig(
        cam, cams.yaw, cams.pitch, cams.fov_y))
    want = RT.trace_rgb(scene, pr, cam_d, rd3)
    _same_bits(RTK.trace(sc, pr_, cam, None, fuse, grid=grid), want)
    for form in ({}, dict(lanes=1, stage="staged"),
                 dict(lanes=32, stage="global")):
        n0 = (RTK.launches, RYG.jit_launches, KFP.launches)
        got = RTK.trace(sc, pr_, cam, None, fuse, grid=tgrid, **form)
        assert (RTK.launches, RYG.jit_launches, KFP.launches) == (
            n0[0] + 1, n0[1], n0[2])
        _same_bits(got, want)


@pytest.mark.cuda
def test_trace_trig_form_raises_on_build_or_launch_failure(cuda_device,
                                                           monkeypatch):
    """A failed build and a failed launch each raise out of K3's trig
    form and out of render_rgb at 9 views (its trig form); neither falls
    back to the plain version."""
    from ascii_renderer_tpu_torch.core.camera import view_trig
    scene = create_rt_demo_scene().build(min_pad=1, device=cuda_device)
    pr = RT.ScenePrims(scene)
    cams = orbit_cameras(9, center=(0, 1.0, 1.0))
    (sc, pr_, cam, fuse, grid), _plain = _rt_grid_args(scene, pr, cams, 6,
                                                       8)
    tgrid = grid._replace(bases=None, trig=view_trig(
        cam, cams.yaw, cams.pitch, cams.fov_y))
    plain = []
    monkeypatch.setattr(RT, "trace_rgb", lambda *a: plain.append(a))

    def no_build():
        raise RuntimeError("nvcc failed")

    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        for run in (lambda: RTK.trace(sc, pr_, cam, None, fuse, grid=tgrid),
                    lambda: RT.render_rgb(scene, cams, 6, 8, 0.5,
                                          prims=pr)):
            with pytest.raises(RuntimeError, match=match):
                run()
    assert plain == []


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["one view", "band", "two views", "farm"])
def test_render_rgb_is_one_k3_launch_on_cuda(cuda_device, call):
    """render_rgb on the card launches K3 once a call and neither the
    jitted grid kernel nor fma32, and equals the plain route (the plain
    grid, then trace_rgb) on the same card."""
    scene = create_rt_demo_scene().build(min_pad=1, device=cuda_device)
    pr = RT.ScenePrims(scene)
    cams = {"one view": scene.camera, "band": scene.camera,
            "two views": orbit_cameras(2, center=(0, 1.0, 1.0)),
            "farm": orbit_cameras(1024, center=(0, 1.0, 1.0))}[call]
    kw = dict(row_lo=12, n_rows=12) if call == "band" else {}
    n0 = (RTK.launches, RYG.jit_launches, KFP.launches)
    got = RT.render_rgb(scene, cams, 36, 96, 0.5, prims=pr, **kw)
    assert (RTK.launches, RYG.jit_launches, KFP.launches) == (
        n0[0] + 1, n0[1], n0[2])
    _args, (cam_d, rd3) = _rt_grid_args(scene, pr, cams, 36, 96, **kw)
    _same_bits(got.reshape(rd3.shape), RT.trace_rgb(scene, pr, cam_d, rd3))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["staged", "global"])
@pytest.mark.parametrize("lanes", RTK.LANES)
@pytest.mark.parametrize("name", RT_SCENES)
def test_trace_kernel_every_form_equals_plain(cuda_device, name, lanes,
                                              stage):
    """K3 with L lanes a ray and the valid slots staged in shared memory
    or read from the global arrays (one launch each) gives trace_rgb's
    bits: one camera at 36x96, 16 orbit views at 24x40, a band of 12
    rows."""
    scene = rt_scene(name, cuda_device)
    pr = RT.ScenePrims(scene)
    orbit = orbit_cameras(16, center=(0, 1.0, 0.0), radius=5.5)
    for cams, rows, cols, kw in ((scene.camera, 36, 96, {}),
                                 (orbit, 24, 40, {}),
                                 (scene.camera, 36, 96,
                                  dict(row_lo=12, n_rows=12))):
        *args, fuse = _rt_args(scene, pr, cams, rows, cols, **kw)
        n0 = RTK.launches
        got = RTK.trace(*args, fuse, lanes=lanes, stage=stage)
        assert RTK.launches == n0 + 1
        _same_bits(got, RT.trace_rgb(*args))


@pytest.mark.cuda
def test_trace_kernel_farm_every_form_equals_plain(cuda_device):
    """The farm's 1,024 orbit views of rt_demo (exact slots, 3,538,944
    rays) through every form of K3 give trace_rgb's bits; the launch's own
    choice keeps one lane a ray there, staged, and takes all 32 at a 96x36
    frame, reading the global arrays."""
    scene = create_rt_demo_scene().build(min_pad=1, device=cuda_device)
    pr = RT.ScenePrims(scene)
    *args, fuse = _rt_args(scene, pr, orbit_cameras(
        1024, center=(0, 1.0, 1.0)), 36, 96)
    want = RT.trace_rgb(*args)
    for stage in ("staged", "global"):
        for lanes in RTK.LANES:
            _same_bits(RTK.trace(*args, fuse, lanes=lanes, stage=stage),
                       want)
    _same_bits(RTK.trace(*args, fuse), want)
    assert RTK.launch_form(1024 * 3456, pr) == (1, True)
    assert RTK.launch_form(3456, pr) == (32, False)


class _FailingLib:
    """A kernel library whose every launch reports a CUDA error."""

    def __getattr__(self, name):
        return lambda *args: 700  # cudaErrorIllegalAddress


@pytest.mark.cuda
def test_trace_and_bin_entries_raise_on_build_or_launch_failure(
        cuda_device, monkeypatch):
    """A failed build and a failed launch each raise out of K3's (rd3 and
    grid forms, and render_rgb) and X9's wrappers; neither falls back to
    its plain version."""
    scene = rt_scene("rt_demo", cuda_device)
    pr = RT.ScenePrims(scene)
    *args, fuse = _rt_args(scene, pr, scene.camera, 12, 32)
    (sc, pr_, cam, gfuse, grid), _plain = _rt_grid_args(
        scene, pr, orbit_cameras(2, center=(0, 1.0, 0.0)), 12, 32)
    ch, rows, cols = bin_calls(cuda_device)["room 96x36"]

    def no_build():
        raise RuntimeError("nvcc failed")

    runs = (lambda: RTK.trace(*args, fuse),
            lambda: RTK.trace(sc, pr_, cam, None, gfuse, grid=grid),
            lambda: RT.render_rgb(scene, scene.camera, 12, 32, 0.5,
                                  prims=pr),
            lambda: BE.binned_entries(dict(ch), rows, cols))
    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        for run in runs:
            with pytest.raises(RuntimeError, match=match):
                run()
    monkeypatch.undo()
    for kw in (dict(lanes=3), dict(stage="shared")):  # forms it lacks
        with pytest.raises(ValueError):
            RTK.trace(*args, fuse, **kw)
        with pytest.raises(ValueError):
            RTK.trace(sc, pr_, cam, None, gfuse, grid=grid, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["mm", "loop"])
@pytest.mark.parametrize("call", ["room 96x36", "teapot 240x135",
                                  "mid-scale HD 960x540",
                                  "near-plane soup 480x270"]
                         + [f"soup {n}" for n in BIN_SOUPS])
def test_bin_entries_kernel_equals_plain(cuda_device, call, kernel):
    """X9 (three or four launches) gives the plain chain's entries,
    offsets, tiles_x and n_tiles bit for bit at its callers' channel dicts
    (the entry() room's, the teapot's, the mid-scale HD arm's, a soup at
    the near plane) and the CPU tests' soups, in both layouts."""
    if call.startswith("soup "):
        np_ch, rows, cols = bin_soup(call[5:])
        ch = {k: torch.from_numpy(v).to(cuda_device)
              for k, v in np_ch.items()}
    else:
        ch, rows, cols = bin_calls(cuda_device)[call]
    n0 = BE.launches
    got = BE.binned_entries(dict(ch), rows, cols, kernel=kernel, counts=True)
    assert BE.launches == n0 + 1
    want = BE.binned_entries_ref(dict(ch), rows, cols, kernel=kernel,
                                 counts=True)
    assert got[0].shape == want[0].shape and got[0].is_contiguous()
    _same_bits(got[0], want[0])
    assert torch.equal(got[1].cpu(), want[1].cpu())
    assert got[2:4] == want[2:4]
    assert torch.equal(got[4].cpu(), want[4].cpu())



# --------------------------------------------------------------------------
# X9's forms and its bin keys; X10
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(BE.FORMS))
@pytest.mark.parametrize("call", ["room 96x36", "teapot 240x135",
                                  "mid-scale HD 960x540"]
                         + [f"soup {n}" for n in BIN_SOUPS])
def test_bin_entries_every_form_equals_plain(cuda_device, call, form):
    """Each form of X9 (three or four launches at chunks of 1,024-4,096
    keys) gives the plain chain's entries, offsets and counts (n_small,
    n_big, n_pairs, n_valid; n_big above big_cap in the many_big soup)
    in walk "mm"'s layout at its callers' dicts and the CPU tests'
    soups."""
    if call.startswith("soup "):
        np_ch, rows, cols = bin_soup(call[5:])
        ch = {k: torch.from_numpy(v).to(cuda_device)
              for k, v in np_ch.items()}
    else:
        ch, rows, cols = bin_calls(cuda_device)[call]
    got = BE.binned_entries(dict(ch), rows, cols, form=form, counts=True)
    assert BE.last_launches == BE.launches_of(
        form, got[3], 4 * ch["valid"].shape[0] + 64 * got[3])
    want = BE.binned_entries_ref(dict(ch), rows, cols, counts=True)
    _same_bits(got[0], want[0])
    assert torch.equal(got[1].cpu(), want[1].cpu())
    assert torch.equal(got[4].cpu(), want[4].cpu())


# a band (ty_lo, tiles_y_band) of each bbox soup's grid
BANDS = {"one_tile": (4, 1), "hd": (2, 22), "many_big": (3, 4),
         "edge": (1, 3), "all_invalid": (0, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(BE.FORMS) + [0])
@pytest.mark.parametrize("name", list(BIN_SOUPS))
def test_bin_keys_kernel_equals_plain(cuda_device, name, form):
    """X9's bin keys (pair_keys) in each form give the plain chain's
    sorted keys, offsets and counts, unbanded and banded, big_cap 0 and
    64, on soups with off-screen, near-plane sized, NaN and infinite
    bounds."""
    np_bb, rows, cols = bbox_soup(name)
    bb = {k: torch.from_numpy(v).to(cuda_device) for k, v in np_bb.items()}
    for cap in (0, 64):
        for kw in ({}, dict(zip(("ty_lo", "tiles_y_band"), BANDS[name]))):
            n0 = BE.launches_keys
            got = BE.pair_keys_bbox(bb, rows, cols, big_cap=cap, form=form,
                                    **kw)
            assert BE.launches_keys == n0 + 1
            want = BE.pair_keys_ref(bb["bx0"], bb["bx1"], bb["by0"],
                                    bb["by1"], bb["valid"], rows, cols,
                                    big_cap=cap, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w.cpu()), (cap, kw)


GROUP_CAPS = {  # (r_cap, pair_cap, grp_cap) over the many_big soup's grid
    "generous": (32 * 2048, 1 << 20, 36),
    "overflow": (64, 600, 2),
    "truncated": (32 * 256, 900, 20),
    "sentinels": (32 * 1024, 1 << 20, 72),
}


def _same_build(cuda_device, src, keys, offs, args, k, rows256):
    """X10 against the plain build bit for bit, with X9's offsets (two
    launches) and without (three), banded pixel rows included."""
    for offsets, y_off in ((None, 0), (offs, 16)):
        want = GB.build_rows(src, keys, *args, k=k, rows256=rows256,
                             y_off=y_off)
        n0 = GB.launches
        got = GB.build_rows(
            src.to(cuda_device), keys.to(cuda_device), *args, k=k,
            rows256=rows256, y_off=y_off,
            offsets=None if offsets is None else offsets.to(cuda_device))
        assert GB.launches == n0 + 1
        assert GB.last_launches == (3 if offsets is None else 2)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if w.dtype == torch.float32:
                assert torch.equal(g.cpu().view(torch.int32),
                                   w.view(torch.int32))
            else:
                assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("caps", sorted(GROUP_CAPS))
@pytest.mark.parametrize("gen", sorted(GB.LAYOUTS))
def test_group_build_kernel_equals_plain(cuda_device, gen, caps):
    """X10 gives the plain build's layout bit for bit for each layout it
    serves, over 32-wide source rows."""
    k, rows256 = GB.LAYOUTS[gen]
    np_bb, rows, cols = bbox_soup("many_big")
    bb = {nm: torch.from_numpy(v) for nm, v in np_bb.items()}
    keys, offs, _c = BE.pair_keys_bbox(bb, rows, cols, big_cap=64)
    n_tiles = -(-rows // 8) * -(-cols // 128)
    src = torch.from_numpy(np.random.default_rng(5).normal(
        size=(keys.shape[0] // 4, 32)).astype(np.float32))
    r_cap, pair_cap, grp_cap = GROUP_CAPS[caps]
    if rows256 and caps == "overflow":
        r_cap = 128
    _same_build(cuda_device, src, keys, offs,
                (-(-cols // 128), n_tiles, r_cap, pair_cap, grp_cap), k,
                rows256)


GROUP_DEPTHS = {  # (tiles_x, n_tiles, depths: a bin's, or choices, caps)
    "ties": (5, 40, [0, 3, 3, 5, 5, 9], (32 * 256, 1 << 16, 40)),
    "flat": (8, 544, [2], (32 * 320, 1 << 16, 60)),
    "deep": (3, 6, [0, 4, 1023, 1200, 1200, 1500], (32 * 256, 1 << 16, 6)),
    "one_bin": (5, 25, [0] * 199 + [50], (32 * 8, 1 << 16, 3)),
    "max_bins": (31, 1023, [0, 0, 0, 1, 2, 5, 8], (32 * 512, 1 << 16, 400)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUP_DEPTHS))
@pytest.mark.parametrize("gen", sorted(GB.LAYOUTS))
def test_group_build_kernel_equals_plain_at_edges(cuda_device, gen, case):
    """X10 equals the plain build where its depth order has its edge
    cases: depths tied across many bins, every bin of a 960x540 frame
    equally deep (one depth bucket), depths from 1023 on with ties (the
    last bucket), a single nonempty bin, 8,184 bins."""
    k, rows256 = GB.LAYOUTS[gen]
    tiles_x, n_tiles, choices, caps = GROUP_DEPTHS[case]
    rng = np.random.default_rng(11)
    depths = (np.array(choices) if len(choices) == n_tiles * 8 else
              rng.choice(choices, n_tiles * 8))
    n_tri = max(64, int(depths.max()) + 1)
    keys = np.concatenate(
        [(b << 18) | np.sort(rng.choice(n_tri, d, replace=False))
         for b, d in enumerate(depths) if d]
        + [(n_tiles * 8 << 18) | np.sort(rng.integers(0, n_tri, 37))])
    keys = torch.from_numpy(keys.astype(np.int32))
    offs = torch.from_numpy(np.searchsorted(
        keys.numpy(), np.arange(n_tiles * 8 + 1) << 18).astype(np.int32))
    src = torch.from_numpy(rng.normal(size=(n_tri, 32)).astype(np.float32))
    _same_build(cuda_device, src, keys, offs, (tiles_x, n_tiles, *caps), k,
                rows256)


@pytest.mark.cuda
def test_bin_keys_and_group_build_raise_on_build_or_launch_failure(
        cuda_device, monkeypatch):
    """A failed build and a failed launch each raise out of pair_keys and
    build_rows; neither falls back to its plain version."""
    np_bb, rows, cols = bbox_soup("one_tile")
    bb = {k: torch.from_numpy(v).to(cuda_device) for k, v in np_bb.items()}
    keys, offs, _c = BE.pair_keys_bbox(bb, rows, cols, big_cap=64)
    src = torch.zeros((keys.shape[0] // 4, 16), device=cuda_device)

    def no_build():
        raise RuntimeError("nvcc failed")

    runs = (lambda: BE.pair_keys_bbox(bb, rows, cols, big_cap=64),
            lambda: GB.build_rows(src, keys, 1, 5, 256, 4096, 5, k=8,
                                  offsets=offs))
    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        for run in runs:
            with pytest.raises(RuntimeError, match=match):
                run()


# --------------------------------------------------------------------------
# the path tracer's sample rays (X7) and batch fold (X14)
# --------------------------------------------------------------------------
# (rows, cols, samples a batch (0: the probe), batch index, row band or
# None, compacted): the reference run's batches and probe, the HD arm's
# batch, a compacted order, a band, a compacted band; where X7 takes a
# sample a thread at HD (the probe), every sample of a slot (the
# progressive HD batch's compacted stream) and a split between (3 of a
# 480x270 batch's 8, ops/ray_grid.samples_per_thread)
PT_RAY_CASES = {"reference batch 0": (36, 96, 32, 0, None, False),
                "reference batch 1": (36, 96, 32, 1, None, False),
                "reference probe": (36, 96, 0, 0, None, False),
                "HD batch": (540, 960, 8, 0, None, False),
                "compacted batch 1": (36, 96, 32, 1, None, True),
                "band batch 1": (36, 96, 32, 1, (12, 12), False),
                "compacted band probe": (36, 96, 0, 0, (12, 12), True),
                "HD probe": (540, 960, 0, 0, None, False),
                "compacted HD batch": (540, 960, 8, 1, None, True),
                "480x270 batch": (270, 480, 8, 0, None, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("pose", [(-np.pi / 2, 0.0), (-1.234, 0.321)])
@pytest.mark.parametrize("case", sorted(PT_RAY_CASES))
def test_pt_rays_kernel_equals_plain(cuda_device, case, pose):
    """X7 equals its plain version on the same CUDA tensors bit for bit
    (a mix of fetched, unfetched and NaN probe pixels), pad rays 0; one
    launch a call."""
    from ascii_renderer_tpu_torch.core.camera import Camera, camera_basis
    rows, cols, B, b, band, compacted = PT_RAY_CASES[case]
    row_lo, n_rows = band if band else (0, rows)
    pc = n_rows * cols
    cam = Camera.create(pos=(0.0, 2.5, 6.0), yaw=pose[0], pitch=pose[1])
    basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    kw = dict(row_lo=row_lo, n_rows=n_rows, device=cuda_device)
    if compacted:
        order = pixel_order(n_rows, cols, 0.3, seed=1)[1] + row_lo * cols
        kw["pix_uid"] = torch.from_numpy(order).to(cuda_device)
    if B:
        kw.update(fet0=torch.from_numpy(pt_outputs(
            -(-pc // 1024) * 1024, seed=2)[4]).to(cuda_device), samples=B,
            s0=b * B, seed=-1640531527 * (b + 1) + 7)
    RYG.pt_launches = 0
    got = RYG.pt_rays(basis, rows, cols, 0.5, **kw)
    want = RYG.pt_rays_ref(basis, rows, cols, 0.5, **kw)
    torch.cuda.synchronize()
    assert RYG.pt_launches == 1 and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# (pc, samples a batch, spp, compacted): the reference run's two batches,
# a last batch past spp (spp 40 at 32), the HD arm's one batch, a
# compacted order; batches of 8 on each side of the size where X14
# changes form (32,400 slots in the tile form, 129,600 in the slot form)
PT_FOLD_CASES = {"reference 2 x 32": (3456, 32, 64, False),
                 "spp 40 at 32": (3456, 32, 40, False),
                 "HD 1 x 8": (518400, 8, 8, False),
                 "compacted 3 x 4": (3456, 4, 10, True),
                 "240x135 2 x 8": (32400, 8, 16, False),
                 "480x270 2 x 8": (129600, 8, 16, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PT_FOLD_CASES))
def test_pt_reduce_kernel_equals_plain(cuda_device, case):
    """X14 equals its plain version on the same CUDA tensors: every
    batch's state bit for bit (NaN in the same places), then the resolve's
    rgb and alpha; overrides in several samples, NaN radiance and ties of
    rint in the seeded outputs; one launch a fold."""
    pc, B, spp, compacted = PT_FOLD_CASES[case]
    n_batches = -(-spp // B)

    def outs(n, seed):
        return [torch.from_numpy(x).to(cuda_device)
                for x in pt_outputs(-(-n // 1024) * 1024, seed=seed,
                                    p_override=0.003)]

    probe = outs(pc, 0)
    slot = None
    if compacted:
        slot = torch.from_numpy(pixel_order(36, 96, 0.3, seed=4)[1]).to(
            cuda_device)
    states = [PR.new_state(pc, cuda_device) for _ in range(2)]
    PR.launches = 0
    for b in range(n_batches):
        o = outs(B * pc, b + 1)
        last = b == n_batches - 1
        kw = dict(first=b == 0, probe=probe[:4] if last else None, spp=spp,
                  slot=slot)
        n_valid = min(B, spp - b * B)
        got = PR.fold(states[0], *o[:4], n_valid, **kw)
        want = PR.fold_ref(states[1], *o[:4], n_valid, **kw)
        torch.cuda.synchronize()
        if not last:
            for g, w in zip(*states):
                _same_bits(g.view(torch.float32), w.view(torch.float32))
    assert PR.launches == n_batches
    _same_bits(got[0], want[0])
    assert torch.equal(got[1], want[1]) and (got[1] != 255).any()


@pytest.mark.cuda
def test_render_pt_takes_rays_and_reduce_in_one_launch_a_batch(cuda_device):
    """render_pt on the card: X7 once for the probe and once a batch, B5
    likewise, X14 once a batch; the alpha plane equals the CPU's and the
    rgb is finite; the old ray grid is not launched."""
    from ascii_renderer_tpu_torch.backends import pathtrace as PT
    from ascii_renderer_tpu_torch.ops import pt_kernel as PTK
    from ascii_renderer_tpu_torch.parallel.worlds import pt_fixture
    scene, cam, pkw = pt_fixture(cuda_device)
    cscene, _c, _k = pt_fixture("cpu")
    pkw = dict(pkw, spp=5, sample_batch=2)
    RYG.pt_launches = RYG.launches = PR.launches = PTK.launches = 0
    rgb, a = PT.render_pt(scene, cam, 0.0, 3, rows=36, cols=96, **pkw)
    torch.cuda.synchronize()
    assert (RYG.pt_launches, PTK.launches, PR.launches,
            RYG.launches) == (4, 4, 3, 0)
    _rgb, a_cpu = PT.render_pt(cscene, cam, 0.0, 3, rows=36, cols=96, **pkw)
    assert torch.equal(a.cpu(), a_cpu) and bool(torch.isfinite(rgb).all())


# B5's frame form, and the frame's set-up
def _pt_frame_launch(device, case):
    """(light, origin, prim, rays, seed, atlas, keywords) of a frame-form
    launch of the demo room at 36x96: X7's rays of batch 1 (32 samples),
    of a band's or of a compacted stream's, with the compacted stream's
    block gate."""
    from ascii_renderer_tpu_torch.atlas.io import demo_atlas
    from ascii_renderer_tpu_torch.backends import pathtrace as PTB
    from ascii_renderer_tpu_torch.core.camera import Camera, camera_basis
    from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
    sb = create_demo_scene()
    sb.set_atlas(demo_atlas())
    scene = sb.build(min_pad=1, device=device)
    prim, atlas, aw, ah, sph_rows = PTB.pack_scene_entries(scene)
    cam = Camera.create(pos=(0.0, 2.5, 6.0), yaw=-1.234, pitch=0.321)
    basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    row_lo, n_rows = (12, 12) if case == "band" else (0, 36)
    pc = n_rows * 96
    kw = dict(row_lo=row_lo, n_rows=n_rows, device=device)
    gate = None
    if case == "compacted":
        act, order = pixel_order(n_rows, 96, 0.3, seed=1)
        kw["pix_uid"] = torch.from_numpy(order).to(device)
        gate = PTB._block_gate((torch.arange(pc) < int(act.sum())).repeat(
            32)).to(device)
    rd = RYG.pt_rays(basis, 36, 96, 0.5, **kw, fet0=torch.from_numpy(
        pt_outputs(pc, seed=3)[4]).to(device), samples=32, s0=32,
        seed=PTB.batch_seed_of(5, 1))
    lc, lr = PTB.get_light_sphere(scene, 0.4)
    light = PTB._light_host(lc, lr, torch.tensor((16.86, 10.76, 8.2)) *
                            1.3).tolist()
    return (light, cam.pos.tolist(), prim, rd, PTB.batch_seed_of(5, 1),
            atlas, dict(pc=pc, npix=36 * 96, uid0=row_lo * 96,
                        pix_uid=kw.get("pix_uid"), bounces=5, nee=True,
                        atlas_w=aw, atlas_h=ah, sph_rows=sph_rows,
                        block_active=gate))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "band", "compacted"])
def test_pt_trace_frame_form_equals_plain_and_per_ray_form(cuda_device,
                                                           case):
    """B5's frame form (the light and the origin by value, uids from the
    stream) equals its plain version and the per-ray form on the origin
    expanded to every ray and the same uids, every output bit for bit."""
    from ascii_renderer_tpu_torch.ops import pt_kernel as PTK
    light, origin, prim, rd, seed, atlas, kw = _pt_frame_launch(
        cuda_device, case)
    nblk = rd.shape[0]
    launches = PTK.launches
    got = PTK.trace_frame(light, origin, prim, rd, seed, atlas, **kw)
    want = PTK.trace_frame_ref(light, origin, prim, rd, seed, atlas, **kw)
    per_ray = PTK.trace_blocks_raw(
        torch.tensor(light, device=cuda_device), prim,
        torch.tensor(origin, device=cuda_device).expand(
            nblk, 8, 128, 3).contiguous(), rd, seed, atlas,
        bounces=5, nee=True, atlas_w=kw["atlas_w"], atlas_h=kw["atlas_h"],
        sph_rows=kw["sph_rows"], block_active=kw["block_active"],
        uid=PTK.frame_uids(nblk, kw["pc"], kw["npix"], kw["uid0"],
                           kw["pix_uid"], cuda_device))
    torch.cuda.synchronize()
    assert PTK.launches == launches + 2
    for g, w, r in zip(got, want, per_ray):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
    assert bool((got[0] != 0).any())


# aten ops that allocate or reshape and launch nothing on the card
_NO_LAUNCH = {"empty", "empty_strided", "view", "_unsafe_view", "reshape",
              "as_strided", "detach", "alias", "slice", "select", "expand",
              "t", "permute", "unsqueeze", "squeeze", "lift_fresh",
              "_reshape_alias", "unbind"}


@pytest.mark.cuda
@pytest.mark.parametrize("band", [False, True])
def test_render_pt_set_up_makes_one_launch_and_no_copy(cuda_device,
                                                       monkeypatch, band):
    """A full frame's or a band's pt.setup asks the card for one op that
    launches (the ray counters' fill) and for no copy from the host: the
    light and the camera position go to the megakernel by value (the
    scene's light read to the host once, as PathtraceBackend reads it).
    The ops are those torch dispatches inside the stage's range (no
    profiler: its sessions lose rows in later tests' sessions)."""
    import contextlib

    from torch.utils._python_dispatch import TorchDispatchMode

    from ascii_renderer_tpu_torch.backends import pathtrace as PTB
    from ascii_renderer_tpu_torch.parallel.worlds import pt_fixture
    stage, ops = [None], []

    @contextlib.contextmanager
    def stage_range(name):
        stage[0] = name
        try:
            yield
        finally:
            stage[0] = None

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if stage[0] == "pt.setup":
                flat = [t for t in torch.utils._pytree.tree_leaves(
                    (args, kwargs, out)) if isinstance(t, torch.Tensor)]
                devs = {t.device.type for t in flat}
                if "cuda" in devs:
                    ops.append((func.__name__.split(".")[0], devs))
            return out

    scene, cam, pkw = pt_fixture(cuda_device)
    kw = dict(pkw, rows=36, cols=96, light_host=PTB.light_sphere_host(scene),
              packed=PTB.pack_scene_entries(scene),
              **(dict(row_lo=12, n_rows=12) if band else {}))
    monkeypatch.setattr(PTB, "record_function", stage_range)
    with Count():
        rgb, _a = PTB.render_pt(scene, cam, 0.0, 3, **kw)
    torch.cuda.synchronize()
    launching = [name for name, _d in ops if name not in _NO_LAUNCH]
    copies = [name for name, devs in ops if "cpu" in devs]
    assert len(launching) <= 1 and not copies, ops
    assert bool(torch.isfinite(rgb).all())


# --------------------------------------------------------------------------
# K2's image form (X11) and X10's inverse of the depth order
# --------------------------------------------------------------------------
# (rows, cols, grp_cap less the tiles, y_off): a grouped walk's image; bins
# no group covers where grp_cap is short, sentinel slots where it is long; a
# band of rows from y_off
IMAGE_CASES = {"36x96": (36, 96, 0, 0), "540x960": (540, 960, 0, 0),
               "uncovered bins": (40, 300, -6, 0),
               "sentinel slots": (61, 200, 3, 0),
               "band of 176 at 176": (176, 960, 0, 176)}


def _image_walk(case, n_tris=200, seed=4):
    """A seeded grouped walk on the CPU: keys of random depths, the plain
    K = 8 build's lanes, slots' bins and places (xl, yl in the band's rows,
    gbins, ginv), winner ids e (-1 where no hit, some -0.0), the
    geometry."""
    rows, cols, extra, y_off = IMAGE_CASES[case]
    tiles_y, tiles_x = -(-rows // 8), -(-cols // 128)
    n_tiles = tiles_y * tiles_x
    grp_cap = n_tiles + extra
    rng = np.random.default_rng(seed + rows + cols)
    depths = rng.choice([0, 0, 1, 2, 5, 9, 14], n_tiles * 8)
    keys = torch.from_numpy(np.concatenate(
        [(b << 18) | np.sort(rng.choice(n_tris, d, replace=False))
         for b, d in enumerate(depths) if d]).astype(np.int32))
    src = torch.from_numpy(rng.normal(size=(n_tris, 32)).astype(np.float32))
    lay = GB.build_rows(src, keys, tiles_x, n_tiles, 32 * 64, 1 << 16,
                        grp_cap, k=8, y_off=y_off)
    e = rng.integers(-1, n_tris, (grp_cap, 8, 128)).astype(np.float32)
    e[rng.random(e.shape) < 0.3] = -1.0
    e.reshape(-1)[::13] = -0.0
    return dict(e=torch.from_numpy(e), groups=(*lay[-7:-4], lay[-1]),
                tiles_x=tiles_x,
                rows=rows, cols=cols, y_off=y_off, keys=keys, src=src,
                caps=(tiles_x, n_tiles, 32 * 64, 1 << 16, grp_cap))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["pack_width", "unaligned_rows"])
@pytest.mark.parametrize("n_attrs,n_pts", [(9, 3), (6, 0)],
                         ids=["9_3pt", "6"])
@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_shade_image_kernel_equals_plain(cuda_device, case, n_attrs, n_pts,
                                         layout):
    """K2's image form (one launch) against its plain version (the grouped
    shade, then the assembly) bit for bit: covered and uncovered bins,
    sentinel slots, a band, ids of -0.0, table rows read as float4 or
    not."""
    w = _image_walk(case)
    scene = shade_builder(TSB, True, n_pts).build(device=cuda_device)
    table = shade_inputs(n_attrs, (1,), n_tris=200)[0].to(cuda_device)
    W = table.shape[1]
    wide = torch.zeros((table.shape[0], -(-W // 8) * 8 + 8),
                       device=cuda_device)
    if layout == "unaligned_rows":
        wide[:, 1:1 + W] = table
        table = wide[:, 1:1 + W]
    else:
        wide[:, :W] = table
        table = wide[:, :-(-W // 8) * 8]
    args = (table, w["e"].to(cuda_device),
            *(t.to(cuda_device) for t in w["groups"]), scene, n_attrs,
            w["tiles_x"], w["rows"], w["cols"], w["y_off"])
    n0, i0 = RSH.launches, RSH.launches_image
    got = RSH.shade_image(*args)
    assert (RSH.launches, RSH.launches_image) == (n0 + 1, i0 + 1)
    want = RSH.shade_image_ref(*args)
    _same_bits(got, want)
    assert got.shape == (w["rows"], w["cols"], 3) and (want > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("gen", sorted(GB.LAYOUTS))
@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_group_build_ginv_equals_plain(cuda_device, case, gen):
    """X10 on the image form's walks (bins no group covers, sentinel
    slots, a band): the layout and ginv, each bin's place that the layout
    block stores, bit for bit with the plain build, with X9's offsets and
    without."""
    w = _image_walk(case)
    k, rows256 = GB.LAYOUTS[gen]
    src, keys = w["src"], w["keys"]
    offs = torch.from_numpy(np.searchsorted(
        keys.numpy(), np.arange(w["caps"][1] * 8 + 1) << 18).astype(np.int32))
    want = GB.build_rows(src, keys, *w["caps"], k=k, rows256=rows256,
                         y_off=w["y_off"])
    for offsets in (None, offs):
        kw = dict(k=k, rows256=rows256, y_off=w["y_off"],
                  offsets=None if offsets is None else offsets.to(
                      cuda_device))
        got = GB.build_rows(src.to(cuda_device), keys.to(cuda_device),
                            *w["caps"], **kw)
        assert len(got) == len(want)
        for g, x in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32)
                               if g.dtype == torch.float32 else g.cpu(),
                               x.view(torch.int32)
                               if x.dtype == torch.float32 else x)


def _stage_ops(monkeypatch, module, attr, names):
    """Route ``module.attr`` (its record_function) to a recorder and count,
    under a TorchDispatchMode, the torch ops that touch the card inside the
    named stages: (mode, {stage: [(op, devices)]})."""
    import contextlib

    from torch.utils._python_dispatch import TorchDispatchMode
    stage, ops = [None], {n: [] for n in names}

    @contextlib.contextmanager
    def stage_range(name):
        prev, stage[0] = stage[0], name
        try:
            yield
        finally:
            stage[0] = prev

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if stage[0] in ops:
                flat = [t for t in torch.utils._pytree.tree_leaves(
                    (args, kwargs, out)) if isinstance(t, torch.Tensor)]
                devs = {t.device.type for t in flat}
                if "cuda" in devs:
                    ops[stage[0]].append((func.__name__.split(".")[0],
                                          devs))
            return out

    monkeypatch.setattr(module, attr, stage_range)
    return Count, ops


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["subtile8 540x960", "subtile3 golden caps",
                                  "subtile8 band", "subtile4 golden caps"])
def test_grouped_frames_shade_and_assemble_in_one_launch(cuda_device,
                                                         monkeypatch, call):
    """A grouped frame on the card (a bunny at 960x540: the headline's
    kernel, the golden call's caps, whose 1,024 bin slots leave bins
    uncovered, a band of 176 rows) shades and assembles in one launch of
    K2's image form: raster.shade and raster.assemble launch nothing else
    and copy nothing; the frame equals the same call through the plain
    version bit for bit."""
    from ascii_renderer_tpu_torch.core.camera import Camera
    from ascii_renderer_tpu_torch.geom import meshes
    v, i = meshes.bunny_like(15000)
    soup = tuple(torch.from_numpy(x).to(cuda_device) for x in
                 meshes.mesh_to_soup(v, i, color=(0.8, 0.78, 0.75)))
    sb = TSB().set_env_light([0.22, 0.24, 0.28], 1.0)
    sb.add_dir_light([-0.5, -0.7, -0.6], [1, 1, 1], 0.9)
    scene = sb.build(device=cuda_device)
    cam = Camera.create(pos=(2.4, 1.4, 2.8),
                        yaw=float(np.arctan2(-2.8, -2.4)), pitch=-0.3)
    T = soup[0].shape[0] // 3
    kernel = call.split()[0]
    kw = dict(v_cap=-(-T // 4096) * 4096, kernel=kernel)
    if "golden" in call:
        kw.update(big_cap=0, r_cap=-(-2 * T // 2048) * 2048, pair_cap=8 * T,
                  tile_cap=1024)
    else:
        kw.update(big_cap=64, r_cap=1 << 17, pair_cap=1 << 19)
    if "band" in call:
        kw.update(row_lo=176, band_rows=176)
    args = (*soup, scene, cam, 540, 960, 0.5)
    R.render_soup_diag(*args, **kw)  # the kernels built, caches warm
    Count, ops = _stage_ops(monkeypatch, R, "stage",
                            ("raster.shade", "raster.assemble"))
    n0, i0 = RSH.launches, RSH.launches_image
    with Count():
        got, diag = R.render_soup_diag(*args, **kw)
    torch.cuda.synchronize()
    assert (RSH.launches, RSH.launches_image) == (n0 + 1, i0 + 1)
    for name, got_ops in ops.items():
        launching = [o for o, _d in got_ops if o not in _NO_LAUNCH]
        copies = [o for o, d in got_ops if "cpu" in d]
        assert not launching and not copies, (name, got_ops)
    monkeypatch.setattr(RSH, "shade_image", RSH.shade_image_ref)
    want, _d = R.render_soup_diag(*args, **kw)
    _same_bits(got, want)
    assert got.shape == (176 if "band" in call else 540, 960, 3)
    assert (want > 0).any() and int(diag["n_tiles_nz"]) > 0


@pytest.mark.cuda
def test_shade_image_and_ui_form_raise_on_build_or_launch_failure(
        cuda_device, monkeypatch):
    """A failed build and a failed launch each raise out of K2's image form
    and X12a's UI form; neither falls back to its plain version."""
    from ascii_renderer_tpu_torch.core.config import Config
    from ascii_renderer_tpu_torch.ops import frame_bytes as FB
    from ascii_renderer_tpu_torch.sim import ui as U
    w = _image_walk("36x96")
    scene = shade_builder(TSB, True, 0).build(device=cuda_device)
    table = shade_inputs(6, (1,), n_tris=200)[0].to(cuda_device)
    rip = np.zeros((16, 3), np.float32)
    rip[0] = (40.0, 20.0, 0.0)
    ui = U.ui_params(Config(), 36, 96, 60.0, rip, 1, 100.0)
    rgb = torch.rand((36, 96, 3), device=cuda_device)

    def no_build():
        raise RuntimeError("nvcc failed")

    groups = [t.to(cuda_device) for t in w["groups"]]
    runs = (lambda: RSH.shade_image(table, w["e"].to(cuda_device), *groups,
                                    scene, 6, w["tiles_x"], w["rows"],
                                    w["cols"]),
            lambda: FB.frame_bytes(rgb, ui=ui))
    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        for run in runs:
            with pytest.raises(RuntimeError, match=match):
                run()


# --------------------------------------------------------------------------
# X13, the stable partition: the mid raster path's compaction and the path
# tracer's compacted stream; the mid path's counts from X9
# --------------------------------------------------------------------------
# (flags, rule, v_cap): one flag, a warp segment's and a tile's edges, the
# largest cap (MAX_V_CAP = 2^19 - 4,096 slots), the count-all form's last
# size and the co-resident form's first, a co-resident call's overflow;
# "grid + 1 tile": one tile more than the co-resident grid holds (sized on
# the card, partition.coop_blocks)
PARTITION_SIZES = {"n 1": (1, "all", 1), "n 1 none": (1, "none", 4),
                   "n 1023": (1023, 0.5, 1023), "n 1024": (1024, 0.5, 600),
                   "n 1025": (1025, 0.5, 2048),
                   "n 2^19 - 4096": ((1 << 19) - 4096, 0.3, (1 << 19) - 4096),
                   "n 32768": (32768, 0.5, 16384),
                   "n 32769": (32769, 0.5, 32769),
                   "co-resident, overflow": (40000, 0.7, 16384),
                   "grid + 1 tile": (None, 0.4, 65536)}


def _partition_n(case, channels):
    """A partition case's flag count: its own, or one tile more than the
    co-resident grid of the form holds."""
    from ascii_renderer_tpu_torch.ops import partition as PTN
    if case == "grid + 1 tile":
        return (PTN.coop_blocks(channels) + 1) * (
            PTN.TILE if channels else PTN.ORDER_TILE)
    return (1 << 19) - 4096 if "2^19" in case else int(case[2:])


def _partition_case(case, device):
    from ascii_renderer_tpu_torch.tools.xla_inputs import (
        PARTITION_CASES, partition_channels)
    n, rule, v_cap = (PARTITION_CASES.get(case) or PARTITION_SIZES[case])
    if n is None:
        n = _partition_n(case, True)
    ch = {k: torch.from_numpy(v).to(device)
          for k, v in partition_channels(n, rule, seed=n).items()}
    return ch, v_cap


def _mesh_channels(device, name, rows, cols):
    """X4's [2T] clip dict of a mesh soup (teapot, mid HD arm) in place."""
    from ascii_renderer_tpu_torch.tools.xla_inputs import mesh_soup
    soup, cam = mesh_soup(name)
    p = torch.from_numpy(soup[0]).to(device)
    return R.clip_screen_channels(None, R.camera_mvp(cam, rows, cols, 0.5),
                                  rows, cols, pos9=R.positions_to_pos9(p))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all", "none", "alternating", "one",
                                  "random", "overflow", "v_cap above 2T"]
                         + sorted(PARTITION_SIZES) + ["teapot 240x135",
                                                      "mid HD 960x540"])
def test_partition_channels_kernel_equals_plain(cuda_device, case):
    """X13's channels form gives the plain compaction's channels (bits),
    valid, cidx and n_valid at the CPU tests' masks, sizes around a
    block and a tile, MAX_V_CAP, the count-all form's edge and one tile
    past the co-resident grid, and X4's own dicts (the teapot at v_cap
    8,192 above its 2,048 slots, the mid HD arm at 16,384), reading X4's
    row views in place; one launch at every size."""
    from ascii_renderer_tpu_torch.ops import partition as PTN
    if case.startswith("teapot"):
        ch, v_cap = _mesh_channels(cuda_device, "teapot", 135, 240), 8192
    elif case.startswith("mid HD"):
        ch, v_cap = _mesh_channels(cuda_device, "mid", 540, 960), 16384
    else:
        ch, v_cap = _partition_case(case, cuda_device)
    n = ch["valid"].shape[0]
    n0 = PTN.launches
    cch, cidx, n_valid = RCH.compact_valid_ch(dict(ch), v_cap)
    assert PTN.launches == n0 + 1
    want = PTN.compact_channels_ref(dict(ch), v_cap)
    torch.cuda.synchronize()
    for k in PTN.COMPACT_KEYS:
        assert cch[k].stride() == (13,)
        _same_bits(cch[k], want[0][k])
    assert torch.equal(cch["valid"].cpu(), want[0]["valid"].cpu())
    assert torch.equal(cidx.cpu(), want[1].cpu())
    assert n_valid.shape == () and n_valid.dtype == torch.int32
    assert int(n_valid) == int(want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("samples", [1, 8])
@pytest.mark.parametrize("case", ["36x96 random", "540x960 random",
                                  "36x96 all", "36x96 none", "36x96 one",
                                  "n 1", "n 1023", "n 1024", "n 1025",
                                  "n 2^19 - 4096", "n 32768", "n 32769",
                                  "grid + 1 tile"])
def test_partition_order_kernel_equals_plain(cuda_device, case, samples):
    """X13's order form gives the plain argsort's slot, pix_uid and the
    gate chain's gates of 1 and ``samples`` samples at the progressive
    tracer's masks (36x96, 960x540), all / none / one active, sizes
    around a block and a tile, the count-all form's edge and one tile
    past the co-resident grid."""
    from ascii_renderer_tpu_torch.ops import partition as PTN
    from ascii_renderer_tpu_torch.tools.xla_inputs import partition_mask
    if case.startswith("n ") or case == "grid + 1 tile":
        n = _partition_n(case, False)
        mask = torch.from_numpy(partition_mask(n, 0.4, seed=n))
    else:
        rows, cols = (int(x) for x in case.split()[0].split("x"))
        kind = case.split()[1]
        mask = torch.from_numpy(pixel_order(rows, cols, 0.3, seed=2)[0])
        if kind != "random":
            mask = torch.zeros_like(mask) if kind != "all" else \
                torch.ones_like(mask)
            if kind == "one":
                mask.view(-1)[mask.numel() // 3] = True
    uid0 = 12 * 96
    n0, o0 = PTN.launches, PTN.launches_order
    slot, uid, gates = PTN.stable_order(mask.to(cuda_device), uid0, samples)
    assert (PTN.launches, PTN.launches_order) == (n0 + 1, o0 + 1)
    w_slot, w_uid, w_gates = PTN.stable_order_ref(mask, uid0, samples)
    torch.cuda.synchronize()
    assert torch.equal(slot.cpu(), w_slot) and torch.equal(uid.cpu(), w_uid)
    assert set(gates) == set(w_gates)
    for s in w_gates:
        assert torch.equal(gates[s].cpu(), w_gates[s]), s


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3456, 29768, 32769, 518400])
def test_partition_repeated_calls_and_graph_replays_equal_plain(cuda_device,
                                                                n):
    """Nothing carries over between X13's calls: two calls of each form
    back to back on one stream, on other masks, then a CUDA graph of each
    form captured once and replayed twice on new masks (copied into the
    captured inputs), each equal to the plain version; the order form
    zeroes its given buffer each time."""
    from ascii_renderer_tpu_torch.ops import partition as PTN
    from ascii_renderer_tpu_torch.tools.xla_inputs import (
        partition_channels, partition_mask)
    v_cap = min(n, 16384)
    chs = [{k: torch.from_numpy(v).to(cuda_device)
            for k, v in partition_channels(n, rule, seed=n + j).items()}
           for j, rule in enumerate((0.3, 0.8, 0.5, "all"))]
    masks = [torch.from_numpy(partition_mask(n, rule, seed=n + j)).to(
        cuda_device) for j, rule in enumerate((0.3, 0.8, 0.5, "none"))]
    zero = torch.full((9,), 7, dtype=torch.int32, device=cuda_device)

    def check(got_c, ch, got_o, mask):
        torch.cuda.synchronize()
        want = PTN.compact_channels_ref(dict(ch), v_cap)
        for k in PTN.COMPACT_KEYS:
            _same_bits(got_c[0][k], want[0][k])
        assert torch.equal(got_c[0]["valid"], want[0]["valid"])
        assert torch.equal(got_c[1], want[1])
        assert int(got_c[2]) == int(want[2])
        w_slot, w_uid, w_gates = PTN.stable_order_ref(mask, 5, 8)
        assert torch.equal(got_o[0], w_slot) and torch.equal(got_o[1], w_uid)
        for s in w_gates:
            assert torch.equal(got_o[2][s], w_gates[s]), s
        assert zero.tolist() == [0] * 9

    got = [(PTN.compact_channels(dict(ch), v_cap),
            PTN.stable_order(m, 5, 8, zero=zero))
           for ch, m in zip(chs[:2], masks[:2])]
    for (gc, go), ch, m in zip(got, chs, masks):
        check(gc, ch, go, m)
    ch_in = {k: v.clone() for k, v in chs[0].items()}
    m_in = masks[0].clone()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):  # built and warm before the capture
        PTN.compact_channels(dict(ch_in), v_cap)
        PTN.stable_order(m_in, 5, 8, zero=zero)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_c = PTN.compact_channels(dict(ch_in), v_cap)
        out_o = PTN.stable_order(m_in, 5, 8, zero=zero)
    for ch, m in zip(chs[2:], masks[2:]):
        for k, v in ch.items():
            ch_in[k].copy_(v)
        m_in.copy_(m)
        zero.fill_(7)
        graph.replay()
        check(out_c, ch, out_o, m)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["mm", "loop"])
@pytest.mark.parametrize("call", ["teapot 240x135", "mid HD 960x540"])
def test_mid_path_counts_from_x9_and_compaction_in_x13(cuda_device,
                                                       monkeypatch, call,
                                                       kernel):
    """The card's mm / loop frame takes n_big from X9's counts (no
    count_big_small call; equal to the chain's over the compacted slots)
    and X9's counts equal the plain version's; raster.compact is one X13
    call and no torch op that launches or copies; raster.shade launches no
    torch op but the pixel centres' four; the frame equals the one through
    the plain compaction."""
    from ascii_renderer_tpu_torch.ops import partition as PTN
    from ascii_renderer_tpu_torch.tools.xla_inputs import mesh_soup
    name, (rows, cols) = (("teapot", (135, 240)) if call.startswith("teapot")
                          else ("mid", (540, 960)))
    soup, cam = mesh_soup(name)
    soup = tuple(torch.from_numpy(x).to(cuda_device) for x in soup)
    from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
    scene = create_demo_scene().build(device=cuda_device)
    v_cap = 8192 if name == "teapot" else 16384
    args = (*soup, scene, cam, rows, cols, 0.5)
    kw = dict(kernel=kernel, v_cap=v_cap, big_cap=64)
    R.render_soup_diag(*args, **kw)  # the kernels built, caches warm
    called = []
    real = RCH.count_big_small
    monkeypatch.setattr(RCH, "count_big_small",
                        lambda *a, **k: called.append(a) or real(*a, **k))
    Count, ops = _stage_ops(monkeypatch, RCH, "stage",
                            ("raster.compact", "raster.shade"))
    n0 = PTN.launches
    with Count():
        got, diag = R.render_soup_diag(*args, **kw)
    torch.cuda.synchronize()
    assert called == [] and PTN.launches == n0 + 1
    compact = [o for o, _d in ops["raster.compact"] if o not in _NO_LAUNCH]
    shade = [o for o, _d in ops["raster.shade"] if o not in _NO_LAUNCH]
    copies = [o for st in ops.values() for o, d in st if "cpu" in d]
    assert not compact and len(shade) <= 4 and not copies, ops
    # the counts: X9's against the plain chain's on the same compaction
    ch = _mesh_channels(cuda_device, name, rows, cols)
    cch = RCH.compact_valid_ch(dict(ch), v_cap)[0]
    counts = BE.binned_entries(dict(cch), rows, cols, kernel=kernel,
                               counts=True)[4]
    want = BE.binned_entries_ref(dict(cch), rows, cols, kernel=kernel,
                                 counts=True)[4]
    assert counts.tolist() == want.tolist()
    assert int(diag["n_big"]) == int(real(cch, rows, cols)[1]) == \
        int(want[1])
    monkeypatch.setattr(PTN, "compact_channels", PTN.compact_channels_ref)
    ref, ref_diag = R.render_soup_diag(*args, **kw)
    _same_bits(got, ref)
    assert {k: int(v) for k, v in diag.items()} == \
        {k: int(v) for k, v in ref_diag.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(36, 96), (540, 960)])
def test_render_pt_compacted_set_up_is_x13_and_no_copy(cuda_device,
                                                       monkeypatch, shape):
    """A compacted frame's pt.setup is one X13 call (its order, uids and
    gates, the counters zeroed in its launch) and no torch op that
    launches, no copy either way; pt.rays copies nothing; the frame
    equals the one through the plain order."""
    from ascii_renderer_tpu_torch.backends import pathtrace as PTB
    from ascii_renderer_tpu_torch.ops import partition as PTN
    from ascii_renderer_tpu_torch.parallel.worlds import pt_fixture
    scene, cam, pkw = pt_fixture(cuda_device)
    rows, cols = shape
    act = torch.from_numpy(pixel_order(rows, cols, 0.3, seed=4)[0]).to(
        cuda_device)
    kw = dict(pkw, rows=rows, cols=cols, spp=8, sample_batch=4,
              light_host=PTB.light_sphere_host(scene),
              packed=PTB.pack_scene_entries(scene), pixel_active=act)
    PTB.render_pt(scene, cam, 0.5, 3, **kw)  # the kernels built
    Count, ops = _stage_ops(monkeypatch, PTB, "record_function",
                            ("pt.setup", "pt.rays"))
    o0 = PTN.launches_order
    with Count():
        rgb, a = PTB.render_pt(scene, cam, 0.5, 3, **kw)
    torch.cuda.synchronize()
    assert PTN.launches_order == o0 + 1
    setup = [o for o, _d in ops["pt.setup"] if o not in _NO_LAUNCH]
    copies = [o for st in ops.values() for o, d in st if "cpu" in d]
    assert not setup and not copies, ops
    monkeypatch.setattr(PTN, "stable_order", PTN.stable_order_ref)
    rgb_ref, a_ref = PTB.render_pt(scene, cam, 0.5, 3, **kw)
    _same_bits(rgb, rgb_ref)
    assert torch.equal(a.cpu(), a_ref.cpu())


@pytest.mark.cuda
def test_partition_raises_on_build_or_launch_failure(cuda_device,
                                                     monkeypatch):
    """A failed build or launch raises out of both forms, on CUDA tensors;
    neither reaches its plain version."""
    from ascii_renderer_tpu_torch.ops import partition as PTN
    ch, v_cap = _partition_case("random", cuda_device)
    plain = []
    monkeypatch.setattr(PTN, "compact_channels_ref",
                        lambda *a: plain.append(a))
    monkeypatch.setattr(PTN, "stable_order_ref", lambda *a: plain.append(a))

    def no_build():
        raise RuntimeError("nvcc failed")

    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        for run in (lambda: PTN.compact_channels(dict(ch), v_cap),
                    lambda: PTN.stable_order(ch["valid"], 0, 8)):
            with pytest.raises(RuntimeError, match=match):
                run()
    assert plain == []
