"""The CUDA kernel build and the kernel wrappers' dispatch.

On the CPU every wrapper runs its plain-torch version and launches
nothing; for any other device it launches the kernel or raises. Without
nvcc the build raises a clear error instead of carrying on without the
kernels. Tests marked ``cuda`` compare each kernel with its plain version
on the card and skip here (run them there with
``python -m pytest tests/test_torch_build.py -m cuda``)."""

import re

import numpy as np
import pytest
import torch

from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.core.camera import (Camera, camera_bases,
                                                  camera_basis, ndc_grid,
                                                  ndc_grid_jit, ray_dirs,
                                                  ray_dirs_jit)
from ascii_renderer_tpu_torch.core.fp import fma32
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import fp as KFP
from ascii_renderer_tpu_torch.ops import pack as PK
from ascii_renderer_tpu_torch.ops import plane_table as PT
from ascii_renderer_tpu_torch.ops import raster_bins as RB
from ascii_renderer_tpu_torch.ops import raster_clip as RCL
from ascii_renderer_tpu_torch.ops import raster_group as RG
from ascii_renderer_tpu_torch.ops import raster_shade as RSH
from ascii_renderer_tpu_torch.ops import ray_grid as RYG
from ascii_renderer_tpu_torch.ops import raster_subtile as RS
from ascii_renderer_tpu_torch.ops import rt_trace as RTK
from ascii_renderer_tpu_torch.ops import setup2dh as S

torch.set_num_threads(2)

KERNEL_MODULES = (S, PK, RG)


def _walk_inputs(device, T=1500, n_attrs=6, seed=0, rows=48, cols=96):
    """Setup inputs of a random rows x cols frame."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    attrs = rng.uniform(-1, 1, (3 * T, n_attrs)).astype(np.float32)
    pos9 = torch.from_numpy(pos).reshape(T, 3, 3).permute(1, 2, 0).reshape(
        9, T).contiguous().to(device)
    attrs_t = torch.from_numpy(attrs).reshape(T, 3 * n_attrs).t().contiguous(
        ).to(device)
    mvp = R.camera_mvp(Camera.create(pos=(2.5, 1.5, 3.0), yaw=-2.3,
                                     pitch=-0.3), rows, cols, 0.5)
    return pos9, attrs_t, mvp


def _layout(cm, bbox, grp_cap=6):
    tw = -(-(cm.shape[0] - 16) // 8) * 8
    src16, _table = PK.pack_channels_split_blocked_ref(cm, [(0, 16),
                                                            (16, 16 + tw)])
    keys = R._subtile_pair_keys_bbox(bbox, 48, 96, big_cap=1024)
    return RG.build_packed_rows_grouped_kgather(
        src16, keys, 1, 6, 32 * 512, 1 << 16, grp_cap, 8)


# walk -> the grouped generation whose layout it walks (ops/raster_group)
GEN_WALKS = {"B9d": "subtile3", "B9e": "subtile4", "B9f_k2": "subtile5",
             "B9f_k4": "subtile6"}


def _gen_layout(walk, cm, bbox, caps):
    """(layout, kernel wrapper, plain version) of a grouped generation's
    walk on a setup block: the 32-wide rows of subtile3/4's wide pack,
    caps (r_cap, pair_cap, grp_cap)."""
    gen = RG.GENERATIONS[GEN_WALKS[walk]]
    src32 = PK.pack_channels_ref(cm.reshape(cm.shape[0], -1), width=40)[:, :32]
    keys = R._subtile_pair_keys_bbox(bbox, 48, 96, big_cap=1024)
    return gen.build(src32, keys, 1, 6, *caps), gen.walk, gen.walk_ref


# every launch counter of the wrappers, as (module, attribute)
COUNTERS = ((S, "launches"), (PK, "launches"), (RG, "launches"),
            (PK, "launches_channels"), (PK, "launches_split"),
            (RB, "launches"), (RB, "launches_loop"), (S, "launches_packed"),
            (RG, "launches_grouped"), (RG, "launches_direct"),
            (RG, "launches_k2"), (RB, "launches_shaded"), (RS, "launches"),
            (RS, "launches_packed"), (RS, "launches_packed_d"),
            (RYG, "launches"), (RYG, "jit_launches"))


@pytest.fixture
def zero_counts():
    saved = [getattr(m, a) for m, a in COUNTERS]
    for m, a in COUNTERS:
        setattr(m, a, 0)
    yield
    for (m, a), v in zip(COUNTERS, saved):
        setattr(m, a, v)


def test_cpu_tensors_run_the_plain_versions(zero_counts):
    pos9, attrs_t, mvp = _walk_inputs("cpu")
    cm, bbox = S.setup_2dh_fused(pos9, attrs_t, mvp, 48, 96)
    cm_r, bbox_r = S.setup_2dh_fused_ref(pos9, attrs_t, mvp, 48, 96)
    assert torch.equal(cm, cm_r) and torch.equal(bbox["valid"], bbox_r["valid"])
    outs = PK.pack_channels_split_blocked(cm, [(0, 16), (16, 40)])
    for o, r in zip(outs, PK.pack_channels_split_blocked_ref(
            cm, [(0, 16), (16, 40)])):
        assert torch.equal(o, r)
    lay = _layout(cm, bbox)
    z, e = RG.tile_eval_grouped_skip(*lay[:6], 6)
    z_r, e_r = RG.tile_eval_grouped_skip_ref(*lay[:6], 6)
    assert torch.equal(e, e_r) and torch.equal(z, z_r)
    assert (e >= 0).sum() > 100
    assert [m.launches for m in KERNEL_MODULES] == [0, 0, 0]


def test_cpu_tensors_run_the_generations_plain_versions(zero_counts):
    """B9d, B9e, B9f and B10's wrappers on CPU tensors: their plain
    versions, nothing launched."""
    pos9, attrs_t, mvp = _walk_inputs("cpu")
    got = S.setup_2dh_fused_packed(pos9, attrs_t, mvp, 48, 96, 24)
    want = S.setup_2dh_fused_packed_ref(pos9, attrs_t, mvp, 48, 96, 24)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    cm, bbox = S.setup_2dh_fused_ref(pos9, attrs_t, mvp, 48, 96)
    for walk in GEN_WALKS:
        lay, fn, ref = _gen_layout(walk, cm, bbox, (32 * 512, 1 << 16, 6))
        (z, e), (z_r, e_r) = fn(*lay[:-5], 6), ref(*lay[:-5], 6)
        assert torch.equal(e, e_r) and torch.equal(z, z_r), walk
        assert (e >= 0).sum() > 100
    assert (S.launches_packed, RG.launches_grouped, RG.launches_direct,
            RG.launches_k2) == (0, 0, 0, 0)


# channel-era subtile walk -> (layout builder, kernel wrapper, plain version)
SUBTILE_WALKS = {
    "B9a": ("build_subtile_rows", "tile_eval_subtile"),
    "B9b": ("build_packed_rows", "tile_eval_packed"),
    "B9c": ("build_packed_rows_pre_id", "tile_eval_packed_d"),
}
SUBTILE_GRID = (64, 512)  # 4 x 8 tiles: tile x offsets 0 .. 384
SUBTILE_CAPS = {"generous": (8192, 1 << 16), "overflow": (256, 2048)}


def _subtile_layout(device, walk, caps):
    """(layout args, kernel wrapper, plain version) of a channel-era walk
    on a random 64x512 frame's 2-D homogeneous walk entries (channel 12
    the triangle id); caps (r_cap, pair_cap)."""
    rows, cols = SUBTILE_GRID
    pos9, attrs_t, mvp = _walk_inputs(device, T=3000, seed=5, rows=rows,
                                      cols=cols)
    cm, bbox = S.setup_2dh_fused_ref(pos9, attrs_t, mvp, rows, cols)
    src16 = cm.view(cm.shape[0], -1)[:16].t().contiguous()
    keys = R._subtile_pair_keys_bbox(bbox, rows, cols, big_cap=1024)
    build, name = SUBTILE_WALKS[walk]
    lay = getattr(RS, build)(src16, keys, 4, 32, *caps)
    args = lay[:3] if walk == "B9c" else lay[:2]
    return (*args, 4, 32), getattr(RS, name), getattr(RS, name + "_ref")


def _fused_inputs(device, scene_name):
    """B8's entries and light vector: the demo room at 96x36, or a random
    soup with a point light at 384x48 (tiles_x = 3)."""
    from ascii_renderer_tpu_torch.backends import raster_oracles as RO
    from ascii_renderer_tpu_torch.geom.tessellate import tessellate_scene
    from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
    from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
    if scene_name == "room":
        scene = create_demo_scene().build(device=device)
        p, n, c = (torch.from_numpy(x).to(device)
                   for x in tessellate_scene(scene))
        cam, rows, cols = scene.camera, 36, 96
    else:
        rng = np.random.default_rng(9)
        T = 2000
        p, n, c = (torch.from_numpy(rng.uniform(lo, 2, (3 * T, 3)).astype(
            np.float32)).to(device) for lo in (-2, -1, 0.2))
        scene = (SceneBuilder().set_env_light([0.15, 0.15, 0.2], 1.0)
                 .add_point_light([1.0, 2.0, 1.0], [1.0, 0.9, 0.8], 1.0)
                 .build(device=device))
        cam = Camera.create(pos=(2.5, 1.5, 3.0), yaw=-2.3, pitch=-0.3)
        rows, cols = 48, 384
    mvp = R.camera_mvp(cam, rows, cols, 0.5)
    ch = R.setup_screen_channels(R.transform_clip_channels(p, mvp), rows,
                                 cols)
    slots = R.clip_attrs_channel_lists(torch.cat([n, c, p], dim=1), ch)
    data, offsets, tiles_y, tiles_x = RO.fused_entries(ch, slots, rows, cols)
    return data, offsets, RO.light_params(scene), tiles_x, tiles_y * tiles_x


def test_cpu_tensors_run_the_channel_era_plain_versions(zero_counts):
    """B8, B9a, B9b and B9c's wrappers on CPU tensors: their plain
    versions, nothing launched."""
    for walk in SUBTILE_WALKS:
        args, fn, ref = _subtile_layout("cpu", walk, SUBTILE_CAPS["generous"])
        (z, e), (z_r, e_r) = fn(*args), ref(*args)
        assert torch.equal(e, e_r) and torch.equal(z, z_r), walk
        assert (e >= 0).sum() > 2000, walk
    args = _fused_inputs("cpu", "room")
    rgb = RB.tile_eval_bins_shaded(*args)
    assert torch.equal(rgb, RB.tile_eval_bins_shaded_ref(*args))
    assert tuple(rgb.shape) == (5, 3, 8, 128) and (rgb > 0).any()
    assert (RB.launches_shaded, RS.launches, RS.launches_packed,
            RS.launches_packed_d) == (0, 0, 0, 0)


def test_non_cpu_tensors_never_fall_back_to_the_plain_versions(zero_counts):
    """A tensor that is not on the CPU must reach the kernel path, whose
    checks raise for anything but contiguous CUDA tensors."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        S.setup_2dh_fused(torch.empty((9, 64), device=meta),
                          torch.empty((18, 64), device=meta),
                          torch.eye(4), 48, 96)
    with pytest.raises(ValueError):
        PK.pack_channels_split_blocked(torch.empty((37, 8, 128), device=meta),
                                       [(0, 16), (16, 40)])
    with pytest.raises(ValueError):
        RG.tile_eval_grouped_skip(
            torch.empty((64, 128), device=meta),
            torch.zeros(3, dtype=torch.int32, device=meta),
            torch.zeros(16, dtype=torch.int32, device=meta),
            torch.zeros(16, dtype=torch.int32, device=meta),
            torch.empty((2, 128), device=meta),
            torch.empty((2, 128), device=meta), 2)
    with pytest.raises(ValueError):
        PK.pack_channels(torch.empty((21, 512), device=meta))
    with pytest.raises(ValueError):
        PK.pack_channels_split(torch.empty((21, 512), device=meta),
                               [(0, 16), (16, 24)])
    offs = torch.zeros(3, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        RB.tile_eval_bins_mm(torch.empty((2, 16, 128), device=meta), offs,
                             1, 2)
    with pytest.raises(ValueError):
        RB.tile_eval_bins(torch.empty((32, 128), device=meta), offs, 1, 2)
    with pytest.raises(ValueError):
        S.setup_2dh_fused_packed(torch.empty((9, 64), device=meta),
                                 torch.empty((18, 64), device=meta),
                                 torch.eye(4), 48, 96, 24)
    i32 = dict(dtype=torch.int32, device=meta)
    xy = (torch.empty((2, 128), device=meta), torch.empty((2, 128),
                                                          device=meta))
    with pytest.raises(ValueError):
        RG.tile_eval_grouped(torch.empty((64, 128), device=meta),
                             torch.zeros(3, **i32), torch.zeros(16, **i32),
                             *xy, 2)
    with pytest.raises(ValueError):
        RG.tile_eval_grouped_k2(torch.empty((32, 256), device=meta),
                                torch.zeros(3, **i32), torch.zeros(16, **i32),
                                torch.zeros(16, **i32), *xy, 2)
    with pytest.raises(ValueError):
        RG.tile_eval_direct(torch.empty((64, 32), device=meta),
                            torch.zeros(16, **i32), torch.zeros(16, **i32),
                            torch.zeros(2, **i32), *xy, 2)
    with pytest.raises(ValueError):
        RB.tile_eval_bins_shaded(torch.empty((64, 128), device=meta),
                                 torch.zeros(3, **i32),
                                 torch.empty(64, device=meta), 1, 2)
    with pytest.raises(ValueError):
        RS.tile_eval_subtile(torch.empty((64, 16, 128), device=meta),
                             torch.zeros(3, **i32), 1, 2)
    with pytest.raises(ValueError):
        RS.tile_eval_packed(torch.empty((64, 128), device=meta),
                            torch.zeros(3, **i32), 1, 2)
    with pytest.raises(ValueError):
        RS.tile_eval_packed_d(torch.empty((64, 128), device=meta),
                              torch.zeros(3, **i32), torch.zeros(16, **i32),
                              1, 2)
    assert [m.launches for m in KERNEL_MODULES] == [0, 0, 0]
    assert (PK.launches_channels, PK.launches_split, RB.launches,
            RB.launches_loop) == (0, 0, 0, 0)
    assert (S.launches_packed, RG.launches_grouped, RG.launches_direct,
            RG.launches_k2) == (0, 0, 0, 0)
    assert (RB.launches_shaded, RS.launches, RS.launches_packed,
            RS.launches_packed_d) == (0, 0, 0, 0)


def test_modal_wrapper_takes_the_override_bytes(zero_counts):
    """B4's wrapper reaches the kernel path for a tensor off the CPU (a
    bool override plane passed as its bytes, others compared with 0), and
    picks K = CELLS cells a thread where that still gives MIN_BLOCKS
    blocks: the 540 x 960 glyph grid, not the 36 x 96 one; a K asked for
    must be 1 or CELLS."""
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    meta = torch.device("meta")
    launches = AK.launches
    for ovr in (torch.empty((36, 96), dtype=torch.bool, device=meta),
                torch.empty((36, 96), dtype=torch.uint8, device=meta)):
        with pytest.raises(ValueError, match="CUDA"):
            AK.modal_filter_kernel(
                torch.empty((36, 96), dtype=torch.int32, device=meta), ovr,
                2, 12)
    assert AK.launches == launches
    with pytest.raises(ValueError, match="cells 2"):  # K is 1 or CELLS
        AK.modal_filter_kernel(torch.zeros((4, 4), dtype=torch.int32),
                               torch.zeros((4, 4), dtype=torch.bool), 2, 12,
                               cells=2)
    assert AK.cells_per_thread(540, 960) == AK.CELLS > 1
    assert AK.cells_per_thread(36, 96) == 1
    assert AK.cells_per_thread(1, 1) == 1
    # a batch of planes counts its views' blocks: a 1,024-view farm of
    # 36 x 96 grids makes enough blocks for K = CELLS
    assert AK.cells_per_thread(36, 96, 1024) == AK.CELLS
    for ovr in (torch.empty((8, 36, 96), dtype=torch.bool, device=meta),):
        with pytest.raises(ValueError, match="CUDA"):
            AK.modal_filter_kernel(
                torch.empty((8, 36, 96), dtype=torch.int32, device=meta),
                ovr, 2, 12)
    with pytest.raises(ValueError, match=r"\[V, H, W\]"):
        AK.modal_filter_kernel(torch.zeros((2, 2, 4, 4), dtype=torch.int32),
                               torch.zeros((2, 2, 4, 4), dtype=torch.bool),
                               2, 12)
    assert AK.launches == launches


def _ray_grid_inputs(device, rows, cols, B, seed):
    """(px, py, basis) of a rows x cols grid at a seeded pose: the centre
    grid (expanded views) if B == 0, else B jittered samples of it."""
    rng = np.random.default_rng(seed)
    cam = Camera.create(pos=(0.0, 1.0, 3.0), yaw=float(rng.uniform(-3, 3)),
                        pitch=float(rng.uniform(-1.4, 1.4)))
    basis = camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    px, py, aspect = ndc_grid(rows, cols, 0.5, device)
    if B:
        jit = torch.from_numpy(((rng.random((B, rows, cols, 2)) - 0.5)
                                * (2.0 / rows)).astype(np.float32))
        jit = jit.to(device)
        px, py = px[None] + jit[..., 0] * aspect, py[None] + jit[..., 1]
    return px, py, basis


def test_ray_grid_wrapper_runs_the_plain_version_on_cpu(zero_counts):
    """The ray grid's wrapper: CPU tensors run core/camera.ray_dirs and
    launch nothing; tensors on another device reach the kernel path,
    which takes CUDA tensors only."""
    px, py, basis = _ray_grid_inputs("cpu", 6, 10, 3, 0)
    assert torch.equal(RYG.ray_grid(px, py, basis), ray_dirs(px, py, basis))
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        RYG.ray_grid(torch.empty((6, 10), device=meta),
                     torch.empty((6, 10), device=meta), basis)
    with pytest.raises(ValueError, match="float32"):
        RYG.ray_grid(torch.empty((6, 10), dtype=torch.float64, device=meta),
                     torch.empty((6, 10), device=meta), basis)
    assert RYG.launches == 0


def test_ray_grid_jit_wrapper_runs_the_plain_version_on_cpu(zero_counts):
    """The ray tracer's grid wrapper: on the CPU ndc_grid_jit and
    ray_dirs_jit, no launch; any other device reaches the kernel path,
    which takes a CUDA device only."""
    yaw = torch.tensor([0.3, -1.2], dtype=torch.float32)
    bases = camera_bases(yaw, torch.tensor([0.1, -0.2]),
                         torch.full((2,), 1.3962634))
    px, py = ndc_grid_jit(6, 10, 0.5, "cpu")
    got = RYG.ray_grid_jit(bases, 6, 10, 0.5, "cpu")
    assert got.shape == (2, 6, 10, 3)
    assert torch.equal(got, ray_dirs_jit(px, py, bases))
    with pytest.raises(ValueError, match="CUDA"):
        RYG.ray_grid_jit(bases, 6, 10, 0.5, "meta")
    assert RYG.jit_launches == 0


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    for fn in (_build.find_nvcc, _build.build, _build.lib):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            fn()
    assert not (tmp_path / "build").exists()  # nothing half-built


def test_c_entry_points_match_the_ctypes_signatures():
    """Every extern "C" launcher in csrc has the parameter count its
    ctypes signature declares, and every declared one exists."""
    found = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[m.group(1)] = len([a for a in m.group(2).split(",")
                                     if a.strip()])
    assert {k: len(v) for k, v in _build.SIGNATURES.items()} == found
    assert {p.name for p in _build.sources()} == {
        "setup2dh.cu", "pack.cu", "raster_group.cu", "pt_trace.cu",
        "modal.cu", "raster_bins.cu", "raster_shaded.cu", "raster_subtile.cu",
        "ray_grid.cu", "fp.cu", "raster_shade.cu", "rt_trace.cu",
        "raster_clip.cu", "plane_table.cu", "bin_entries.cu",
        "group_build.cu", "frame_bytes.cu", "pt_reduce.cu", "partition.cu",
        "accum.cu", "rt_trace_trig.cu", "soft_raster.cu"}
    for flag in ("-fmad=false", "arch=compute_90a,code=sm_90a"):
        assert flag in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    # the staged span pack that tools/pack_probe.py measures
    from ascii_renderer_tpu_torch.tools import pack_probe
    (m,) = re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                       pack_probe.SOURCE.read_text())
    assert m.group(1) == "pack_staged_launch"
    assert len(m.group(2).split(",")) == len(pack_probe.SIGNATURE)


@pytest.mark.parametrize("mod", (RB, RG, RS, KFP, RSH, RTK, RCL, PT),
                         ids=("bins", "group", "subtile", "fp", "shade",
                              "trace", "clip", "table"))
def test_launches_per_call_names_the_module_wrappers(mod):
    """LAUNCHES_PER_CALL keys are the module's wrappers, two launches for
    a walk with a merge; kernel_ab reads it, and a module that predates
    it gets the walks with a merge that existed before it."""
    from types import SimpleNamespace

    from ascii_renderer_tpu_torch.tools import kernel_ab
    assert mod.LAUNCHES_PER_CALL
    for name, n in mod.LAUNCHES_PER_CALL.items():
        assert callable(getattr(mod, name)) and n in (1, 2)
        assert kernel_ab._per_call(mod, name) == n
    if mod is RG:  # all four grouped walks: slab work items, then a merge
        assert set(RG.LAUNCHES_PER_CALL.values()) == {2}
    old = SimpleNamespace()
    assert kernel_ab._per_call(old, "tile_eval_grouped_skip") == 2
    assert kernel_ab._per_call(old, "tile_eval_grouped_k2") == 1
    assert kernel_ab._per_call(old, "tile_eval_subtile") == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_attrs", [6, 9])
def test_kernels_equal_plain_versions_on_cuda(cuda_device, n_attrs,
                                              zero_counts):
    pos9, attrs_t, mvp = _walk_inputs(cuda_device, n_attrs=n_attrs)
    cm, bbox = S.setup_2dh_fused(pos9, attrs_t, mvp, 48, 96)
    cm_r, bbox_r = S.setup_2dh_fused_ref(pos9, attrs_t, mvp, 48, 96)
    assert torch.equal(bbox["valid"], bbox_r["valid"])
    assert torch.equal(cm, cm_r)  # the same fused chains: bit for bit
    spans = [(0, 16), (16, 16 + -(-(3 * n_attrs + 3) // 8) * 8)]
    for o, r in zip(PK.pack_channels_split_blocked(cm, spans),
                    PK.pack_channels_split_blocked_ref(cm, spans)):
        assert torch.equal(o.view(torch.int32), r.view(torch.int32))
    lay = _layout(cm, bbox)
    z, e = RG.tile_eval_grouped_skip(*lay[:6], 6)
    z_r, e_r = RG.tile_eval_grouped_skip_ref(*lay[:6], 6)
    torch.cuda.synchronize()
    assert torch.equal(e, e_r) and torch.equal(z, z_r)
    assert [m.launches for m in KERNEL_MODULES] == [1, 2, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,B", [(36, 96, 0), (36, 96, 32),
                                         (540, 960, 0), (540, 960, 8),
                                         (1, 1, 0), (7, 13, 3)])
def test_ray_grid_kernel_equals_plain_on_cuda(cuda_device, rows, cols, B,
                                              zero_counts):
    """The ray grid kernel equals core/camera.ray_dirs bit for bit, on the
    CPU and on the same CUDA tensors, at the PT runs' centre grids and
    jittered batches and at odd sizes, over seeded poses; one launch a
    call."""
    for seed in range(3):
        px, py, basis = _ray_grid_inputs(cuda_device, rows, cols, B, seed)
        got = RYG.ray_grid(px, py, basis)
        torch.cuda.synchronize()
        assert got.shape == (*px.shape, 3)
        for want in (ray_dirs(px, py, basis).cpu(),
                     ray_dirs(px.cpu(), py.cpu(), basis)):
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)), seed
    assert RYG.launches == 3


# B4's planes: (indices, override mask) makers over a numpy generator
MODAL_PLANES = {
    "random": lambda rng, h, w: (rng.integers(0, 6, (h, w)),
                                 rng.random((h, w)) < 0.1),
    # every int32, -1 and INT_MIN among them: no value is a sentinel
    "full_range": lambda rng, h, w: (
        np.where(rng.random((h, w)) < 0.3,
                 rng.choice([-1, -2**31, 2**31 - 1, 0], (h, w)),
                 rng.integers(-2**31, 2**31, (h, w))),
        rng.random((h, w)) < 0.2),
    "all_override": lambda rng, h, w: (rng.integers(0, 4, (h, w)),
                                       np.ones((h, w), bool)),
    "no_override": lambda rng, h, w: (rng.integers(0, 4, (h, w)),
                                      np.zeros((h, w), bool)),
    # two values: deep Boyer-Moore ties, the scan order decides
    "two_values": lambda rng, h, w: (rng.integers(0, 2, (h, w)),
                                     rng.random((h, w)) < 0.05),
}
# grids: the driven 540x960 and 36x96, odd sizes, one cell, one row, one
# column, and heights that are no multiple of any tile height (4 K)
MODAL_SHAPES = ((540, 960), (36, 96), (13, 45), (1, 1), (1, 77), (61, 1),
                (70, 33))


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [1, 4])
@pytest.mark.parametrize("plane", sorted(MODAL_PLANES))
@pytest.mark.parametrize("radius,thresh", [(1, 5), (2, 12), (3, 24)])
def test_modal_kernel_equals_plain_on_cuda(cuda_device, radius, thresh,
                                           plane, cells):
    """B4 (``modal_kernel<R, K>``) equals ``modal_filter`` exactly, every
    grid walked at K = ``cells`` cells a thread, one launch a call."""
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    rng = np.random.default_rng(radius * 10 + cells)
    for h, w in MODAL_SHAPES:
        i, o = MODAL_PLANES[plane](rng, h, w)
        idx = torch.from_numpy(i.astype(np.int32))
        ovr = torch.from_numpy(o)
        launches = AK.launches
        got = AK.modal_filter_kernel(idx.to(cuda_device),
                                     ovr.to(cuda_device), radius, thresh,
                                     cells=cells)
        torch.cuda.synchronize()
        assert AK.launches == launches + 1
        assert torch.equal(got.cpu(), AK.modal_filter(idx, ovr, radius,
                                                      thresh)), (h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [1, 4])
@pytest.mark.parametrize("plane", sorted(MODAL_PLANES))
@pytest.mark.parametrize("radius,thresh", [(1, 5), (2, 12), (3, 24)])
def test_modal_kernel_batch_equals_plain_on_cuda(cuda_device, radius, thresh,
                                                 plane, cells):
    """B4 over a batch of planes [V, H, W] in one launch equals
    ``modal_filter`` on the batch and each plane's own launch exactly: no
    vote crosses a plane's edge."""
    from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
    rng = np.random.default_rng(radius * 100 + cells)
    for v, (h, w) in ((5, (36, 96)), (3, (13, 45)), (4, (1, 77)),
                      (2, (61, 1)), (7, (1, 1))):
        planes = [MODAL_PLANES[plane](rng, h, w) for _ in range(v)]
        idx = torch.from_numpy(np.stack([i for i, _ in planes])
                               .astype(np.int32))
        ovr = torch.from_numpy(np.stack([o for _, o in planes]))
        launches = AK.launches
        got = AK.modal_filter_kernel(idx.to(cuda_device),
                                     ovr.to(cuda_device), radius, thresh,
                                     cells=cells)
        torch.cuda.synchronize()
        assert AK.launches == launches + 1
        assert torch.equal(got.cpu(), AK.modal_filter(idx, ovr, radius,
                                                      thresh)), (v, h, w)
        for k in range(v):
            one = AK.modal_filter_kernel(idx[k].to(cuda_device),
                                         ovr[k].to(cuda_device), radius,
                                         thresh, cells=cells)
            assert torch.equal(got[k].cpu(), one.cpu()), (v, h, w, k)


@pytest.mark.cuda
@pytest.mark.parametrize("views,rows,cols", [(1, 36, 96), (1024, 36, 96),
                                             (3, 12, 32), (2, 540, 960),
                                             (5, 1, 1), (4, 7, 13)])
def test_ray_grid_jit_kernel_equals_plain_on_cuda(cuda_device, views, rows,
                                                  cols, zero_counts):
    """The ray tracer's grid kernel equals ndc_grid_jit + ray_dirs_jit bit
    for bit, on the CPU and on the same CUDA device, for a batch of seeded
    poses in one launch."""
    rng = np.random.default_rng(views + rows)
    yaw = torch.from_numpy(rng.uniform(-3, 3, views).astype(np.float32))
    pitch = torch.from_numpy(rng.uniform(-1.4, 1.4, views).astype(np.float32))
    fov = torch.full((views,), np.float32(80 * np.pi / 180))
    bases = camera_bases(yaw, pitch, fov)
    got = RYG.ray_grid_jit(bases, rows, cols, 0.5, cuda_device)
    torch.cuda.synchronize()
    assert got.shape == (views, rows, cols, 3) and RYG.jit_launches == 1
    px, py = ndc_grid_jit(rows, cols, 0.5, cuda_device)
    for want in (ray_dirs_jit(px, py, tuple(b.to(cuda_device)
                                            for b in bases)).cpu(),
                 RYG.ray_grid_jit(bases, rows, cols, 0.5, "cpu")):
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("views,rows,cols,row_lo,n_rows",
                         [(1, 36, 96, 12, 12), (1024, 36, 96, 24, 12),
                          (3, 540, 960, 176, 176), (2, 7, 13, 3, 4)])
def test_ray_grid_jit_band_equals_plain_on_cuda(cuda_device, views, rows,
                                                cols, row_lo, n_rows,
                                                zero_counts):
    """The jitted grid kernel launched for a row band (its global row
    offset) equals the plain version's band, on the CPU and on the card,
    and the full grid's rows, bit for bit."""
    rng = np.random.default_rng(views + row_lo)
    yaw = torch.from_numpy(rng.uniform(-3, 3, views).astype(np.float32))
    pitch = torch.from_numpy(rng.uniform(-1.4, 1.4, views).astype(np.float32))
    fov = torch.full((views,), np.float32(80 * np.pi / 180))
    bases = camera_bases(yaw, pitch, fov)
    got = RYG.ray_grid_jit(bases, rows, cols, 0.5, cuda_device, row_lo,
                           n_rows)
    full = RYG.ray_grid_jit(bases, rows, cols, 0.5, cuda_device)
    torch.cuda.synchronize()
    assert got.shape == (views, n_rows, cols, 3) and RYG.jit_launches == 2
    px, py = ndc_grid_jit(rows, cols, 0.5, cuda_device, row_lo, n_rows)
    for want in (ray_dirs_jit(px, py, tuple(b.to(cuda_device)
                                            for b in bases)).cpu(),
                 RYG.ray_grid_jit(bases, rows, cols, 0.5, "cpu", row_lo,
                                  n_rows),
                 full[:, row_lo:row_lo + n_rows].cpu()):
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
def test_pt_band_uids_equal_plain_on_cuda(cuda_device, zero_counts):
    """B5 on a row band's global uids (its pixels' uids, row_lo * cols on)
    equals its plain version bit for bit; render_pt's bands on the card
    are the card's full frame rows bit for bit, and the alpha planes the
    CPU band's."""
    import math

    from ascii_renderer_tpu_torch.backends import pathtrace as PT
    from ascii_renderer_tpu_torch.ops import pt_kernel as PTK
    from ascii_renderer_tpu_torch.parallel.worlds import pt_fixture
    args, kw = _pt_inputs(cuda_device, 20)
    uid = (torch.arange(3 * 1024, dtype=torch.int32) + 12 * 96).reshape(
        3, 8, 128).to(cuda_device)
    got = PTK.trace_blocks_raw(*args, **kw, uid=uid)
    want = PTK.trace_blocks_raw_ref(*args, **kw, uid=uid)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    scene, cam, pkw = pt_fixture(cuda_device)
    cscene, _c, _k = pt_fixture("cpu")
    full = PT.render_pt(scene, cam, 0.0, 3, rows=36, cols=96, **pkw)
    for lo in (0, 12, 24):
        band = PT.render_pt(scene, cam, 0.0, 3, rows=36, cols=96, row_lo=lo,
                            n_rows=12, **pkw)
        cpu = PT.render_pt(cscene, cam, 0.0, 3, rows=36, cols=96, row_lo=lo,
                           n_rows=12, **pkw)
        assert torch.equal(band[0].view(torch.int32),
                           full[0][lo:lo + 12].view(torch.int32))
        assert torch.equal(band[1], full[1][lo:lo + 12])
        assert torch.equal(band[1].cpu(), cpu[1])
    assert PTK.launches > 0 and not math.isnan(float(full[0].sum()))


def _pt_inputs(device, n_tris, n_blocks=3, seed=0):
    """A random scene of spheres and n_tris triangles (2 + n_tris entries
    past 64 take the kernel's chunked entry stream) with the demo atlas,
    and n_blocks x 1,024 random rays into it."""
    from ascii_renderer_tpu_torch.atlas.io import demo_atlas
    from ascii_renderer_tpu_torch.backends import pathtrace as PT
    from ascii_renderer_tpu_torch.scene.builder import MaterialIds
    from ascii_renderer_tpu_torch.scene.builder import SceneBuilder
    rng = np.random.default_rng(seed)
    sb = SceneBuilder()
    mats = (MaterialIds.WHITE, MaterialIds.RED, MaterialIds.GLASS,
            MaterialIds.MIRROR, MaterialIds.LIGHT)
    for i in range(3):
        sb.add_sphere(rng.uniform(-3, 3, 3), 0.7, mats[i])
    for i in range(n_tris):
        a = rng.uniform(-4, 4, 3)
        sb.add_triangle(a, a + rng.uniform(-2, 2, 3), a + rng.uniform(-2, 2, 3),
                        mats[i % 5], (0, 0), (31, 0), (0, 31))
    sb.set_atlas(demo_atlas())
    scene = sb.build(min_pad=1, device=device)
    prim, atlas, aw, ah, sph_rows = PT.pack_scene_entries(scene)
    n = n_blocks * 1024
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    rd = torch.nn.functional.normalize(d, dim=1).reshape(n_blocks, 8, 128, 3)
    ro = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(
        np.float32)).reshape(n_blocks, 8, 128, 3)
    lc, lr = PT.get_light_sphere(scene, 0.5)
    params = PT._params(lc, lr, torch.tensor((16.86, 10.76, 8.2)) * 1.3,
                        device)
    return ((params, prim, ro.to(device), rd.to(device), 17, atlas),
            dict(bounces=5, nee=True, atlas_w=aw, atlas_h=ah,
                 sph_rows=sph_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [20, 150])
def test_pt_kernel_equals_plain_on_cuda(cuda_device, n_tris):
    """Resident (<= 64 entries) and chunked entry streams, with a block
    gate and custom uids: ov / fet exactly, radiance bit for bit (the
    kernel and the plain version round every operation alike)."""
    from ascii_renderer_tpu_torch.ops import pt_kernel as PTK
    args, kw = _pt_inputs(cuda_device, n_tris)
    assert (args[1].shape[0] * 4 > 64) == (n_tris > 64)
    act = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda_device)
    uid = torch.randperm(3 * 1024, generator=torch.Generator().manual_seed(
        1)).to(torch.int32).reshape(3, 8, 128).to(cuda_device)
    launches = PTK.launches
    got = PTK.trace_blocks_raw(*args, **kw, block_active=act, uid=uid)
    want = PTK.trace_blocks_raw_ref(*args, **kw, block_active=act, uid=uid)
    torch.cuda.synchronize()
    assert PTK.launches == launches + 1
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert not got[0][1].any() and got[0][0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [20, 150])
def test_pt_kernel_regenerates_paths_on_cuda(cuda_device, n_tris):
    """The persistent kernel over more rays than its grid holds lanes
    (300 x 1,024 rays: no multiple of the lanes of any grid of 132 SMs),
    whose paths end at every bounce: resident and chunked entry streams,
    a random block gate and permuted uids, every output bit for bit."""
    from ascii_renderer_tpu_torch.ops import pt_kernel as PTK
    nblk = 300
    args, kw = _pt_inputs(cuda_device, n_tris, n_blocks=nblk)
    g = torch.Generator().manual_seed(2)
    act = (torch.rand(nblk, generator=g) < 0.6).to(torch.int32)
    act[0] = 1
    uid = torch.randperm(nblk * 1024, generator=g).to(torch.int32)
    act, uid = act.to(cuda_device), uid.reshape(nblk, 8, 128).to(cuda_device)
    launches = PTK.launches
    got = PTK.trace_blocks_raw(*args, **kw, block_active=act, uid=uid)
    stats = {}
    want = PTK.trace_blocks_raw_ref(*args, **kw, block_active=act, uid=uid,
                                    stats=stats)
    torch.cuda.synchronize()
    assert PTK.launches == launches + 1
    alive = stats["alive"]
    assert all(a > b for a, b in zip(alive, alive[1:])) and alive[-1] > 0
    for g_, w in zip(got, want):
        assert torch.equal(g_.view(torch.int32), w.view(torch.int32))
    assert not got[0][act == 0].any() and got[0][act == 1].any()


# bin sizes of the walk fixtures: a 3 x 2 grid with an empty bin and bins
# across the 128- and 256-entry chunks; the same with a seventh bin of
# 1,150 entries that starts at entry 743, off a chunk boundary (ten
# chunks: ten work items); one tile with one deep bin
BINS = {"grid": ((0, 300, 129, 1, 256, 57), 3),
        "deep": ((0, 300, 129, 1, 256, 57, 1150), 3),
        "one tile": ((1300,), 1)}


def _bins_entries(seed, sizes=BINS["grid"][0], tiles_x=3):
    """Random plane entries (row-major [P, 16] with the inert tail) binned
    over a grid tiles_x tiles wide, and the offsets: bins of ``sizes``,
    coefficients up to 1e10, depth ties with the previous entry, 20%
    invalid entries. In a bin of 1,100 entries or more, each pair of
    entries across a chunk boundary is a depth tie of the nearest kind,
    the earlier at z = +0.0 and the later at -0.0 on the same edges: the
    walk keeps the earlier, as the merge in bin order must."""
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    P = int(offs[-1])
    tile = np.repeat(np.arange(len(sizes)), sizes)
    cx = (tile % tiles_x) * 128 + rng.uniform(-20, 148, P)
    cy = (tile // tiles_x) * 8 + rng.uniform(-2, 10, P)
    ent = np.zeros((P + (-(P + 256)) % 128 + 256, 16), np.float32)
    for k in range(3):
        ang = rng.uniform(0, 2 * np.pi, P)
        scale = np.where(rng.random(P) < 0.15, 3e8, 1.0)
        a = np.cos(ang) * rng.uniform(0.05, 40, P) * scale
        b = np.sin(ang) * rng.uniform(0.05, 40, P) * scale
        g = -(a * (cx + rng.uniform(-40, 40, P))
              + b * (cy + rng.uniform(-6, 6, P)))
        ent[:P, 3 * k:3 * k + 3] = np.stack([a, b, g], -1)
    zx, zy = rng.normal(size=P) * 2e-3, rng.normal(size=P) * 2e-2
    ent[:P, 9:12] = np.stack(
        [zx, zy, rng.uniform(-0.1, 1.1, P) - zx * cx - zy * cy], -1)
    ent[:P, 12] = rng.random(P) >= 0.2
    ent[:P, 13] = np.concatenate(
        [np.sort(rng.choice(100000, n, replace=False)) for n in sizes])
    tie = np.nonzero(rng.random(P) < 0.3)[0]
    tie = tie[(tie > 0) & (tile[tie] == tile[tie - 1])]
    ent[tie, 9:12] = ent[tie - 1, 9:12]
    for lo, hi in zip(offs[:-1], offs[1:]):
        if hi - lo < 1100:
            continue
        for b in range(-(-(lo + 1) // 128) * 128, hi, 128):
            ent[b - 1, 9:13] = (0.0, 0.0, 0.0, 1.0)
            ent[b, :9] = ent[b - 1, :9]
            ent[b, 9:13] = (-0.0, -0.0, -0.0, 1.0)
    return ent, offs


def _sliced_walk(ent, offsets, tiles_x, n_tiles, mm):
    """The kernel's design as a plain walk: every work item of
    ``work_items`` (one 128-entry chunk of one bin) walked on its own from
    (inf, -1) under the walk's rule (B6: least z, then least id; B6':
    the first entry of least z), then each tile's items folded in slot
    order with a strict z < best."""
    inf = float("inf")
    n_ent = ent.shape[0]
    ent = torch.cat([ent, ent.new_zeros((RB.MM_CHUNK, RB.N_CHAN))])
    off = offsets.long()
    pix = torch.arange(RB.PIX)
    zb = torch.full((n_tiles, RB.PIX), inf)
    tb = torch.full((n_tiles, RB.PIX), -1.0)
    for q, t, c in zip(*(x.tolist() for x in RB.work_items(offsets, n_ent))):
        base = (int(off[t]) // RB.MM_CHUNK + c) * RB.MM_CHUNK
        e = torch.arange(base, base + RB.MM_CHUNK)
        ch = ent[e]                                     # [128, 16]
        live = (e >= off[t]) & (e < off[t + 1])
        if not mm:
            live &= ch[:, RB.CH_VALID] > 0.0
        x = ((pix % 128) + (t % tiles_x) * 128).float()[None] + 0.5
        y = ((pix // 128) + (t // tiles_x) * 8).float()[None] + 0.5

        def plane(k):
            a, b, g = (ch[:, 3 * k + i, None] for i in range(3))
            if mm:
                return fma32(b, y, a * x) + g
            return fma32(a, x, b * y) + g

        z = plane(3)
        ok = (live[:, None] & (plane(0) <= 0.0) & (plane(1) <= 0.0)
              & (plane(2) <= 0.0) & (z >= 0.0) & (z <= 1.0))
        zm = torch.where(ok, z, inf)                    # [128, 1024]
        tid = ch[:, RB.CH_TID, None].expand_as(zm)
        if mm:
            at_min = zm == zm.amin(dim=0)
            k = torch.where(at_min, tid, inf).argmin(dim=0)
        else:
            k = zm.argmin(dim=0)
        zc = zm.gather(0, k[None])[0]
        tc = torch.where(zc < inf, tid.gather(0, k[None])[0], -1.0)
        better = zc < zb[t]
        zb[t] = torch.where(better, zc, zb[t])
        tb[t] = torch.where(better, tc, tb[t])
    return zb.view(n_tiles, 8, 128), tb.view(n_tiles, 8, 128)


@pytest.mark.parametrize("mm", [True, False])
@pytest.mark.parametrize("bins", sorted(BINS))
def test_sliced_walk_equals_the_plain_walk(bins, mm):
    """B6 / B6' as the kernels walk them, chunk by chunk from the work
    list and merged in slot order, equal the plain walks bit for bit (z
    as int32, ids), ties across chunk boundaries and -0.0 included; every
    work item is one chunk, and a tile's items are consecutive slots."""
    sizes, tiles_x = BINS[bins]
    ent, offs = _bins_entries(6, sizes, tiles_x)
    ent, offs = torch.from_numpy(ent), torch.from_numpy(offs)
    n_tiles = len(sizes)
    slots, tiles, chunks = RB.work_items(offs, ent.shape[0])
    first, n = RB.bin_slots(offs)
    assert int(n.sum()) == slots.numel()
    assert torch.equal(slots, first[tiles] + chunks)
    assert int(slots.max()) < RB.n_slots(ent.shape[0], n_tiles)
    z, t = _sliced_walk(ent, offs, tiles_x, n_tiles, mm)
    z_r, t_r = RB._bins_walk_ref(ent, offs, tiles_x, n_tiles, mm)
    assert torch.equal(t, t_r) and int((t >= 0).sum()) > 500
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))
    if bins != "grid":  # the boundary ties: the earlier entry's +0.0
        deep = t[-1][z[-1] == 0.0]
        assert deep.numel() > 50
        assert not torch.signbit(z[-1][z[-1] == 0.0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("mm", [True, False])
@pytest.mark.parametrize("bins", sorted(BINS))
def test_bins_kernel_equals_plain_on_cuda(cuda_device, bins, mm,
                                          zero_counts):
    """B6 (mm: channel-major chunks) and B6' (row-major entries, the valid
    flag tested): z and winner ids exactly equal to the plain versions,
    on the 3 x 2 grid, with a deep bin split over ten work items, and on
    one tile; one wrapper call counts one launch."""
    sizes, tiles_x = BINS[bins]
    ent, offs = _bins_entries(6, sizes, tiles_x)
    n_tiles = len(sizes)
    o = torch.from_numpy(offs).to(cuda_device)
    data = torch.from_numpy(ent).to(cuda_device)
    if mm:
        data = data.reshape(-1, 128, 16).transpose(1, 2).contiguous()
        fn, ref = RB.tile_eval_bins_mm, RB.tile_eval_bins_mm_ref
    else:
        data = RB.pack_entries(data)
        fn, ref = RB.tile_eval_bins, RB.tile_eval_bins_ref
    z, t = fn(data, o, tiles_x, n_tiles)
    z_r, t_r = ref(data, o, tiles_x, n_tiles)
    torch.cuda.synchronize()
    assert (RB.launches, RB.launches_loop) == ((1, 0) if mm else (0, 1))
    assert torch.equal(t, t_r) and int((t >= 0).sum()) > 500
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))
    if bins != "one tile":
        assert (t[0] == -1).all()  # the empty bin


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c,n", [(21, 8192), (30, 700), (40, 69632),
                                 (5, 1000), (64, 4100), (12, 2048)])
def test_pack_channels_kernels_equal_plain_on_cuda(cuda_device, c, n,
                                                   aligned, zero_counts):
    """B7, B7' and (where N is a multiple of 1,024) B3 bit-exact: W = C
    rounded up to 8 (8 to 64), N no multiple of the block's rows, spans
    past C and overlapping, and an input whose data_ptr is 4 bytes past a
    16-byte boundary (a contiguous view one float into its buffer)."""
    g = torch.Generator().manual_seed(c)
    buf = torch.randn(c * n + 1, generator=g).to(cuda_device)
    cm = buf[1:].view(c, n) if not aligned else buf[:-1].view(c, n)
    assert (cm.data_ptr() % 16 == 0) == aligned and cm.is_contiguous()
    w = -(-c // 8) * 8
    got = PK.pack_channels(list(cm))
    assert tuple(got.shape) == (n, w)
    assert torch.equal(got.view(torch.int32),
                       PK.pack_channels_ref(list(cm)).view(torch.int32))
    spans = [(0, min(16, w)), (w // 2, w), (max(0, c - 3), c + 5)]
    for o, r in zip(PK.pack_channels_split(cm, spans),
                    PK.pack_channels_split_ref(cm, spans)):
        assert torch.equal(o.view(torch.int32), r.view(torch.int32))
    blocked = n % 1024 == 0
    if blocked:
        cm3 = cm.view(c, n // 128, 128)
        for o, r in zip(PK.pack_channels_split_blocked(cm3, spans),
                        PK.pack_channels_split_blocked_ref(cm3, spans)):
            assert torch.equal(o.view(torch.int32), r.view(torch.int32))
    torch.cuda.synchronize()
    assert (PK.launches_channels, PK.launches_split, PK.launches) == (
        1, 3, 3 if blocked else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,tp", [(37, 68644, 69632), (46, 1000, 1024),
                                    (37, 300, 1024), (1, 700, 1024)])
def test_pack_channels_reads_a_row_strided_block_on_cuda(cuda_device, c, n,
                                                         tp, zero_counts):
    """B7 reads the first N columns of a wider [C, Tp] channel-major block
    in place (generation 2 packs B2's rows so), bit for bit with the pack
    of their contiguous copy, in one launch."""
    g = torch.Generator().manual_seed(n)
    blk = torch.randn((c, tp), generator=g).to(cuda_device)
    view = blk[:, :n]
    w = -(-c // 8) * 8
    got = PK.pack_channels(view, width=w)
    torch.cuda.synchronize()
    assert PK.launches_channels == 1
    assert torch.equal(got.view(torch.int32), PK.pack_channels_ref(
        view.contiguous(), width=w).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(32 * 512, 1 << 16, 6), (64, 4096, 1)],
                         ids=["generous", "overflow"])
@pytest.mark.parametrize("walk", sorted(GEN_WALKS))
def test_generation_walks_equal_plain_on_cuda(cuda_device, walk, caps,
                                              zero_counts):
    """B9d, B9e and B9f (on the K2 and the K4 layout, gskip in [0, 3]) at
    generous caps and at caps that overflow (clamped slab starts): winner
    ids and depth bits equal to the plain versions."""
    pos9, attrs_t, mvp = _walk_inputs(cuda_device, T=3000, seed=5)
    cm, bbox = S.setup_2dh_fused(pos9, attrs_t, mvp, 48, 96)
    lay, fn, ref = _gen_layout(walk, cm, bbox, caps)
    z, e = fn(*lay[:-5], caps[2])
    z_r, e_r = ref(*lay[:-5], caps[2])
    torch.cuda.synchronize()
    assert (RG.launches_grouped, RG.launches_direct, RG.launches_k2) == {
        "B9d": (1, 0, 0), "B9e": (0, 1, 0)}.get(walk, (0, 0, 1))
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 500
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n_attrs", [6, 9])
def test_setup_packed_equals_plain_and_b2_b3_on_cuda(cuda_device, n_attrs,
                                                    zero_counts):
    """B10 against its plain version and against B2 then B3 on the card:
    bbox, walk rows and shade rows bit for bit, sign of zero included."""
    pos9, attrs_t, mvp = _walk_inputs(cuda_device, T=1500, n_attrs=n_attrs)
    tw = -(-(3 * n_attrs + 3) // 8) * 8
    got = S.setup_2dh_fused_packed(pos9, attrs_t, mvp, 48, 96, tw)
    want = S.setup_2dh_fused_packed_ref(pos9, attrs_t, mvp, 48, 96, tw)
    cm, bb = S.setup_2dh_fused(pos9, attrs_t, mvp, 48, 96)
    two = PK.pack_channels_split_blocked(cm, [(0, 16), (16, 16 + tw)])
    torch.cuda.synchronize()
    assert S.launches_packed == 1
    for other in (want, (bb, *two)):
        for k in ("bx0", "bx1", "by0", "by1", "valid"):
            assert torch.equal(got[0][k], other[0][k]), k
        for a, b in zip(got[1:], other[1:]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(got[0]["valid"].sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("caps", sorted(SUBTILE_CAPS))
@pytest.mark.parametrize("walk", sorted(SUBTILE_WALKS))
def test_subtile_walks_equal_plain_on_cuda(cuda_device, walk, caps,
                                           zero_counts):
    """B9a (expanded rows), B9b (packed rows) and B9c (packed rows, depth
    mask) on a 4-tile-wide grid, at generous caps and at caps that
    overflow (clamped chunk starts, dropped pairs): winner ids and depth
    bits equal to the plain versions."""
    args, fn, ref = _subtile_layout(cuda_device, walk, SUBTILE_CAPS[caps])
    z, e = fn(*args)
    z_r, e_r = ref(*args)
    torch.cuda.synchronize()
    assert (RS.launches, RS.launches_packed, RS.launches_packed_d) == {
        "B9a": (1, 0, 0), "B9b": (0, 1, 0), "B9c": (0, 0, 1)}[walk]
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 300
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["room", "point_light"])
def test_shaded_walk_equals_plain_on_cuda(cuda_device, scene_name,
                                          zero_counts):
    """B8 on the demo room and on a random soup lit by a point light: rgb
    bit for bit equal to the plain version (-0.0 folded into +0.0)."""
    args = _fused_inputs(cuda_device, scene_name)
    rgb = RB.tile_eval_bins_shaded(*args)
    want = RB.tile_eval_bins_shaded_ref(*args)
    torch.cuda.synchronize()
    assert RB.launches_shaded == 1
    assert torch.equal((rgb + 0.0).view(torch.int32),
                       (want + 0.0).view(torch.int32))
    assert int((rgb.amax(1) > 0).sum()) > 1000


# --------------------------------------------------------------------------
# B8 and B1: the work-item walks, sliced as the kernels slice them
# --------------------------------------------------------------------------
def _light_vector():
    """B8's light parameters: ambient, a directional light and two point
    lights (raster_bins L_* layout)."""
    lp = torch.zeros(64)
    lp[0:3] = torch.tensor([0.12, 0.1, 0.08])
    lp[3:6] = torch.tensor([-0.48, -0.64, -0.6])
    lp[6:9] = torch.tensor([0.9, 0.85, 0.8])
    lp[9] = 2.0
    lp[10:16] = torch.tensor([100.0, 10.0, 5.0, 1.0, 0.9, 0.7])
    lp[16:22] = torch.tensor([300.0, 40.0, -2.0, 0.3, 0.4, 1.0])
    return lp


def _shaded_entries(seed, sizes=BINS["grid"][0], tiles_x=3):
    """Random 64-channel vertex-form entries (two per row, with the inert
    tail) binned over a grid tiles_x tiles wide, and the offsets: bins of
    ``sizes``, triangles of both windings up to ~60 px across, depth ties
    with the previous entry, 20% invalid entries. In a bin of 1,100
    entries or more, each pair of entries across a 64-entry chunk
    boundary (chunks start at the bin's offset rounded down to 16) is a
    depth tie of the nearest kind, the earlier at z = +0.0 and the later
    at -0.0 on the same vertices with another colour: the walk keeps the
    earlier, as the merge in bin order must."""
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    P = int(offs[-1])
    tile = np.repeat(np.arange(len(sizes)), sizes)
    cx = (tile % tiles_x) * 128 + rng.uniform(-20, 148, P)
    cy = (tile // tiles_x) * 8 + rng.uniform(-4, 12, P)
    ent = np.zeros((P + RB.S_CHUNK + 16 + P % 2, RB.NS_CHAN), np.float32)
    ent[:P, RB.S_VALID] = rng.random(P) >= 0.2
    r = rng.uniform(2, 30, (P, 1))
    ang = rng.uniform(0, 2 * np.pi, (P, 3))
    ent[:P, RB.S_X0:RB.S_X2 + 1] = cx[:, None] + r * np.cos(ang)
    ent[:P, RB.S_Y0:RB.S_Y2 + 1] = cy[:, None] + r * np.sin(ang) * 0.5
    ent[:P, RB.S_Z0:RB.S_Z2 + 1] = rng.uniform(-0.1, 1.1, (P, 3))
    ent[:P, RB.S_IW0:RB.S_IW2 + 1] = rng.uniform(0.3, 3.0, (P, 3))
    attrs = rng.uniform(-1, 1, (P, 3, 9))
    attrs[:, :, 3:6] = rng.uniform(0, 1, (P, 3, 3))            # colours
    attrs[:, :, 6:9] = rng.uniform(-5, 5, (P, 3, 3))           # positions
    ent[:P, RB.S_ATTR:RB.S_ATTR + 27] = attrs.reshape(P, 27)
    tie = np.nonzero(rng.random(P) < 0.3)[0]
    tie = tie[(tie > 0) & (tile[tie] == tile[np.maximum(tie - 1, 0)])]
    ent[tie, RB.S_X0:RB.S_Z2 + 1] = ent[tie - 1, RB.S_X0:RB.S_Z2 + 1]
    for lo, hi in zip(offs[:-1], offs[1:]):
        if hi - lo < 1100:
            continue
        start = (lo // 16) * 16
        for b in range(start + RB.S_CHUNK, hi, RB.S_CHUNK):
            ent[b - 1, RB.S_VALID] = ent[b, RB.S_VALID] = 1.0
            ent[b - 1, RB.S_Z0:RB.S_Z2 + 1] = 0.0
            ent[b, RB.S_X0:RB.S_Y2 + 1] = ent[b - 1, RB.S_X0:RB.S_Y2 + 1]
            ent[b, RB.S_Z0:RB.S_Z2 + 1] = -0.0
            ent[b, RB.S_ATTR + 3:RB.S_ATTR + 27:9] = 0.0  # red -> black
    return ent.reshape(-1, RB.NS_PACK * RB.NS_CHAN), offs


def _sliced_shaded(data, offsets, light, tiles_x, n_tiles):
    """B8 as its kernel walks it: every work item of ``shaded_work_items``
    (one 64-entry chunk of one bin, from the bin's offset rounded down to
    16) walked on its own for the first live entry of least z, the items
    of a tile folded in slot order with a strict z < best, then each
    pixel shaded from its winning entry. Returns (rgb, z, winner)."""
    inf = float("inf")
    ent = data.reshape(-1, RB.NS_CHAN)
    ent_z = torch.cat([ent, ent.new_zeros((RB.S_CHUNK, RB.NS_CHAN))])
    off = offsets.long()
    px, py = RB.tile_pixel_centres(tiles_x, n_tiles, "cpu")
    zb = torch.full((n_tiles, RB.PIX), inf)
    wb = torch.zeros((n_tiles, RB.PIX), dtype=torch.long)
    for _q, t, c in zip(*(x.tolist() for x in RB.shaded_work_items(
            offsets, ent.shape[0]))):
        base = (int(off[t]) // 16) * 16 + c * RB.S_CHUNK
        p = torch.arange(base, base + RB.S_CHUNK)
        ch = ent_z[p]
        live = (p >= off[t]) & (p < off[t + 1]) & (ch[:, RB.S_VALID] > 0.0)
        w0, w1, w2, z = RB._shaded_planes(ch[:, None, :], px[t][None],
                                          py[t][None])
        ok = (live[:, None] & (w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)
              & (z >= 0.0) & (z <= 1.0))
        zm = torch.where(ok, z, inf)                    # [64, 1024]
        k = zm.argmin(dim=0)                            # the first of least z
        zc = zm.gather(0, k[None])[0]
        better = zc < zb[t]
        zb[t] = torch.where(better, zc, zb[t])
        wb[t] = torch.where(better, p[k], wb[t])
    rgb = RB._shade_winners(ent, wb, zb < inf, px, py, light, n_tiles)
    return rgb, zb, torch.where(zb < inf, wb, -1)


@pytest.mark.parametrize("bins", sorted(BINS))
def test_sliced_shaded_walk_equals_the_plain_version(bins):
    """B8 as its kernel walks it, chunk by chunk from the work list and
    merged in slot order, equals the plain version bit for bit (rgb as
    int32, -0.0 folded), ties across chunk boundaries included; a tile's
    items are consecutive slots below the host's bound."""
    sizes, tiles_x = BINS[bins]
    data, offs = _shaded_entries(8, sizes, tiles_x)
    data, offs = torch.from_numpy(data), torch.from_numpy(offs)
    n_tiles, light = len(sizes), _light_vector()
    n_ent = data.numel() // RB.NS_CHAN
    slots, tiles, chunks = RB.shaded_work_items(offs, n_ent)
    first, n = RB.shaded_bin_slots(offs)
    assert int(n.sum()) == slots.numel()
    assert torch.equal(slots, first[tiles] + chunks)
    assert int(slots.max()) < RB.shaded_n_slots(n_ent, n_tiles)
    rgb, z, win = _sliced_shaded(data, offs, light, tiles_x, n_tiles)
    want = RB.tile_eval_bins_shaded_ref(data, offs, light, tiles_x, n_tiles)
    assert torch.equal((rgb + 0.0).view(torch.int32),
                       (want + 0.0).view(torch.int32))
    assert int((win >= 0).sum()) > 500 and (want.amax(1) > 0).any()
    if bins != "grid":  # the boundary ties: the earlier entry's +0.0
        tied = z[-1] == 0.0
        assert int(tied.sum()) > 50
        assert not torch.signbit(z[-1][tied]).any()
        assert not torch.signbit(
            data.view(-1, RB.NS_CHAN)[win[-1][tied], RB.S_Z0]).any()


# group slab layouts: (rows of each group's deepest slot, r_cap): a
# generous cap; one group of 1,170 rows far deeper than the others (37
# slabs), whose slab boundaries carry +0.0 / -0.0 depth ties; the same
# with r_cap short of the layout (clamped rowptr); one group
GROUPED = {"generous": ((40, 70, 5, 0, 130, 33), 1024),
           "deep": ((40, 70, 5, 0, 130, 33, 1170), 1664),
           "overflow": ((40, 70, 5, 0, 130, 33, 1170), 1280),
           "one group": ((300,), 320)}


def _grouped_entries(seed, depths, r_cap):
    """A random rows128 layout of len(depths) groups: slot g of group t
    holds min(depth, ...) entries after a skip of 0..3 rows (the K-gather's
    misaligned starts), rows in CHUNK_RG multiples per group; plane
    coefficients up to 1e10, depth ties with the previous row, ids
    increasing in each slot. In the deepest group each pair of rows across
    a slab boundary of slot 0 is a depth tie of the nearest kind, the
    earlier at z = +0.0, the later at -0.0. Returns (rows128, rowptr,
    gdepth, gskip, xl, yl)."""
    rng = np.random.default_rng(seed)
    G = len(depths)
    gskip = rng.integers(0, 4, (G, 8))
    gdepth = np.stack([rng.integers(0, d + 1, 8) for d in depths])
    gdepth[:, 0] = depths
    need = (gdepth + gskip).max(1)
    rowptr = np.concatenate([[0], np.cumsum(-(-need // 32) * 32)])
    rows = np.zeros((max(int(rowptr[-1]), r_cap), 8, 16), np.float32)
    bx = rng.integers(0, 6, (G, 8))
    by = rng.integers(0, 6, (G, 8))
    n = rows.shape[0]
    cx = bx[:, :, None] * 16 + rng.uniform(-6, 22, (G, 8, n))
    cy = by[:, :, None] * 8 + rng.uniform(-3, 11, (G, 8, n))
    for t in range(G):
        lo, hi = int(rowptr[t]), int(rowptr[t + 1])
        for k in range(3):
            ang = rng.uniform(0, 2 * np.pi, (hi - lo, 8))
            scale = np.where(rng.random((hi - lo, 8)) < 0.15, 3e8, 1.0)
            a = np.cos(ang) * rng.uniform(0.05, 40, (hi - lo, 8)) * scale
            b = np.sin(ang) * rng.uniform(0.05, 40, (hi - lo, 8)) * scale
            g = -(a * (cx[t, :, :hi - lo].T + rng.uniform(-20, 20, a.shape))
                  + b * (cy[t, :, :hi - lo].T + rng.uniform(-5, 5, a.shape)))
            rows[lo:hi, :, 3 * k:3 * k + 3] = np.stack([a, b, g], -1)
        zx = rng.normal(size=(hi - lo, 8)) * 2e-3
        zy = rng.normal(size=(hi - lo, 8)) * 2e-2
        rows[lo:hi, :, 9:12] = np.stack(
            [zx, zy, rng.uniform(-0.1, 1.1, zx.shape)
             - zx * cx[t, :, :hi - lo].T - zy * cy[t, :, :hi - lo].T], -1)
        rows[lo:hi, :, 12] = np.sort(rng.choice(100000, (hi - lo) * 8,
                                                replace=False)
                                     ).reshape(8, hi - lo).T
        tie = np.nonzero(rng.random(hi - lo) < 0.3)[0]
        tie = tie[tie > 0] + lo
        rows[tie, :, 9:12] = rows[tie - 1, :, 9:12]
        if hi - lo >= 1100:
            for r in range(lo + 32, hi, 32):
                rows[r - 1, 0, 9:12] = 0.0
                rows[r, 0, :9] = rows[r - 1, 0, :9]
                rows[r, 0, 9:12] = -0.0
    lane = np.arange(128)
    xl = (bx.repeat(16, 1) * 16 + lane % 16 + 0.5).astype(np.float32)
    yl = (by.repeat(16, 1) * 8).astype(np.float32)
    return (torch.from_numpy(rows[:r_cap].reshape(r_cap, 128)),
            torch.from_numpy(rowptr.astype(np.int32)),
            torch.from_numpy(gdepth.reshape(-1).astype(np.int32)),
            torch.from_numpy(gskip.reshape(-1).astype(np.int32)),
            torch.from_numpy(xl), torch.from_numpy(yl))


def _sliced_grouped(rows, rowptr, gdepth, gskip, xl, yl, grp_cap, per=1):
    """B1 (``per`` = 1) and B9f (``per`` = 2 entries a row) as their kernel
    walks them: every work item of ``group_work_items`` (one slab of
    32 // per rows of one group, rows min(r0 + c*R, r_cap - R) + r, R =
    32 // per, whose sub-entry j of row r is entry idx = c*32 + per*r + j)
    walked on its own for the first live covering entry of least z, then
    each group's items folded in slot order with a strict z < best."""
    r_cap = rows.shape[0]
    slab = RG.CHUNK_RG // per
    rp = torch.clamp(rowptr.long(), 0, r_cap)

    def stage(t, c):
        start = min(int(rp[t]) + c * slab, r_cap - slab)
        return (rows[start:start + slab].view(slab, 8, per, 16)
                .transpose(1, 2).reshape(-1, 1, 8, 16))

    return _sliced_fold(RG.group_work_items(rowptr, r_cap, slab), stage,
                        gdepth, gskip, xl, yl, grp_cap)


def _sliced_fold(items, stage, gdepth, gskip, xl, yl, grp_cap):
    """The grouped walks' work items (slot, group, slab) in slot order,
    slab c of group t staged as ``stage(t, c)`` -> [32 entries, 1, 8
    slots, 16 channels]: each item walked on its own for the first live
    covering entry of least z (idx = c*32 + r live iff skip <= idx < skip
    + depth), folded into its group with a strict z < best."""
    inf = float("inf")
    zb = torch.full((grp_cap, 8, 8, 16), inf)
    eb = torch.full((grp_cap, 8, 8, 16), -1.0)
    r_iota = torch.arange(RG.CHUNK_RG).view(-1, 1, 1, 1)
    ys = (torch.arange(8.0) + 0.5).view(1, 8, 1, 1)
    for _q, t, c in zip(*(x.tolist() for x in items)):
        ent = stage(t, c)
        x = xl[t].view(1, 1, 8, 16)
        y = ys + yl[t].view(1, 1, 8, 16)

        def plane(k):  # entry channels k..k+2 -> [32, 8 rows, 8 slots, 16]
            a, b, g = (ent[..., k + i:k + i + 1] for i in range(3))
            return fma32(b, y, fma32(a, x, g))

        z = plane(9)
        idx = c * RG.CHUNK_RG + r_iota
        skip = gskip[t * 8:t * 8 + 8].view(1, 1, 8, 1)
        depth = gdepth[t * 8:t * 8 + 8].view(1, 1, 8, 1)
        ok = ((plane(0) <= 0.0) & (plane(3) <= 0.0) & (plane(6) <= 0.0)
              & (z >= 0.0) & (z <= 1.0) & (idx >= skip)
              & (idx < skip + depth))
        zm = torch.where(ok, z, inf)
        k = zm.argmin(dim=0)                 # the first of least z
        zc = zm.gather(0, k[None])[0]
        ec = ent[..., 12:13].expand(zm.shape).gather(0, k[None])[0]
        better = zc < zb[t]
        zb[t] = torch.where(better, zc, zb[t])
        eb[t] = torch.where(better, ec, eb[t])
    return zb.view(grp_cap, 8, 128), eb.view(grp_cap, 8, 128)


@pytest.mark.parametrize("case", sorted(GROUPED))
def test_sliced_grouped_walk_equals_the_plain_walk(case):
    """B1 as its kernel walks it, slab by slab from the work list and
    merged in slot order, equals the plain walk bit for bit (z as int32,
    ids), skip windows, clamped rowptr and the +0.0 / -0.0 ties across
    slab boundaries included."""
    depths, r_cap = GROUPED[case]
    lay = _grouped_entries(11, depths, r_cap)
    G = len(depths)
    slots, groups, slabs = RG.group_work_items(lay[1], r_cap)
    first, n = RG.group_slots(torch.clamp(lay[1], 0, r_cap))
    assert int(n.sum()) == slots.numel()
    assert torch.equal(slots, first[groups] + slabs)
    assert int(slots.max()) < RG.group_n_slots(r_cap, G)
    z, e = _sliced_grouped(*lay, G)
    z_r, e_r = RG.tile_eval_grouped_skip_ref(*lay, G)
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 300
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))
    if case in ("deep", "overflow"):  # the boundary ties: the earlier +0.0
        zt = z[-1][:, :16]
        assert int((zt == 0.0).sum()) > 20
        assert not torch.signbit(zt[zt == 0.0]).any()


def _k2_rows(rows128, rowptr, gdepth, gskip, xl, yl):
    """A rows128 layout in B9f's two-entry rows: row q holds entries 2q and
    2q + 1 (lane g*32 + j*16 + c), rowptr in row units."""
    r2 = rows128.shape[0] // 2
    rows256 = (rows128.view(r2, 2, 8, 16).transpose(1, 2)
               .reshape(r2, 256).contiguous())
    return rows256, rowptr // 2, gdepth, gskip, xl, yl


# B9f's layouts: GROUPED relaid to two-entry rows (skips 0..3, a group of
# 37 slabs with +0.0 / -0.0 ties at slab boundaries, the clamp, one
# group), and the K2 and K4 builds of a random 48x96 soup
K2_CASES = sorted(GROUPED) + ["K2 build", "K4 build"]


def _k2_layout(case):
    """(layout args, grp_cap) of a B9f case on the CPU."""
    if case in GROUPED:
        depths, r_cap = GROUPED[case]
        return _k2_rows(*_grouped_entries(11, depths, r_cap)), len(depths)
    pos9, attrs_t, mvp = _walk_inputs("cpu", T=3000, seed=5)
    cm, bbox = S.setup_2dh_fused_ref(pos9, attrs_t, mvp, 48, 96)
    lay, _fn, _ref = _gen_layout("B9f_" + case[:2].lower(), cm, bbox,
                                 (32 * 512, 1 << 16, 6))
    return lay[:-5], 6


@pytest.mark.parametrize("case", K2_CASES)
def test_sliced_k2_walk_equals_the_plain_walk(case):
    """B9f as its kernel walks it, 16-row (32-entry) slab by slab from the
    work list and merged in slot order, equals the plain walk bit for bit
    (z as int32, ids): odd skip windows, a group of 37 slabs with
    +0.0 / -0.0 ties at slab boundaries, rowptr clamped to a short r_cap,
    one group, and the K2 and K4 builds."""
    lay, G = _k2_layout(case)
    r_cap2 = lay[0].shape[0]
    slots, groups, slabs = RG.group_work_items(lay[1], r_cap2, 16)
    first, n = RG.group_slots(torch.clamp(lay[1], 0, r_cap2), 16)
    assert int(n.sum()) == slots.numel()
    assert torch.equal(slots, first[groups] + slabs)
    assert int(slots.max()) < RG.group_n_slots(r_cap2, G, 16)
    z, e = _sliced_grouped(*lay, G, per=2)
    z_r, e_r = RG.tile_eval_grouped_k2_ref(*lay, G)
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 300
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))
    assert set(lay[3].tolist()) >= ({0, 1} if case == "K2 build" else
                                    {0, 1, 2, 3})
    if case in ("deep", "overflow"):  # the boundary ties: the earlier +0.0
        zt = z[-1][:, :16]
        assert int((zt == 0.0).sum()) > 20
        assert not torch.signbit(zt[zt == 0.0]).any()


@pytest.mark.parametrize("case", sorted(GROUPED))
def test_sliced_b9d_walk_equals_the_plain_walk(case):
    """B9d as its kernel walks it (B1's slab work items with every skip at
    0, live iff idx < depth), merged in slot order, equals the plain walk
    bit for bit (z as int32, ids): clamped rowptr, one group and the
    +0.0 / -0.0 ties across slab boundaries included."""
    depths, r_cap = GROUPED[case]
    rows, rowptr, gdepth, _gskip, xl, yl = _grouped_entries(11, depths,
                                                             r_cap)
    G = len(depths)
    z, e = _sliced_grouped(rows, rowptr, gdepth, torch.zeros_like(gdepth),
                           xl, yl, G)
    z_r, e_r = RG.tile_eval_grouped_ref(rows, rowptr, gdepth, xl, yl, G)
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 300
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))
    if case in ("deep", "overflow"):  # the boundary ties: the earlier +0.0
        zt = z[-1][:, :16]
        assert int((zt == 0.0).sum()) > 20
        assert not torch.signbit(zt[zt == 0.0]).any()


def _direct_entries(seed, depths):
    """B9e's inputs (src_pair, goff, gdepth, gchunks, xl, yl) from a random
    rows128 layout (``_grouped_entries``): slot g of group t's entries are
    its rows from the group's first, laid out as one strip of the
    pair-ordered table, strips in (group, slot) order but the shallowest
    live strip of the deepest group last, so its later slabs read
    clamped at p_max. Channels 16-31 hold noise (the walk reads 0-15),
    the 32 rows past p_max zeros, as the build leaves them; the deepest
    group's slot 0 carries +0.0 / -0.0 ties across its slab boundaries."""
    rows, rowptr, gdepth, _gskip, xl, yl = _grouped_entries(seed, depths,
                                                            1 << 12)
    G = len(depths)
    rows = rows.view(-1, 8, 16)
    gd = gdepth.view(G, 8)
    gchunks = (gd.amax(1) + 31) // 32
    deep = int(gchunks.argmax())
    live = torch.nonzero(gd[deep] > 0)[:, 0]
    last = (deep, int(live[gd[deep][live].argmin()]))
    order = [(t, g) for t in range(G) for g in range(8) if (t, g) != last]
    goff = torch.zeros((G, 8), dtype=torch.int32)
    strips, p = [], 0
    for t, g in order + [last]:
        d, lo = int(gd[t, g]), int(rowptr[t])
        goff[t, g] = p
        strips.append(rows[lo:lo + d, g])
        p += d
    noise = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1e3, 1e3, (p, 16)).astype(np.float32))
    src_pair = torch.cat([torch.cat([torch.cat(strips), noise], 1),
                          torch.zeros((32, 32))])
    return (src_pair, goff.view(-1), gdepth, gchunks.to(torch.int32), xl,
            yl)


def _deep_soup_inputs():
    """The random 48x96 soup with 1,500 small triangles stacked in front of
    one spot: one group far deeper than the rest."""
    pos9, attrs_t, mvp = _walk_inputs("cpu", T=3000, seed=5)
    rng = np.random.default_rng(7)
    stack = (np.repeat(rng.normal(0, 0.1, (1500, 3)), 3, 0)
             + rng.normal(0, 0.05, (4500, 3))).astype(np.float32)
    spos9 = torch.from_numpy(stack).view(1500, 3, 3).permute(1, 2, 0).reshape(
        9, 1500)
    return (torch.cat([pos9, spos9], 1),
            torch.cat([attrs_t, attrs_t[:, :1500]], 1), mvp)


# B9e's layouts: the subtile4 build of the random 48x96 soup (at generous
# caps, with one group far deeper than the rest, at a pair_cap that
# overflows), and random strips (a group of 0 chunks, a strip clamped at
# p_max, +0.0 / -0.0 ties across slab boundaries in a group of 37 slabs)
DIRECT = {"soup": (32 * 512, 1 << 16, 6), "deep soup": (32 * 512, 1 << 16, 6),
          "overflow": (64, 2048, 6), "zero chunks": GROUPED["generous"][0],
          "clamp": GROUPED["one group"][0], "ties": GROUPED["deep"][0]}


def _direct_layout(case):
    """(B9e's args (src_pair, goff, gdepth, gchunks, xl, yl), grp_cap,
    n_pairs or None) of a DIRECT case on the CPU."""
    if case in ("zero chunks", "clamp", "ties"):
        return _direct_entries(13, DIRECT[case]), len(DIRECT[case]), None
    pos9, attrs_t, mvp = (_deep_soup_inputs() if case == "deep soup" else
                          _walk_inputs("cpu", T=3000, seed=5))
    cm, bbox = S.setup_2dh_fused_ref(pos9, attrs_t, mvp, 48, 96)
    lay, _fn, _ref = _gen_layout("B9e", cm, bbox, DIRECT[case])
    return lay[:-5], DIRECT[case][2], int(lay[-3])


def _sliced_direct(src_pair, goff, gdepth, gchunks, xl, yl, grp_cap):
    """B9e as its kernel walks it: every work item of ``direct_work_items``
    staged from 8 strips (slot g from src_pair rows min(goff + c*32,
    p_max) + r, channels 0-15), walked and folded as ``_sliced_fold``."""
    p_max = src_pair.shape[0] - RG.CHUNK_RG
    goff = torch.clamp(goff.long(), min=0).view(grp_cap, 8)
    r_off = torch.arange(RG.CHUNK_RG)[:, None]

    def stage(t, c):
        start = torch.clamp(goff[t] + c * RG.CHUNK_RG, max=p_max)
        return src_pair[start[None, :] + r_off, :16].view(-1, 1, 8, 16)

    return _sliced_fold(RG.direct_work_items(gchunks, p_max), stage, gdepth,
                        torch.zeros_like(gdepth), xl, yl, grp_cap)


@pytest.mark.parametrize("case", list(DIRECT))
def test_sliced_direct_walk_equals_the_plain_walk(case):
    """B9e as its kernel walks it, slab by slab from its work list (each
    slot's strip read on its own) and merged in slot order, equals the
    plain walk bit for bit (z as int32, ids), and the list's slots stay
    under the bound the partials are sized by: the subtile4 builds (a
    deep group, an overflowing pair_cap), a group of 0 chunks, a strip
    clamped at p_max, +0.0 / -0.0 ties across slab boundaries."""
    lay, G, n_pairs = _direct_layout(case)
    src_pair, goff, gdepth, gchunks = lay[:4]
    p_max = src_pair.shape[0] - RG.CHUNK_RG
    slots, groups, slabs = RG.direct_work_items(gchunks, p_max)
    first, n = RG.group_slots(RG.direct_rowptr(
        gchunks, RG.direct_n_slots(p_max, G)))
    assert torch.equal(n, gchunks.long())
    assert int(n.sum()) == slots.numel()
    assert torch.equal(slots, first[groups] + slabs)
    assert int(slots.max()) < RG.direct_n_slots(p_max, G)
    z, e = _sliced_direct(*lay, G)
    z_r, e_r = RG.tile_eval_direct_ref(*lay, G)
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 300
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))
    if case == "overflow":
        assert p_max < n_pairs
    elif case == "deep soup":
        assert int(gchunks.max()) >= 20
    elif case == "zero chunks":
        empty = gchunks == 0
        assert empty.any() and (e[empty] == -1).all()
        assert torch.isinf(z[empty]).all()
    elif case == "clamp":
        ends = goff + (gchunks.repeat_interleave(8) - 1) * RG.CHUNK_RG
        assert bool((ends > p_max).any())
    elif case == "ties":  # the boundary ties: the earlier +0.0
        zt = z[-1][:, :16]
        assert int((zt == 0.0).sum()) > 20
        assert not torch.signbit(zt[zt == 0.0]).any()


# B9a's layouts (tile row counts, tiles_x, r_cap): a grid 4 tiles wide
# (tile x offsets up to 384); the same with a ninth tile of 1,152 rows
# whose item boundaries carry +0.0 / -0.0 depth ties; the same with r_cap
# short of the layout (clamped rowptr, chunks re-read at r_cap - 8)
SUBTILES = {"grid": ((40, 72, 8, 0, 136, 32, 16, 64), 4, 512),
            "deep": ((40, 72, 8, 0, 136, 32, 16, 64, 1152), 4, 1600),
            "overflow": ((40, 72, 8, 0, 136, 32, 16, 64, 1152), 4, 1200)}


def _random_tile(rng, ent, lo, hi, t, tiles_x):
    """Random walk entries for rows lo..hi of tile t (ent [n, 8, 16], one
    entry per lane group): planes in global pixel centres, coefficients up
    to 1e10, depth ties with the previous row, ids increasing; in a tile of
    1,100 rows or more, group 0's rows across each 32-row item boundary
    are a tie of the nearest kind, the earlier at z = +0.0, the later at
    -0.0 on the same edges."""
    m = hi - lo
    tx, ty = t % tiles_x, t // tiles_x
    cx = tx * 128 + np.arange(8)[:, None] * 16 + rng.uniform(-6, 22, (8, m))
    cy = ty * 8 + rng.uniform(-3, 11, (8, m))
    for k in range(3):
        ang = rng.uniform(0, 2 * np.pi, (m, 8))
        scale = np.where(rng.random((m, 8)) < 0.15, 3e8, 1.0)
        a = np.cos(ang) * rng.uniform(0.05, 40, (m, 8)) * scale
        b = np.sin(ang) * rng.uniform(0.05, 40, (m, 8)) * scale
        g = -(a * (cx.T + rng.uniform(-20, 20, a.shape))
              + b * (cy.T + rng.uniform(-5, 5, a.shape)))
        ent[lo:hi, :, 3 * k:3 * k + 3] = np.stack([a, b, g], -1)
    zx = rng.normal(size=(m, 8)) * 2e-3
    zy = rng.normal(size=(m, 8)) * 2e-2
    ent[lo:hi, :, 9:12] = np.stack(
        [zx, zy, rng.uniform(-0.1, 1.1, zx.shape) - zx * cx.T - zy * cy.T],
        -1)
    ent[lo:hi, :, 12] = np.sort(rng.choice(100000, m * 8, replace=False)
                                ).reshape(8, m).T
    tie = np.nonzero(rng.random(m) < 0.3)[0]
    tie = tie[tie > 0] + lo
    ent[tie, :, 9:12] = ent[tie - 1, :, 9:12]
    if m >= 1100:
        for r in range(lo + 32, hi, 32):
            ent[r - 1, 0, 9:12] = 0.0
            ent[r, 0, :9] = ent[r - 1, 0, :9]
            ent[r, 0, 9:12] = -0.0


def _subtile_entries(seed, n_rows, tiles_x, r_cap):
    """A random expanded layout (rows f32 [r_cap, 16, 128], channel c of
    group g over lanes 16g..16g+15) of len(n_rows) tiles tiles_x wide:
    group g of tile t holds ``_random_tile``'s entries for its first rows
    and the inert row (G0 = +1) after. Returns (rows, rowptr)."""
    rng = np.random.default_rng(seed)
    rowptr = np.concatenate([[0], np.cumsum(n_rows)]).astype(np.int32)
    n = max(int(rowptr[-1]), r_cap)
    ent = np.zeros((n, 8, 16), np.float32)
    ent[:, :, 2] = 1.0  # inert
    for t, (lo, hi) in enumerate(zip(rowptr[:-1], rowptr[1:])):
        m = hi - lo
        if m == 0:
            continue
        _random_tile(rng, ent, lo, hi, t, tiles_x)
        dead = np.arange(m)[:, None] >= rng.integers(m // 2, m + 1, 8)
        dead[:, 0] = False
        ent[lo:hi][dead] = np.float32([0, 0, 1] + [0] * 13)
    rows = torch.from_numpy(ent[:r_cap]).transpose(1, 2).repeat_interleave(
        16, dim=-1).contiguous()
    return rows, torch.from_numpy(rowptr)


def _sliced_subtile(rows, rowptr, tiles_x, n_tiles):
    """B9a as its kernel walks it: every work item of
    ``subtile_work_items`` (up to 32 rows of one tile, each 8-row chunk c of
    the tile read at min(r0 + 8c, r_cap - 8)) walked on its own for the
    first covering entry of least z, then each tile's items folded in slot
    order with a strict z < best."""
    inf = float("inf")
    r_cap = rows.shape[0]
    rp = torch.clamp(rowptr.long(), 0, r_cap)
    zb = torch.full((n_tiles, 8, 8, 16), inf)
    eb = torch.full((n_tiles, 8, 8, 16), -1.0)
    for _q, t, k in zip(*(x.tolist() for x in RS.subtile_work_items(
            rowptr, r_cap))):
        m = min(int(rp[t + 1] - rp[t]) - k * RS.ITEM_R, RS.ITEM_R)
        d = k * RS.ITEM_R + torch.arange(m)
        row = torch.clamp(rp[t] + (d // 8) * 8, max=r_cap - 8) + d % 8
        ent = rows[row][:, :, ::16].transpose(1, 2).reshape(m, 1, 8, 16)
        tx, ty = t % tiles_x, t // tiles_x
        x = (tx * 128 + torch.arange(128)).float().view(1, 1, 8, 16) + 0.5
        y = (torch.arange(8) + ty * 8).float().view(1, 8, 1, 1) + 0.5

        def plane(c):  # channels c..c+2 -> [m, 8 rows, 8 groups, 16]
            a, b, g = (ent[..., c + i:c + i + 1] for i in range(3))
            return fma32(a, x, b * y) + g

        z = plane(9)
        ok = ((plane(0) <= 0.0) & (plane(3) <= 0.0) & (plane(6) <= 0.0)
              & (z >= 0.0) & (z <= 1.0))
        zm = torch.where(ok, z, inf)
        j = zm.argmin(dim=0)                 # the first of least z
        zc = zm.gather(0, j[None])[0]
        ec = ent[..., 12:13].expand(zm.shape).gather(0, j[None])[0]
        better = zc < zb[t]
        zb[t] = torch.where(better, zc, zb[t])
        eb[t] = torch.where(better, ec, eb[t])
    return zb.view(n_tiles, 8, 128), eb.view(n_tiles, 8, 128)


@pytest.mark.parametrize("case", sorted(SUBTILES))
def test_sliced_subtile_walk_equals_the_plain_walk(case):
    """B9a as its kernel walks it, 32-row item by item from the work list
    (each 8-row chunk clamped as the reference clamps it) and merged in
    slot order, equals the plain walk bit for bit (z as int32, ids): a
    grid 4 tiles wide, a tile of 1,152 rows (36 items) with +0.0 / -0.0
    ties across item boundaries, and an r_cap short of the layout."""
    n_rows, tiles_x, r_cap = SUBTILES[case]
    rows, rowptr = _subtile_entries(12, n_rows, tiles_x, r_cap)
    n_tiles = len(n_rows)
    slots, tiles, items = RS.subtile_work_items(rowptr, r_cap)
    first, n = RS.subtile_items(torch.clamp(rowptr, 0, r_cap))
    assert int(n.sum()) == slots.numel()
    assert torch.equal(slots, first[tiles] + items)
    assert int(slots.max()) < RS.subtile_n_slots(r_cap, n_tiles)
    z, e = _sliced_subtile(rows, rowptr, tiles_x, n_tiles)
    z_r, e_r = RS.tile_eval_subtile_ref(rows, rowptr, tiles_x, n_tiles)
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 1000
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))
    if case != "grid":  # the boundary ties: the earlier +0.0
        zt = z[-1][:, :16]
        assert int((zt == 0.0).sum()) > 20
        assert not torch.signbit(zt[zt == 0.0]).any()


# B9b's / B9c's packed layouts, SUBTILES' cases with every tile's rows
# rounded up to the 32-row chunk (= one work item): a grid 4 tiles wide,
# the same with a ninth tile of 1,152 rows (36 items) whose item
# boundaries carry +0.0 / -0.0 ties, and the same with r_cap short of it
PACKED = {"grid": ((64, 96, 32, 0, 160, 32, 32, 64), 4, 512),
          "deep": ((64, 96, 32, 0, 160, 32, 32, 64, 1152), 4, 1664),
          "overflow": ((64, 96, 32, 0, 160, 32, 32, 64, 1152), 4, 1216)}
PACKED_WALKS = {"B9b": ("tile_eval_packed", False),
                "B9c": ("tile_eval_packed_d", True)}


def _packed_entries(seed, n_rows, tiles_x, r_cap, masked):
    """A random packed layout (rows f32 [r_cap, 128], lane g*16 + c) of
    len(n_rows) tiles tiles_x wide: bin (t, g) holds ``_random_tile``'s
    entries in its first depth[t*8 + g] rows (group 0 in all of them);
    group 1's last live row is a backdrop covering its bin at z near 1.
    Dead slots hold build_packed_rows' inert row (G0 = +1, ZC = 2) or,
    ``masked``, as build_packed_rows_pre_id's hold live rows of other
    pairs, the next tile's backdrop, which wins wherever the depth mask
    does not kill it. Returns (rows, rowptr, depth i32 [n_tiles*8])."""
    rng = np.random.default_rng(seed)
    rowptr = np.concatenate([[0], np.cumsum(n_rows)]).astype(np.int32)
    n = max(int(rowptr[-1]), r_cap)
    ent = np.zeros((n, 8, 16), np.float32)
    depth = np.zeros((len(n_rows), 8), np.int32)
    backdrops = {}
    for t, (lo, hi) in enumerate(zip(rowptr[:-1], rowptr[1:])):
        m = hi - lo
        if m == 0:
            continue
        _random_tile(rng, ent, lo, hi, t, tiles_x)
        depth[t] = rng.integers(m // 2, m + 1, 8)
        depth[t, 0] = m
        back = lo + depth[t, 1] - 1
        ent[back, 1, :12] = [0, 0, -1] * 3 + [0, 0, rng.uniform(0.99, 1.0)]
        backdrops[t] = ent[back, 1].copy()
    inert = np.float32([0, 0, 1] + [0] * 8 + [2] + [0] * 4)
    for t, (lo, hi) in enumerate(zip(rowptr[:-1], rowptr[1:])):
        dead = np.arange(hi - lo)[:, None] >= depth[t]
        ent[lo:hi][dead] = inert if not masked else backdrops[
            min((u for u in backdrops if u > t), default=0)]
    rows = torch.from_numpy(ent[:r_cap].reshape(r_cap, 128).copy())
    return rows, torch.from_numpy(rowptr), torch.from_numpy(depth.ravel())


def _sliced_packed(rows, rowptr, depth, tiles_x, n_tiles):
    """B9b (``depth`` None) or B9c as their kernels walk them: every work
    item of ``subtile_work_items`` (one 32-row chunk of one tile, read at
    min(r0 + 32k, r_cap - 32), row i the tile's slot 32k + i, which B9c
    masks by its bin's depth) walked on its own for the first covering
    entry of least z, the planes rounded as the reference's expand dot,
    then each tile's items folded in slot order with a strict z < best."""
    inf = float("inf")
    r_cap = rows.shape[0]
    rp = torch.clamp(rowptr.long(), 0, r_cap)
    zb = torch.full((n_tiles, 8, 8, 16), inf)
    eb = torch.full((n_tiles, 8, 8, 16), -1.0)
    lx = (torch.arange(128).float() + 0.5).view(1, 1, 8, 16)
    i = torch.arange(RS.ITEM_R).view(-1, 1, 1, 1)
    for _q, t, k in zip(*(x.tolist() for x in RS.subtile_work_items(
            rowptr, r_cap))):
        start = min(int(rp[t]) + k * RS.ITEM_R, r_cap - RS.ITEM_R)
        ent = rows[start:start + RS.ITEM_R].view(RS.ITEM_R, 1, 8, 16)
        tx, ty = t % tiles_x, t // tiles_x
        bx = float(tx * 128)
        y = (torch.arange(8) + ty * 8).float().view(1, 8, 1, 1) + 0.5

        def plane(c):  # channels c..c+2 -> [32, 8 rows, 8 groups, 16]
            a, b, g = (ent[..., c + j:c + j + 1] for j in range(3))
            return fma32(b, y, fma32(bx, a, a * lx + g))

        z = plane(9)
        ok = ((plane(0) <= 0.0) & (plane(3) <= 0.0) & (plane(6) <= 0.0)
              & (z >= 0.0) & (z <= 1.0))
        if depth is not None:
            ok &= k * RS.ITEM_R + i < depth.view(n_tiles, 1, 8, 1)[t]
        zm = torch.where(ok, z, inf)
        j = zm.argmin(dim=0)                 # the first of least z
        zc = zm.gather(0, j[None])[0]
        ec = ent[..., 12:13].expand(zm.shape).gather(0, j[None])[0]
        better = zc < zb[t]
        zb[t] = torch.where(better, zc, zb[t])
        eb[t] = torch.where(better, ec, eb[t])
    return zb.view(n_tiles, 8, 128), eb.view(n_tiles, 8, 128)


def _packed_args(walk, case, device="cpu"):
    """(args, kernel wrapper, plain version) of a packed walk on case's
    layout."""
    name, masked = PACKED_WALKS[walk]
    n_rows, tiles_x, r_cap = PACKED[case]
    rows, rowptr, depth = (x.to(device) for x in _packed_entries(
        13, n_rows, tiles_x, r_cap, masked))
    args = (rows, rowptr) + ((depth,) if masked else ()) + (tiles_x,
                                                            len(n_rows))
    return args, getattr(RS, name), getattr(RS, name + "_ref")


@pytest.mark.parametrize("case", sorted(PACKED))
@pytest.mark.parametrize("walk", sorted(PACKED_WALKS))
def test_sliced_packed_walk_equals_the_plain_walk(walk, case):
    """B9b and B9c as their kernels walk them, chunk item by item from the
    work list (B9c masking row i of item k by 32k + i) and merged in slot
    order, equal the plain walks bit for bit (z as int32, ids): a grid 4
    tiles wide (the packed rounding of tile x offsets up to 384), a tile of
    1,152 rows (36 items) with +0.0 / -0.0 ties across item boundaries,
    and an r_cap short of the layout. B9c's dead slots hold rows that win
    where they are not masked."""
    args, _fn, ref = _packed_args(walk, case)
    rows, rowptr = args[:2]
    r_cap, n_tiles = rows.shape[0], args[-1]
    rp = torch.clamp(rowptr, 0, r_cap)
    slots, tiles, items = RS.subtile_work_items(rowptr, r_cap)
    first, n = RS.subtile_items(rp)
    assert int(n.sum()) == slots.numel() == int(rp[-1]) // RS.ITEM_R
    assert torch.equal(slots, first[tiles] + items)
    assert int(slots.max()) < RS.subtile_n_slots(r_cap, n_tiles)
    depth = args[2] if walk == "B9c" else None
    z, e = _sliced_packed(rows, rowptr, depth, args[-2], n_tiles)
    z_r, e_r = ref(*args)
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 1000
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))
    if depth is not None:  # unmasked, the dead slots' backdrops show
        _z_u, e_u = RS.tile_eval_packed_ref(rows, rowptr, *args[-2:])
        assert int((e_u != e_r).sum()) > 100
    if case != "grid":  # the boundary ties: the earlier +0.0
        zt = z[-1][:, :16]
        assert int((zt == 0.0).sum()) > 20
        assert not torch.signbit(zt[zt == 0.0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("bins", sorted(BINS))
def test_shaded_kernel_on_the_work_list_equals_plain_on_cuda(
        cuda_device, bins, zero_counts):
    """B8's work-item walk and merge on the random bins (a 1,150-entry bin
    over 19 items with boundary ties, one deep tile): rgb bit for bit
    equal to the plain version; one call counts one launch."""
    sizes, tiles_x = BINS[bins]
    data, offs = _shaded_entries(8, sizes, tiles_x)
    args = (torch.from_numpy(data).to(cuda_device),
            torch.from_numpy(offs).to(cuda_device),
            _light_vector().to(cuda_device), tiles_x, len(sizes))
    rgb = RB.tile_eval_bins_shaded(*args)
    want = RB.tile_eval_bins_shaded_ref(*args)
    torch.cuda.synchronize()
    assert RB.launches_shaded == 1
    assert torch.equal((rgb + 0.0).view(torch.int32),
                       (want + 0.0).view(torch.int32))
    assert int((rgb.amax(1) > 0).sum()) > 500


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUPED))
def test_grouped_skip_kernel_on_the_work_list_equals_plain_on_cuda(
        cuda_device, case, zero_counts):
    """B1's slab work items and merge on the random layouts (a group far
    deeper than the rest, clamped rowptr, one group): z and ids bit for
    bit equal to the plain walk; one call counts one launch."""
    depths, r_cap = GROUPED[case]
    lay = [x.to(cuda_device) for x in _grouped_entries(11, depths, r_cap)]
    z, e = RG.tile_eval_grouped_skip(*lay, len(depths))
    z_r, e_r = RG.tile_eval_grouped_skip_ref(*lay, len(depths))
    torch.cuda.synchronize()
    assert RG.launches == 1
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 300
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUPED))
def test_grouped_kernel_on_the_work_list_equals_plain_on_cuda(
        cuda_device, case, zero_counts):
    """B9d's slab work items and merge on the random layouts with every
    skip at 0 (a group of 37 slabs with +0.0 / -0.0 boundary ties, clamped
    rowptr and the re-read live rows under it, one group): z and ids bit
    for bit equal to the plain walk; one call counts one launch."""
    depths, r_cap = GROUPED[case]
    rows, rowptr, gdepth, _gskip, xl, yl = (
        x.to(cuda_device) for x in _grouped_entries(11, depths, r_cap))
    z, e = RG.tile_eval_grouped(rows, rowptr, gdepth, xl, yl, len(depths))
    z_r, e_r = RG.tile_eval_grouped_ref(rows, rowptr, gdepth, xl, yl,
                                        len(depths))
    torch.cuda.synchronize()
    assert RG.launches_grouped == 1
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 300
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DIRECT))
def test_direct_kernel_on_the_work_list_equals_plain_on_cuda(
        cuda_device, case, zero_counts):
    """B9e's slab work items (strips staged per slot, the gchunks prefix
    formed on the device) and merge on the sliced test's layouts: z and
    ids bit for bit equal to the plain walk; one call counts one
    launch."""
    lay, G, _n_pairs = _direct_layout(case)
    lay = [x.to(cuda_device) for x in lay]
    z, e = RG.tile_eval_direct(*lay, G)
    z_r, e_r = RG.tile_eval_direct_ref(*lay, G)
    torch.cuda.synchronize()
    assert RG.launches_direct == 1
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 300
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_CASES)
def test_k2_kernel_on_the_work_list_equals_plain_on_cuda(cuda_device, case,
                                                         zero_counts):
    """B9f's slab work items and merge on the sliced test's layouts (odd
    skips, a group of 37 slabs, clamped rowptr, one group, the K2 and K4
    builds): z and ids bit for bit equal to the plain walk; one call counts
    one launch."""
    lay, G = _k2_layout(case)
    lay = [x.to(cuda_device) for x in lay]
    z, e = RG.tile_eval_grouped_k2(*lay, G)
    z_r, e_r = RG.tile_eval_grouped_k2_ref(*lay, G)
    torch.cuda.synchronize()
    assert RG.launches_k2 == 1
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 300
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SUBTILES))
def test_subtile_kernel_on_the_work_list_equals_plain_on_cuda(
        cuda_device, case, zero_counts):
    """B9a's chunk work items and merge on the sliced test's layouts (4
    tiles wide, a tile of 36 items with boundary ties, an overflowing
    r_cap): z and ids bit for bit equal to the plain walk; one call counts
    one launch."""
    n_rows, tiles_x, r_cap = SUBTILES[case]
    rows, rowptr = (x.to(cuda_device) for x in _subtile_entries(
        12, n_rows, tiles_x, r_cap))
    z, e = RS.tile_eval_subtile(rows, rowptr, tiles_x, len(n_rows))
    z_r, e_r = RS.tile_eval_subtile_ref(rows, rowptr, tiles_x, len(n_rows))
    torch.cuda.synchronize()
    assert RS.launches == 1
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 1000
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PACKED))
@pytest.mark.parametrize("walk", sorted(PACKED_WALKS))
def test_packed_kernel_on_the_work_list_equals_plain_on_cuda(
        cuda_device, walk, case, zero_counts):
    """B9b's and B9c's chunk work items and merge on the sliced test's
    layouts (4 tiles wide, a tile of 36 items with boundary ties, an
    overflowing r_cap; B9c's dead slots holding winning rows): z and ids
    bit for bit equal to the plain walks; one call counts one launch."""
    args, fn, ref = _packed_args(walk, case, cuda_device)
    z, e = fn(*args)
    z_r, e_r = ref(*args)
    torch.cuda.synchronize()
    assert (RS.launches_packed, RS.launches_packed_d) == {
        "B9b": (1, 0), "B9c": (0, 1)}[walk]
    assert torch.equal(e, e_r) and int((e >= 0).sum()) > 1000
    assert torch.equal(z.view(torch.int32), z_r.view(torch.int32))


@pytest.mark.cuda
def test_exactness_canary_on_cuda(cuda_device, zero_counts):
    """``utils/exactness.run_checks`` on the card: B3 and B7' at the
    reference's canary shape [40, 69632] and the float32 identity product
    bit for bit; each pack launches once per span."""
    from ascii_renderer_tpu_torch.utils import exactness
    checks = exactness.run_checks(cuda_device)
    assert exactness.verdict(checks) == "ok", checks
    assert (PK.launches, PK.launches_split) == (2, 2)
