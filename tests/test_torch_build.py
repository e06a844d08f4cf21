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
from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import pack as PK
from ascii_renderer_tpu_torch.ops import raster_group as RG
from ascii_renderer_tpu_torch.ops import setup2dh as S

torch.set_num_threads(2)

KERNEL_MODULES = (S, PK, RG)


def _walk_inputs(device, T=1500, n_attrs=6, seed=0):
    """Setup inputs and the grouped-walk layout of a random 48x96 frame."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (3 * T, 3)).astype(np.float32)
    attrs = rng.uniform(-1, 1, (3 * T, n_attrs)).astype(np.float32)
    pos9 = torch.from_numpy(pos).reshape(T, 3, 3).permute(1, 2, 0).reshape(
        9, T).contiguous().to(device)
    attrs_t = torch.from_numpy(attrs).reshape(T, 3 * n_attrs).t().contiguous(
        ).to(device)
    mvp = R.camera_mvp(Camera.create(pos=(2.5, 1.5, 3.0), yaw=-2.3,
                                     pitch=-0.3), 48, 96, 0.5)
    return pos9, attrs_t, mvp


def _layout(cm, bbox, grp_cap=6):
    tw = -(-(cm.shape[0] - 16) // 8) * 8
    src16, _table = PK.pack_channels_split_blocked_ref(cm, [(0, 16),
                                                            (16, 16 + tw)])
    keys = R._subtile_pair_keys_bbox(bbox, 48, 96, big_cap=1024)
    return RG.build_packed_rows_grouped_kgather(
        src16, keys, 1, 6, 32 * 512, 1 << 16, grp_cap, 8)


@pytest.fixture
def zero_counts():
    saved = [m.launches for m in KERNEL_MODULES]
    for m in KERNEL_MODULES:
        m.launches = 0
    yield
    for m, v in zip(KERNEL_MODULES, saved):
        m.launches = v


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
    assert [m.launches for m in KERNEL_MODULES] == [0, 0, 0]


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
        "setup2dh.cu", "pack.cu", "raster_group.cu"}
    for flag in ("-fmad=false", "arch=compute_90a,code=sm_90a"):
        assert flag in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)


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
