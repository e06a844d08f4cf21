"""Port parity for the path tracer's scene side: the atlas IO, the scene
builder (spheres, triangles, quads, planes, lights, atlas), the demo
scenes, the megakernel's entry / atlas pack and ``utils.from_jax``
against the JAX package, from the same inputs."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ascii_renderer_tpu.atlas import io as JIO
from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.ops import pt_kernel as JPK
from ascii_renderer_tpu.scene import builder as JB
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu_torch.atlas import io as TIO
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.ops import pt_kernel as TPK
from ascii_renderer_tpu_torch.scene import builder as TB
from ascii_renderer_tpu_torch.scene import demo as TD
from ascii_renderer_tpu_torch.utils.from_jax import scene_from_numpy

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                     "atlas_wide_32x16.bin")


def _wide_quad(mod, atlas):
    sb = mod.SceneBuilder()
    sb.add_quad([-4, -2, 0], [4, -2, 0], [4, 2, 0], [-4, 2, 0],
                mod.MaterialIds.WHITE, (0, 16), (32, 16), (32, 0), (0, 0))
    sb.add_triangle([0, 0, -1], [1, 0, -1], [0, 1, -1], mod.MaterialIds.RED,
                    (1, 2), (3, 4), (70000, -5))
    sb.add_plane([0, 2, 0], -1.0, mod.MaterialIds.MIRROR)
    sb.add_rect([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], 99)
    sb.set_area_light([50, 50, 50], 0.1, auto=False)
    sb.set_atlas(atlas)
    return sb


def _builders(name):
    """(JAX SceneBuilder, port SceneBuilder) for a named test scene."""
    if name == "demo":
        pair = (JD.create_demo_scene(), TD.create_demo_scene())
        for sb, atlas in zip(pair, (JIO.demo_atlas(), TIO.demo_atlas())):
            sb.set_atlas(atlas)
        return pair
    if name == "rt_demo":
        return JD.create_rt_demo_scene(), TD.create_rt_demo_scene()
    if name == "wide_atlas_quad":
        return (_wide_quad(JB, JIO.load_atlas(ASSET, 32, 16)),
                _wide_quad(TB, TIO.load_atlas(ASSET, 32, 16)))
    raise KeyError(name)


def _leaves(scene):
    return {f.name: np.asarray(getattr(scene, f.name))
            for f in dataclasses.fields(scene) if f.name != "camera"}


def test_atlas_io_equals_jax():
    for args in ((), (26, 24), (64, 64), (128, 64)):
        np.testing.assert_array_equal(TIO.demo_atlas(*args),
                                      JIO.demo_atlas(*args))
    np.testing.assert_array_equal(TIO.demo_atlas_wide(),
                                  JIO.demo_atlas_wide())
    arr = TIO.load_atlas(ASSET, 32, 16, strict=True)
    np.testing.assert_array_equal(arr, JIO.load_atlas(ASSET, 32, 16))
    np.testing.assert_array_equal(arr, TIO.demo_atlas_wide())
    bad = arr.copy()
    bad[0, 0, 3] = 7
    np.testing.assert_array_equal(TIO.valid_mask(bad), JIO.valid_mask(bad))
    with pytest.raises(ValueError, match="size mismatch"):
        TIO.load_atlas(ASSET, 32, 15)


@pytest.mark.parametrize("name", ["demo", "rt_demo", "wide_atlas_quad"])
@pytest.mark.parametrize("min_pad", [1, 8])
def test_scene_fields_equal_jax_build(name, min_pad):
    jsb, tsb = _builders(name)
    js = jsb.build(min_pad=min_pad)
    ts = tsb.build(min_pad=min_pad, device="cpu")
    for k, want in _leaves(js).items():
        got = getattr(ts, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for f in dataclasses.fields(js.camera):
        np.testing.assert_array_equal(
            getattr(ts.camera, f.name).numpy(),
            np.asarray(getattr(js.camera, f.name)), err_msg=f.name)
    assert ts.atlas_enabled == js.atlas_enabled
    for pred in ("sph_valid", "tri_valid", "quad_valid", "pln_valid"):
        np.testing.assert_array_equal(getattr(ts, pred)().numpy(),
                                      np.asarray(getattr(js, pred)()))


def test_builder_capacities_and_material_fallback():
    sb = TB.SceneBuilder(max_spheres=2, max_tris=1, max_quads=1,
                         max_planes=1)
    for i in range(3):
        sb.add_sphere([i, 0, 0], 1.0, 42)  # unknown id -> WHITE
        sb.add_triangle()
        sb.add_quad()
        sb.add_plane()
    s = sb.build(min_pad=1, device="cpu")
    assert (int(s.n_sph), int(s.n_tri), int(s.n_quad), int(s.n_pln)) == \
        (2, 1, 1, 1)
    assert s.sph_mat.tolist() == [TB.MaterialIds.WHITE] * 2
    with pytest.raises(ValueError):
        sb.add_sphere([float("nan"), 0, 0])
    assert not s.atlas_enabled


def _unpack_jax_atlas(flat, texels):
    """JAX atlas layouts -> packed rgba uint32 per texel."""
    flat = np.asarray(flat)
    if JPK.use_gather_layout(texels):
        return flat.view(np.uint32).reshape(-1)[:texels]
    packed = flat[:128].T.reshape(-1)[:texels].astype(np.int64)
    alpha = flat[128:].T.reshape(-1)[:texels].astype(np.int64)
    return ((packed << 8) | alpha).astype(np.uint32)


def _packs_equal(js, ts):
    """Both packers' entry streams: flags, shading and UVs exactly, the
    float channels within 1 ulp (the JAX packer's sums may fuse); atlas
    w, h and sph_rows equal. Returns (JAX pack, port pack)."""
    jp = JPT.pack_scene_entries(js)
    tp = TPT.pack_scene_entries(ts)
    assert tp[2:] == jp[2:]  # atlas w, h, sph_rows
    want = np.asarray(jp[0]).reshape(-1, TPK.N_CHAN)
    got = tp[0].numpy().reshape(-1, TPK.N_CHAN)
    assert got.shape == want.shape
    exact = [TPK.C_KIND, TPK.C_ISLIGHT, TPK.C_ISSPEC, TPK.C_TEXTURABLE,
             TPK.C_SHR, TPK.C_SHG, TPK.C_SHB] + list(
                 range(TPK.C_UVAX, TPK.C_UVCY + 1))
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32))
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()
    return jp, tp


@pytest.mark.parametrize("name,atlas", [
    ("demo", (32, 32)), ("demo", (26, 24)), ("demo", (128, 64)),
    ("wide_atlas_quad", None), ("rt_demo", None)])
def test_pack_scene_entries_equals_jax(name, atlas):
    jsb, tsb = _builders(name)
    if atlas is not None:
        jsb.set_atlas(JIO.demo_atlas(*atlas))
        tsb.set_atlas(TIO.demo_atlas(*atlas))
    js, ts = jsb.build(min_pad=1), tsb.build(min_pad=1, device="cpu")
    jp, tp = _packs_equal(js, ts)
    texels = jp[2] * jp[3]
    if texels:
        np.testing.assert_array_equal(tp[1].numpy().view(np.uint32),
                                      _unpack_jax_atlas(jp[1], texels))
    else:
        assert not ts.atlas_enabled


def test_pack_rejects_atlases_above_the_kernel_budget():
    """An atlas above MAX_ATLAS_TEXELS stays out of the kernel's pack, as
    JAX's packer leaves it out: the prims alone, atlas w = h = 0 (such a
    scene renders through the XLA core)."""
    jsb, tsb = _builders("demo")
    jsb.set_atlas(JIO.demo_atlas(512, 256))
    tsb.set_atlas(TIO.demo_atlas(512, 256))
    js, ts = jsb.build(min_pad=1), tsb.build(min_pad=1, device="cpu")
    jp, tp = _packs_equal(js, ts)
    assert tp[2:4] == (0, 0) and ts.atlas_enabled
    assert not TPT.atlas_ok(ts)


def test_scene_from_jax_carries_spheres_quads_and_atlas():
    jsb, tsb = _builders("demo")
    js = jsb.build(min_pad=1)
    d = _leaves(js)
    d["camera"] = {f.name: np.asarray(getattr(js.camera, f.name))
                   for f in dataclasses.fields(js.camera)}
    ts = scene_from_numpy(d, "cpu")
    own = tsb.build(min_pad=1, device="cpu")
    for k, want in d.items():
        if k != "camera":
            np.testing.assert_array_equal(getattr(ts, k).numpy(), want,
                                          err_msg=k)
            np.testing.assert_array_equal(getattr(own, k).numpy(), want,
                                          err_msg=k)
    assert ts.camera.pos.device.type == "cpu"
    for a, b in zip(TPT.pack_scene_entries(ts)[:2],
                    TPT.pack_scene_entries(own)[:2]):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        scene_from_numpy(d)  # the device is the caller's to name


def test_kernel_layout_constants_equal_jax():
    """The entry channels, block shape and atlas budget are the JAX
    kernel's; the 32x32 demo atlas is in its gather layout and 128x64 in
    its one-hot layout (both unpacked above)."""
    assert JPK.use_gather_layout(32 * 32)
    assert not JPK.use_gather_layout(128 * 64)
    assert TPK.MAX_ATLAS_TEXELS == JPK.MAX_ATLAS_TEXELS
    assert (TPK.N_CHAN, TPK.PACK, TPK.BH, TPK.BW) == (
        JPK.N_CHAN, JPK.PACK, JPK.BH, JPK.BW)
    for c in ("C_KIND", "C_AX", "C_E1X", "C_NX", "C_D0", "C_R1X", "C_C1",
              "C_R2X", "C_R2Y", "C_R2Z", "C_C2", "C_BADS", "C_SHR",
              "C_ISLIGHT", "C_ISSPEC", "C_TEXTURABLE", "C_UVAX", "C_UVCY"):
        assert getattr(TPK, c) == getattr(JPK, c), c
