"""The megakernel's frame form (``ops/pt_kernel.trace_frame``: one origin
and the light's parameters by value, each ray's RNG id formed from its
place in the stream) and the frame set-up around it
(``backends/pathtrace._FrameRays``), on the CPU through the plain
versions; and the forms the sample rays (X7, ``ops/ray_grid.pt_rays``)
and the batch fold (X14, ``ops/pt_reduce.fold``) take by launch size.

Tolerances: the frame form's plain version equals the per-ray plain
version bit for bit on the same rays (every output, the pad rays too); a
``render_pt`` frame through the frame form equals the frame the per-ray
form gives with the origin block, uid block and light copy the set-up
used to stage (rgb bit for bit, alpha exactly); a band frame stays within
atol 1e-5 of JAX's interpreted kernel path, alpha exactly (the bound of
``tests/test_torch_pt_frame.py``). Inputs are seeded with numpy; JAX runs
on its CPU backend."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.atlas import io as JIO
from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu_torch.atlas import io as TIO
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.ops import pt_kernel as PK
from ascii_renderer_tpu_torch.ops import pt_reduce as PR
from ascii_renderer_tpu_torch.ops import ray_grid as RYG
from ascii_renderer_tpu_torch.scene import demo as TD
from ascii_renderer_tpu_torch.tools.xla_inputs import pixel_order, pt_outputs

torch.set_num_threads(2)

LIGHT = (16.86, 10.76, 8.2)
ROWS, COLS = 8, 24
POSE = dict(pos=(0.0, 2.5, 6.0), yaw=-math.pi / 2)
# (case, samples, row band or None, compacted)
FRAME_CASES = (("full probe", 1, None, False), ("full batch", 3, None, False),
               ("band batch", 3, (2, 4), False),
               ("compacted batch", 3, None, True),
               ("compacted band probe", 1, (4, 3), True))


@functools.lru_cache(maxsize=None)
def _scene():
    sb = TD.create_demo_scene()
    sb.set_atlas(TIO.demo_atlas())
    scene = sb.build(min_pad=1, device="cpu")
    return scene, TPT.pack_scene_entries(scene)


def _light(scene, t=0.0):
    lc, lr = TPT.get_light_sphere(scene, t)
    return TPT._light_host(lc, lr, torch.tensor(LIGHT) * 1.3).tolist()


def _np_uids(nblk, pc, npix, uid0, pix_uid):
    """Each ray's RNG id, ray r = s * pc + p, as a plain numpy loop over
    samples would write them (int64, before the int32 view)."""
    r = np.arange(nblk * 1024, dtype=np.int64)
    s, p = r // pc, r % pc
    base = (np.asarray(pix_uid, np.int64)[p] if pix_uid is not None
            else uid0 + p)
    return s * npix + base


def _frame_rays(case):
    """(rays rd [nblk, 8, 128, 3], pc, npix, uid0, pix_uid, gate) of a
    launch of the frame at ROWS x COLS: X7's plain rays, a seeded
    compacted order and its gate."""
    _name, samples, band, compacted = FRAME_CASES[case]
    row_lo, n_rows = band if band else (0, ROWS)
    pc = n_rows * COLS
    cam = TC.Camera.create(**POSE)
    basis = TC.camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    pix_uid = gate = None
    if compacted:
        act, order = pixel_order(n_rows, COLS, 0.4, seed=case)
        pix_uid = torch.from_numpy(order + row_lo * COLS)
        live = torch.arange(pc) < int(act.sum())
        gate = TPT._block_gate(live.repeat(samples))
    kw = dict(row_lo=row_lo, n_rows=n_rows, pix_uid=pix_uid, device="cpu")
    if samples > 1:
        kw.update(fet0=torch.from_numpy(pt_outputs(pc + 7, seed=case)[4]),
                  samples=samples, s0=samples, seed=TPT.batch_seed_of(3, 1))
    rd = RYG.pt_rays(basis, ROWS, COLS, 0.5, **kw)
    return rd, pc, ROWS * COLS, row_lo * COLS, pix_uid, gate


@pytest.mark.parametrize("case", range(len(FRAME_CASES)),
                         ids=[c[0] for c in FRAME_CASES])
def test_frame_uids_follow_the_stream(case):
    """frame_uids: s * npix + the slot's pixel uid, int32 [nblk, 8,
    128], pad rays included; as a numpy loop forms them."""
    rd, pc, npix, uid0, pix_uid, _g = _frame_rays(case)
    nblk = rd.shape[0]
    got = PK.frame_uids(nblk, pc, npix, uid0, pix_uid)
    assert got.shape == (nblk, 8, 128) and got.dtype == torch.int32
    want = _np_uids(nblk, pc, npix, uid0, pix_uid)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)
    if pix_uid is None and uid0 == 0:  # a full frame: the stream position
        np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                      np.arange(nblk * 1024))


def test_frame_uids_wrap_as_int32():
    """Past 2^31 the ids wrap as the kernel's uint32 arithmetic does."""
    got = PK.frame_uids(1, 1, 2 ** 31 - 5, 3)
    want = (np.arange(1024, dtype=np.int64) * (2 ** 31 - 5) + 3) % 2 ** 32
    np.testing.assert_array_equal(
        got.reshape(-1).numpy().astype(np.int64) % 2 ** 32, want)


@pytest.mark.parametrize("case", range(len(FRAME_CASES)),
                         ids=[c[0] for c in FRAME_CASES])
def test_trace_frame_plain_equals_the_per_ray_plain_version(case):
    """The frame form's plain version on the same rays as the per-ray
    plain version given the light as a tensor, the origin on every ray
    and the uids of a numpy loop: every output bit for bit, pads too."""
    scene, (prim, atlas, aw, ah, sph_rows) = _scene()
    rd, pc, npix, uid0, pix_uid, gate = _frame_rays(case)
    nblk = rd.shape[0]
    light = _light(scene, 0.7)
    origin = [0.25, 2.5, 6.0]
    kw = dict(bounces=3, nee=True, atlas_w=aw, atlas_h=ah,
              sph_rows=sph_rows, block_active=gate)
    got = PK.trace_frame(light, origin, prim, rd, 11, atlas, pc=pc,
                         npix=npix, uid0=uid0, pix_uid=pix_uid, **kw)
    uid = torch.from_numpy(_np_uids(nblk, pc, npix, uid0, pix_uid).astype(
        np.int32)).reshape(nblk, 8, 128)
    want = PK.trace_blocks_raw_ref(
        torch.tensor(light), prim,
        torch.tensor(origin).expand(nblk, 8, 128, 3).contiguous(), rd, 11,
        atlas, **kw, uid=uid)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert bool((got[0] != 0).any())


def test_trace_frame_wrapper_runs_the_plain_version_on_cpu():
    """CPU: the plain version, nothing launched; bad arguments raise;
    another device reaches the kernel path, which takes CUDA tensors
    only."""
    scene, (prim, atlas, aw, ah, sph_rows) = _scene()
    rd, pc, npix, uid0, pix_uid, gate = _frame_rays(3)
    kw = dict(pc=pc, npix=npix, uid0=uid0, pix_uid=pix_uid, bounces=1,
              nee=False, atlas_w=aw, atlas_h=ah, sph_rows=sph_rows,
              block_active=gate)
    light = _light(scene)
    launches = PK.launches
    got = PK.trace_frame(light, (0, 2.5, 6), prim, rd, 1, atlas, **kw)
    want = PK.trace_frame_ref(light, (0, 2.5, 6), prim, rd, 1, atlas, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert PK.launches == launches
    with pytest.raises(ValueError, match="8 floats"):
        PK.trace_frame(light[:7], (0, 2.5, 6), prim, rd, 1, atlas, **kw)
    with pytest.raises(ValueError, match="pix_uid"):
        PK.trace_frame(light, (0, 2.5, 6), prim, rd, 1, atlas,
                       **dict(kw, pix_uid=pix_uid.long()))
    with pytest.raises(ValueError, match="rd must be"):
        PK.trace_frame(light, (0, 2.5, 6), prim, rd[..., :64, :], 1, atlas,
                       **kw)
    with pytest.raises(ValueError, match="CUDA"):
        PK.trace_frame(light, (0, 2.5, 6), prim.to("meta"), rd.to("meta"),
                       1, atlas.to("meta"),
                       **dict(kw, pix_uid=pix_uid.to("meta"),
                              block_active=gate.to("meta")))
    assert PK.launches == launches


def _per_ray_frame(scene, packed, cam, *, rows, cols, spp, B, row_lo=0,
                   n_rows=None, pixel_active=None, seed=3):
    """render_pt's kernel path through the per-ray form, with the inputs
    its set-up used to stage: the origin block (0 past the rays), the
    light on the tensor path, the uid block of a band or a compacted
    stream (0 past the rays), the block gates by launch size."""
    prim, atlas, aw, ah, sph_rows = packed
    band = TC.band_of(rows, row_lo, n_rows)
    pc, n_batches = band * cols, -(-spp // B)
    lc, lr = TPT.get_light_sphere(scene, 0.0)
    params = TPT._params(lc, lr, torch.tensor(LIGHT) * 1.3, "cpu")
    basis = TC.camera_basis(cam.yaw, cam.pitch, cam.fov_y)
    pix_uid = slot = None
    mask = None
    if pixel_active is not None:
        act = pixel_active.reshape(-1).long()
        local = torch.arange(pc)
        slot = torch.argsort((1 - act) * pc + local).to(torch.int32)
        pix_uid = slot + row_lo * cols
        mask = local < act.sum()
    pu = pix_uid if pix_uid is not None else (
        torch.arange(pc, dtype=torch.int32) + row_lo * cols)

    def trace(rd, samples, sd):
        n = samples * pc
        nblk = rd.shape[0]
        ro = torch.zeros((nblk * 1024, 3))
        ro[:n] = cam.pos.to(torch.float32)
        uid = None
        if pixel_active is not None or band != rows:
            uid = torch.zeros(nblk * 1024, dtype=torch.int32)
            uid[:n] = (torch.arange(samples, dtype=torch.int32)[:, None]
                       * (rows * cols) + pu[None, :]).reshape(-1)
            uid = uid.view(nblk, 8, 128)
        gate = None if mask is None else TPT._block_gate(mask.repeat(samples))
        return PK.trace_blocks_raw_ref(
            params, prim, ro.view(nblk, 8, 128, 3), rd, sd, atlas,
            bounces=2, nee=True, atlas_w=aw, atlas_h=ah, sph_rows=sph_rows,
            block_active=gate, uid=uid)

    rays = dict(row_lo=row_lo, n_rows=band, pix_uid=pix_uid, device="cpu")
    probe = trace(RYG.pt_rays(basis, rows, cols, 0.5, **rays), 1, seed)
    state = PR.new_state(pc, "cpu")
    for b in range(n_batches):
        bs = TPT.batch_seed_of(seed, b)
        rd = RYG.pt_rays(basis, rows, cols, 0.5, **rays, fet0=probe[4],
                         samples=B, s0=b * B, seed=bs)
        cr, cg, cb, ovf, _f = trace(rd, B, bs)
        last = b == n_batches - 1
        out = PR.fold(state, cr, cg, cb, ovf, min(B, spp - b * B),
                      first=b == 0, probe=probe[:4] if last else None,
                      spp=spp, slot=slot)
    return out[0].reshape(band, cols, 3), out[1].reshape(band, cols)


@pytest.mark.parametrize("band,compacted", [(None, False), ((2, 5), False),
                                            (None, True), ((3, 4), True)],
                         ids=["full", "band", "compacted",
                              "compacted band"])
def test_render_pt_frame_equals_the_per_ray_frame(band, compacted):
    """render_pt (the frame form, nothing staged but the counters) gives
    the frame of the per-ray form on the staged origin and uid blocks:
    rgb bit for bit, alpha exactly; spp 5 in batches of 2 (the last past
    spp)."""
    scene, packed = _scene()
    cam = TC.Camera.create(**POSE)
    row_lo, n_rows = band if band else (0, None)
    n = n_rows or ROWS
    act = None
    if compacted:
        act = torch.from_numpy(pixel_order(n, COLS, 0.5, seed=2)[0])
    kw = dict(rows=ROWS, cols=COLS, spp=5, row_lo=row_lo, n_rows=n_rows)
    rgb, a = TPT.render_pt(scene, cam, 0.0, 3, pixel_aspect=0.5,
                           bounces=2, light_color=LIGHT, sample_batch=2,
                           pixel_active=act, packed=packed, **kw)
    want_rgb, want_a = _per_ray_frame(scene, packed, cam, B=2,
                                      pixel_active=act, **kw)
    assert torch.equal(a, want_a) and bool((a != 255).any())
    if act is not None:  # an inactive pixel's values are unspecified
        rgb, want_rgb = rgb[act], want_rgb[act]
    assert torch.equal(rgb.view(torch.int32), want_rgb.view(torch.int32))


def test_render_pt_band_equals_jax_kernel_path():
    """A row band (rows 2-5 of 8 x 24; spp 5, batches of 2, 2 bounces):
    the port's render_pt within atol 1e-5 of JAX's interpreted kernel
    path's band, alpha exactly."""
    jsb = JD.create_demo_scene()
    jsb.set_atlas(JIO.demo_atlas())
    fn = jax.jit(functools.partial(
        JPT.render_pt, rows=ROWS, cols=COLS, pixel_aspect=0.5, spp=5,
        bounces=2, light_color=LIGHT, sample_batch=2, use_kernel=True,
        row_lo=2, n_rows=4))
    j_rgb, j_a = (np.asarray(x) for x in fn(
        jsb.build(min_pad=1), JC.Camera.create(pos=(0, 2.5, 6),
                                               yaw=-np.pi / 2),
        jnp.float32(0), jax.random.key(4)))
    scene, packed = _scene()
    rgb, a = TPT.render_pt(
        scene, TC.Camera.create(**POSE), 0.0, TPT.frame_seed_of(4),
        rows=ROWS, cols=COLS, pixel_aspect=0.5, spp=5, bounces=2,
        light_color=LIGHT, sample_batch=2, row_lo=2, n_rows=4,
        packed=packed)
    np.testing.assert_array_equal(a.numpy(), j_a)
    assert (j_a != 255).any()
    np.testing.assert_allclose(rgb.numpy(), j_rgb, atol=1e-5, rtol=0)


def test_frame_set_up_stages_no_ray_block():
    """A full frame's or a band's set-up holds the light and the origin
    as host floats and one counter a launch, and nothing a ray; a
    compacted one adds its order, uids and gates."""
    scene, _p = _scene()
    cam = TC.Camera.create(**POSE)
    light = _light(scene)
    for row_lo, band in ((0, ROWS), (2, 4)):
        fr = TPT._FrameRays(light, TC.camera_floats(cam)[:3], ROWS, COLS,
                            row_lo, band, 2, 3, None, "cpu")
        assert fr.light == light and fr.origin == [0.0, 2.5, 6.0]
        assert (fr.pc, fr.npix, fr.uid0) == (band * COLS, ROWS * COLS,
                                             row_lo * COLS)
        assert fr.counters.shape == (4,) and not fr.counters.any()
        assert fr.pix_uid is None and fr.slot is None and not fr._gates
        assert all(isinstance(x, float) for x in fr.light + fr.origin)
    act = torch.from_numpy(pixel_order(4, COLS, 0.3, seed=5)[0])
    fr = TPT._FrameRays(light, TC.camera_floats(cam)[:3], ROWS, COLS, 2, 4,
                        2, 3, act, "cpu")
    assert torch.equal(fr.pix_uid, fr.slot + 2 * COLS)
    assert set(fr._gates) == {1, 2}


# --------------------------------------------------------------------------
# the kernels' forms by launch size
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pc,samples,per", [
    (518400, 8, 8), (518400, 1, 1), (3456, 32, 1), (270336, 4, 4),
    (135168, 4, 2), (129600, 8, 3), (1152, 32, 1)])
def test_x7_samples_per_thread(pc, samples, per):
    """Every sample of a slot in one thread where the slots fill the
    card (the HD arm's batch), one where they do not (96x36), a split
    between."""
    assert RYG.samples_per_thread(pc, samples) == per


def test_x14_forms_by_size():
    """The tile form below TILE_BELOW slots, a thread a slot from there."""
    assert PR.form_of(3456) == "tile" and PR.form_of(1152) == "tile"
    assert PR.form_of(32400) == "tile"
    assert PR.form_of(518400) == "slot" and PR.form_of(129600) == "slot"
    assert PR.form_of(PR.TILE_BELOW) == "slot"
    assert PR.form_of(PR.TILE_BELOW - 1) == "tile"
