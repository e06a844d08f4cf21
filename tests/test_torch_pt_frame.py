"""The path tracer's frame around its megakernel: the sample rays
(``ops/ray_grid.pt_rays``, X7) and the batch fold with the frame's
resolve (``ops/pt_reduce.fold``, X14), their plain versions against the
reference's arithmetic, and ``render_pt`` through them against JAX's
kernel path.

Tolerances: the rays bit for bit (JAX's eager ``batch_rays`` arithmetic:
``_hash_unit``, the jitter, the grid and its normalisation); the fold's
override, alpha and first-sample picks exactly, its totals within rtol
1e-5 of JAX's (``jnp.sum`` adds in another order than the port's
sample-by-sample fold); the fold bit for bit against an explicit float32
loop and under a permutation of the pixels; ``render_pt`` within atol
1e-5 of JAX's interpreted kernel path, alpha exactly. Inputs are seeded
with numpy; JAX runs on its CPU backend."""

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
from ascii_renderer_tpu_torch.ops import pt_reduce as PR
from ascii_renderer_tpu_torch.ops import ray_grid as RYG
from ascii_renderer_tpu_torch.scene import demo as TD
from ascii_renderer_tpu_torch.tools.xla_inputs import pixel_order, pt_outputs

torch.set_num_threads(2)

LIGHT = (16.86, 10.76, 8.2)
# the poster pose and a pose off the axes whose float32 basis XLA's trig
# and the port's libm give alike (asserted below)
POSES = ((-math.pi / 2, 0.0), (-1.234, 0.321))
ROWS, COLS = 12, 32
# (case, samples a batch, batch index, row band or None, compacted)
RAY_CASES = (("probe", 0, 0, None, False), ("batch 0", 3, 0, None, False),
             ("batch 1", 3, 1, None, False),
             ("compacted batch 1", 3, 1, None, True),
             ("band batch 1", 3, 1, (4, 5), False),
             ("compacted band probe", 0, 0, (4, 5), True),
             ("compacted band batch 0", 2, 0, (4, 5), True))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _cams(pose):
    yaw, pitch = POSES[pose]
    return (JC.Camera.create(pos=(0.0, 2.5, 6.0), yaw=yaw, pitch=pitch),
            TC.Camera.create(pos=(0.0, 2.5, 6.0), yaw=yaw, pitch=pitch))


def _jax_rays(jcam, row_lo, band, pix_uid, fet0, B, b, seed):
    """render_pt's rays as the reference computes them (eagerly): the
    centre grid of the band (primary_ray_grid), or under compaction its
    recomputation from the sorted uids (pathtrace.py:537-544); then the
    probe's centre rays, or batch_rays' hash jitter (:579-602)."""
    uu, vv, ww, focal = JC.camera_basis(jcam.yaw, jcam.pitch, jcam.fov_y)
    aspect = jnp.float32(COLS / ROWS) * jnp.float32(0.5)
    _ro, rd0, px, py = JPT.primary_ray_grid(
        jcam, ROWS, COLS, 0.5, row_lo=row_lo,
        n_rows=None if band == ROWS else band)
    if pix_uid is not None:
        uid = jnp.asarray(pix_uid)
        r_gl = (uid // COLS).astype(jnp.float32)
        c_gl = (uid % COLS).astype(jnp.float32)
        x_s = (c_gl + 0.5) / jnp.float32(COLS)
        y_s = (jnp.float32(ROWS - 1) - r_gl + 0.5) / jnp.float32(ROWS)
        px = ((-1.0 + 2.0 * x_s) * aspect).reshape(band, COLS)
        py = (-1.0 + 2.0 * y_s).reshape(band, COLS)
        rd0 = (px[..., None] * uu + py[..., None] * vv + focal * ww)
        rd0 = rd0 / jnp.linalg.norm(rd0, axis=-1, keepdims=True)
    else:
        uid = jnp.arange(band * COLS, dtype=jnp.int32) + row_lo * COLS
    if fet0 is None:
        return np.asarray(rd0).reshape(-1, 3)
    uid_sp = (jnp.arange(B, dtype=jnp.int32)[:, None] * jnp.int32(ROWS * COLS)
              + uid[None, :])
    s_idx = b * B + jnp.arange(B)
    jxu = JPT._hash_unit(uid_sp, jnp.int32(seed), 0x40000001)
    jyu = JPT._hash_unit(uid_sp, jnp.int32(seed), 0x40000002)
    r2 = jnp.stack([jxu, jyu], axis=-1).reshape(B, band, COLS, 2)
    rpof = 2.0 * (r2 - 0.5) / jnp.float32(ROWS)
    rpof = rpof.at[..., 0].multiply(aspect)
    fetched = (jnp.asarray(fet0) > 0.5).reshape(band, COLS)
    use_jit = (s_idx > 0)[:, None, None] & jnp.logical_not(fetched)[None]
    jx = jnp.where(use_jit, rpof[..., 0], 0.0)
    jy = jnp.where(use_jit, rpof[..., 1], 0.0)
    rd = ((px[None] + jx)[..., None] * uu + (py[None] + jy)[..., None] * vv
          + focal * ww)
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    return np.asarray(rd).reshape(-1, 3)


@pytest.mark.parametrize("case", range(len(RAY_CASES)),
                         ids=[c[0] for c in RAY_CASES])
@pytest.mark.parametrize("pose", range(len(POSES)))
def test_pt_rays_plain_equals_jax_batch_rays(pose, case):
    """X7's plain version (the port's CPU path) equals the reference's
    ray arithmetic bit for bit: the first samples * pc rays of the block,
    the pad rays 0."""
    _name, B, b, band_of, compacted = RAY_CASES[case]
    jcam, tcam = _cams(pose)
    basis = TC.camera_basis(tcam.yaw, tcam.pitch, tcam.fov_y)
    want_basis = JC.camera_basis(jcam.yaw, jcam.pitch, jcam.fov_y)
    for g, w in zip(basis, want_basis):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    row_lo, band = band_of if band_of else (0, ROWS)
    pc = band * COLS
    pix_uid = None
    if compacted:
        _act, order = pixel_order(band, COLS, 0.4, seed=case)
        pix_uid = order + row_lo * COLS
    fet0 = None
    if B:
        fet0 = pt_outputs(pc + 100, seed=case)[4]
    seed = TPT.batch_seed_of(5, b)
    want = _jax_rays(jcam, row_lo, band, pix_uid, None if fet0 is None
                     else fet0[:pc], max(B, 1), b, seed)
    got = RYG.pt_rays(
        basis, ROWS, COLS, 0.5, row_lo=row_lo, n_rows=band,
        pix_uid=None if pix_uid is None else torch.from_numpy(pix_uid),
        fet0=None if fet0 is None else torch.from_numpy(fet0),
        samples=max(B, 1), s0=b * max(B, 1), seed=seed if B else None,
        device="cpu")
    n = max(B, 1) * pc
    assert got.shape == (-(-n // 1024), 8, 128, 3)
    flat = got.reshape(-1, 3).numpy()
    np.testing.assert_array_equal(_bits(flat[:n]), _bits(want))
    assert not flat[n:].any()


def test_pt_rays_wrapper_runs_the_plain_version_on_cpu():
    """CPU: the plain version, nothing launched; another device reaches
    the kernel path, which takes CUDA tensors only; a batch needs its
    seed and the probe is one sample."""
    _jcam, tcam = _cams(0)
    basis = TC.camera_basis(tcam.yaw, tcam.pitch, tcam.fov_y)
    RYG.pt_launches = 0
    fet0 = torch.zeros(ROWS * COLS)
    got = RYG.pt_rays(basis, ROWS, COLS, 0.5, fet0=fet0, samples=2, seed=3,
                      device="cpu")
    want = RYG.pt_rays_ref(basis, ROWS, COLS, 0.5, fet0=fet0, samples=2,
                           seed=3, device="cpu")
    assert torch.equal(got, want) and RYG.pt_launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        RYG.pt_rays(basis, ROWS, COLS, 0.5, device="meta")
    with pytest.raises(ValueError, match="seed"):
        RYG.pt_rays(basis, ROWS, COLS, 0.5, fet0=fet0.to("meta"),
                    device="meta")
    with pytest.raises(ValueError, match="one sample"):
        RYG.pt_rays(basis, ROWS, COLS, 0.5, samples=2, device="meta")


@functools.lru_cache(maxsize=None)
def _scenes():
    jsb, tsb = JD.create_demo_scene(), TD.create_demo_scene()
    jsb.set_atlas(JIO.demo_atlas())
    tsb.set_atlas(TIO.demo_atlas())
    return jsb.build(min_pad=1), tsb.build(min_pad=1, device="cpu")


def _fold_inputs(pc, B, n_batches, seed):
    """Seeded megakernel outputs: the probe's (pc rays, padded to its
    blocks) and each batch's (B * pc rays, padded)."""
    def padded(n, s):
        return pt_outputs(-(-n // 1024) * 1024, seed=s)
    return padded(pc, seed), [padded(B * pc, seed + 1 + b)
                              for b in range(n_batches)]


def _port_fold(probe, batches, pc, B, spp, slot=None):
    """The port's frame end through ops/pt_reduce: a fold a batch, the
    last one resolving. Returns (rgb f32 [pc, 3], alpha u8 [pc])."""
    state = PR.new_state(pc, "cpu")
    tp = [torch.from_numpy(x) for x in probe]
    for b, outs in enumerate(batches):
        last = b == len(batches) - 1
        out = PR.fold(state, *(torch.from_numpy(x) for x in outs[:4]),
                      min(B, spp - b * B), first=b == 0,
                      probe=tp[:4] if last else None, spp=spp,
                      slot=None if slot is None else torch.from_numpy(slot))
        assert (out is None) != last
    return out


# (spp, sample batch, row band or None, compacted)
FOLD_CASES = ((4, 2, None, False), (5, 2, None, False), (3, 3, None, False),
              (40, 32, None, False), (5, 2, None, True), (6, 4, (2, 3), True),
              (4, 4, (6, 6), False))


@pytest.mark.parametrize("case", range(len(FOLD_CASES)))
def test_fold_equals_jax_batch_step_and_frame_end(monkeypatch, case):
    """The reference's render_pt(use_kernel=True) on a megakernel that
    returns seeded outputs (its own batch_step, scan and frame end; its
    compaction's key sorts) against the port's folds on the same outputs:
    alpha, the overrides and their colours exact, the totals within rtol
    1e-5 (summed in another order)."""
    spp, B, band_rows, compacted = FOLD_CASES[case]
    row_lo, band = band_rows if band_rows else (0, 6)
    rows, cols = 12 if band_rows else 6, 16
    pc = band * cols
    n_batches = -(-spp // B)
    probe, batches = _fold_inputs(pc, B, n_batches, 10 * case)
    frame_seed = 9
    seeds = np.asarray([TPT.batch_seed_of(frame_seed, b)
                        for b in range(n_batches)], np.int32)

    def fake(scene, ro, rd, seed, *a, **k):
        n = int(np.prod(rd.shape[:-1]))
        if rd.ndim == 3:
            return tuple(jnp.asarray(x[:n]) for x in probe)
        idx = jnp.argmax(jnp.asarray(seeds) == seed)
        return tuple(jnp.asarray(np.stack([o[i][:n] for o in batches]))[idx]
                     for i in range(5))

    monkeypatch.setattr(JPT, "trace_eye_paths_kernel_packed", fake)
    js, _ts = _scenes()
    act, order = pixel_order(band, cols, 0.5, seed=case)
    j_rgb, j_a = JPT.render_pt(
        js, JC.Camera.create(pos=(0, 2.5, 6), yaw=-np.pi / 2),
        jnp.float32(0), jax.random.key(frame_seed), rows=rows, cols=cols,
        pixel_aspect=0.5, spp=spp, bounces=2, light_color=LIGHT,
        sample_batch=B, use_kernel=True, row_lo=row_lo,
        n_rows=band if band_rows else None,
        pixel_active=jnp.asarray(act) if compacted else None)
    j_rgb, j_a = np.asarray(j_rgb).reshape(pc, 3), np.asarray(j_a).reshape(pc)
    rgb, a = _port_fold(probe, batches, pc, B, spp,
                        slot=order if compacted else None)
    np.testing.assert_array_equal(a.numpy(), j_a)
    ovr = j_a != 255
    assert ovr.any() and (~ovr).any()
    np.testing.assert_array_equal(rgb.numpy()[ovr], j_rgb[ovr])
    np.testing.assert_allclose(rgb.numpy()[~ovr], j_rgb[~ovr], rtol=1e-5,
                               atol=0)


def _np_fold(probe, batches, pc, B, spp):
    """The fold as an explicit float32 loop in numpy, pixel by pixel."""
    tot = np.zeros((3, pc), np.float32)
    oc = np.zeros((3, pc), np.float32)
    ov = np.zeros(pc, np.int64)
    for b, outs in enumerate(batches):
        n_valid = min(B, spp - b * B)
        for p in range(pc):
            acc = np.zeros(3, np.float32)
            first = None
            for s in range(n_valid):
                c = np.asarray([outs[k][s * pc + p] for k in range(3)],
                               np.float32)
                acc = acc + c
                o = int(np.rint(outs[3][s * pc + p]))
                if first is None and o > 0:
                    first = (o, c)
            tot[:, p] = tot[:, p] + acc
            if first is not None and ov[p] == 0:
                ov[p], oc[:, p] = first
    o0 = np.rint(probe[3][:pc]).astype(np.int64)
    has0 = o0 > 0
    ov = np.where(has0, o0, ov)
    oc = np.where(has0, np.stack([probe[k][:pc] for k in range(3)]), oc)
    inv = np.float32(1.0) / np.float32(spp)
    mean = np.clip(tot * inv, np.float32(0), np.float32(1))
    rgb = np.where(ov > 0, np.clip(oc, np.float32(0), np.float32(1)), mean)
    return rgb.T, np.where(ov > 0, ov, 255).astype(np.uint8)


@pytest.mark.parametrize("spp,B", [(5, 2), (40, 32), (8, 8)])
def test_fold_equals_an_explicit_float32_loop(spp, B):
    """Bit for bit (NaN where the loop has NaN)."""
    pc = 5 * 7
    probe, batches = _fold_inputs(pc, B, -(-spp // B), 3)
    rgb, a = _port_fold(probe, batches, pc, B, spp)
    want_rgb, want_a = _np_fold(probe, batches, pc, B, spp)
    np.testing.assert_array_equal(a.numpy(), want_a)
    nan = np.isnan(want_rgb)
    assert nan.any()
    np.testing.assert_array_equal(np.isnan(rgb.numpy()), nan)
    np.testing.assert_array_equal(_bits(rgb.numpy())[~nan],
                                  _bits(want_rgb)[~nan])


@pytest.mark.parametrize("spp,B", [(5, 2), (40, 32)])
def test_fold_permutes_with_the_pixels(spp, B):
    """The outputs of pixels placed in another stream order, with the
    order given as ``slot``, are the identity order's bit for bit."""
    pc = 6 * 16
    n_batches = -(-spp // B)
    probe, batches = _fold_inputs(pc, B, n_batches, 7)
    perm = np.random.default_rng(2).permutation(pc).astype(np.int32)

    def permuted(outs, samples):
        return tuple(np.concatenate([
            x[:samples * pc].reshape(samples, pc)[:, perm].reshape(-1),
            x[samples * pc:]]) for x in outs)

    p_probe = permuted(probe, 1)
    p_batches = [permuted(o, B) for o in batches]
    rgb, a = _port_fold(probe, batches, pc, B, spp)
    p_rgb, p_a = _port_fold(p_probe, p_batches, pc, B, spp, slot=perm)
    assert torch.equal(p_a, a)
    assert torch.equal(p_rgb.view(torch.int32), rgb.view(torch.int32))


def test_fold_wrapper_runs_the_plain_version_on_cpu():
    """CPU: the plain version, nothing launched; the state keeps the
    running totals between batches; bad arguments raise."""
    pc, B = 40, 3
    probe, batches = _fold_inputs(pc, B, 2, 1)
    PR.launches = 0
    state = PR.new_state(pc, "cpu")
    outs = [torch.from_numpy(x) for x in batches[0][:4]]
    assert PR.fold(state, *outs, B, first=True) is None
    tot = torch.stack([torch.from_numpy(x[:B * pc]).reshape(B, pc)
                       for x in batches[0][:3]])
    want = torch.zeros((3, pc))
    for s in range(B):
        want = want + tot[:, s]
    assert torch.equal(state[0][:3].view(torch.int32),
                       (torch.zeros((3, pc)) + want).view(torch.int32))
    assert PR.launches == 0
    with pytest.raises(ValueError, match="spp"):
        PR.fold(state, *outs, B, first=False,
                probe=[torch.from_numpy(x) for x in probe[:4]])
    with pytest.raises(ValueError, match="one sample"):
        PR.fold(state, *outs, 0, first=False)
    with pytest.raises(ValueError, match="float32"):
        PR.fold(state, outs[0][:10], *outs[1:], B, first=False)
    with pytest.raises(ValueError, match="CUDA"):
        PR.fold(tuple(t.to("meta") for t in state),
                *(o.to("meta") for o in outs), B, first=False)


@functools.lru_cache(maxsize=None)
def _jax_render(rows, cols, spp, bounces, sample_batch, compacted):
    js, _ts = _scenes()
    fn = jax.jit(functools.partial(
        JPT.render_pt, rows=rows, cols=cols, pixel_aspect=0.5, spp=spp,
        bounces=bounces, light_color=LIGHT, sample_batch=sample_batch,
        use_kernel=True))
    cam = JC.Camera.create(pos=(0, 2.5, 6), yaw=-np.pi / 2)
    act = jnp.asarray(pixel_order(rows, cols, 0.5, seed=1)[0])
    return [np.asarray(x) for x in fn(
        js, cam, jnp.float32(0), jax.random.key(4),
        pixel_active=act if compacted else None)]


@pytest.mark.parametrize("compacted", [False, True])
def test_render_pt_equals_jax_kernel_path(compacted):
    """8x24, spp 5, sample batch 2 (three batches, the last past spp), 2
    bounces, plain and compacted: the port's render_pt (X7 and X14's
    plain versions around B5's) within atol 1e-5 of JAX's interpreted
    kernel path, alpha exactly."""
    _js, ts = _scenes()
    j_rgb, j_a = _jax_render(8, 24, 5, 2, 2, compacted)
    act = torch.from_numpy(pixel_order(8, 24, 0.5, seed=1)[0])
    rgb, a = TPT.render_pt(
        ts, TC.Camera.create(pos=(0, 2.5, 6), yaw=-np.pi / 2), 0.0,
        TPT.frame_seed_of(4), rows=8, cols=24, pixel_aspect=0.5, spp=5,
        bounces=2, light_color=LIGHT, sample_batch=2,
        pixel_active=act if compacted else None)
    np.testing.assert_array_equal(a.numpy(), j_a)
    assert (j_a != 255).any()
    np.testing.assert_allclose(rgb.numpy(), j_rgb, atol=1e-5, rtol=0)
