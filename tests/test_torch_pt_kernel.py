"""Port parity for the path-trace megakernel's plain version (B5,
``ops/pt_kernel``) against the Pallas kernel in interpret mode, from the
same rays, seeds and uids: the RNG stream, the deterministic first bounce
across the three atlas shapes, the multi-bounce estimate, and the block
gate / uid contract.

Tolerances: at one bounce without NEE the output involves no
transcendental function, and ov / fet must match exactly with the
radiance within 1e-5 (the JAX tests' own bound). With more bounces the
paths run through sin, cos and pow, which XLA's CPU code and torch's CPU
kernels compute differently by an ulp or so, and XLA fuses some products
into the adds they feed: at least 99% of rays must be within 1e-4 and
the image mean within 0.5%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.atlas import io as JIO
from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.core.camera import Camera as JCam
from ascii_renderer_tpu.core.camera import primary_ray_dirs as j_dirs
from ascii_renderer_tpu.ops import pt_kernel as JPK
from ascii_renderer_tpu.scene import demo as JD
from ascii_renderer_tpu_torch.atlas import io as TIO
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.ops import pt_kernel as TPK
from ascii_renderer_tpu_torch.scene import demo as TD

torch.set_num_threads(2)

LIGHT = (16.86, 10.76, 8.2)


def _scenes(atlas=(32, 32), min_pad=8):
    jsb, tsb = JD.create_demo_scene(), TD.create_demo_scene()
    jsb.set_atlas(JIO.demo_atlas(*atlas))
    tsb.set_atlas(TIO.demo_atlas(*atlas))
    return jsb.build(min_pad=min_pad), tsb.build(min_pad=min_pad,
                                                 device="cpu")


def _rays(rows, cols, pos=(0, 2.5, 5.2)):
    cam = JCam.create(pos=pos, yaw=-np.pi / 2)  # faces the poster
    rd = np.asarray(j_dirs(cam, rows, cols, 0.5))
    ro = np.broadcast_to(np.asarray(cam.pos), rd.shape).copy()
    return ro, rd


def _trace_both(js, ts, ro, rd, seed, bounces, nee):
    lc, lr = JPT.get_light_sphere(js, 0.0)
    j = JPT.trace_eye_paths_kernel(
        js, jnp.asarray(ro), jnp.asarray(rd), seed, lc, lr, bounces=bounces,
        light_color=jnp.asarray(LIGHT) * 1.3, nee=nee, interpret=True)
    tlc, tlr = TPT.get_light_sphere(ts, 0.0)
    launches = TPK.launches
    t = TPT.trace_eye_paths_kernel(
        ts, torch.from_numpy(ro), torch.from_numpy(rd), seed, tlc, tlr,
        bounces=bounces, light_color=torch.tensor(LIGHT) * 1.3, nee=nee)
    assert TPK.launches == launches  # CPU tensors never launch
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("seed", [0, 1, -7, 2 ** 31 - 1])
@pytest.mark.parametrize("ctr", [1, 2, 6, 17, 0x40000001, 0x40000002])
def test_hash_unit_equals_jax(seed, ctr):
    uid = np.random.default_rng(ctr % 1000).integers(
        -2 ** 31, 2 ** 31, 4096, dtype=np.int64).astype(np.int32)
    uid[:3] = (0, 1, -1)
    want = np.asarray(JPT._hash_unit(jnp.asarray(uid), jnp.int32(seed), ctr))
    got = TPK.hash_unit(torch.from_numpy(uid), seed, ctr).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_draw_numbering_is_the_static_trace_order():
    """Per bounce: u1, u2, u3, then h1, h2 where NEE runs (not on the last
    bounce), then u4 from bounce 2 (Russian roulette)."""
    seq = [(j, s) for j in range(5)
           for s in ("u1", "u2", "u3", "h1", "h2", "u4")
           if (s[0] != "h" or j < 4) and (s != "u4" or j >= 2)]
    assert [TPK.draw_index(j, s, 5, True) for j, s in seq] == \
        list(range(1, len(seq) + 1))
    assert [TPK.draw_index(j, "u1", 4, False) for j in range(4)] == \
        [1, 4, 7, 11]
    assert TPK.draw_index(3, "u4", 4, False) == 14


@pytest.mark.parametrize("i", [0, 1, 7, 123456, 2 ** 31 - 1, 2 ** 32 - 1])
def test_frame_and_batch_seeds_equal_jax(i):
    kd = np.asarray(jax.random.key_data(jax.random.key(i))).reshape(-1)
    want = int(kd[-1].astype(np.uint32).view(np.int32))
    assert TPT.frame_seed_of(i) == want
    for b in range(3):
        jb = jnp.int32(want) + (b + 1) * jnp.int32(-1640531527)
        assert TPT.batch_seed_of(want, b) == int(jb)


@pytest.mark.parametrize("atlas", [(32, 32), (26, 24), (128, 64)])
def test_first_bounce_equals_jax_kernel(atlas):
    """Bounce 1 without NEE is RNG-free: misses, light hits, glyph
    overrides and the fetch flag. 32x32 is JAX's gather layout, 26x24 a
    padded tail slab, 128x64 its one-hot layout."""
    js, ts = _scenes(atlas)
    ro, rd = _rays(24, 48)
    (j_lo, j_ov, j_f), (t_lo, t_ov, t_f) = _trace_both(js, ts, ro, rd, 0, 1,
                                                       False)
    np.testing.assert_array_equal(t_ov, j_ov)
    np.testing.assert_array_equal(t_f, j_f)
    np.testing.assert_allclose(t_lo, j_lo, atol=1e-5, rtol=0)
    assert t_f.sum() > 0 and (t_ov > 0).sum() > 10  # the poster is hit


def test_multi_bounce_equals_jax_kernel():
    """Bounces 3, NEE on, 1,024 rays, the same seed and uids."""
    js, ts = _scenes(min_pad=1)
    ro, rd = _rays(16, 64, pos=(0, 2.0, 4.0))
    (j_lo, j_ov, j_f), (t_lo, t_ov, t_f) = _trace_both(js, ts, ro, rd, 5, 3,
                                                       True)
    np.testing.assert_array_equal(t_ov, j_ov)
    np.testing.assert_array_equal(t_f, j_f)
    err = np.abs(t_lo - j_lo).max(-1)
    assert (err <= 1e-4).mean() >= 0.99, err.max()
    assert abs(t_lo.mean() - j_lo.mean()) <= 5e-3 * abs(j_lo.mean())
    assert (t_lo > 0).mean() > 0.5  # the paths did gather light


def _raw_inputs(ts, n_blocks, seed):
    rng = np.random.default_rng(seed)
    n = n_blocks * TPK.BLOCK
    ro = np.tile(np.float32([0, 2.5, 5.2]), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5  # towards the poster wall
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tp = TPT.pack_scene_entries(ts)
    lc, lr = TPT.get_light_sphere(ts, 0.0)
    params = TPT._params(lc, lr, torch.tensor(LIGHT) * 1.3, "cpu")
    return (ro.reshape(n_blocks, 8, 128, 3), rd.reshape(n_blocks, 8, 128, 3),
            tp, params)


def test_block_gate_and_uids_equal_jax_kernel():
    """trace_blocks_raw's contract: a 0 in block_active zeroes its 1,024
    rays; uid sets each ray's RNG stream."""
    js, ts = _scenes(min_pad=1)
    ro, rd, tp, params = _raw_inputs(ts, 2, 3)
    uid = np.random.default_rng(4).permutation(2 * 1024).astype(
        np.int32).reshape(2, 8, 128)
    act = np.array([0, 1], np.int32)
    jp = JPT.pack_scene_entries(js)
    kw = dict(bounces=2, nee=True, atlas_w=tp[2], atlas_h=tp[3],
              sph_rows=tp[4])
    want = JPK.trace_blocks_raw(
        jnp.asarray(params.numpy()), jp[0], jnp.asarray(ro), jnp.asarray(rd),
        9, jp[1], interpret=True, block_active=jnp.asarray(act),
        uid=jnp.asarray(uid), **kw)
    got = TPK.trace_blocks_raw(
        params, tp[0], torch.from_numpy(ro), torch.from_numpy(rd), 9, tp[1],
        block_active=torch.from_numpy(act), uid=torch.from_numpy(uid), **kw)
    for name, g, w in zip(("lor", "log", "lob", "ov", "fet"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (2, 8, 128)
        assert not g[0].any(), name  # the gated block
        if name in ("ov", "fet"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert (np.abs(g - w) <= 1e-4).mean() >= 0.99, name


def test_output_is_placement_invariant():
    """Permuting the rays and carrying their uids permutes the outputs bit
    for bit (the RNG is a function of uid and seed alone)."""
    _js, ts = _scenes(min_pad=1)
    ro, rd, tp, params = _raw_inputs(ts, 2, 5)
    kw = dict(bounces=3, nee=True, atlas_w=tp[2], atlas_h=tp[3],
              sph_rows=tp[4])
    base = TPK.trace_blocks_raw(params, tp[0], torch.from_numpy(ro),
                                torch.from_numpy(rd), 11, tp[1], **kw)
    perm = torch.from_numpy(np.random.default_rng(6).permutation(2048))
    ro_p = torch.from_numpy(ro).reshape(-1, 3)[perm].reshape(2, 8, 128, 3)
    rd_p = torch.from_numpy(rd).reshape(-1, 3)[perm].reshape(2, 8, 128, 3)
    got = TPK.trace_blocks_raw(params, tp[0], ro_p, rd_p, 11, tp[1],
                               uid=perm.to(torch.int32).reshape(2, 8, 128),
                               **kw)
    for g, b in zip(got, base):
        assert torch.equal(g.reshape(-1), b.reshape(-1)[perm])


def test_stats_count_the_work_the_kernel_does():
    _js, ts = _scenes(min_pad=1)
    ro, rd, tp, params = _raw_inputs(ts, 1, 7)
    stats = {}
    TPK.trace_blocks_raw_ref(params, tp[0], torch.from_numpy(ro),
                             torch.from_numpy(rd), 1, tp[1], bounces=3,
                             nee=True, atlas_w=tp[2], atlas_h=tp[3],
                             sph_rows=tp[4], stats=stats)
    assert stats["segments"] > 1024 and stats["segments"] <= 3 * 1024
    assert 0 < stats["shadow_rays"] <= 2 * 1024


def test_wrapper_checks_and_never_falls_back():
    _js, ts = _scenes(min_pad=1)
    ro, rd, tp, params = _raw_inputs(ts, 1, 8)
    kw = dict(bounces=1, nee=False, atlas_w=tp[2], atlas_h=tp[3],
              sph_rows=tp[4])
    meta = torch.device("meta")
    launches = TPK.launches
    with pytest.raises(ValueError):
        TPK.trace_blocks_raw(params.to(meta), tp[0].to(meta),
                             torch.from_numpy(ro).to(meta),
                             torch.from_numpy(rd).to(meta), 0,
                             tp[1].to(meta), **kw)
    with pytest.raises(ValueError, match="ro/rd"):
        TPK.trace_blocks_raw(params, tp[0], torch.from_numpy(ro)[..., :64, :],
                             torch.from_numpy(rd)[..., :64, :], 0, tp[1],
                             **kw)
    with pytest.raises(ValueError, match="budget.*XLA core"):
        TPK.trace_blocks_raw(params, tp[0], torch.from_numpy(ro),
                             torch.from_numpy(rd), 0, tp[1],
                             **dict(kw, atlas_w=512, atlas_h=256))
    assert TPK.launches == launches
