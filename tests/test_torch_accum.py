"""Port parity for progressive accumulation (``sim/accum``) against the JAX
package's jitted ``accumulate`` / ``active_mask`` (the rounding of its
``ProgressivePathTracer`` step), fed the same seeded samples, and the
port's ``ProgressivePathTracer``: its adaptive-skip trajectory (the
compacted, block-gated ray stream of ``render_pt(pixel_active=)``) equals
the full one, as ``tests/test_aux_subsystems.py`` asserts for JAX.

The plain version of K1b (``ops/accum.accumulate_ref``, the statistics
step's one launch on the card) is held to the same jitted calls on seeded
edge planes (zeros, NaN, infinities, counts at max_samples - 1), in both
statistics modes, with and without a camera-move reset and a sample alpha
plane; the skip mask it writes to ``active_mask`` of the new state; the
tracer's skip trajectory to the full one, a replaced ``state`` included.

Tolerances: every AccumState field, the display rgb and the active mask
bit for bit (on the edge planes: NaN in the same places, every other
value bit for bit)."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.core import camera as JC
from ascii_renderer_tpu.sim import accum as JA
from ascii_renderer_tpu_torch.atlas.io import demo_atlas
from ascii_renderer_tpu_torch.core import camera as TC
from ascii_renderer_tpu_torch.core.config import (AdaptiveConfig, Config,
                                                  PathTracerConfig)
from ascii_renderer_tpu_torch.ops import accum as OA
from ascii_renderer_tpu_torch.scene.demo import create_demo_scene
from ascii_renderer_tpu_torch.sim import accum as TA
from ascii_renderer_tpu_torch.tools import xla_inputs as xi
from ascii_renderer_tpu_torch.utils.from_jax import accum_state_from_numpy

torch.set_num_threads(2)

H, W = 12, 32
FIELDS = [f.name for f in dataclasses.fields(TA.AccumState)]


def _eq(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=what)


def _samples(rng, base, step):
    s = np.clip(base + rng.normal(0, 0.08 * (step % 3 + 1), base.shape),
                0, 1).astype(np.float32)
    s[:4] = base[:4]  # a converging band
    return s, rng.integers(0, 256, (H, W)).astype(np.uint8)


def _pose(step):
    pos = (0.0, 1.0, 5.0) if step < 4 else (0.0, 1.0, 5.5)  # a move at 4
    return (JC.Camera.create(pos=pos, yaw=-1.5, pitch=0.1),
            TC.Camera.create(pos=pos, yaw=-1.5, pitch=0.1))


@pytest.mark.parametrize("mode", ["rgb", "perceptual"])
def test_accumulate_and_active_mask_equal_jax(mode):
    """8 batches of seeded samples (a camera move before the fifth), the
    first 2 folded by JAX alone and its state carried over with
    accum_state_from_numpy: every state field, the display rgb, the
    active mask that accumulate returns and active_mask equal JAX's
    jitted calls bit for bit."""
    kw = dict(max_tolerance=0.1, max_samples=64, stats_mode=mode)
    jacc = jax.jit(functools.partial(JA.accumulate, **kw))
    jmask = jax.jit(functools.partial(JA.active_mask, **{
        k: v for k, v in kw.items()}))
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    js = JA.AccumState.create(H, W)
    ts = None
    n_act = []
    for step in range(8):
        jc, tc = _pose(step)
        s, a = _samples(rng, base, step)
        js, jd, jact = jacc(js, jnp.asarray(s), jc,
                            sample_alpha=jnp.asarray(a))
        if step < 2:
            continue
        if ts is None:  # carry JAX's state over
            ts = accum_state_from_numpy(
                {f: np.asarray(getattr(js, f)) for f in FIELDS}, "cpu")
            continue
        ts, td, tact = TA.accumulate(ts, torch.from_numpy(s), tc,
                                     sample_alpha=torch.from_numpy(a), **kw)
        for f in FIELDS:
            _eq(getattr(ts, f).numpy(), getattr(js, f), f"{f}, step {step}")
        _eq(td.numpy(), jd, f"display, step {step}")
        _eq(tact.numpy(), jact, f"act, step {step}")
        _eq(TA.active_mask(ts, **kw).numpy(), jmask(js), f"mask {step}")
        n_act.append(int(tact.sum()))
    assert min(n_act) < H * W < max(n_act) + 1  # some pixels froze


def test_luminances_equal_jax_jit():
    """luminance (the channel mean, a sum times XLA's 1/3) and
    perceptual_luminance (0.3 / 0.59 / 0.11, fused left to right) equal
    the jitted reference on seeded rgb."""
    rgb = np.random.default_rng(5).uniform(0, 2, (4096, 3)).astype(np.float32)
    for t, j in ((TA.luminance, JA.luminance),
                 (TA.perceptual_luminance, JA.perceptual_luminance)):
        _eq(t(torch.from_numpy(rgb)).numpy(), jax.jit(j)(rgb), t.__name__)


def _tracer_cfg():
    return Config(grid_width=96, grid_height=36,
                  path_tracer=PathTracerConfig(samples_per_batch=2,
                                               max_bounces=2),
                  adaptive=AdaptiveConfig(max_tolerance=0.3, max_samples=4))


def _scene():
    sb = create_demo_scene()
    sb.set_atlas(demo_atlas())
    return sb.build(min_pad=1, device="cpu")


def test_progressive_skip_equals_full_trajectory():
    """ProgressivePathTracer(use_kernel=True, adaptive_skip=True) on the
    megakernel's plain version, 36 x 96 (3,456 pixels, several 1,024-ray
    blocks a sample), 6 batches with a camera move before the fifth: the
    display rgb, the alpha plane and the active mask equal
    adaptive_skip=False bit for bit while the active set shrinks."""
    cfg = _tracer_cfg()
    scene = _scene()
    fast = TA.ProgressivePathTracer(cfg, scene, use_kernel=True,
                                    adaptive_skip=True)
    full = TA.ProgressivePathTracer(cfg, scene, use_kernel=True,
                                    adaptive_skip=False)
    assert fast.skip and not full.skip
    n_act = []
    for step in range(6):
        cam = TC.Camera.create(pos=(0, 2.5, 6 if step < 4 else 5.8),
                               yaw=-math.pi / 2)
        d1, a1, m1 = fast.step(cam)
        d2, a2, m2 = full.step(cam)
        assert torch.equal(d1.view(torch.int32), d2.view(torch.int32)), step
        assert torch.equal(a1, a2) and torch.equal(m1, m2), step
        n_act.append(int(m1.sum()))
    assert n_act[0] == 36 * 96 and min(n_act[1:4]) < 36 * 96 // 2
    assert n_act[4] == 36 * 96  # the move re-samples every pixel


def test_progressive_converges_and_polls_done():
    """With max_samples 4 every pixel freezes by the fifth batch: done,
    and poll_done answers True once a probe 2 batches old saw no active
    pixel; a step after convergence leaves the display unchanged."""
    cfg = _tracer_cfg()
    tr = TA.ProgressivePathTracer(cfg, _scene(), use_kernel=True)
    cam = TC.Camera.create(pos=(0, 2.5, 6), yaw=-math.pi / 2)
    polled = []
    for _ in range(7):
        disp, _a, _m = tr.step(cam)
        polled.append(tr.poll_done())
    assert tr.done
    assert polled[:4] == [False] * 4 and polled[-1]
    again, _a, act = tr.step(cam)
    assert not act.any() and torch.equal(again, disp)
    assert tr._inflight.maxlen == 64


def test_a_batch_that_raises_before_its_fold_changes_nothing(monkeypatch):
    """A batch whose render raises folds nothing: the state, its skip mask
    and the any-active flags' turn stay as the last fold left them, and the
    tracer then converges and polls done as one that never failed."""
    cfg = _tracer_cfg()
    scene = _scene()
    cam = TC.Camera.create(pos=(0, 2.5, 6), yaw=-math.pi / 2)
    tr = TA.ProgressivePathTracer(cfg, scene, use_kernel=True)
    ok = TA.ProgressivePathTracer(cfg, scene, use_kernel=True)
    render = TA.PT.render_pt
    polled, want = [], []
    for k in range(7):
        if k == 2:
            state, folds = tr.state, tr._folds

            def fail(*a, **kw):
                raise RuntimeError("render failed")

            monkeypatch.setattr(TA.PT, "render_pt", fail)
            with pytest.raises(RuntimeError, match="render failed"):
                tr.step(cam)
            monkeypatch.setattr(TA.PT, "render_pt", render)
            assert tr.state is state and tr._folds == folds
            assert tr._skip_of is state
        got = tr.step(cam)
        polled.append(tr.poll_done())
        exp = ok.step(cam)
        want.append(ok.poll_done())
        for g, w, what in zip(got, exp, ("display", "alpha", "act")):
            if k < 2:
                _eq(g, w, f"{what}, batch {k}")
    assert tr.done and polled[-1] and polled[:4] == [False] * 4
    assert sum(polled) == sum(want)


def _eq_nan(got, want, what):
    """NaN in the same places, every other value bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype.kind != "f":
        return _eq(got, want, what)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    _eq(got[~nan], want[~nan], what)


@pytest.mark.parametrize("mode", ["rgb", "perceptual"])
@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("with_alpha", [True, False])
def test_plain_k1b_equals_jax_on_edge_planes(mode, reset, with_alpha):
    """ops/accum.accumulate_ref (K1b's plain version) and sim/accum's
    accumulate on a seeded 24 x 40 state with NaN, infinities, signed
    zeros, negative values and counts at max_samples - 1 (no subnormals:
    XLA's CPU code flushes them, the port keeps them as CUDA does): the
    new state, the display rgb and act equal JAX's jitted accumulate, and
    the skip mask equals JAX's jitted active_mask of the new state; reset
    where the JAX state's cam_sig differs from the camera's."""
    kw = dict(max_tolerance=0.1, max_samples=16, stats_mode=mode)
    c = xi.accum_case((24, 40), seed=7 + reset, max_samples=16,
                      subnormals=False)
    jc, tc = _pose(0)
    sig = np.asarray(JA._signature(jc))
    cam_sig = np.full(5, np.inf, np.float32) if reset else sig
    planes = {f: c[f] for f in OA.FIELDS}
    js = JA.AccumState(cam_sig=jnp.asarray(cam_sig),
                       **{f: jnp.asarray(v) for f, v in planes.items()})
    sa = c["sample_alpha"] if with_alpha else None
    jnew, jd, jact = jax.jit(functools.partial(JA.accumulate, **kw))(
        js, jnp.asarray(c["sample"]), jc,
        sample_alpha=None if sa is None else jnp.asarray(sa))
    jskip = jax.jit(functools.partial(JA.active_mask, **kw))(jnew)
    flags = torch.tensor([0, 5], dtype=torch.int32)
    new, disp, act, skip = OA.accumulate_ref(
        tuple(torch.from_numpy(v) for v in planes.values()),
        torch.from_numpy(c["sample"]),
        None if sa is None else torch.from_numpy(sa), reset=reset,
        flags=flags, slot=0, **kw)
    for f, t in zip(OA.FIELDS, new):
        _eq_nan(t.numpy(), getattr(jnew, f), f)
    _eq_nan(disp.numpy(), jd, "display")
    _eq(act.numpy(), jact, "act")
    _eq(skip.numpy(), jskip, "skip")
    assert flags.tolist() == [int(np.asarray(jact).any()), 0]
    if reset:  # the zero state: every pixel warms up, before and after
        assert bool(act.all()) and bool(skip.all())
    else:  # both values in both masks
        assert 0 < int(act.sum()) < act.numel()
        assert 0 < int(skip.sum()) < skip.numel()
    ts = accum_state_from_numpy({f: np.asarray(getattr(js, f))
                                 for f in FIELDS}, "cpu")
    tnew, td, tact = TA.accumulate(
        ts, torch.from_numpy(c["sample"]), tc,
        sample_alpha=None if sa is None else torch.from_numpy(sa), **kw)
    for f in FIELDS:
        _eq_nan(getattr(tnew, f).numpy(), getattr(jnew, f), f"sim {f}")
    _eq_nan(td.numpy(), jd, "sim display")
    _eq(tact.numpy(), jact, "sim act")


def test_cached_skip_mask_is_active_mask_of_the_new_state():
    """After each batch of the progressive tracer (a camera move before
    the fifth), the skip mask the fold wrote equals sim/accum.active_mask
    of the tracer's new state and JAX's jitted active_mask of the same
    state; ``done`` reads it."""
    cfg = _tracer_cfg()
    tr = TA.ProgressivePathTracer(cfg, _scene(), use_kernel=True)
    kw = dict(max_tolerance=cfg.adaptive.max_tolerance,
              max_samples=cfg.adaptive.max_samples,
              stats_mode=cfg.adaptive.stats_mode)
    jmask = jax.jit(functools.partial(JA.active_mask, **kw))
    for step in range(6):
        tr.step(TC.Camera.create(pos=(0, 2.5, 6 if step < 4 else 5.8),
                                 yaw=-math.pi / 2))
        assert tr._skip_of is tr.state
        want = TA.active_mask(tr.state, **kw)
        assert torch.equal(tr._skip_mask, want), step
        js = JA.AccumState(**{f: jnp.asarray(getattr(tr.state, f).numpy())
                              for f in FIELDS})
        _eq(tr._skip_mask.numpy(), jmask(js), f"JAX mask {step}")
        assert tr.done == (not bool(want.any()))


def test_skip_trajectory_equals_full_for_8_batches_with_a_replaced_state(
        monkeypatch):
    """8 batches of adaptive_skip=True against adaptive_skip=False (a
    camera move before the fourth), each tracer's state replaced before
    the sixth by the one it had after the fourth batch: display, alpha
    and mask bit for bit every batch; the skip tracer forms no mask chain
    but for the replaced state (active_mask of it, not its cached mask)."""
    cfg = _tracer_cfg()
    scene = _scene()
    fast = TA.ProgressivePathTracer(cfg, scene, use_kernel=True,
                                    adaptive_skip=True)
    full = TA.ProgressivePathTracer(cfg, scene, use_kernel=True,
                                    adaptive_skip=False)
    kept, seen = {}, []
    real = TA.active_mask

    def spy(state, **kw):
        seen.append(state)
        return real(state, **kw)

    monkeypatch.setattr(TA, "active_mask", spy)
    for step in range(8):
        if step == 5:
            fast.state, full.state = kept["fast"], kept["full"]
            assert fast._skip_of is not fast.state
        cam = TC.Camera.create(pos=(0, 2.5, 6 if step < 3 else 5.9),
                               yaw=-math.pi / 2)
        n_seen = len(seen)
        d1, a1, m1 = fast.step(cam)
        assert seen[n_seen:] == ([kept["fast"]] if step == 5 else []), step
        d2, a2, m2 = full.step(cam)
        assert torch.equal(d1.view(torch.int32), d2.view(torch.int32)), step
        assert torch.equal(a1, a2) and torch.equal(m1, m2), step
        if step == 3:
            kept = {"fast": fast.state, "full": full.state}
    assert 0 < int(m1.sum()) < m1.numel()
