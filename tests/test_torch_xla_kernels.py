"""The kernels that stand for XLA code of the reference: the fused
multiply-add ``fma32`` (``ops/fp``), the raster's deferred shade
(``ops/raster_shade``) and the ray tracer's frame (``ops/rt_trace``), on
the CPU.

CPU tensors run the plain versions and launch nothing; a tensor on any
other device reaches the kernel path, which raises where it cannot run.
What the kernels are handed is checked here without a card: the float64
form of ``fma32`` against exact rational rounding (midpoint ties,
subnormals, signed zeros, infinities, overflow), the strides and scalars
each wrapper packs (replayed on the CPU with the kernel's addressing),
the ray tracer's table of fused products against the decisions the
plain version makes, a replay of its kernel's tile reduction (1-32
lanes a ray) against ``torch.argmin`` and of its grid form's rays (the
index of a ray to its view, row and column, the host's float32
constants, ``csrc/ray_dir.cuh``'s rounding) against the plain grid, and
the grid form's argument checks. ``_shade_rows`` and the shade's
plain version are held to the reference's (0 to 3 point lights, no
directional light, an f32 id of -0.0, an id past the table), and the
shade kernel's division-free grid indices are replayed. The clip (X4), the plane table (X3) and the bin entries (X9)
never fall back and raise on a failed build or launch. The kernels
themselves are held to their plain versions on the card
(``tests/test_torch_build_xla.py``, marked ``cuda``)."""

import dataclasses
import inspect
import sys
from fractions import Fraction
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import raster_common as JRC
from ascii_renderer_tpu.scene.builder import SceneBuilder as JSB
from ascii_renderer_tpu_torch.backends import raster as R
from ascii_renderer_tpu_torch.backends import raster_common as RCM
from ascii_renderer_tpu_torch.backends import raster_oracles as RO
from ascii_renderer_tpu_torch.backends import raytrace as RT
from ascii_renderer_tpu_torch.backends import rt_core as RC
from ascii_renderer_tpu_torch.core.fp import fma32, fma32_f64
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import bin_entries as BE
from ascii_renderer_tpu_torch.ops import fp as KFP
from ascii_renderer_tpu_torch.ops import plane_table as PT
from ascii_renderer_tpu_torch.ops import raster_clip as RCL
from ascii_renderer_tpu_torch.ops import raster_shade as RSH
from ascii_renderer_tpu_torch.ops import rt_trace as RTK
from ascii_renderer_tpu_torch.parallel.mesh import orbit_cameras
from ascii_renderer_tpu_torch.scene.builder import MaterialIds as TM
from ascii_renderer_tpu_torch.scene.builder import SceneBuilder as TSB
from ascii_renderer_tpu_torch.scene.demo import create_rt_demo_scene
from ascii_renderer_tpu_torch.tools.xla_inputs import (
    FMA_CASES, fma_operands, fma_specials, fma_ties, front_inputs, rt_scene,
    shade_builder, shade_inputs)

torch.set_num_threads(2)

COUNTERS = ((KFP, "launches"), (RSH, "launches"), (RTK, "launches"),
            (RCL, "launches"), (PT, "launches"), (BE, "launches"))


@pytest.fixture
def zero_counts():
    saved = [getattr(m, a) for m, a in COUNTERS]
    for m, a in COUNTERS:
        setattr(m, a, 0)
    yield
    for (m, a), v in zip(COUNTERS, saved):
        setattr(m, a, v)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# --------------------------------------------------------------------------
# fma32: the float64 form against exact rounding, the kernel's operands
# --------------------------------------------------------------------------
_MAX = Fraction(float(np.finfo(np.float32).max))
_HALF_TOP = Fraction(2) ** 103  # half the float32 spacing at FLT_MAX


def _round_f32(q: Fraction) -> float:
    """IEEE float32 round-to-nearest-even of the rational q, over the
    whole range: subnormals, and infinity from FLT_MAX + half a step."""
    if abs(q) >= _MAX + _HALF_TOP:
        return float("inf") if q > 0 else float("-inf")
    if q == 0:
        return 0.0
    lo = np.float32(float(q))  # within a float32 step of q
    cands = {lo, np.nextafter(lo, np.float32(np.inf)),
             np.nextafter(lo, np.float32(-np.inf))}
    cands = {v for v in cands if np.isfinite(v)}
    return float(min(cands, key=lambda v: (
        abs(Fraction(float(v)) - q),
        int(np.asarray(v, np.float32).view(np.int32)) & 1)))


def _exact_fma(a, b, c) -> np.ndarray:
    """Correctly rounded float32 a*b + c from exact rational arithmetic;
    IEEE's special values where an operand is not finite."""
    out = []
    for x, y, z in zip(a, b, c):
        x, y, z = float(x), float(y), float(z)
        if not all(np.isfinite((x, y, z))):
            out.append(np.float32(np.float64(x) * y + z))  # inf / nan rules
            continue
        q = Fraction(x) * Fraction(y) + Fraction(z)
        # an exact zero is +0, unless both addends are -0
        if q == 0:
            p_neg = (np.signbit(x) != np.signbit(y))
            out.append(np.float32(-0.0 if (p_neg and np.signbit(z))
                                  else 0.0))
            continue
        out.append(np.float32(_round_f32(q)))
    return np.asarray(out, np.float32)


def test_fma32_f64_is_correctly_rounded_at_the_edges():
    """The float64 form (the CPU path and the card's twin) equals exact
    rounding bit for bit on constructed midpoint ties, subnormals, exact
    cancellation and IEEE's special values; NaN where IEEE gives NaN. A
    sum past FLT_MAX rounds to infinity (a tie there used to come out as
    -inf when the float64 sum's lost part was negative)."""
    a, b, c = (np.concatenate(x) for x in zip(fma_ties(), fma_specials()))
    with np.errstate(all="ignore"):
        want = _exact_fma(a, b, c)
        naive = (a.astype(np.float64) * b + c).astype(np.float32)
    got = fma32_f64(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))
    assert (_bits(naive[~nan]) != _bits(want[~nan])).sum() >= 100
    assert np.isposinf(got[np.flatnonzero((a == 2.0 ** 64) & (c == -1.0))]
                       ).all()


def test_cpu_tensors_run_the_plain_versions(zero_counts):
    """fma32, shade and trace on CPU tensors are their plain versions and
    launch nothing."""
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
               for _ in range(3))
    assert torch.equal(fma32(a, b, c), fma32_f64(a, b, c))
    assert torch.equal(fma32(a.t(), 2.5, c.t()),
                       fma32_f64(a.t(), 2.5, c.t()))
    scene = shade_builder(TSB, True, 3).build(device="cpu")
    table, ids, px, py = shade_inputs(9, (4, 8, 16))
    assert torch.equal(RSH.shade(table, ids, px, py, scene, 9),
                       RSH.shade_ref(table, ids, px, py, scene, 9))
    rs = create_rt_demo_scene().build(device="cpu")
    pr = RT.ScenePrims(rs)
    cams = orbit_cameras(2, center=(0, 1.0, 1.0))
    rgb = RT.render_rgb(rs, cams, 6, 8, 0.5, prims=pr)
    from ascii_renderer_tpu_torch.core.camera import camera_bases
    from ascii_renderer_tpu_torch.ops.ray_grid import ray_grid_jit
    rd3 = ray_grid_jit(camera_bases(cams.yaw, cams.pitch, cams.fov_y), 6, 8,
                       0.5, "cpu").reshape(2, 48, 3)
    assert torch.equal(rgb.reshape(2, 48, 3),
                       RT.trace_rgb(rs, pr, cams.pos.float(), rd3))
    assert (KFP.launches, RSH.launches, RTK.launches) == (0, 0, 0)


def test_non_cpu_tensors_never_fall_back_to_the_plain_versions(zero_counts):
    """A tensor that is not on the CPU reaches the kernel path, whose
    checks raise for anything but CUDA tensors."""
    meta = torch.device("meta")
    x = torch.empty((4, 8), device=meta)
    for args in ((x, x, x), (x, 2.0, 1.0), (1.0, x, torch.tensor(2.0))):
        with pytest.raises(ValueError):
            fma32(*args)
    with pytest.raises(ValueError):
        KFP.fma32_kernel(torch.ones(3), 1.0, 1.0)  # not a CUDA tensor
    scene = shade_builder(TSB, True, 3).build(device="cpu")
    on_meta = dataclasses.replace(scene, **{
        f: getattr(scene, f).to(meta) for f in (
            "env_color", "env_intensity", "dl_dir", "dl_col", "pt_pos",
            "pt_col", "n_dl", "n_pt")})
    table, ids, px, py = (t.to(meta) for t in shade_inputs(9, (2, 8, 16)))
    with pytest.raises(ValueError):
        RSH.shade(table, ids, px, py, on_meta, 9)
    rs = create_rt_demo_scene().build(device="cpu")
    with pytest.raises(ValueError):
        RT.trace(rs, RT.ScenePrims(rs), torch.zeros((1, 3), device=meta),
                 torch.zeros((1, 8, 3), device=meta))
    with pytest.raises(ValueError):  # the kernel's wrapper: CUDA only
        RTK.trace(rs, RT.ScenePrims(rs), torch.zeros((1, 3)),
                  torch.zeros((1, 8, 3)), (True, True))
    assert (KFP.launches, RSH.launches, RTK.launches) == (0, 0, 0)


def _front_calls(monkeypatch):
    """Record every call of X4's and X3's plain versions."""
    calls = []
    for mod, name in ((RCL, "clip_screen_ref"), (PT, "plane_table_ref")):
        def rec(*a, _real=getattr(mod, name), _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    return calls


def _front_meta(seed=2):
    """X4's and X3's inputs on the CPU and on the meta device: positions,
    pos9, attrs (A = 9 and 6), the clip dict and a compaction's cidx."""
    p, attrs, mvp = front_inputs(60, seed, "cpu")
    ch = RCL.clip_screen(p, mvp, 36, 96)
    cch, cidx, _n = R.compact_valid_ch(dict(ch), 64)
    meta = torch.device("meta")
    on = {"p": p, "pos9": R.positions_to_pos9(p), "attrs": attrs,
          "ch": ch, "cch": cch, "cidx": cidx}
    to_meta = {k: ({c: t.to(meta) for c, t in v.items()}
                   if isinstance(v, dict) else v.to(meta))
               for k, v in on.items()}
    return on, to_meta, mvp


def test_front_kernels_cpu_tensors_run_the_plain_versions(zero_counts,
                                                          monkeypatch):
    """clip_screen and plane_table on CPU tensors are their plain versions
    (each reached once a call) and launch nothing."""
    on, _m, mvp = _front_meta()
    calls = _front_calls(monkeypatch)
    for pos9, src in ((False, on["p"]), (True, on["pos9"])):
        ch = RCL.clip_screen(src, mvp, 36, 96, pos9=pos9)
        assert ch["area2"].shape == on["ch"]["area2"].shape == (120,)
    for A in (9, 6):
        a = on["attrs"][:, :A]
        PT.plane_table(on["ch"], on["ch"], a)
        PT.plane_table(on["cch"], on["ch"], a, on["cidx"])
    assert calls == ["clip_screen_ref"] * 2 + ["plane_table_ref"] * 4
    assert (RCL.launches, PT.launches, KFP.launches) == (0, 0, 0)


def test_front_kernels_never_fall_back(zero_counts, monkeypatch):
    """Tensors that are not on the CPU reach the kernel paths, whose checks
    raise for anything but CUDA tensors; no call reaches a plain
    version."""
    _on, m, mvp = _front_meta()
    calls = _front_calls(monkeypatch)
    with pytest.raises(ValueError):
        RCL.clip_screen(m["p"], mvp, 36, 96)
    with pytest.raises(ValueError):
        RCL.clip_screen(m["pos9"], mvp, 36, 96, pos9=True)
    with pytest.raises(ValueError):
        PT.plane_table(m["ch"], m["ch"], m["attrs"])
    with pytest.raises(ValueError):
        PT.plane_table(m["cch"], m["ch"], m["attrs"][:, :6], m["cidx"])
    with pytest.raises(ValueError):  # the kernel takes A = 6 or 9 only
        PT.plane_table(m["ch"], m["ch"], m["attrs"][:, :4])
    assert calls == []
    assert (RCL.launches, PT.launches) == (0, 0)


class _FailingLib:
    """A kernel library whose every launch reports a CUDA error."""

    def __getattr__(self, name):
        return lambda *args: 700  # cudaErrorIllegalAddress


def test_front_kernels_raise_on_build_or_launch_failure(zero_counts,
                                                        monkeypatch):
    """Past the device checks, a failed build and a failed launch each
    raise out of clip_screen and plane_table; neither falls back to the
    plain version."""
    _on, m, mvp = _front_meta()
    calls = _front_calls(monkeypatch)
    monkeypatch.setattr(_build, "require_cuda", lambda *t, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)

    def no_build():
        raise RuntimeError("nvcc failed")

    runs = (lambda: RCL.clip_screen(m["p"], mvp, 36, 96),
            lambda: PT.plane_table(m["cch"], m["ch"], m["attrs"], m["cidx"]),
            lambda: BE.binned_entries(m["cch"], 36, 96))
    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        for run in runs:
            with pytest.raises(RuntimeError, match=match):
                run()
    assert calls == []
    # the failed launches
    assert (RCL.launches, PT.launches, BE.launches) == (1, 1, 1)


def test_bin_entries_never_fall_back(zero_counts, monkeypatch):
    """binned_entries on tensors that are not on the CPU reaches the
    kernel path, whose checks raise for anything but CUDA tensors and for
    what the kernels do not take; no call reaches the plain version."""
    _on, m, _mvp = _front_meta()
    calls = []
    monkeypatch.setattr(BE, "binned_entries_ref",
                        lambda *a, **k: calls.append(a))
    with pytest.raises(ValueError):
        BE.binned_entries(m["cch"], 36, 96)
    with pytest.raises(ValueError):
        BE.binned_entries(m["ch"], 36, 96, kernel="loop")
    monkeypatch.setattr(_build, "require_cuda", lambda *t, what: None)
    for kw in (dict(big_cap=0), dict(big_cap=BE.MAX_BIG_CAP + 1),
               dict(tile_window=0)):
        with pytest.raises(ValueError):
            BE.binned_entries(m["cch"], 36, 96, **kw)
    with pytest.raises(ValueError):  # 4,096 tiles: a key's tile overflows
        BE.binned_entries(m["cch"], 8 * 64, 128 * 64)
    assert calls == [] and BE.launches == 0


def _replay(t, geom, k, dims):
    """Operand k of a packed launch, read back as the kernel addresses it:
    sizes geom[:dims], strides geom[dims * (k + 1):dims * (k + 2)] from
    the tensor's own storage offset."""
    return torch.as_strided(t, geom[:dims], geom[dims * (k + 1):
                                                  dims * (k + 2)])


@pytest.mark.parametrize("case", FMA_CASES)
def test_fma32_packs_strides_and_scalars(case):
    """pack_operands + broadcast_geom hand the kernel each operand as its
    strides over the output (0 along a broadcast dimension) or as a
    float32 scalar; replayed with the kernel's addressing they give the
    same fused product-add as the plain version."""
    ops = fma_operands(case, "cpu")
    tensors, scalars, mask, shape = KFP.pack_operands(*ops, "cpu")
    geom = KFP.broadcast_geom(tensors, shape)
    D = KFP.MAX_DIMS
    vals = []
    for k, x in enumerate(ops):
        if mask >> k & 1:
            assert tensors[k] is None and isinstance(scalars[k], float)
            assert scalars[k] == float(np.float32(
                x.item() if isinstance(x, torch.Tensor) else x))
            vals.append(torch.full(geom[:D], scalars[k]))
        else:
            assert tensors[k].dtype == torch.float32
            vals.append(_replay(tensors[k], geom, k, D))
    assert geom[:D][D - len(shape):] == list(shape)
    want = fma32_f64(*ops)
    got = fma32_f64(*vals).reshape(shape)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "zero_d":  # a 0-d CPU tensor is a scalar, rounded to float32
        assert mask == 0b110 and scalars[2] == -1.25


def test_fma32_kernel_refuses_what_it_cannot_take():
    """More than 6 dimensions after broadcasting, or an operand that
    requires a gradient, raise before any build or launch."""
    x = torch.ones((1, 1, 1, 1, 1, 1, 2))
    with pytest.raises(ValueError):
        KFP.pack_operands(x, 1.0, torch.ones(2, requires_grad=True), "cpu")
    tensors, _s, _m, shape = KFP.pack_operands(x, 1.0, 2.0, "cpu")
    assert len(shape) == 7 > KFP.MAX_DIMS


# --------------------------------------------------------------------------
# the deferred shade
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_attrs,dir_light,n_pts", [
    (9, False, 5), (9, True, 5), (9, True, 0), (6, False, 0), (6, True, 0)],
    ids=["9_no_dl_5_of_8", "9_dl_5_of_8", "9_dl_none", "6_no_dl", "6_dl"])
def test_shade_rows_equals_jax(n_attrs, dir_light, n_pts):
    """_shade_rows (the plain version of the shade kernel) against the
    reference's _shade_rows under jax.jit, the same gathered rows and
    centres: no-hit pixels zero in both, colours within 1e-5 (the
    reference's rsqrt is an estimate refined by one Newton step, within
    an ulp of the correctly rounded 1 / sqrt)."""
    table, ids, px, py = shade_inputs(n_attrs, (6, 40))
    idx = ids.reshape(-1).long()
    g = table[torch.where(idx >= 0, idx, table.shape[0] - 1)]
    hit = ids >= 0
    ts = shade_builder(TSB, dir_light, n_pts).build(device="cpu")
    js = shade_builder(JSB, dir_light, n_pts).build()
    assert ts.pt_pos.shape[0] == (8 if n_pts else 0)
    assert int(ts.n_dl) == int(dir_light) and int(ts.n_pt) == n_pts
    want = np.asarray(jax.jit(JRC._shade_rows, static_argnums=(5,))(
        g.numpy(), hit.numpy(), px.numpy(), py.numpy(), js, n_attrs))
    got = RCM._shade_rows(g, hit, px, py, ts, n_attrs).numpy()
    assert got.shape == want.shape == (6, 40, 3)
    np.testing.assert_array_equal(got[~hit.numpy()], 0.0)
    np.testing.assert_array_equal(want[~hit.numpy()], 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[hit.numpy()] > 0).mean() > 0.5


def _jax_shade(table, ids, px, py, js, n_attrs):
    """The reference's shade of f32 winner ids as ``shade_groups`` gathers
    them (the id truncated, a hit where id >= 0.0), ``_shade_rows`` under
    jax.jit."""
    e = ids.numpy()
    idx = e.astype(np.int32)
    g = table.numpy()[np.where(idx >= 0, idx, 0)]
    return np.asarray(jax.jit(JRC._shade_rows, static_argnums=(5,))(
        g.reshape(-1, g.shape[-1]), e >= 0.0, px.numpy(), py.numpy(), js,
        n_attrs))


@pytest.mark.parametrize("dir_light", [True, False], ids=["dl", "no_dl"])
@pytest.mark.parametrize("n_pts", [0, 1, 2, 3])
def test_shade_ref_equals_jax_for_each_light_count(n_pts, dir_light):
    """The plain version (the gather, then ``_shade_rows``) against the
    reference's gather and ``_shade_rows`` under jax.jit, for 0 to 3 point
    lights with and without a directional light (without one, the
    default light): no-hit pixels zero in both, colours within 1e-5 (the
    reference's rsqrt is within an ulp of the correctly rounded one)."""
    table, ids, px, py = shade_inputs(9, (4, 8, 16), seed=n_pts)
    ts = shade_builder(TSB, dir_light, n_pts).build(device="cpu")
    js = shade_builder(JSB, dir_light, n_pts).build()
    assert int(ts.n_dl) == int(dir_light) and int(ts.n_pt) == n_pts
    got = RSH.shade_ref(table, ids, px, py, ts, 9).numpy()
    want = _jax_shade(table, ids, px, py, js, 9)
    hit = ids.numpy() >= 0
    np.testing.assert_array_equal(got[~hit], 0.0)
    np.testing.assert_array_equal(want[~hit], 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[hit] > 0).mean() > 0.5


@pytest.mark.parametrize("case", ["negative_zero_id", "id_past_the_table"])
def test_shade_edges_equal_jax(case):
    """An f32 id of -0.0 is a hit on row 0 (the plain version against the
    reference's gather and shade); an id past the table gives NaN rgb (the
    kernel's answer, which is ``_shade_rows`` of a row of NaN in the port
    and in the reference; the reference's gather would clamp such an id
    instead, and no caller makes one)."""
    table, ids, px, py = shade_inputs(9, (4, 8, 16), seed=5)
    ts = shade_builder(TSB, True, 2).build(device="cpu")
    js = shade_builder(JSB, True, 2).build()
    flat = ids.view(-1)
    if case == "negative_zero_id":
        flat[::7] = -0.0
        flat[3::7] = -0.5  # truncates to row 0, but is no hit
        got = RSH.shade_ref(table, ids, px, py, ts, 9).numpy()
        want = _jax_shade(table, ids, px, py, js, 9)
        zero = (flat == 0) & torch.signbit(flat)
        assert bool(zero.any())
        assert (got.reshape(-1, 3)[zero.numpy()] > 0).any()
        np.testing.assert_array_equal(got.reshape(-1, 3)[3::7], 0.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    past = np.zeros(flat.shape[0], bool)
    past[::5] = True
    idx = flat.long().clamp(min=0).numpy()
    g = table.numpy()[idx]
    g[past] = np.nan
    hit = (flat >= 0).numpy() | past
    px_, py_ = px.view(-1), py.view(-1)
    got = RCM._shade_rows(torch.from_numpy(g), torch.from_numpy(hit), px_,
                          py_, ts, 9).numpy()
    want = np.asarray(jax.jit(JRC._shade_rows, static_argnums=(5,))(
        g, hit, px_.numpy(), py_.numpy(), js, 9))
    assert np.isnan(got[past]).all() and np.isnan(want[past]).all()
    np.testing.assert_allclose(got[~past], want[~past], rtol=0, atol=1e-5)


def _div_magic(d):
    """csrc/raster_shade.cu's make_div: (magic, shift) of a divisor."""
    s = 0
    while (1 << s) < d:
        s += 1
    return (((1 << 32) * ((1 << s) - d)) // d + 1) & 0xFFFFFFFF, s


def test_shade_grid_division_is_exact():
    """The kernel's pixel-grid indices come from (umulhi(n, magic) + n) >>
    shift in 32-bit arithmetic: equal to n // d for every divisor and
    every n < 2^31 tried (the grids' own sizes, powers of two, random
    divisors; n at 0, d - 1, d, random and 2^31 - 1)."""
    rng = np.random.default_rng(7)
    ds = [1, 2, 3, 7, 8, 16, 36, 96, 128, 540, 960, 1024, 2 ** 30,
          2 ** 31 - 1, *rng.integers(1, 2 ** 31, 200).tolist()]
    for d in ds:
        magic, shift = _div_magic(d)
        n = np.r_[0, d - 1, d, 2 ** 31 - 1, rng.integers(0, 2 ** 31, 2000),
                  rng.integers(0, min(4 * d, 2 ** 31), 2000)].astype(
                      np.uint64)
        hi = (n * np.uint64(magic)) >> np.uint64(32)
        q = ((hi + n) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)
        np.testing.assert_array_equal(q, n // np.uint64(d), err_msg=str(d))


def test_shade_forms():
    """The kernel ships in one form, blocks of 128 threads (the source's
    RS_THREADS, which tools/build_variants overrides for its variants),
    and the wrapper takes no form; it refuses a table of no rows before
    any build."""
    src = (Path(RSH.__file__).parent / "csrc" / "raster_shade.cu").read_text()
    assert "#define RS_THREADS 128" in src
    assert list(inspect.signature(RSH.shade).parameters) == [
        "table", "ids", "px", "py", "scene", "n_attrs"]
    meta = torch.device("meta")
    scene = shade_builder(TSB, True, 3).build(device="cpu")
    table, ids, px, py = (t.to(meta) for t in shade_inputs(9, (2, 8, 16)))
    with pytest.raises(ValueError, match="holds no 9-attribute"):
        RSH.shade(table[:0], ids, px, py, scene, 9)


def _capture_shade(monkeypatch):
    """Record each call of ops/raster_shade.shade (its callers look it up
    on the module), passing it through."""
    calls = []

    def rec(table, ids, px, py, scene, n_attrs):
        calls.append((table, ids, px, py, scene, n_attrs))
        return RSH.shade_ref(table, ids, px, py, scene, n_attrs)

    monkeypatch.setattr(RSH, "shade", rec)
    return calls


def _replay_shade(table, ids, px, py, scene, n_attrs):
    """The shade of a packed launch on the CPU: every operand read back as
    the kernel addresses it (the table's rows by its row stride, ids and
    centres by their strides over the pixel grid), then the plain
    lighting."""
    shape = torch.broadcast_shapes(ids.shape, px.shape, py.shape)
    geom = KFP.broadcast_geom((ids, px, py), shape, RSH.MAX_DIMS)
    rows = torch.as_strided(table, (table.shape[0], 3 * n_attrs + 3),
                            (table.stride(0), 1))
    rids, rpx, rpy = (_replay(t, geom, k, RSH.MAX_DIMS)
                      for k, t in enumerate((ids, px, py)))
    return RSH.shade_ref(rows, rids, rpx, rpy, scene, n_attrs).reshape(
        *shape, 3)


def test_shade_callers_pack_their_layouts(monkeypatch):
    """Each caller of the shade hands it what its kernel can address: the
    headline's grouped tiles (f32 ids [grp, 8, 128], lane centres, the
    table a column slice of the wide pack), the mid path's plane table
    (i32 ids [rows, cols], centres as broadcast rows and columns) and the
    compacted tiles of the retired generations (truncated i32 ids);
    replayed with the kernel's addressing they give the caller's frame."""
    calls = _capture_shade(monkeypatch)
    scene = shade_builder(TSB, True, 2).build(device="cpu")
    table, ids, _px, _py = shade_inputs(9, (3, 8, 128), n_tris=60)
    wide = torch.zeros((table.shape[0], 64))
    wide[:, 16:16 + table.shape[1]] = table
    xl = torch.from_numpy(np.random.default_rng(2).integers(
        0, 4, (3, 128)).astype(np.float32) * 128 + np.arange(128)
        + 0.5).float()
    yl = torch.tensor([[0.0], [8.0], [16.0]]).expand(3, 128)
    outs = [R.shade_groups(ids, xl, yl, wide[:, 16:16 + table.shape[1]],
                           scene, 9)]
    tid = ids[:2].reshape(16, 128)[:, :96].to(torch.int32).contiguous()
    outs.append(RCM.shade_from_table(tid, table, scene, 16, 96, 9))
    etile = ids[:2].clone()
    nonempty = torch.tensor([True, True])
    outs.append(RO.shade_tiles_compact(etile, nonempty, table, scene, 8, 256,
                                       2, 9))
    assert len(calls) == 3
    assert calls[0][0].stride(0) == 64 and calls[0][1].dtype == torch.float32
    assert calls[1][1].dtype == torch.int32 == calls[2][1].dtype
    assert calls[1][2].stride() == (96, 1) and calls[1][2].shape == (1, 96)
    for (table_, ids_, px_, py_, sc, na), out in zip(calls, outs):
        got = _replay_shade(table_, ids_, px_, py_, sc, na)
        want = RSH.shade_ref(table_, ids_, px_, py_, sc, na)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (outs[0] > 0).any() and (outs[1] > 0).any()


# --------------------------------------------------------------------------
# the ray tracer's frame: where its products fuse
# --------------------------------------------------------------------------
_HELPERS = ("_mul_add", "_sub_mul", "_mul_sub", "_diff", "dot")
_NESTED = set(_HELPERS) | {"rdot", "cross", "norm", "w"}


def _record_fuses(monkeypatch, run):
    """Run ``run`` with rt_core's fuse helpers recorded: for each call of
    an intersection function of rt_core (spheres_t, planes_t, tris_t,
    tri_hit_info, reflect), its case and the "F" / "-" of each helper call
    in it, in the order the calls begin (for dot and _diff: whether the
    left product fused); for the sites of backends/raytrace itself, every
    decision under "raytrace". Returns {(case, function): [strings]}."""
    log, firsts = [], []
    real_fma = RC.fma32

    def fma(a, b, c):
        firsts.append(a)
        return real_fma(a, b, c)

    def wrap(name, fn):
        def w(*args):
            frame, names, top = sys._getframe(1), [], None
            while frame is not None:
                names.append(frame.f_code.co_name)
                if top is None and frame.f_code.co_name not in _NESTED:
                    top = frame
                frame = frame.f_back
            entry = [top, names, None]
            log.append(entry)
            n0 = len(firsts)
            out = fn(*args)
            if name == "_diff":
                entry[2] = firsts[n0] is args[0]
            elif name == "dot":
                entry[2] = firsts[n0] is args[0].x
            else:
                entry[2] = len(firsts) > n0
            return out
        return w

    monkeypatch.setattr(RC, "fma32", fma)
    for name in _HELPERS:
        monkeypatch.setattr(RC, name, wrap(name, getattr(RC, name)))
    run()
    monkeypatch.undo()
    seqs, cur = {}, None
    for top, names, fused in log:
        fn = top.f_code.co_name
        if top is not cur:
            cur = top
            if fn not in RTK.HELPERS:
                case = "raytrace"
            elif fn == "reflect":
                case = "bounce"
            elif top.f_locals["rd"].x.dim() == 0:
                case = "shadow_dir"
            elif "occluded" in names:
                case = "shadow_point"
            elif top.f_locals["ro"].x.shape[-1] == 1:
                case = "primary"
            else:
                case = "bounce"
            key = (case, "raytrace" if case == "raytrace" else fn)
            seqs.setdefault(key, []).append("")
        seqs[key][-1] += "F" if fused else "-"
    return seqs


def test_rt_fuse_table_equals_the_plain_decisions(monkeypatch):
    """ops/rt_trace.FUSE, the kernel's decision at every fuse site of the
    intersection helpers in each of the four cases, equals what the plain
    version decides when it renders a batch of views of a scene with a
    mirror, triangles, quads, a directional and a point light; every
    site of backends/raytrace itself fuses. The one site that varies, the
    sphere's c, is rt_core.sphere_c_fused for these shapes."""
    scene = rt_scene("tris_quad", "cpu")
    cams = orbit_cameras(3, center=(0, 1.0, 0.0), radius=5.0)
    seqs = _record_fuses(monkeypatch,
                         lambda: RT.render_rgb(scene, cams, 6, 10, 0.5))
    table = {}
    for (case, fn), runs in seqs.items():
        if case == "raytrace":
            assert set("".join(runs)) == {"F"}
            continue
        assert len(set(runs)) == 1, (case, fn, set(runs))
        assert len(runs[0]) == len(RTK.HELPERS[fn].split()), (case, fn)
        table.setdefault(case, {})[fn] = runs[0]
    assert table == RTK.FUSE
    n_sph = scene.sph_pos.shape[0]
    assert RC.sphere_c_fused((3, 1, 1), n_sph)
    assert not RC.sphere_c_fused((3, 1, 60), n_sph)


@pytest.mark.parametrize("views,rows,cols", [(2, 4, 6), (1, 4, 6),
                                             (2, 1, 1)])
def test_sphere_decision_follows_the_shapes(monkeypatch, views, rows, cols):
    """With one sphere slot, or one ray a view, the sphere's c fuses
    elsewhere than FUSE says. At every call of spheres_t the plain version
    makes, its decision is rt_core.sphere_c_fused of that call's
    origins, which have one of the two shapes raytrace.trace asks about."""
    sb = TSB()
    sb.add_plane([0, 1, 0], 0.0, TM.MIRROR)
    sb.add_sphere([0, 1, -1], 0.8, TM.RED)
    sb.add_point_light([1, 3, 2], [1, 0.9, 0.8], 2.0)
    sb.set_env_light([0.2, 0.3, 0.5], 1.0)
    scene = sb.build(min_pad=1, device="cpu")
    assert scene.sph_pos.shape[0] == 1
    cams = orbit_cameras(views, center=(0, 1.0, -1.0), radius=4.0)
    calls, firsts = [], []
    real_fma, real_sph, real_sub = RC.fma32, RC.spheres_t, RC._sub_mul

    def fma(a, b, c):
        firsts.append(a)
        return real_fma(a, b, c)

    def spheres_t(ro, *args):
        calls.append([tuple(ro.x.shape), None])
        return real_sph(ro, *args)

    def sub_mul(x, a, b):  # the sphere's c, or the bounce's reflect
        n0 = len(firsts)
        out = real_sub(x, a, b)
        if calls and calls[-1][1] is None:
            calls[-1][1] = len(firsts) > n0
        return out

    monkeypatch.setattr(RC, "fma32", fma)
    monkeypatch.setattr(RC, "spheres_t", spheres_t)
    monkeypatch.setattr(RC, "_sub_mul", sub_mul)
    RT.render_rgb(scene, cams, rows, cols, 0.5)
    monkeypatch.undo()
    asked = {(views, 1, 1), (views, 1, rows * cols)}
    assert {shape for shape, _f in calls} <= asked
    for shape, fused in calls:
        assert fused == RC.sphere_c_fused(shape, 1), shape
    assert len(calls) >= 3


def test_light_pair_follows_the_slots():
    """The first two set light slots are 0 and 1 only where two
    directional lights are set: the builder pads the directional slots to
    8, so a point light's slot is 8 or more."""
    two = rt_scene("two_lights", "cpu")
    assert two.dl_dir.shape[0] == 8
    assert RTK.light_pair(two, 2, 2) and RTK.light_pair(two, 2, 0)
    demo = create_rt_demo_scene().build(min_pad=1, device="cpu")
    assert not RTK.light_pair(demo, 1, 1)
    assert not RTK.light_pair(demo, 0, 2)


# --------------------------------------------------------------------------
# the ray tracer's frame: its tile reduction
# --------------------------------------------------------------------------
K_NONE = 2 ** 31 - 1  # csrc/rt_trace.cu kNone
K_BIG = float(np.float32(1e30))


def _before(ta, ka, tb, kb) -> bool:
    """csrc/rt_trace.cu before(): a NaN first, then the lesser t (-0 ==
    +0), then the lesser slot; K_NONE is no candidate."""
    if kb == K_NONE:
        return ka != K_NONE
    if ka == K_NONE:
        return False
    na, nb = np.isnan(ta), np.isnan(tb)
    if na != nb:
        return bool(na)
    if not na and ta != tb:
        return ta < tb
    return ka < kb


def _tile_first_min(t, slots, L):
    """closest_hit's search as a tile of L lanes runs it: lane r takes
    items r, r + L, ... with the serial take (the first minimum, a NaN
    first), then the xor butterfly with before(). Every lane must end with
    the same (t, slot)."""
    lanes = []
    for r in range(L):
        best, k = 0.0, K_NONE
        for i in range(r, len(t), L):
            if k == K_NONE or t[i] < best or (np.isnan(t[i])
                                              and not np.isnan(best)):
                best, k = float(t[i]), int(slots[i])
        lanes.append((best, k))
    m = L // 2
    while m:
        lanes = [lanes[j ^ m] if _before(*lanes[j ^ m], *lanes[j])
                 else lanes[j] for j in range(L)]
        m //= 2
    assert len({(repr(a), b) for a, b in lanes}) == 1
    return lanes[0]


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32])
def test_rt_tile_reduction_is_the_first_minimum(L):
    """Over random t arrays of slots, some invalid (NaN, +-0, K_BIG ties,
    duplicates, no valid slot), the tile's search over the valid slots
    gives torch.argmin's first minimum of them; where that is a hit (t <
    5e29) or NaN it is also argmin's over every slot with the invalid
    ones at K_BIG, as the plain version searches; with no valid slot it is
    no candidate."""
    rng = np.random.default_rng(L)
    for case in range(300):
        n = int(rng.integers(1, 90))
        t = rng.choice(np.float32([0.5, 2.0, 7.25, K_BIG, 0.0, -0.0, np.nan,
                                   3e29, 6e29, np.inf]), n)
        t = np.where(rng.random(n) < 0.4, rng.uniform(0.1, 50, n)
                     .astype(np.float32), t).astype(np.float32)
        if case % 7 == 0:
            t[rng.integers(0, n, 3)] = np.float32(np.nan)
        valid = rng.random(n) < (0.0 if case % 11 == 0 else 0.6)
        slots = np.flatnonzero(valid)
        got_t, got_k = _tile_first_min(t[slots], slots, L)
        if not slots.size:
            assert got_k == K_NONE
            continue
        j = int(torch.argmin(torch.from_numpy(t[slots])))
        assert got_k == slots[j], (case, t[slots], got_k)
        full = np.where(valid, t, np.float32(K_BIG))
        if np.isnan(got_t) or got_t < 5e29:
            assert got_k == int(torch.argmin(torch.from_numpy(full)))


def _fmaf(a, b, c):
    """One float32 fma of numpy float32 arrays (core/fp.fma32_f64)."""
    return fma32_f64(*(torch.from_numpy(np.asarray(x, np.float32))
                       for x in (a, b, c))).numpy()


def _replay_grid_form(grid, cam):
    """The grid form's primary rays as the kernel computes them, replayed
    on the CPU in float32: ray i of V * R (R = band * cols) takes view
    i // R, row row_lo + j // cols and column j % cols of j = i - view *
    R, the view's 12 floats (origin, uu, vv, focal * ww) as the wrapper
    sends them, then ray_dir.cuh's jit_centre and direction<true>.
    Returns (origins, directions) f32 [V, R, 3]."""
    views = RTK._grid_views(grid, cam).numpy()
    from ascii_renderer_tpu_torch.core.camera import jit_grid_consts
    sx, sy, aspect = (np.float32(c) for c in jit_grid_consts(
        grid.rows, grid.cols, grid.pixel_aspect))
    V, R = views.shape[0], grid.band * grid.cols
    i = np.arange(V * R)
    view = i // R
    j = i - view * R
    r, col = j // grid.cols, j % grid.cols
    b = views[view]
    x = _fmaf(col.astype(np.float32) + np.float32(0.5), sx,
              np.float32(-1.0)) * aspect
    y = _fmaf((grid.rows - 1 - (grid.row_lo + r)).astype(np.float32)
              + np.float32(0.5), sy, np.float32(-1.0))
    d = [_fmaf(x, b[:, 3 + k], y * b[:, 6 + k]) + b[:, 9 + k]
         for k in range(3)]
    length = torch.from_numpy(_fmaf(d[2], d[2], _fmaf(d[1], d[1],
                                                      d[0] * d[0])))
    from ascii_renderer_tpu_torch.core.fp import sqrt32
    length = sqrt32(length).numpy()
    rd = np.stack([dk / length for dk in d], axis=-1)
    return b[:, :3].reshape(V, R, 3), rd.reshape(V, R, 3)


@pytest.mark.parametrize("views,rows,cols,row_lo,band", [
    (1, 36, 96, 0, 36), (3, 36, 96, 12, 12), (2, 7, 5, 6, 1),
    (4, 24, 40, 0, 24)])
def test_grid_form_rays_replay_the_plain_grid(views, rows, cols, row_lo,
                                              band):
    """The grid form's rays, replayed as the kernel indexes and rounds
    them, equal rt_trace.grid_rays (ndc_grid_jit + ray_dirs_jit, the
    render path's plain grid) bit for bit, and the origins are the views'
    own; grid_rays of a band is those rows of the full grid's."""
    cams = orbit_cameras(views, center=(0, 1.0, 1.0))
    yaw, pitch, fov = (getattr(cams, f) for f in ("yaw", "pitch", "fov_y"))
    from ascii_renderer_tpu_torch.core.camera import camera_bases
    grid = RTK.Grid(camera_bases(yaw, pitch, fov), rows, cols, 0.5, row_lo,
                    band)
    cam = cams.pos.reshape(-1, 3)
    ro, rd = _replay_grid_form(grid, cam)
    want = RTK.grid_rays(grid, "cpu")
    assert want.shape == (views, band * cols, 3)
    assert np.array_equal(_bits(rd), _bits(want))
    assert np.array_equal(ro, np.broadcast_to(cam.numpy()[:, None],
                                              ro.shape))
    full = RTK.grid_rays(grid._replace(row_lo=0, band=rows), "cpu")
    assert torch.equal(want, full.reshape(views, rows, cols, 3)[
        :, row_lo:row_lo + band].reshape(want.shape))


def _grid_case(case):
    """(scene, prims, cam, rd3, grid) of one wrong call of the grid form:
    each raises ValueError before anything launches."""
    from ascii_renderer_tpu_torch.core.camera import camera_bases
    rs = create_rt_demo_scene().build(device="cpu")
    pr = RT.ScenePrims(rs)
    cams = orbit_cameras(2, center=(0, 1.0, 1.0))
    bases = camera_bases(cams.yaw, cams.pitch, cams.fov_y)
    grid = RTK.Grid(bases, 6, 8, 0.5, 0, 6)
    cam = cams.pos.reshape(-1, 3)
    rd3 = torch.zeros((2, 48, 3))
    return {"rays and grid": (rs, pr, cam, rd3, grid),
            "neither": (rs, pr, cam, None, None),
            "band past the grid": (rs, pr, cam, None,
                                   grid._replace(row_lo=4, band=3)),
            "no columns": (rs, pr, cam, None, grid._replace(cols=0)),
            "origins of other views": (rs, pr, cam[:1], None, grid),
            "scene on the host": (rs, pr, cam, None, grid)}[case]


@pytest.mark.parametrize("case", ["rays and grid", "neither",
                                  "band past the grid", "no columns",
                                  "origins of other views",
                                  "scene on the host"])
def test_trace_grid_form_refuses_what_it_cannot_take(zero_counts, case):
    """ops/rt_trace.trace takes its rays from rd3 or from a grid, never
    both or neither; a grid's band must lie inside it, with columns, and
    its origins match its views; a host scene never reaches the kernel.
    Each raises ValueError and launches nothing."""
    scene, pr, cam, rd3, grid = _grid_case(case)
    with pytest.raises(ValueError):
        RTK.trace(scene, pr, cam, rd3, (True, True), grid=grid)
    assert RTK.launches == 0


def _replay_view_basis(t):
    """ray_dir.cuh's view_basis of one view's 8 floats, replayed on Python
    floats in the kernel's order (core/fp's one-rounding scalar ops): the
    view's 12 floats (origin, uu, vv, focal * ww)."""
    import math

    from ascii_renderer_tpu_torch.core.fp import (div32, fma32_scalar,
                                                  round32, sqrt32_scalar)

    def norm(a):
        return sqrt32_scalar(fma32_scalar(a[2], a[2], fma32_scalar(
            a[1], a[1], round32(a[0] * a[0]))))

    def cross(a, b):
        return [fma32_scalar(a[(k + 1) % 3], b[(k + 2) % 3],
                             -round32(a[(k + 2) % 3] * b[(k + 1) % 3]))
                for k in range(3)]

    def keep_nan_max(v, lo):
        return v if math.isnan(v) else (lo if v < lo else v)

    t = [float(x) for x in t]
    cp, sp, cy, sy, half = t[3:]
    ww = [round32(cp * cy), sp, round32(cp * sy)]
    nw = norm(ww)
    ww = [div32(x, nw) for x in ww]
    uu = cross(ww, [0.0, 1.0, 0.0])
    nu = norm(uu)
    if nu < round32(1e-3):
        uu = [1.0, 0.0, 0.0]
    else:
        d = keep_nan_max(nu, round32(1e-20))
        uu = [div32(x, d) for x in uu]
    vv = cross(uu, ww)
    nv = norm(vv)
    focal = div32(1.0, keep_nan_max(half, round32(1e-6)))
    return t[:3] + uu + [div32(x, nv) for x in vv] + [round32(focal * w)
                                                      for w in ww]


@pytest.mark.parametrize("views,rows,cols,row_lo,band", [
    (9, 7, 5, 0, 7), (16, 24, 40, 12, 12), (1024, 3, 4, 1, 2)])
def test_trig_grid_form_replays_the_plain_grid(views, rows, cols, row_lo,
                                               band):
    """K3's trig form's inputs (core/camera.view_trig, each view's origin
    and trig) with its bases formed as the kernel forms them (view_basis,
    replayed on Python floats) give the 12 floats the bases grid sends
    (trig_views_ref too) bit for bit, and rays equal to rt_trace.grid_rays
    of the bases grid (and of the trig grid) bit for bit."""
    from ascii_renderer_tpu_torch.core.camera import camera_bases, view_trig
    cams = orbit_cameras(views, center=(0, 1.0, 1.0))
    yaw, pitch, fov = (getattr(cams, f) for f in ("yaw", "pitch", "fov_y"))
    cam = cams.pos.reshape(-1, 3)
    grid = RTK.Grid(camera_bases(yaw, pitch, fov), rows, cols, 0.5, row_lo,
                    band)
    trig = view_trig(cam, yaw, pitch, fov)
    tgrid = RTK.Grid(None, rows, cols, 0.5, row_lo, band, trig)
    want12 = RTK._grid_views(grid, cam).numpy()
    replayed = np.asarray([_replay_view_basis(t) for t in trig], np.float32)
    assert np.array_equal(_bits(replayed), _bits(want12))
    assert np.array_equal(_bits(RTK.trig_views_ref(trig).numpy()),
                          _bits(want12))
    assert np.array_equal(RTK._grid_views(tgrid, cam).numpy(), trig)
    ro, rd = _replay_grid_form(grid, cam)
    want = RTK.grid_rays(grid, "cpu")
    assert np.array_equal(_bits(rd), _bits(want))
    assert torch.equal(RTK.grid_rays(tgrid, "cpu").view(torch.int32),
                       want.view(torch.int32))


def test_trig_grid_table_checks():
    """A trig grid's table is f32 [V, 8] with one origin a view: another
    width, rays given beside the grid or another count of origins raise
    ValueError before anything launches."""
    from ascii_renderer_tpu_torch.core.camera import camera_bases, view_trig
    rs = create_rt_demo_scene().build(device="cpu")
    pr = RT.ScenePrims(rs)
    cams = orbit_cameras(9, center=(0, 1.0, 1.0))
    cam = cams.pos.reshape(-1, 3)
    yaw, pitch, fov = cams.yaw, cams.pitch, cams.fov_y
    bgrid = RTK.Grid(camera_bases(yaw, pitch, fov), 6, 8, 0.5, 0, 6)
    tgrid = bgrid._replace(bases=None, trig=view_trig(cam, yaw, pitch, fov))
    n0 = RTK.launches
    with pytest.raises(ValueError, match=r"\[V, 8\]"):  # another width
        RTK.trace(rs, pr, cam, None, (True, True),
                  grid=tgrid._replace(trig=tgrid.trig[:, :7]))
    with pytest.raises(ValueError, match="one of the rays"):
        RTK.trace(rs, pr, cam, torch.zeros((9, 48, 3)), (True, True),
                  grid=tgrid)
    with pytest.raises(ValueError, match="cam"):  # 8 origins for 9 views
        RTK.trace(rs, pr, cam[:8], None, (True, True), grid=tgrid)
    assert RTK.launches == n0
