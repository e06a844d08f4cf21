"""K1b, the progressive tracer's statistics step (``ops/accum``,
``csrc/accum.cu``), against its plain version: on the card bit for bit
(NaN in the same places) at the progressive shapes [36, 96] and
[540, 960], in both statistics modes, with and without a reset and a
sample alpha plane, with and without the any-active flags; a fold is one
launch, a camera move's too (no fill); a failed build or launch raises.
On the CPU: CPU tensors launch nothing, and past the device checks a
failed build or launch raises (meta tensors). No JAX here (the card's
machine has none); the ``cuda`` tests skip without a card. The plain
version against JAX is ``tests/test_torch_accum.py``."""

import pytest
import torch

from ascii_renderer_tpu_torch.core.camera import Camera
from ascii_renderer_tpu_torch.ops import _build
from ascii_renderer_tpu_torch.ops import accum as OA
from ascii_renderer_tpu_torch.ops import fp as KFP
from ascii_renderer_tpu_torch.sim import accum as SA
from ascii_renderer_tpu_torch.tools.xla_inputs import accum_case

torch.set_num_threads(2)

KW = dict(max_tolerance=0.1, max_samples=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


class _FailingLib:
    """A kernel library whose every launch reports a CUDA error."""

    def __getattr__(self, name):
        return lambda *args: 700  # cudaErrorIllegalAddress


def _case(shape, seed, dev):
    c = accum_case(shape, seed, KW["max_samples"])
    return ({k: torch.from_numpy(v).to(dev) for k, v in c.items()})


def _same(got, want, what):
    """NaN in the same places, every other value bit for bit."""
    got = got.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if not got.is_floating_point():
        assert torch.equal(got, want), what
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32)), what


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("with_alpha", [False, True])
@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("mode", ["rgb", "perceptual"])
@pytest.mark.parametrize("shape", [(36, 96), (540, 960)])
def test_k1b_equals_plain_on_cuda(cuda_device, shape, mode, reset,
                                  with_alpha, flags):
    c = _case(shape, 3 + len(mode), cuda_device)
    state = tuple(c[f] for f in OA.FIELDS)
    sa = c["sample_alpha"] if with_alpha else None
    kw = dict(KW, stats_mode=mode, reset=reset)
    fl = torch.tensor([0, 7], dtype=torch.int32, device=cuda_device) \
        if flags else None
    n0 = OA.launches
    new, disp, act, skip = OA.accumulate(state, c["sample"], sa, flags=fl,
                                         slot=0, **kw)
    torch.cuda.synchronize()
    assert OA.launches == n0 + 1
    fl_ref = torch.tensor([0, 7], dtype=torch.int32) if flags else None
    want = OA.accumulate_ref(
        tuple(t.cpu() for t in state), c["sample"].cpu(),
        None if sa is None else sa.cpu(), flags=fl_ref, slot=0, **kw)
    for f, g, w in zip(OA.FIELDS, new, want[0]):
        _same(g, w, f)
    for what, g, w in zip(("display", "act", "skip"), (disp, act, skip),
                          want[1:]):
        _same(g, w, what)
    if flags:
        assert fl.cpu().tolist() == fl_ref.tolist() == [
            int(bool(want[2].any())), 0]
    if not reset:
        assert 0 < int(act.sum()) < act.numel()
        assert 0 < int(skip.sum()) < skip.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("moved", [False, True])
def test_a_fold_is_one_launch(cuda_device, moved):
    """sim/accum.accumulate on the card: one kernel row in the profile,
    K1b's, and no fma32, whether or not the camera moved (a move folds
    into a zero state without a fill)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    c = _case((36, 96), 5, cuda_device)
    cam = Camera.create(pos=(0, 2.5, 6), yaw=-1.5)
    state = SA.AccumState.create(36, 96, cuda_device)
    state, _d, _a = SA.accumulate(state, c["sample"], cam, **KW)
    if moved:
        cam = Camera.create(pos=(0, 2.5, 5.5), yaw=-1.5)
    torch.cuda.synchronize()
    k1 = KFP.launches
    for _attempt in range(5):  # the profiler now and then drops the rows
        # at a session's edge: spin kernels sit there, and are left out
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            new, _d, act = SA.accumulate(state, c["sample"], cam,
                                         sample_alpha=c["sample_alpha"],
                                         **KW)
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "spin_kernel" not in e.name]
        if names:
            break
    assert len(names) == 1 and "accum_kernel" in names[0], names
    assert KFP.launches == k1
    # every pixel warms up: a second sample, or the first after the reset
    assert bool(act.all())
    assert torch.equal(new.count.cpu(),
                       torch.full((36, 96), 1.0 if moved else 2.0))


@pytest.mark.cuda
def test_k1b_raises_on_build_or_launch_failure(cuda_device, monkeypatch):
    """A failed build and a failed launch each raise out of the wrapper,
    which never reaches the plain version."""
    c = _case((36, 96), 1, cuda_device)
    plain = []
    monkeypatch.setattr(OA, "accumulate_ref", lambda *a, **k: plain.append(a))

    def no_build():
        raise RuntimeError("nvcc failed")

    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        with pytest.raises(RuntimeError, match=match):
            OA.accumulate(tuple(c[f] for f in OA.FIELDS), c["sample"],
                          reset=False, **KW)
    assert plain == []


def test_k1b_cpu_launches_nothing_and_failures_raise(monkeypatch):
    """CPU tensors take the plain version and count no launch; past the
    device checks (meta tensors) a failed build or launch raises, with no
    fallback to the plain version; a sample that is not [..., 3] raises
    ValueError."""
    c = _case((6, 10), 2, "cpu")
    n0 = OA.launches
    OA.accumulate(tuple(c[f] for f in OA.FIELDS), c["sample"], reset=True,
                  **KW)
    assert OA.launches == n0
    meta = tuple(c[f].to("meta") for f in OA.FIELDS)
    sample = c["sample"].to("meta")
    plain = []
    monkeypatch.setattr(OA, "accumulate_ref", lambda *a, **k: plain.append(a))
    monkeypatch.setattr(_build, "require_device", lambda *t, what: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)

    def no_build():
        raise RuntimeError("nvcc failed")

    for lib, match in ((no_build, "nvcc failed"),
                       (lambda: _FailingLib(), "launch failed")):
        monkeypatch.setattr(_build, "lib", lib)
        for reset in (False, True):
            with pytest.raises(RuntimeError, match=match):
                OA.accumulate(meta, sample, reset=reset, **KW)
    assert plain == []
    with pytest.raises(ValueError):
        OA.accumulate(meta, sample[..., :2], reset=False, **KW)
