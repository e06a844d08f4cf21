"""The glyph tail's kernels against their plain versions on the card, bit
for bit: X12a (``ops/frame_bytes``, ``Frame.from_float`` with and
without the alpha and UI planes, and its UI form: the frame step's UI
layer by value, its ripple cells against the reference march for every
radius 0-200, the entry() step's ``frame.compose`` one launch with no
copy to the card) and B4's chars form
(``ops/ascii_kernel.glyph_chars``: from the rgb bytes or an index plane,
the mode filter on at radius 1-3 and K = 1 / 4, and off; ramps of one
code, ten and a hundred), on one grid and on
batches of views, and the float frame to chars in exactly two launches.
No JAX here (the card's machine has none); the tests are marked ``cuda``
and skip without a card. The CPU side of both is
``tests/test_torch_glyph_tail.py``."""

import numpy as np
import pytest
import torch

from ascii_renderer_tpu_torch.ascii import ascii_pass as TA
from ascii_renderer_tpu_torch.core import quantize as Q
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
from ascii_renderer_tpu_torch.ops import frame_bytes as FB
from ascii_renderer_tpu_torch.sim import ui as U
from ascii_renderer_tpu_torch.tools.xla_inputs import (GLYPH_RAMPS,
                                                       glyph_frame,
                                                       ripple_case)

torch.set_num_threads(2)

SHAPES = ((540, 960), (36, 96), (13, 45), (1, 1), (61, 1), (3, 36, 96),
          (5, 13, 45))
THRESH = {1: 5, 2: 12, 3: 24}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _frame(shape, seed, dev):
    return tuple(torch.from_numpy(x).to(dev)
                 for x in glyph_frame(shape, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rgb", "rgb+a", "rgb+a+ui", "rgb+ui"])
@pytest.mark.parametrize("shape", SHAPES)
def test_frame_bytes_equals_plain_on_cuda(cuda_device, shape, form):
    rgb, a, chars, mask = _frame(shape, len(shape) * 10 + len(form),
                                 cuda_device)
    a = a if "+a" in form else None
    ui = (chars, mask) if "ui" in form else (None, None)
    n = FB.launches
    got = FB.frame_bytes(rgb, a, *ui)
    torch.cuda.synchronize()
    assert FB.launches == n + 1
    want = FB.frame_bytes_ref(*(None if t is None else t.cpu()
                                for t in (rgb, a, *ui)))
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["padded rows", "padded views",
                                  "transposed"])
def test_frame_bytes_of_strided_rows_equals_plain_on_cuda(cuda_device, view):
    """X12a reads rows one stride apart as they lie (the raster's image, a
    view of its padded tile grid: one launch, no copy); other strides take
    one copy first."""
    rgb, a, chars, mask = _frame((2, 544, 1024), 5, cuda_device)
    if view == "padded rows":
        rgb = rgb[0, :540, :960]
    elif view == "padded views":
        rgb = rgb[:, :540, :960]
    else:
        rgb = rgb[0, :96, :80].transpose(0, 1)
    shape = tuple(rgb.shape[:-1])
    assert not rgb.is_contiguous()
    n = FB.launches
    got = FB.frame_bytes(rgb)
    torch.cuda.synchronize()
    assert FB.launches == n + 1
    want = FB.frame_bytes_ref(rgb.cpu())
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1]) and got[1].shape == shape


@pytest.mark.cuda
# (radius, cells a thread); radius 0: the mode filter off
@pytest.mark.parametrize("mode,cells", [(0, None), (1, 1), (1, 4), (2, 1),
                                        (2, 4), (3, 1), (3, 4)])
@pytest.mark.parametrize("ramp", range(len(GLYPH_RAMPS)))
def test_glyph_chars_equals_plain_on_cuda(cuda_device, ramp, mode, cells):
    ramp = GLYPH_RAMPS[ramp]
    for k, shape in enumerate(SHAPES):
        rgb, a, chars, mask = _frame(shape, k + 7 * mode, cuda_device)
        frame = Frame.from_float(rgb, a, overrides=(chars, mask))
        idx = Q.quantize_index(frame.rgb, len(ramp))
        kw = dict(mode_on=mode > 0, radius=max(mode, 1),
                  thresh=THRESH[max(mode, 1)], cells=cells)
        for src in (frame.rgb, idx):
            n = (AK.launches, AK.launches_chars, AK.launches_map)
            got = AK.glyph_chars(src, frame.a, ramp, **kw)
            torch.cuda.synchronize()
            assert (AK.launches, AK.launches_chars, AK.launches_map) == (
                n[0] + (mode > 0), n[1] + (mode > 0), n[2] + (mode == 0))
            want = AK.glyph_chars_ref(src.cpu(), frame.a.cpu(), ramp,
                                      mode_on=mode > 0, radius=max(mode, 1),
                                      thresh=THRESH[max(mode, 1)])
            assert torch.equal(got.cpu(), want), (shape, src.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 2])
def test_float_frame_to_chars_in_two_launches_on_cuda(cuda_device, mode):
    """Frame.from_float (with the UI plane) then glyph_decide: X12a and the
    chars form, one launch each, and nothing else on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rgb, a, chars, mask = _frame((540, 960), 3, cuda_device)
    kw = dict(ramp=GLYPH_RAMPS[1], mode_on=mode > 0, mode_radius=2,
              mode_thresh=12, grayscale=False)

    def run():
        return TA.glyph_decide(Frame.from_float(rgb, a,
                                                overrides=(chars, mask)),
                               **kw)[0]

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 2, names
    cpu = Frame.from_float(rgb.cpu(), a.cpu(), overrides=(chars.cpu(),
                                                          mask.cpu()))
    assert torch.equal(got.cpu(), TA.glyph_decide(cpu, **kw)[0])


def _ui_pool(rows, cols, n, seed, radius=None):
    """n live ripples of a seeded pool over and around a rows x cols grid
    (every radius ``radius`` where given), the clock at 1,500 ms."""
    rng = np.random.default_rng(seed)
    rip = np.stack([rng.uniform(-20, cols + 20, 16),
                    rng.uniform(-20, rows + 20, 16),
                    rng.uniform(0, 1500, 16)], -1).astype(np.float32)
    if radius is not None:
        rip[:, 2] = 1500.0 - radius / 0.05
    rip[0] = (0.0, rows - 1.0, 1500.0)  # radius 0 at the corner
    return rip, n, 1500.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 16])
@pytest.mark.parametrize("shape", [(1, 1), (36, 96), (13, 45), (540, 960)])
def test_frame_bytes_ui_form_equals_plain_on_cuda(cuda_device, shape, n):
    """X12a's UI form (the UI layer by value: border, FPS digits, live
    ripples marched in the launch) against its plain version (the planes
    drawn on the host, then burnt in), bit for bit, with and without an
    alpha plane, at FPS values 0, 7, 1e7, NaN and half-way ones."""
    from ascii_renderer_tpu_torch.core.config import Config
    rows, cols = shape
    rgb, a, _c, _m = _frame(shape, rows + n, cuda_device)
    for k, fps in enumerate((0.0, 7.0, 1e7, float("nan"), 2.5, 59.5)):
        rip, nr, t = _ui_pool(rows, cols, n, k + n,
                              radius=100.0 if k == 5 else None)
        ui = U.ui_params(Config(), rows, cols, fps, rip, nr, t)
        alpha = a if k % 2 else None
        n0, u0 = FB.launches, FB.launches_ui
        got = FB.frame_bytes(rgb, alpha, ui=ui)
        torch.cuda.synchronize()
        assert (FB.launches, FB.launches_ui) == (n0 + 1, u0 + 1)
        want = FB.frame_bytes_ref(rgb.cpu(), None if alpha is None
                                  else alpha.cpu(), ui=ui)
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8 and torch.equal(g.cpu(), w), fps


@pytest.mark.cuda
@pytest.mark.parametrize("radii", [range(0, 101), range(101, 201)],
                         ids=["0-100", "101-200"])
def test_ui_form_ripple_cells_equal_the_march(cuda_device, radii):
    """X12a's UI form's ripple cells against the reference march itself
    (``sim/ui._bresenham_np``: the JS err rule, 8 octants, 128 steps at
    most) for every radius 0-200: one ripple at the centre of a grid that
    holds its box and two cells more on each side, its '*' cells exactly
    the march's (``tools/xla_inputs.ripple_case``). From radius 128 on
    the kernel replays the march."""
    for r in radii:
        ui, want = ripple_case(r)
        rgb = torch.zeros((ui.rows, ui.cols, 3), device=cuda_device)
        _rgb8, a = FB.frame_bytes(rgb, ui=ui)
        got = (a == ord("*")).cpu().numpy()
        assert np.array_equal(got, want), (r, np.argwhere(got != want)[:5])


@pytest.mark.cuda
@pytest.mark.parametrize("ripples", [0, 16])
def test_entry_step_compose_is_one_launch_and_no_copy(cuda_device,
                                                      monkeypatch, ripples):
    """entry()'s step on the card: after its first frame, frame.compose is
    one launch (X12a's UI form) and asks the card for no other op and no
    copy from the host; the step's chars and tint equal the CPU step's,
    with live ripples too."""
    import contextlib

    from torch.utils._python_dispatch import TorchDispatchMode

    from ascii_renderer_tpu_torch.entry import entry
    from ascii_renderer_tpu_torch.sim import framestep as FS
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
            if stage[0] == "frame.compose":
                flat = [t for t in torch.utils._pytree.tree_leaves(
                    (args, kwargs, out)) if isinstance(t, torch.Tensor)]
                devs = {t.device.type for t in flat}
                if "cuda" in devs:
                    ops.append((func.__name__.split(".")[0], devs))
            return out

    fn, args = entry(device="cuda")
    fn_c, args_c = entry(device="cpu")
    state, state_c = args[1], args_c[1]
    if ripples:
        rip, n, _t = _ui_pool(36, 96, ripples, 3)
        rip[:, 2] = -np.linspace(0.0, 1900.0, 16)  # radii 0 to 95 at t = 0
        kw = dict(ripples=torch.from_numpy(rip),
                  n_ripples=torch.tensor(n, dtype=torch.int32))
        state, state_c = state.replace(**kw), state_c.replace(**kw)
    state, _ch, _t = fn(args[0], state, *args[2:])
    state_c, _ch, _t = fn_c(args_c[0], state_c, *args_c[2:])
    monkeypatch.setattr(FS, "record_function", stage_range)
    n0, u0 = FB.launches, FB.launches_ui
    with Count():
        state, chars, tint = fn(args[0], state, *args[2:])
    torch.cuda.synchronize()
    assert (FB.launches, FB.launches_ui) == (n0 + 1, u0 + 1)
    no_launch = {"empty", "empty_strided", "view", "_unsafe_view",
                 "reshape", "as_strided", "detach", "alias", "slice",
                 "select", "expand", "t", "permute", "unsqueeze", "squeeze",
                 "lift_fresh", "_reshape_alias"}
    assert not [o for o, _d in ops if o not in no_launch], ops
    assert not [o for o, d in ops if "cpu" in d], ops
    _s, chars_c, tint_c = fn_c(args_c[0], state_c, *args_c[2:])
    assert torch.equal(chars.cpu(), chars_c)
    assert torch.equal(tint.cpu(), tint_c)
    if ripples:
        assert (chars_c == ord("*")).any()
