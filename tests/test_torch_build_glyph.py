"""The glyph tail's kernels against their plain versions on the card, bit
for bit: X12a (``ops/frame_bytes``, ``Frame.from_float`` with and
without the alpha and UI planes) and B4's chars form
(``ops/ascii_kernel.glyph_chars``: from the rgb bytes or an index plane,
the mode filter on at radius 1-3 and K = 1 / 4, and off; ramps of one
code, ten and a hundred), on one grid and on
batches of views, and the float frame to chars in exactly two launches.
No JAX here (the card's machine has none); the tests are marked ``cuda``
and skip without a card. The CPU side of both is
``tests/test_torch_glyph_tail.py``."""

import pytest
import torch

from ascii_renderer_tpu_torch.ascii import ascii_pass as TA
from ascii_renderer_tpu_torch.core import quantize as Q
from ascii_renderer_tpu_torch.core.frame import Frame
from ascii_renderer_tpu_torch.ops import ascii_kernel as AK
from ascii_renderer_tpu_torch.ops import frame_bytes as FB
from ascii_renderer_tpu_torch.tools.xla_inputs import GLYPH_RAMPS, glyph_frame

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
