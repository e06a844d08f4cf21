"""``fma32`` is the correctly rounded float32 fused multiply-add, checked
against exact rational arithmetic, including the float64 double-rounding
ties that a plain float64 evaluation gets wrong."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from ascii_renderer_tpu_torch.core.fp import fma32

torch.set_num_threads(2)


def _round_f32(q: Fraction) -> np.float32:
    """Nearest float32 to the rational q, ties to even (normal range)."""
    lo = np.float32(float(q))          # within an ulp of q
    cands = {lo, np.nextafter(lo, np.float32(np.inf)),
             np.nextafter(lo, np.float32(-np.inf))}
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.asarray(v).view(np.int32)) & 1))
    return np.float32(best)


def _exact(a, b, c):
    return np.asarray([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)], np.float32)


def _f32(*xs):
    return np.asarray(xs, np.float32)


# a*b + c lands a hair off a float32 midpoint, and the float64 sum rounds
# onto it: only the sign of the lost part decides
ULP = 2.0 ** -23
TIES = (
    _f32(1 + ULP, 1 - ULP, 1 + ULP, -(1 + ULP)),
    _f32(2.0 ** -24 * (1 - ULP), 2.0 ** -24 * (1 + ULP), 2.0 ** -14 * (1 - ULP),
         2.0 ** -24 * (1 - ULP)),
    _f32(1 + ULP, 1 + ULP, 1024 * (1 + ULP), -(1 + ULP)),
)


@pytest.mark.parametrize("case", ["ties", "random", "cancel"])
def test_fma32_is_correctly_rounded(case):
    rng = np.random.default_rng(3)
    if case == "ties":
        a, b, c = TIES
    elif case == "random":
        a, b, c = (rng.normal(size=400).astype(np.float32) * 10.0 ** rng
                   .integers(-3, 4, 400) for _ in range(3))
        a, b, c = (x.astype(np.float32) for x in (a, b, c))
    else:  # c = -round(a*b): the result is the product's rounding error
        a = rng.normal(size=400).astype(np.float32)
        b = rng.normal(size=400).astype(np.float32)
        c = -(a * b)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _exact(a, b, c))
    if case == "ties":  # the plain float64 route is wrong on every one
        naive = (a.astype(np.float64) * b + c).astype(np.float32)
        assert (naive != got.numpy()).all()


def test_fma32_broadcasts_python_floats():
    x = torch.tensor([0.1, 0.7, 3.0])
    np.testing.assert_array_equal(
        fma32(x, 255.0, 0.5).numpy(),
        _exact(x.numpy(), [255.0] * 3, [0.5] * 3))
