"""Float32 arithmetic that rounds where the reference rounds.

The JAX reference is compiled by XLA, whose code generator fuses a product
that feeds an add or a subtract into one fused multiply-add (one rounding
instead of two). It follows LLVM's rules for an expression tree, in the
order the expression is written:

  a*b + c               -> fma(a, b, c)
  c + a*b               -> fma(a, b, c)
  a*b + c*d             -> fma(a, b, c*d)        (the left product fuses)
  a*b - c*d             -> fma(a, b, -(c*d))
  (a*b + c*d) + e*f     -> fma(e, f, fma(a, b, c*d))

The golden frames were rendered that way, so the port evaluates the same
chains with an explicit fused multiply-add: ``fma32`` for tensors (plain
versions, shading; on CUDA tensors one launch of the kernel of
``ops/fp.py``, on the CPU the float64 form ``fma32_f64``), its scalar form
``fma32_scalar`` on Python floats and its array form ``fma32_np`` on numpy
arrays (the host's camera chains: the MVP, the camera bases), and
``fmaf`` in the CUDA kernels, which are built with ``-fmad=false`` so that
nothing else fuses. All three host forms share one algorithm (a float64
product and sum, the sum's exact error deciding double-rounding ties).
Every chain that fuses carries a comment naming the rule it follows.

Square roots are taken in float64 and rounded once (``sqrt32``,
``rsqrt32``): torch's CPU float32 ``sqrt`` is not correctly rounded (about
0.6% of uniform inputs in [0, 100) come out an ulp off), while XLA's and
CUDA's ``sqrtf`` are, and a float64 root rounded once is the correctly
rounded float32 root. The CPU and CUDA tensors of the port then agree.

On Python floats (``round32``, ``div32``, ``fma32_scalar``) a float32
value is a Python float that float32 holds exactly; a product, sum or
quotient of two such values taken in float64 and rounded once by
``round32`` is the float32 operation's result.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def fma32(a, b, c) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (IEEE fusedMultiplyAdd).
    Operands broadcast; Python floats are taken as float32 values. The
    first tensor operand's device decides: on the CPU the float64 form
    (``fma32_f64``), elsewhere one launch of the CUDA kernel of
    ``ops/fp.py`` (``__fmaf_rn``), which raises where it cannot run."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    if ref.device.type == "cpu":
        return fma32_f64(a, b, c)
    from ascii_renderer_tpu_torch.ops.fp import fma32_kernel
    return fma32_kernel(a, b, c)


_F32_OVERFLOW = 2.0 ** 128  # the float32 grid's next step past FLT_MAX
_F32_MAX = float(np.finfo(np.float32).max)
# FLT_MAX plus half its ulp: from here on a float64 rounds to infinity (the
# tie goes to the even neighbour, 2^128)
_F32_ROUNDS_TO_INF = 2.0 ** 128 - 2.0 ** 103


def _two_sum(p, c):
    """(s, err): s = p + c rounded, err its exact error (s + err == p + c),
    on Python floats or numpy float64 arrays alike."""
    s = p + c
    bv = s - p
    return s, (p - (s - bv)) + (c - bv)


_np_f32 = np.float32


def round32(x: float) -> float:
    """The float32 nearest ``x`` (ties to even) as a Python float, through
    ``numpy.float32``; a magnitude from FLT_MAX + half an ulp on gives
    infinity without numpy's overflow warning."""
    if abs(x) >= _F32_ROUNDS_TO_INF:  # False for NaN
        return math.copysign(math.inf, x)
    return float(_np_f32(x))


def div32(a: float, b: float) -> float:
    """IEEE float32 ``a / b`` of two float32 values (Python floats); a zero
    divisor gives the IEEE infinity or NaN, not Python's exception."""
    if b == 0.0:
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.float32(a) / np.float32(b))
    return round32(a / b)


def sqrt32_scalar(x: float) -> float:
    """Correctly rounded float32 square root of a float32 value (``sqrt32``
    on a Python float)."""
    return round32(math.sqrt(x)) if x >= 0.0 else math.nan


def _midpoint32(s: float) -> bool:
    """Whether the finite float64 ``s`` lies halfway between two adjacent
    float32 values (below 2^128): an odd multiple of half the float32
    spacing at its magnitude (2^-150 for subnormals)."""
    m, e = math.frexp(s)
    t = math.ldexp(s, 150) if e <= -126 else m * 33554432.0  # 2^25
    return t.is_integer() and int(t) & 1 == 1 and e <= 128


def fma32_scalar(a: float, b: float, c: float) -> float:
    """``fma32`` of three float32 values given as Python floats: the
    correctly rounded float32 ``a * b + c`` as a Python float, by
    ``fma32_f64``'s algorithm (the product exact in float64, the sum's
    TwoSum error deciding a double-rounding tie, 2^128 the upper
    neighbour past FLT_MAX)."""
    s, err = _two_sum(a * b, c)
    r = round32(s)
    # a tie needs an inexact sum that landed on a float32 midpoint
    if err == 0.0 or err != err or not _midpoint32(s):
        return r
    r64 = math.copysign(_F32_OVERFLOW, s) if math.isinf(r) else r
    o = 2.0 * s - r64                    # r's neighbour across s
    return round32(max(r64, o) if err > 0.0 else min(r64, o))


def fma32_np(a, b, c) -> np.ndarray:
    """``fma32`` on numpy arrays (or scalars) of float32 values: float32
    array of the correctly rounded ``a * b + c``, broadcast, by
    ``fma32_f64``'s algorithm in numpy float64. The tie step runs only
    where some sum is inexact and may lie on a float32 midpoint: a normal
    sum whose 29 low bits are 1 << 28, or a subnormal, overflowing or
    infinite one."""
    a64, b64, c64 = (np.asarray(x, np.float32).astype(np.float64)
                     for x in (a, b, c))
    with np.errstate(over="ignore", invalid="ignore"):
        s, err = _two_sum(a64 * b64, c64)
        r = s.astype(np.float32)
        mag = np.abs(s)
        maybe = (((s.view(np.uint64) & 0x1FFFFFFF) == 0x10000000)
                 | (mag < 2.0 ** -126) | (mag >= _F32_MAX)) & (err != 0)
        if not maybe.any():
            return r
        r64 = np.where(np.isinf(r) & np.isfinite(s),
                       np.copysign(_F32_OVERFLOW, s), r.astype(np.float64))
        o = 2.0 * s - r64
        tie = ((o.astype(np.float32).astype(np.float64) == o) & (o != r64)
               & (err != 0))
        pick = np.where(err > 0, np.maximum(r64, o),
                        np.minimum(r64, o)).astype(np.float32)
    return np.where(tie, pick, r)


def fma32_f64(a, b, c) -> torch.Tensor:
    """``fma32`` in float64, on the device of the first tensor operand.

    The float32 product is exact in float64, so one float64 add leaves the
    exact sum within half a float64 ulp; rounding that to float32 is exact
    unless the float64 sum lands on a float32 midpoint it did not start on
    (double rounding). The add's exact error (TwoSum) decides those ties.
    A sum that rounds past FLT_MAX takes 2^128 as its upper neighbour, so
    that a tie there goes to FLT_MAX or infinity as IEEE rounding does."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))

    def f64(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=ref.device).double()

    a64, b64, c64 = f64(a), f64(b), f64(c)
    # the product is exact (24 + 24 bits < 53); s + err == p + c exactly
    s, err = _two_sum(a64 * b64, c64)
    r = s.float()
    r64 = torch.where(torch.isinf(r) & torch.isfinite(s),
                      torch.copysign(torch.full_like(s, _F32_OVERFLOW), s),
                      r.double())
    o = 2.0 * s - r64                    # r's neighbour if s is a midpoint
    tie = (o.float().double() == o) & (o != r64) & (err != 0)
    up = torch.maximum(r64, o)
    down = torch.minimum(r64, o)
    return torch.where(tie, torch.where(err > 0, up, down).float(), r)


def libm32(fn, x, device=None) -> torch.Tensor:
    """``fn`` (a ``math`` function) of a float32 scalar, taken in float64
    through Python's libm and rounded once to float32: the same on every
    host, unlike torch's CPU trig, whose vectorised paths differ by an ulp
    between builds (XLA's float32 trig differs from it on a few percent of
    arguments, tests/test_torch_camera_exact.py)."""
    return torch.tensor(fn(float(x)), dtype=torch.float32, device=device)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (CUDA's ``sqrtf``). Where a
    caller needs ``1 / sqrtf(x)``, it takes ``torch.reciprocal`` of this."""
    return torch.sqrt(x.double()).float()


def rsqrt32(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) in float64, rounded once to float32."""
    return torch.reciprocal(torch.sqrt(x.double())).float()
