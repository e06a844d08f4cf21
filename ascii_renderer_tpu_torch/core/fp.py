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
versions, shading, the camera; on CUDA tensors one launch of the kernel of
``ops/fp.py``, on the CPU the float64 form ``fma32_f64``) and ``fmaf`` in
the CUDA kernels, which are built with ``-fmad=false`` so that nothing
else fuses. Every chain that fuses carries a comment naming the rule it
follows.

Square roots are taken in float64 and rounded once (``sqrt32``,
``rsqrt32``): torch's CPU float32 ``sqrt`` is not correctly rounded (about
0.6% of uniform inputs in [0, 100) come out an ulp off), while XLA's and
CUDA's ``sqrtf`` are, and a float64 root rounded once is the correctly
rounded float32 root. The CPU and CUDA tensors of the port then agree.
"""

from __future__ import annotations

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
    p = a64 * b64                        # exact: 24 + 24 bits < 53
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)    # s + err == p + c exactly
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
