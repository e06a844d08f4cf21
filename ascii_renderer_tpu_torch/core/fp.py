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
versions, shading, the camera) and ``fmaf`` in the CUDA kernels, which are
built with ``-fmad=false`` so that nothing else fuses. Every chain that
fuses carries a comment naming the rule it follows.
"""

from __future__ import annotations

import torch


def fma32(a, b, c) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (IEEE fusedMultiplyAdd).

    The float32 product is exact in float64, so one float64 add leaves the
    exact sum within half a float64 ulp; rounding that to float32 is exact
    unless the float64 sum lands on a float32 midpoint it did not start on
    (double rounding). The add's exact error (TwoSum) decides those ties.
    Operands broadcast; Python floats are taken as float32 values."""
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
    r64 = r.double()
    o = 2.0 * s - r64                    # r's neighbour if s is a midpoint
    tie = (o.float().double() == o) & (o != r64) & (err != 0)
    up = torch.maximum(r64, o)
    down = torch.minimum(r64, o)
    return torch.where(tie, torch.where(err > 0, up, down).float(), r)
