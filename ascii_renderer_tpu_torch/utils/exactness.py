"""Exactness canary (torch port of ``ascii_renderer_tpu/utils/exactness.py``).

The raster pipeline's bit-exactness rests on operations the CPU tests
cannot see run on the card: the pack kernels' transposes and a float32
matrix product that must stay exact (TF32, which keeps ~10 mantissa bits,
is off at import: ``ascii_renderer_tpu_torch/__init__.py``).
``run_checks(device)`` runs them, under the JAX package's names, on
``device`` (the kernels on a CUDA device, their plain versions on the
CPU) and returns a name -> bool dict; ``verdict()`` reduces it to one
string:

  - pack_blocked: B3, ``ops/pack.pack_channels_split_blocked`` on a
    [40, 544, 128] input with spans (0, 16), (16, 40);
  - pack_flat: B7', ``ops/pack.pack_channels_split`` on the same [40, N];
  - xla_select_dot: a float32 ``torch.matmul`` of the [24, 24] identity
    with a [512, 24] matrix (the reference's barriered select dot), exact
    only while TF32 stays off.
"""

from __future__ import annotations

import numpy as np
import torch


def run_checks(device="cuda") -> dict[str, bool]:
    """Each check True iff the operation is bit-exact on ``device``."""
    from ascii_renderer_tpu_torch.ops import pack as P

    rng = np.random.default_rng(0)
    cm_np = rng.normal(size=(40, 69632)).astype(np.float32)
    cm = torch.from_numpy(cm_np).to(device)
    want = cm_np.T

    b = P.pack_channels_split_blocked(cm.reshape(40, 544, 128),
                                      [(0, 16), (16, 40)])
    pack_blocked = (np.array_equal(b[0].cpu().numpy(), want[:, :16])
                    and np.array_equal(b[1].cpu().numpy(), want[:, 16:40]))

    a = P.pack_channels_split(cm, [(0, 16), (16, 40)])
    pack_flat = np.array_equal(a[0].cpu().numpy(), want[:, :16])

    x = rng.normal(size=(512, 24)).astype(np.float32)
    eye = torch.eye(24, dtype=torch.float32, device=device)
    got = torch.matmul(eye, torch.from_numpy(x).to(device).t())
    xla_select_dot = np.array_equal(got.cpu().numpy(), x.T)

    return {"pack_blocked": pack_blocked, "pack_flat": pack_flat,
            "xla_select_dot": xla_select_dot}


def verdict(checks: dict[str, bool]) -> str:
    """'ok' iff every check passed, else 'FAIL:<names>'."""
    bad = sorted(k for k, v in checks.items() if not v)
    return "ok" if not bad else "FAIL:" + ",".join(bad)
