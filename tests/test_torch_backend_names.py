"""Two reference names the port's backend modules carry, on the CPU
against the JAX package: ``backends/pathtrace.environment_ch`` (the sky /
ground gradient a missed path gathers, re-exported from
``backends/pt_core`` as the reference's module defines it) and
``backends/raytrace.gi_V3`` ([..., 3] -> flat V3 channels) against the
reference's on seeded arrays: gi_V3 bit for bit, environment_ch within
1e-6 as ``tests/test_torch_pt_core.py`` holds it (its pow is rounded once
from float64, where XLA's float32 pow may differ by an ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.backends import pathtrace as JPT
from ascii_renderer_tpu.backends import pt_core as JPC
from ascii_renderer_tpu.backends import raytrace as JRT
from ascii_renderer_tpu_torch.backends import pathtrace as TPT
from ascii_renderer_tpu_torch.backends import pt_core as TPC
from ascii_renderer_tpu_torch.backends import raytrace as TRT

torch.set_num_threads(2)


def _bits(a):
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def _dirs(seed, n):
    """n seeded unit directions, the horizon band (|y| < 0.05, where the
    ground blend runs) and the poles included."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d[: n // 4, 1] = rng.uniform(-0.06, 0.06, n // 4)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0.05, 1]]
    return d.astype(np.float32)


def test_environment_ch_is_the_pt_core_one():
    assert TPT.environment_ch is TPC.environment_ch
    assert callable(JPT.environment_ch)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_environment_ch_equals_jax(seed):
    d = _dirs(seed, 4096)
    want = np.asarray(JPT.environment_ch(JPC.V3.of(jnp.asarray(d))).stack())
    got = TPT.environment_ch(TPC.V3.of(torch.from_numpy(d))).stack().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("shape", [(7, 3), (4, 5, 3), (2, 3, 4, 3)])
def test_gi_v3_equals_jax(shape):
    rng = np.random.default_rng(len(shape))
    arr = rng.standard_normal(shape).astype(np.float32)
    R = arr.size // 3
    want = JRT.gi_V3(jnp.asarray(arr), R)
    got = TRT.gi_V3(torch.from_numpy(arr), R)
    assert isinstance(got, TPC.V3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (R,)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
