"""Port parity for the channel pack (kernel B3's plain version): the exact
transpose must equal JAX ``pack_channels_split_blocked`` bit for bit, up to
the sign of zero (JAX's MXU identity-dot transpose turns -0.0 into +0.0;
the port's copy keeps it, which no consumer can observe)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ascii_renderer_tpu.ops.pack import pack_channels_split_blocked as j_pack
from ascii_renderer_tpu_torch.ops import pack as P

torch.set_num_threads(2)


@pytest.mark.parametrize("n_attrs", [6, 9])
def test_pack_ref_bit_exact_vs_jax(n_attrs):
    c = 16 + 3 * n_attrs + 3
    tw = -(-(3 * n_attrs + 3) // 8) * 8
    rng = np.random.default_rng(n_attrs)
    cm3 = rng.normal(size=(c, 16, 128)).astype(np.float32)
    # values the 3-way bf16 split must carry exactly: wide exponents,
    # full mantissas, signed zeros and integers (the id channel)
    cm3[0] *= np.float32(1e6)
    cm3[1] = np.float32(1.0) + np.float32(2.0 ** -23) * rng.integers(
        0, 1 << 20, size=(16, 128)).astype(np.float32)
    cm3[2, :, :7] = -0.0
    cm3[12] = np.arange(16 * 128, dtype=np.float32).reshape(16, 128)
    spans = [(0, 16), (16, 16 + tw)]
    want = j_pack(jnp.asarray(cm3), spans)
    got = P.pack_channels_split_blocked(torch.from_numpy(cm3), spans)
    assert len(got) == 2
    for g, w, (a, b) in zip(got, want, spans):
        assert tuple(g.shape) == (16 * 128, b - a) and g.is_contiguous()
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal((g + np.float32(0)).view(np.uint32),
                                      w.view(np.uint32))
    # channels past C read as zeros
    np.testing.assert_array_equal(got[1][:, c - 16:].numpy(), 0.0)
    assert np.signbit(got[0][:, 2].numpy()).sum() >= 7 * 16  # -0.0 kept


def test_pack_rejects_bad_shapes():
    with pytest.raises(ValueError):
        P.pack_channels_split_blocked(torch.zeros((37, 5, 128)), [(0, 16)])
    with pytest.raises(ValueError):
        P.pack_channels_split_blocked(torch.zeros((37, 8, 128)), [(0, 16)])
