"""Port parity: K3 encoder attention's plain twin against the JAX Pallas
kernel (interpret mode) and its XLA reference, f32, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.ops import encoder_attention as te
from multimeditron_tpu.ops.encoder_attention import (
    _encoder_attention_xla,
    encoder_attention,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _make(B, S, H, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H * Dh)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("B,S,H,Dh", [(2, 17, 4, 8), (1, 65, 2, 16)])
def test_twin_matches_pallas_interpret_and_xla(B, S, H, Dh):
    q, k, v = _make(B, S, H, Dh)
    got = te.encoder_attention(*map(torch.from_numpy, (q, k, v)), H)
    pallas = encoder_attention(*map(jnp.asarray, (q, k, v)), H, interpret=True)
    xla = _encoder_attention_xla(*map(jnp.asarray, (q, k, v)), H, Dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)
    assert te.launches["encoder_attention"] == 0  # CPU tensors take the twin


def test_kv_len_masks_keys_on_valid_rows():
    B, S, H, Dh, kv_len = 2, 24, 2, 8, 17
    q, k, v = _make(B, S, H, Dh, seed=1)
    got = te.encoder_attention(*map(torch.from_numpy, (q, k, v)), H, kv_len=kv_len)
    want = encoder_attention(*map(jnp.asarray, (q, k, v)), H, kv_len=kv_len,
                             interpret=True)
    # rows >= kv_len are garbage by contract; compare the valid ones
    np.testing.assert_allclose(got.numpy()[:, :kv_len], np.asarray(want)[:, :kv_len], **TOL)
    # keys past kv_len get no weight: changing them changes no valid row
    k2, v2 = k.copy(), v.copy()
    k2[:, kv_len:] = 1e3
    v2[:, kv_len:] = -1e3
    again = te.encoder_attention(*map(torch.from_numpy, (q, k2, v2)), H, kv_len=kv_len)
    np.testing.assert_allclose(again.numpy()[:, :kv_len], got.numpy()[:, :kv_len], **TOL)


def test_wrapper_rejects_bad_input():
    q, k, v = map(torch.from_numpy, _make(1, 5, 2, 4))
    with pytest.raises(ValueError, match="num_heads"):
        te.encoder_attention(q, k, v, 3)
    with pytest.raises(ValueError, match="kv_len"):
        te.encoder_attention(q, k, v, 2, kv_len=0)
    with pytest.raises(ValueError, match="dtype"):
        te.encoder_attention(q.double(), k.double(), v.double(), 2)
