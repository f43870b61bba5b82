"""Port parity: models/common.py (norms, rotary, activations) against JAX, f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.models import common as tc
from multimeditron_tpu.models import common as jc

TOL = dict(atol=1e-5, rtol=1e-5)
LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_rms_norm():
    x, w = _rand(2, 5, 64), _rand(64, seed=1)
    got = tc.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    want = jc.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm(with_bias):
    x, w, b = _rand(3, 7, 32), _rand(32, seed=1), _rand(32, seed=2)
    tb = torch.from_numpy(b) if with_bias else None
    jb = jnp.asarray(b) if with_bias else None
    got = tc.layer_norm(torch.from_numpy(x), torch.from_numpy(w), tb, 1e-5)
    want = jc.layer_norm(jnp.asarray(x), jnp.asarray(w), jb, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scaling", [None, LLAMA3])
@pytest.mark.parametrize("head_dim,theta", [(128, 500000.0), (16, 10000.0)])
def test_rope_frequencies(scaling, head_dim, theta):
    got = tc.rope_frequencies(head_dim, theta, scaling)
    want = jc.rope_frequencies(head_dim, theta, scaling)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("two_d", [False, True])
def test_apply_rope(two_d):
    B, H, S, D = 2, 3, 6, 16
    x = _rand(B, H, S, D)
    rng = np.random.default_rng(4)
    shape = (B, S, 2) if two_d else (B, S)
    pos = rng.integers(0, 40, shape).astype(np.int32)
    inv = jc.rope_frequencies(D, 10000.0, LLAMA3)
    got = tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        torch.from_numpy(np.array(inv)))
    want = jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), inv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_and_xielu():
    x = _rand(4, 33) * 3
    ap, an = np.array([0.2], np.float32), np.array([-0.4], np.float32)
    np.testing.assert_allclose(tc.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jc.gelu(jnp.asarray(x))), **TOL)
    got = tc.xielu(torch.from_numpy(x), torch.from_numpy(ap), torch.from_numpy(an))
    want = jc.xielu(jnp.asarray(x), jnp.asarray(ap), jnp.asarray(an))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
