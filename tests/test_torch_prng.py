"""Port parity: multimeditron_torch.serve.prng against jax.random (threefry2x32,
jax_threefry_partitionable=True) on the CPU. Keys, folds, splits, random bits
and uniforms are equal bit for bit; the gumbel noise is -log(-log(u)) of
equal uniforms, within 1e-6 (the two libraries' float32 log differ in the
last bit, and the outer log of values near 1 turns that into an absolute
error); categorical draws are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.serve import prng

SEEDS = [0, 3, 7, 123456, 2 ** 31 - 1, -5]


def _key_words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_match_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _key_words(jax.random.PRNGKey(seed)))
    for data in (0, 1, 5, 3 * (1 << 20) + 17, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(prng.prng_key(seed), data).numpy(),
            _key_words(jax.random.fold_in(jax.random.PRNGKey(seed), data)))
    for num in (2, 3):
        np.testing.assert_array_equal(
            prng.split(prng.prng_key(seed), num).numpy(),
            _key_words(jax.random.split(jax.random.PRNGKey(seed), num)))


def test_split_chain_and_batched_fold_in_match_jax():
    """The plain decode chunk's key chain, and the speculative step's
    position keys: fold_in over a tensor of ids (a vmap in JAX)."""
    jkey, tkey = jax.random.PRNGKey(11), prng.prng_key(11)
    for _ in range(5):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey)
        np.testing.assert_array_equal(tsub.numpy(), _key_words(jsub))
    ids = np.arange(4)[:, None] * (1 << 20) + np.arange(30, 35)[None, :]
    want = jax.vmap(lambda d: jax.random.fold_in(jax.random.PRNGKey(7), d))(
        jnp.asarray(ids.reshape(-1), jnp.int32))
    got = prng.fold_in(prng.prng_key(7), torch.from_numpy(ids.reshape(-1)))
    np.testing.assert_array_equal(got.numpy(), _key_words(want))


@pytest.mark.parametrize("shape", [(7,), (3, 1000), (2, 3, 5)])
def test_bits_and_uniform_match_jax(shape):
    key = jax.random.PRNGKey(4)
    np.testing.assert_array_equal(
        prng.random_bits(prng.prng_key(4), shape).numpy(),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(prng.prng_key(4), shape).numpy(),
                                  np.asarray(jax.random.uniform(key, shape)))
    got = prng.gumbel(prng.prng_key(4), shape).numpy()
    want = np.asarray(jax.random.gumbel(key, shape))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,V", [(1, 50), (8, 128256)])
def test_categorical_matches_jax(n, V):
    logits = np.random.default_rng(n).normal(size=(n, V)).astype(np.float32) * 3
    for seed in (0, 9):
        want = jax.random.categorical(jax.random.PRNGKey(seed), jnp.asarray(logits), axis=-1)
        got = prng.categorical(prng.prng_key(seed), torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_per_row_categorical_matches_vmapped_jax():
    """One key per row draws as jax.vmap(categorical) over (keys, rows)."""
    logits = np.random.default_rng(3).normal(size=(6, 4096)).astype(np.float32)
    ids = np.arange(6) * (1 << 20) + 40
    jkeys = jax.vmap(lambda d: jax.random.fold_in(jax.random.PRNGKey(2), d))(
        jnp.asarray(ids, jnp.int32))
    want = jax.vmap(lambda k, row: jax.random.categorical(k, row))(jkeys, jnp.asarray(logits))
    tkeys = prng.fold_in(prng.prng_key(2), torch.from_numpy(ids))
    got = prng.categorical(tkeys, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rejects_bad_keys_and_seeds():
    with pytest.raises(ValueError, match="32-bit"):
        prng.prng_key(2 ** 31)
    with pytest.raises(ValueError, match="words"):
        prng.split(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="one key per row"):
        prng.random_bits(torch.zeros((4, 2), dtype=torch.int64), (3, 10))


def _device_words(monkeypatch):
    """Make every draw read the key's words from the key tensor, as a draw
    on the card does from a key held there (a CUDA graph's static key)."""
    monkeypatch.setattr(prng, "_words", lambda key: (key[..., :1], key[..., 1:]))


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1, -5])
def test_key_on_the_device_draws_as_the_host_key_and_jax(monkeypatch, seed):
    """A key whose words are read from the key tensor (what a CUDA graph
    replays) gives the bits, uniforms and categorical draws of the same key
    hashed with Python ints, and JAX's (uniforms on [0, 1) and gumbel's
    [tiny, 1), the engine's: XLA on the CPU fuses other bounds' scale and
    shift into one rounding)."""
    logits = np.random.default_rng(seed % 97).normal(size=(4, 3000)).astype(np.float32) * 3
    key = prng.prng_key(seed)
    assert isinstance(prng._words(key)[0], int)

    def draws():
        return (prng.random_bits(key, (3, 700)), prng.uniform(key, (3, 700)),
                prng.uniform(key, (3, 700), -2.5, 7.0), prng.gumbel(key, (3, 700)),
                prng.categorical(key, torch.from_numpy(logits)))

    on_host = draws()
    _device_words(monkeypatch)
    on_device = draws()
    for a, b in zip(on_device, on_host):
        assert torch.equal(a, b)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(on_device[1].numpy(),
                                  np.asarray(jax.random.uniform(jkey, (3, 700))))
    np.testing.assert_array_equal(
        on_device[4].numpy(),
        np.asarray(jax.random.categorical(jkey, jnp.asarray(logits), axis=-1)))


def test_draws_build_no_tensor_from_a_host_scalar(monkeypatch):
    """uniform, gumbel and categorical make no tensor from a Python scalar:
    on the card that is a pageable upload, which a CUDA graph cannot hold."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"torch.tensor{args}")

    key = prng.prng_key(3)
    want = prng.categorical(key, torch.ones(2, 50))
    monkeypatch.setattr(torch, "tensor", refuse)
    prng.uniform(key, (5,), 0.25, 0.5)
    prng.gumbel(key, (2, 9))
    assert torch.equal(prng.categorical(key, torch.ones(2, 50)), want)
