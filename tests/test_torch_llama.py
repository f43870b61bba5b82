"""Port parity: the Llama decoder against JAX in f32 — no cache, contiguous
prefill into a cache, contiguous decode steps (S = 1 and 2, and writes past
the cache's end), one paged decode step and one speculative verify block —
with weights moved by multimeditron_torch.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.convert import export_jax_params, load_jax_params
from multimeditron_torch.models import llama as tl
from multimeditron_tpu.models import llama as jl
from tests.test_torch_vit import perturbed

# Whole-decoder outputs sum float32 products in another order than XLA over
# two layers and a vocab projection; 1e-5 still holds at these sizes.
TOL = dict(atol=1e-5, rtol=1e-5)
LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}

CONFIGS = {
    "llama_gqa": jl.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                                num_layers=2, num_heads=4, num_kv_heads=2,
                                rope_scaling=LLAMA3, dtype=jnp.float32),
    "tied_mha": jl.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=96,
                               num_layers=2, num_heads=4, num_kv_heads=4,
                               tie_word_embeddings=True, dtype=jnp.float32),
    "apertus_like": jl.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                                   num_layers=2, num_heads=4, num_kv_heads=2,
                                   use_qk_norm=True, mlp_gate=False, hidden_act="xielu",
                                   dtype=jnp.float32),
    "qwen_like_gelu": jl.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                                     num_layers=2, num_heads=4, num_kv_heads=1,
                                     use_qk_norm=True, mlp_gate=False, hidden_act="gelu",
                                     dtype=jnp.float32),
}


def _pair(name, seed=0):
    jcfg = CONFIGS[name]
    params = perturbed(jl.init_llama_params(jax.random.PRNGKey(seed), jcfg), seed=seed)
    tcfg = tl.LlamaConfig(**{**dataclasses.asdict(jcfg), "dtype": torch.float32})
    model = tl.Llama(tcfg, device="cpu")
    load_jax_params(model, params)
    return jcfg, params, model


def _ids(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 96, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_no_cache_forward_matches_jax(name):
    jcfg, params, model = _pair(name)
    ids = _ids(2, 9)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0  # right padding
    want, _ = jl.llama_forward(params, jcfg, input_ids=jnp.asarray(ids),
                               attention_mask=jnp.asarray(mask))
    with torch.inference_mode():
        got, cache = model(input_ids=torch.from_numpy(ids),
                           attention_mask=torch.from_numpy(mask))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_2d_position_ids_match_jax():
    jcfg, params, model = _pair("llama_gqa")
    ids = _ids(2, 6)
    pos = np.random.default_rng(2).integers(0, 5, (2, 6, 2)).astype(np.int32)
    want, _ = jl.llama_forward(params, jcfg, input_ids=jnp.asarray(ids),
                               position_ids=jnp.asarray(pos))
    with torch.inference_mode():
        got, _ = model(input_ids=torch.from_numpy(ids), position_ids=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["llama_gqa", "apertus_like"])
def test_contiguous_prefill_matches_jax(name):
    """The serving engine's local prefill: causal forward writing K/V into a
    fresh contiguous cache, returning final-normed hidden states."""
    jcfg, params, model = _pair(name)
    ids = _ids(2, 8, seed=3)
    mask = np.ones_like(ids)
    mask[0, 5:] = 0
    jcache = jl.init_kv_cache(jcfg, 2, 8)
    _, jnew, jhidden = jl.llama_forward(
        params, jcfg, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        kv_cache=jcache, prefill=True, return_hidden=True)
    with torch.inference_mode():
        tcache = tl.init_kv_cache(model.cfg, 2, 8)
        hidden, tnew = model(input_ids=torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask),
                             kv_cache=tcache, prefill=True, return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), **TOL)
    np.testing.assert_array_equal(tnew["length"].numpy(), np.asarray(jnew["length"]))


def test_paged_decode_step_matches_jax():
    """One S=1 step against a page pool + ring: the ring row written this
    step and the logits match (GQA, pages + ring rows in use)."""
    jcfg, params, model = _pair("llama_gqa", seed=4)
    B, P, pm, n_pages, T = 3, 8, 3, 10, 16
    L, Hkv, Dh = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    rng = np.random.default_rng(5)
    kp = rng.normal(size=(L, Hkv, n_pages, P, Dh)).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    rk = rng.normal(size=(L, B, Hkv, T, Dh)).astype(np.float32)
    rv = rng.normal(size=rk.shape).astype(np.float32)
    table = np.array([[3, 7, 0], [1, 0, 0], [5, 2, 9]], np.int32)
    pages_len = np.array([10, 4, 17], np.int32)
    length = pages_len + np.array([2, 2, 0], np.int32)  # mid-chunk, step 2
    tokens = np.array([[5], [17], [80]], np.int32)
    arrays = dict(k=kp, v=vp, ring_k=rk, ring_v=rv, page_table=table,
                  pages_length=pages_len, length=length)
    want, jnew = jl.llama_forward(
        params, jcfg, input_ids=jnp.asarray(tokens),
        kv_cache={k: jnp.asarray(a) for k, a in arrays.items()}, page_size=P)
    with torch.inference_mode():
        tcache = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
        got, tnew = model(input_ids=torch.from_numpy(tokens), kv_cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("ring_k", "ring_v"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), **TOL)
    np.testing.assert_array_equal(tnew["length"].numpy(), np.asarray(jnew["length"]))


@pytest.mark.parametrize("gen", [[0, 0, 0], [2, 2, 0]])
def test_paged_verify_block_matches_jax(gen):
    """A speculative verify block (S = 3) against a page pool + ring: the
    block's K/V land at ring rows [t, t + 3), t = max(length - pages_len),
    and the logits match, with the engine's contract (every slot folded,
    t = 0) and with ring rows already in use (t = 2)."""
    jcfg, params, model = _pair("llama_gqa", seed=7)
    B, P, pm, n_pages, T, S = 3, 8, 3, 10, 16, 3
    L, Hkv, Dh = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim_
    rng = np.random.default_rng(8)
    kp = rng.normal(size=(L, Hkv, n_pages, P, Dh)).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    rk = rng.normal(size=(L, B, Hkv, T, Dh)).astype(np.float32)
    rv = rng.normal(size=rk.shape).astype(np.float32)
    table = np.array([[3, 7, 0], [1, 0, 0], [5, 2, 9]], np.int32)
    pages_len = np.array([10, 4, 0], np.int32)
    length = pages_len + np.asarray(gen, np.int32)
    tokens = rng.integers(0, 96, (B, S)).astype(np.int32)
    arrays = dict(k=kp, v=vp, ring_k=rk, ring_v=rv, page_table=table,
                  pages_length=pages_len, length=length)
    want, jnew = jl.llama_forward(
        params, jcfg, input_ids=jnp.asarray(tokens),
        kv_cache={k: jnp.asarray(a) for k, a in arrays.items()}, page_size=P, prefill=True)
    with torch.inference_mode():
        tcache = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
        got, tnew = model(input_ids=torch.from_numpy(tokens), kv_cache=tcache, prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("ring_k", "ring_v"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), **TOL)
    np.testing.assert_array_equal(tnew["length"].numpy(), np.asarray(jnew["length"]))


def test_convert_roundtrip():
    _, params, model = _pair("apertus_like", seed=6)
    back = export_jax_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("option", [
    dict(sequence_parallel=True), dict(ring_attention=True),
    dict(pipeline_parallel=2), dict(mlp_gate=False, hidden_act="tanh"),
])
def test_unported_options_raise(option):
    cfg = tl.LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32,
                         num_layers=1, num_heads=2, num_kv_heads=1, **option)
    with pytest.raises(NotImplementedError):
        tl.Llama(cfg, device="cpu")


def _filled_cache(cfg, B, max_len, lengths, seed):
    """A contiguous cache holding random K/V (stale rows included) and the
    given per-sample lengths, as numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, cfg.num_kv_heads, max_len, cfg.head_dim_)
    return dict(k=rng.normal(size=shape).astype(np.float32),
                v=rng.normal(size=shape).astype(np.float32),
                length=np.asarray(lengths, np.int32))


def _cache_step_pair(jcfg, params, model, ids, arrays, prefill):
    """One forward of ``ids`` against the cache ``arrays`` in JAX and in the
    port: (JAX logits, JAX cache, port logits, port cache)."""
    want, jnew = jl.llama_forward(params, jcfg, input_ids=jnp.asarray(ids), prefill=prefill,
                                  kv_cache={k: jnp.asarray(a) for k, a in arrays.items()})
    with torch.inference_mode():
        tcache = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
        got, tnew = model(input_ids=torch.from_numpy(ids), kv_cache=tcache, prefill=prefill)
    return np.asarray(want), jnew, got.numpy(), tnew


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("name", ["llama_gqa", "tied_mha"])
def test_contiguous_decode_matches_jax(name, S):
    """A decode step (S = 1) and a multi-token step (S = 2) against a
    contiguous cache with ragged lengths: K/V written at each sample's
    length, then non-causal attention over the masked cache."""
    jcfg, params, model = _pair(name)
    arrays = _filled_cache(jcfg, 3, 12, [5, 0, 9], seed=4)
    want, jnew, got, tnew = _cache_step_pair(jcfg, params, model, _ids(3, S, seed=5),
                                             arrays, prefill=False)
    np.testing.assert_allclose(got, want, **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), **TOL)
    np.testing.assert_array_equal(tnew["length"].numpy(), np.asarray(jnew["length"]))


@pytest.mark.parametrize("prefill", [False, True])
def test_contiguous_writes_past_the_end_are_dropped(prefill):
    """Rows at or past max_len are dropped, as JAX's out-of-range scatter
    drops them: a sample at capacity (an inactive slot still running the
    step) and one whose block reaches past the end (a verify block near
    capacity)."""
    jcfg, params, model = _pair("llama_gqa")
    arrays = _filled_cache(jcfg, 3, 8, [8, 6, 2], seed=6)
    want, jnew, got, tnew = _cache_step_pair(jcfg, params, model, _ids(3, 4, seed=7),
                                             arrays, prefill=prefill)
    for key in ("k", "v"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), **TOL)
    np.testing.assert_array_equal(tnew["k"][:, 0].numpy(), arrays["k"][:, 0])  # untouched
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_cache_layout_matches_jax():
    jcfg, _, model = _pair("llama_gqa")
    jc = jl.init_paged_kv_cache(jcfg, 5, 16, 3, 2, ring_size=8)
    tc = tl.init_paged_kv_cache(model.cfg, 5, 16, 3, 2, ring_size=8)
    assert set(jc) == set(tc)
    for key in jc:
        assert tuple(jc[key].shape) == tuple(tc[key].shape), key
        assert not tc[key].any()
