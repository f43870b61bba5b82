"""Port parity: models/generation.py against the JAX generate on
tests.test_multimodal.tiny_mm_config, f32, on the CPU. Repeats
tests/test_generation.py on the port (greedy against a teacher-forced
reference, EOS fill, sampled tokens for one threefry key, sample_tokens'
filters, make_generate_fn) and adds an image batch with 2-D position ids and
the right-padding check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.models import generation as tg
from multimeditron_torch.serve import prng
from multimeditron_tpu.data.chat_template import ChatTemplate
from multimeditron_tpu.data.collator import DataCollatorForMultimodal
from multimeditron_tpu.data.loaders import AutoModalityLoader
from multimeditron_tpu.models import generation as jg
from tests.fixtures.toy_tokenizer import ToyTokenizer
from tests.test_generation import _naive_greedy
from tests.test_multimodal import ATTACH, _img
from tests.test_torch_engine import jax_model, port_model  # noqa: F401 (fixtures)


@pytest.fixture(scope="module")
def collator(jax_model):
    return DataCollatorForMultimodal(
        tokenizer=ToyTokenizer(),
        modality_processors=jax_model[0].processors(),
        modality_loaders={"image": AutoModalityLoader.create("raw-image")},
        attachment_token=ATTACH,
        chat_template=ChatTemplate.llama(),
        add_generation_prompt=True,
        pad_to_multiple=8,
    )


@pytest.fixture(scope="module")
def mixed(collator):
    """An image prompt and a text prompt, right-padded to one width."""
    return collator([
        {"conversations": [{"role": "user", "content": f"describe {ATTACH} image"}],
         "modalities": [{"type": "image", "value": _img((0, 0, 255))}]},
        {"conversations": [{"role": "user", "content": "count to ten"}], "modalities": []},
    ])


def _jax_generate(jax_model, batch, **kw):
    jmodel, params = jax_model
    return np.asarray(jg.generate(jmodel, params, batch, **kw))


def _port_generate(port_model, batch, **kw):
    out = tg.generate(port_model, batch, **kw)
    assert out.dtype == torch.int32 and out.device == torch.device("cpu")
    return out.numpy()


def test_greedy_matches_jax_and_naive(port_model, jax_model, mixed):
    n = 6
    got = _port_generate(port_model, mixed, max_new_tokens=n, do_sample=False)
    np.testing.assert_array_equal(got, _jax_generate(jax_model, mixed, max_new_tokens=n,
                                                     do_sample=False))
    ref = _naive_greedy(*jax_model, mixed, n)
    eos = port_model.config.eos_token_idx
    for b in range(2):
        for t in range(n):
            assert got[b, t] == ref[b, t]
            if ref[b, t] == eos:
                break


def test_eos_fills_after_finish(port_model, jax_model, collator, monkeypatch):
    """A sample that emits EOS holds EOS to the end, as in the JAX function.
    Random weights seldom emit the configured EOS, so EOS is set (in both
    models) to a token that the greedy run emits at step 2 of sample 0."""
    prompts = [{"conversations": [{"role": "user", "content": c}], "modalities": []}
               for c in ("x", "tell me", "what now")]
    batch = collator(prompts)
    first = _port_generate(port_model, batch, max_new_tokens=8, do_sample=False)
    eos = int(first[0, 2])
    assert eos not in first[0, :2]
    monkeypatch.setattr(port_model.config, "eos_token_idx", eos)
    monkeypatch.setattr(jax_model[0].config, "eos_token_idx", eos)
    got = _port_generate(port_model, batch, max_new_tokens=8, do_sample=False)
    np.testing.assert_array_equal(got, _jax_generate(jax_model, batch, max_new_tokens=8,
                                                     do_sample=False))
    np.testing.assert_array_equal(got[0, :3], first[0, :3])
    assert (got[0, 2:] == eos).all()
    for row in got[1:]:
        hit = np.nonzero(row == eos)[0]
        if len(hit):
            assert (row[hit[0]:] == eos).all()


@pytest.mark.parametrize("kw", [dict(temperature=1.0), dict(temperature=0.8, top_k=20),
                                dict(temperature=1.2, top_p=0.9),
                                dict(temperature=0.9, top_k=40, top_p=0.8)])
def test_sampled_tokens_match_jax(port_model, jax_model, mixed, kw):
    got = _port_generate(port_model, mixed, max_new_tokens=6, key=prng.prng_key(7), **kw)
    want = _jax_generate(jax_model, mixed, max_new_tokens=6, key=jax.random.PRNGKey(7), **kw)
    np.testing.assert_array_equal(got, want)
    again = _port_generate(port_model, mixed, max_new_tokens=6, key=prng.prng_key(7), **kw)
    np.testing.assert_array_equal(again, got)


def test_default_key_is_jax_default(port_model, jax_model, mixed):
    got = _port_generate(port_model, mixed, max_new_tokens=5, temperature=1.0)
    np.testing.assert_array_equal(got, _jax_generate(jax_model, mixed, max_new_tokens=5,
                                                     temperature=1.0))


def test_sample_tokens_filters_match_jax():
    """sample_tokens against the JAX one over keys and filters; top_k=1 and
    a tiny top_p are greedy."""
    logits = np.random.default_rng(0).normal(size=(5, 50)).astype(np.float32) * 3
    for seed in range(4):
        for kw in (dict(), dict(top_k=3), dict(top_p=0.6), dict(top_k=10, top_p=0.9),
                   dict(temperature=0.5, top_p=0.95)):
            got = tg.sample_tokens(torch.from_numpy(logits), prng.prng_key(seed), **kw)
            want = jg.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(seed), **kw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    small = torch.tensor([[1.0, 2.0, 3.0, -1.0]])
    for seed in range(5):
        assert int(tg.sample_tokens(small, prng.prng_key(seed), top_k=1)[0]) == 2
        assert int(tg.sample_tokens(small, prng.prng_key(seed), top_p=0.1)[0]) == 2
    assert int(tg.sample_tokens(small, prng.prng_key(0), do_sample=False)[0]) == 2


def test_make_generate_fn_matches_generate(port_model, mixed):
    fn = tg.make_generate_fn(port_model, temperature=0.7, top_k=30)
    key = prng.prng_key(3)
    got = fn(mixed, key, max_new_tokens=8)
    want = tg.generate(port_model, mixed, max_new_tokens=8, temperature=0.7, top_k=30, key=key)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    greedy = fn(mixed, key, max_new_tokens=8, do_sample=False)
    np.testing.assert_array_equal(
        greedy.numpy(), tg.generate(port_model, mixed, max_new_tokens=8, do_sample=False).numpy())


@pytest.mark.parametrize("do_sample", [False, True])
def test_image_batch_with_2d_position_ids_matches_jax(port_model, jax_model, mixed, do_sample):
    """(B, S, 2) position ids: the first channel the token index, the second
    a compressed stream; decode continues from the largest valid position."""
    mask = np.asarray(mixed["attention_mask"])
    idx = np.cumsum(mask, axis=-1) - 1
    pos = np.stack([idx, idx // 2], axis=-1) * mask[..., None]
    batch = {**mixed, "position_ids": pos.astype(np.int32)}
    kw = dict(max_new_tokens=6, do_sample=do_sample, temperature=0.9)
    got = _port_generate(port_model, batch, key=prng.prng_key(5), **kw)
    np.testing.assert_array_equal(got, _jax_generate(jax_model, batch,
                                                     key=jax.random.PRNGKey(5), **kw))


def test_left_padding_raises(port_model, mixed):
    ids = np.asarray(mixed["input_ids"])
    mask = np.asarray(mixed["attention_mask"])
    n = int(mask[1].sum())
    assert n < ids.shape[1]  # the text prompt is shorter than the image prompt
    left_ids, left_mask = np.zeros_like(ids[1:]), np.zeros_like(mask[1:])
    left_ids[0, -n:], left_mask[0, -n:] = ids[1, :n], 1
    with pytest.raises(ValueError, match="right-padded"):
        tg.generate(port_model, {"input_ids": left_ids, "attention_mask": left_mask},
                    max_new_tokens=2)
