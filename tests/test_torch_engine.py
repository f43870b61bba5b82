"""Port parity: the paged serving engine against the JAX ServingEngine on
tests.test_multimodal.tiny_mm_config, greedy, f32, on the CPU: identical
tokens, every page free after run(), pool exhaustion queues requests."""

import jax
import numpy as np
import pytest
import torch

from multimeditron_torch.convert import load_jax_params
from multimeditron_torch.models import multimodal as tm
from multimeditron_torch.serve import engine as te
from multimeditron_tpu.data.chat_template import ChatTemplate
from multimeditron_tpu.data.collator import DataCollatorForMultimodal
from multimeditron_tpu.data.loaders import AutoModalityLoader
from multimeditron_tpu.models.multimodal import MultimodalModel
from multimeditron_tpu.serve.engine import EngineConfig as JEngineConfig
from multimeditron_tpu.serve.engine import ServingEngine as JServingEngine
from tests.fixtures.toy_tokenizer import ToyTokenizer
from tests.test_multimodal import ATTACH, tiny_mm_config
from tests.test_paged_engine import PROMPTS

BASE = dict(max_slots=2, max_seq_len=128, max_new_tokens=8, prefill_buckets=(32, 64),
            do_sample=False, kv_mode="paged", page_size=16)


@pytest.fixture(scope="module")
def pair():
    """(port model, collated PROMPTS, the JAX paged engine's greedy tokens),
    set up as in tests/test_paged_engine.py."""
    jmodel = MultimodalModel(tiny_mm_config())
    jmodel.config.eos_token_idx = 2
    params = jmodel.init_params(jax.random.PRNGKey(0))
    collator = DataCollatorForMultimodal(
        tokenizer=ToyTokenizer(),
        modality_processors=jmodel.processors(),
        modality_loaders={"image": AutoModalityLoader.create("raw-image")},
        attachment_token=ATTACH,
        chat_template=ChatTemplate.llama(),
        add_generation_prompt=True,
        pad_to_multiple=8,
    )
    tmodel = tm.MultimodalModel(tm.MultimodalConfig.from_dict(jmodel.config.to_dict()))
    assert tmodel.config.eos_token_idx == 2
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    batches = [collator([p]) for p in PROMPTS]
    want = JServingEngine(jmodel, params, JEngineConfig(**BASE)).generate(batches)
    return tmodel, batches, want


def _engine(tmodel, **kw):
    return te.ServingEngine(tmodel, te.EngineConfig(**{**BASE, **kw}))


def test_greedy_tokens_match_jax_and_pages_are_released(pair):
    tmodel, batches, want = pair
    eng = _engine(tmodel)
    got = eng.generate(batches)
    assert got == want
    assert sorted(eng.free_pages) == list(range(1, eng.num_pages))
    assert np.all(eng.page_table == 0) and np.all(eng.slot_num_pages == 0)
    assert eng.n_prefill_calls >= 2 and eng.n_decode_chunks >= 1


def test_pool_exhaustion_queues_requests(pair):
    tmodel, batches, want = pair
    # room for about one request at a time
    eng = _engine(tmodel, num_pages=4)
    reqs = [eng.submit(b) for b in batches]
    eng.step()
    assert len(eng.queue) >= 1
    eng.run()
    assert all(r.done and r.finish_reason for r in reqs)
    assert sorted(eng.free_pages) == list(range(1, eng.num_pages))
    assert [r.tokens for r in reqs] == want


def test_sampling_is_seeded_and_filtered(pair):
    tmodel, batches, _ = pair
    kw = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9, seed=3)
    a = _engine(tmodel, **kw).generate(batches)
    b = _engine(tmodel, **kw).generate(batches)
    assert a == b
    assert all(len(t) >= 1 and all(0 <= x < 4096 for x in t) for t in a)
    # temperature 0 in a sampling engine is greedy
    greedy = _engine(tmodel, **kw).generate(batches, temperature=0.0)
    assert greedy == pair[2]


def test_oversized_and_long_prompts_rejected(pair):
    tmodel, batches, _ = pair
    eng = _engine(tmodel, num_pages=2)
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(batches[0], max_new_tokens=100)
    long_batch = {"input_ids": np.ones((1, 70), np.int32),
                  "attention_mask": np.ones((1, 70), np.int32)}
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        _engine(tmodel).submit(long_batch)


@pytest.mark.parametrize("option", [
    dict(kv_mode="slab"), dict(speculative_k=2), dict(tp=2), dict(quantize_llm=True),
    dict(w8a8_prefill=True), dict(prefill_group_cap=1), dict(attn_impl="xla"),
])
def test_unported_engine_options_raise(pair, option):
    with pytest.raises(NotImplementedError, match="not ported"):
        _engine(pair[0], **option)


def test_forked_groups_raise(pair):
    tmodel, batches, _ = pair
    eng = _engine(tmodel)
    with pytest.raises(NotImplementedError, match="forked"):
        eng.submit_group(batches[0], 2)
    with pytest.raises(NotImplementedError, match="forked"):
        eng.generate(batches, group_size=3)


def test_engine_state_lives_on_the_model_device(pair):
    eng = _engine(pair[0])
    assert eng.device == torch.device("cpu")
    assert all(t.device == eng.device for t in eng.state.values())
    assert eng.state["ring_k"].shape[3] == 16  # ring rounded up to 16 rows
