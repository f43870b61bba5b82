"""Port parity: the paged serving engine against the JAX ServingEngine on
tests.test_multimodal.tiny_mm_config, f32, on the CPU: identical greedy and
sampled tokens, every page free after run(), pool exhaustion queues
requests."""

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
def jax_model():
    """The JAX model (eos 2) and its seeded params, as in
    tests/test_paged_engine.py."""
    jmodel = MultimodalModel(tiny_mm_config())
    jmodel.config.eos_token_idx = 2
    return jmodel, jmodel.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_model(jax_model):
    """The port's model on the CPU with the JAX model's weights."""
    jmodel, params = jax_model
    tmodel = tm.MultimodalModel(tm.MultimodalConfig.from_dict(jmodel.config.to_dict()),
                                device="cpu")
    assert tmodel.config.eos_token_idx == 2
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return tmodel


@pytest.fixture(scope="module")
def pair(jax_model, port_model):
    """(port model, collated PROMPTS, the JAX paged engine's greedy tokens)."""
    jmodel, params = jax_model
    collator = DataCollatorForMultimodal(
        tokenizer=ToyTokenizer(),
        modality_processors=jmodel.processors(),
        modality_loaders={"image": AutoModalityLoader.create("raw-image")},
        attachment_token=ATTACH,
        chat_template=ChatTemplate.llama(),
        add_generation_prompt=True,
        pad_to_multiple=8,
    )
    batches = [collator([p]) for p in PROMPTS]
    want = JServingEngine(jmodel, params, JEngineConfig(**BASE)).generate(batches)
    return port_model, batches, want


def _engine(tmodel, **kw):
    return te.ServingEngine(tmodel, te.EngineConfig(**{**BASE, **kw}))


def test_greedy_tokens_match_jax_and_pages_are_released(pair):
    tmodel, batches, want = pair
    eng = _engine(tmodel)
    got = eng.generate(batches)
    assert got == want
    assert sorted(eng.kv.free_pages) == list(range(1, eng.kv.num_pages))
    assert np.all(eng.kv.page_table == 0) and np.all(eng.kv.slot_num_pages == 0)
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
    assert sorted(eng.kv.free_pages) == list(range(1, eng.kv.num_pages))
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


def test_plain_sampled_tokens_match_jax(pair, jax_model):
    """do_sample=True plain decode: threefry keys as the JAX engine derives
    them (prefill seeds, one split per decode step, seed + 1 per chunk) give
    the JAX engine's tokens, with top-k and top-p on."""
    tmodel, batches, _ = pair
    jmodel, params = jax_model
    kw = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9, seed=3, decode_chunk=4)
    want = JServingEngine(jmodel, params, JEngineConfig(**{**BASE, **kw})).generate(batches)
    assert _engine(tmodel, **kw).generate(batches) == want


def test_oversized_and_long_prompts_rejected(pair):
    tmodel, batches, _ = pair
    eng = _engine(tmodel, num_pages=2)
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(batches[0], max_new_tokens=100)
    # longer than the largest bucket prefills in chunks; no room to decode raises
    long_batch = {"input_ids": np.ones((1, 128), np.int32),
                  "attention_mask": np.ones((1, 128), np.int32)}
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine(tmodel).submit(long_batch)


@pytest.mark.parametrize("option", [
    dict(tp=2), dict(quantize_llm=True, tp=2), dict(prefill_group_cap=1, tp=2),
    dict(attn_impl="xla"),
])
def test_unported_engine_options_raise(pair, option):
    with pytest.raises(NotImplementedError, match="not ported"):
        _engine(pair[0], **option)


def test_w8a8_prefill_without_quantize_llm_raises(pair):
    """As in the JAX engine; the quantised engine itself runs in
    tests/test_torch_llama_quant.py."""
    with pytest.raises(ValueError, match="w8a8_prefill requires quantize_llm"):
        _engine(pair[0], w8a8_prefill=True)


def test_forked_groups_raise(pair):
    """Forked groups run (tests/test_torch_engine_groups.py); malformed ones
    raise."""
    tmodel, batches, _ = pair
    eng = _engine(tmodel)
    with pytest.raises(ValueError, match="n >= 1"):
        eng.submit_group(batches[0], 0)
    with pytest.raises(ValueError, match="max_slots"):
        eng.submit_group(batches[0], 3)
    with pytest.raises(ValueError, match="multiple of group_size"):
        eng.generate(batches, group_size=2)
    assert not eng.queue


def test_engine_state_lives_on_the_model_device(pair):
    eng = _engine(pair[0], speculative_k=3)
    assert eng.device == torch.device("cpu")
    tensors = {k: t for k, t in eng.state.items() if k != "seed"}
    assert all(t.device == eng.device for t in tensors.values())
    assert eng.state["seed"] == 0  # the plain decode chunk's seed, a host int
    assert eng.state["ring_k"].shape[3] == 16  # ring rounded up to 16 rows
    assert eng.state["history"].shape == (2, 128 + 3 + 2)


@pytest.mark.parametrize("option", [dict(), dict(kv_mode="slab"), dict(speculative_k=2),
                                    dict(do_sample=True, seed=4)])
def test_decode_runs_the_step_body_eagerly_off_the_card(pair, option, monkeypatch):
    """Off the card, in slab mode and with speculation no step is a graph
    replay: each live plain decode step runs the one step body that the
    card's graph captures, and a speculative engine runs its verify step."""
    calls = []
    body = te.ServingEngine._decode_step
    monkeypatch.setattr(te.ServingEngine, "_decode_step",
                        lambda self, key: calls.append(key) or body(self, key))
    eng = _engine(pair[0], **option)
    eng.generate(pair[1])
    assert eng.n_decode_graph_steps == 0 and eng._decode_graph is None
    assert len(calls) == eng.n_decode_steps
    assert (eng.n_decode_steps > 0) == ("speculative_k" not in option)
    assert all((k is None) != eng.cfg.do_sample for k in calls)
