"""Port parity: the slab KV mode of the serving engine against the JAX slab
engine on tests.test_multimodal.tiny_mm_config, f32, on the CPU: greedy and
sampled tokens, speculative decoding (k = 2, 3; sampling independent of k),
a chunked prompt with an image in a later chunk, submit_group's fallback to
independent requests, the int8 LLM (quantize_llm, with and without
w8a8_prefill), slab against paged, and slots that run up to max_seq_len
(their out-of-range cache writes dropped, as JAX drops them)."""

import numpy as np
import pytest

from multimeditron_torch.ops import wo_matmul as tw
from multimeditron_torch.serve import engine as te
from multimeditron_tpu.serve.engine import EngineConfig as JEngineConfig
from multimeditron_tpu.serve.engine import ServingEngine as JServingEngine
from tests.test_spec_decode import PROMPTS as SPEC_PROMPTS
from tests.test_torch_engine import jax_model, pair, port_model  # noqa: F401 (fixtures)
from tests.test_torch_engine_groups import _text, collator  # noqa: F401 (fixture)
from tests.test_multimodal import ATTACH, _img

BASE = dict(max_slots=2, max_seq_len=128, max_new_tokens=8, prefill_buckets=(32, 64),
            do_sample=False, kv_mode="slab")
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9, seed=3, decode_chunk=4)
SPEC = dict(max_slots=4, max_seq_len=96, prefill_buckets=(16, 32))


def _ids(ids):
    ids = np.asarray([ids], np.int32)
    return {"input_ids": ids, "attention_mask": np.ones_like(ids)}


SPEC_BATCHES = [_ids(p) for p in SPEC_PROMPTS]


def _port(tmodel, **kw):
    return te.ServingEngine(tmodel, te.EngineConfig(**{**BASE, **kw}))


def _jax(jax_model, batches, max_new_tokens=None, group_size=None, **kw):
    jmodel, params = jax_model
    eng = JServingEngine(jmodel, params, JEngineConfig(**{**BASE, **kw}))
    return eng.generate(batches, max_new_tokens=max_new_tokens, group_size=group_size)


def test_greedy_matches_jax_slab_and_paged(pair, jax_model):
    """The port's slab engine gives the JAX slab engine's greedy tokens, and
    those of the paged engines (tests/test_paged_engine.py:53)."""
    tmodel, batches, paged_want = pair
    eng = _port(tmodel)
    got = eng.generate(batches)
    assert got == _jax(jax_model, batches)
    assert got == paged_want
    assert got == _port(tmodel, kv_mode="paged", page_size=16).generate(batches)
    assert eng.n_prefill_calls >= 2 and eng.n_decode_chunks >= 1
    assert not eng.active.any() and all(r is None for r in eng.slot_request)


def test_slab_state_has_no_pages(pair):
    eng = _port(pair[0], speculative_k=2)
    st = eng.state
    assert st["k"].shape == (2, 2, 2, 128, 16) and st["v"].shape == st["k"].shape
    assert not any(k in st for k in ("page_table", "pages_length", "ring_k", "ring_v"))
    assert not hasattr(eng.kv, "free_pages")
    # no page accounting: any budget is admitted (the cache caps the length)
    eng.submit(pair[1][0], max_new_tokens=10_000)
    with pytest.raises(ValueError, match="kv_mode"):
        _port(pair[0], kv_mode="ring")


def test_sampled_tokens_match_jax(pair, jax_model):
    tmodel, batches, _ = pair
    want = _jax(jax_model, batches, **SAMPLED)
    assert _port(tmodel, **SAMPLED).generate(batches) == want
    # temperature 0 in a sampling engine is greedy
    assert _port(tmodel, **SAMPLED).generate(batches, temperature=0.0) == pair[2]


@pytest.fixture(scope="module")
def spec_plain(jax_model):
    """The JAX slab engine's plain greedy tokens for the speculative prompts."""
    return _jax(jax_model, SPEC_BATCHES, max_new_tokens=24, **SPEC)


@pytest.mark.parametrize("k", [2, 3])
def test_speculative_greedy_matches_jax(port_model, jax_model, spec_plain, k):
    eng = _port(port_model, speculative_k=k, **SPEC)
    got = eng.generate(SPEC_BATCHES, max_new_tokens=24)
    assert got == spec_plain
    assert got == _jax(jax_model, SPEC_BATCHES, max_new_tokens=24, speculative_k=k, **SPEC)
    assert eng.spec_verify_steps > 0 and eng.n_decode_steps == 0


def test_speculative_sampling_matches_jax_and_is_independent_of_k(port_model, jax_model):
    kw = dict(do_sample=True, temperature=1.3, seed=7, **SPEC)
    want = _jax(jax_model, SPEC_BATCHES, max_new_tokens=20, speculative_k=2, **kw)
    for k in (2, 3, 5):
        assert _port(port_model, speculative_k=k, **kw).generate(
            SPEC_BATCHES, max_new_tokens=20) == want
    greedy = _port(port_model, speculative_k=2, seed=7, **SPEC).generate(
        SPEC_BATCHES, max_new_tokens=20)
    assert want != greedy  # it actually samples at this temperature


def test_chunked_prompt_matches_jax(port_model, jax_model, collator):
    """Prompts longer than the largest bucket prefill chunk by chunk into the
    slot's own row: an image whose span lands in a later chunk, then a text
    prompt, then the first again (rows reused by the next request)."""
    filler = " ".join(f"w{i}" for i in range(80))
    mm_long = {"conversations": [{"role": "user", "content": f"{filler} look {ATTACH} now"}],
               "modalities": [{"type": "image", "value": _img((200, 30, 10))}]}
    b1, b2 = collator([mm_long]), collator([_text("repeat " * 70)])
    assert int(np.asarray(b1["attention_mask"]).sum()) > 64
    kw = dict(max_seq_len=256)
    eng = _port(port_model, **kw)
    got = [eng.generate([b], max_new_tokens=6) for b in (b1, b2, b1)]
    jmodel, params = jax_model
    jeng = JServingEngine(jmodel, params, JEngineConfig(**{**BASE, **kw}))
    assert got == [jeng.generate([b], max_new_tokens=6) for b in (b1, b2, b1)]
    assert got[0] == got[2]
    # and a chunked prompt decoding beside a bucketed one
    assert _port(port_model, **kw).generate([b2, b1]) == _jax(jax_model, [b2, b1], **kw)


def test_submit_group_falls_back_to_independent_requests(pair, jax_model):
    tmodel, batches, _ = pair
    eng = _port(tmodel, **SAMPLED)
    reqs = eng.submit_group(batches[1], 3)
    assert len(reqs) == 3 and len(eng.queue) == 3 and not any(r.forks for r in reqs)
    eng.run()
    got = [r.tokens for r in reqs]
    assert got == _jax(jax_model, [batches[1]] * 3, group_size=3, **SAMPLED)
    # a group larger than the slots queues, as independent requests do
    assert len(_port(tmodel).submit_group(batches[0], 5)) == 5


@pytest.mark.parametrize("w8a8", [False, True])
def test_quantized_slab_engine_matches_jax(port_model, jax_model, w8a8):
    """quantize_llm (W8A16 through K9's twin) and w8a8_prefill in slab mode;
    the last prompt takes the 256 bucket, so the W8A8 gate fires."""
    kw = dict(max_slots=4, max_seq_len=320, max_new_tokens=10, prefill_buckets=(16, 32, 256),
              quantize_llm=True, w8a8_prefill=w8a8)
    batches = SPEC_BATCHES + [_ids(list(range(3, 43)))]
    before = tw.launches["w8a8_matmul"]
    got = _port(port_model, **kw).generate(batches)
    assert got == _jax(jax_model, batches, **kw)
    assert (tw.launches["w8a8_matmul"] > before) == w8a8
    assert _port(port_model, speculative_k=2, **kw).generate(batches) == got


@pytest.mark.parametrize("spec_k", [0, 3])
def test_slots_run_up_to_capacity(port_model, jax_model, spec_k):
    """A slot decodes until its cache row is full while another keeps going:
    the full slot, inactive, still runs each step and writes at max_seq_len,
    and a verify block near capacity reaches past the end. Those writes are
    dropped, and the tokens equal the JAX slab engine's."""
    kw = dict(max_slots=2, max_seq_len=40, max_new_tokens=64, prefill_buckets=(16, 32),
              speculative_k=spec_k)
    batches = [_ids(list(range(4, 34))), _ids([5, 6, 5, 6, 5])]
    budgets = (64, 30)
    jmodel, params = jax_model
    jeng = JServingEngine(jmodel, params, JEngineConfig(**{**BASE, **kw}))
    want = [jeng.submit(b, max_new_tokens=n) for b, n in zip(batches, budgets)]
    jeng.run()
    eng = _port(port_model, **kw)
    reqs = [eng.submit(b, max_new_tokens=n) for b, n in zip(batches, budgets)]
    eng.run()
    assert [r.tokens for r in reqs] == [r.tokens for r in want]
    assert [r.finish_reason for r in reqs] == [r.finish_reason for r in want]
    assert reqs[0].finish_reason == "capacity" and len(reqs[0].tokens) == 40 - 30 + 1
    assert len(reqs[1].tokens) > len(reqs[0].tokens)  # decoded on past the full slot
