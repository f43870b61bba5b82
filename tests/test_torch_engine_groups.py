"""Port parity: forked groups, chunked prefill of long prompts and staggered
admission in the paged engine against the JAX paged engine, f32, on the CPU.
Repeats the cases of tests/test_paged_engine.py (chunked prefill, group
forks, staggered admission) and tests/test_serving_edges.py (chunked prefill
against a single bucket)."""

import dataclasses

import jax
import numpy as np
import pytest

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
from tests.test_multimodal import ATTACH, _img, tiny_mm_config
from tests.test_paged_engine import PROMPTS
from tests.test_torch_engine import jax_model, port_model  # noqa: F401 (fixtures)

BASE = dict(max_slots=2, max_seq_len=128, max_new_tokens=8, prefill_buckets=(32, 64),
            do_sample=False, kv_mode="paged", page_size=16)
LONG = dict(max_seq_len=256, prefill_buckets=(32, 64))


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


def _engine(tmodel, **kw):
    return te.ServingEngine(tmodel, te.EngineConfig(**{**BASE, **kw}))


def _jax_engine(jax_model, **kw):
    jmodel, params = jax_model
    return JServingEngine(jmodel, params, JEngineConfig(**{**BASE, **kw}))


def _text(content):
    return {"conversations": [{"role": "user", "content": content}], "modalities": []}


# ----------------------------------------------------------------------
# Chunked prefill
# ----------------------------------------------------------------------
def test_chunked_prefill_through_pages(port_model, jax_model, collator):
    batch = collator([_text("repeat " * 90)])
    assert batch["input_ids"].shape[1] > 64
    want = _jax_engine(jax_model, **LONG).generate([batch], max_new_tokens=6)
    eng = _engine(port_model, **LONG)
    assert eng.generate([batch], max_new_tokens=6) == want
    assert eng.n_prefill_calls >= 2  # one call per chunk
    assert sorted(eng.kv.free_pages) == list(range(1, eng.kv.num_pages))


def test_chunked_prefill_multimodal_through_pages(port_model, jax_model, collator):
    """An image whose span lands in a later chunk is spliced, and back-to-back
    long prompts do not contaminate each other through the reused slab."""
    filler = " ".join(f"w{i}" for i in range(80))
    mm_long = {"conversations": [{"role": "user", "content": f"{filler} look {ATTACH} now"}],
               "modalities": [{"type": "image", "value": _img((200, 30, 10))}]}
    b1, b2 = collator([mm_long]), collator([_text("repeat " * 70)])
    assert int(np.asarray(b1["attention_mask"]).sum()) > 64
    jeng, eng = _jax_engine(jax_model, **LONG), _engine(port_model, **LONG)
    want = [jeng.generate([b], max_new_tokens=6) for b in (b1, b2, b1)]
    got = [eng.generate([b], max_new_tokens=6) for b in (b1, b2, b1)]
    assert got == want
    assert got[0] == got[2]


@pytest.mark.parametrize("multimodal", [False, True])
def test_chunked_prefill_matches_single_bucket(port_model, jax_model, collator, multimodal):
    """A prompt longer than the largest bucket (16/32) prefills in chunks and
    gives the tokens of a single-bucket engine and of the JAX engine."""
    if multimodal:
        filler = " ".join(f"w{i}" for i in range(40))
        sample = {"conversations": [{"role": "user", "content": f"{filler} look {ATTACH} now"}],
                  "modalities": [{"type": "image", "value": _img((200, 30, 10))}]}
    else:
        sample = _text(" ".join(f"word{i}" for i in range(60)))
    batch = collator([sample])
    assert int(np.asarray(batch["attention_mask"]).sum()) > 32
    kw = dict(max_slots=1, max_seq_len=300, page_size=128)
    small = _engine(port_model, prefill_buckets=(16, 32), **kw).generate([batch], max_new_tokens=8)
    big = _engine(port_model, prefill_buckets=(256,), **kw).generate([batch], max_new_tokens=8)
    want = _jax_engine(jax_model, prefill_buckets=(16, 32), **kw).generate(
        [batch], max_new_tokens=8)
    assert small == big == want


# ----------------------------------------------------------------------
# Forked groups
# ----------------------------------------------------------------------
@pytest.mark.parametrize("prompt", [0, 1], ids=["text", "image"])
def test_group_fork_matches_jax_and_independent_greedy(port_model, jax_model, collator, prompt):
    b = collator([PROMPTS[prompt]])
    want = _jax_engine(jax_model, max_slots=4).generate([b, b, b], max_new_tokens=8,
                                                        group_size=3)
    ind = _engine(port_model, max_slots=4).generate([b, b, b], max_new_tokens=8)
    grp = _engine(port_model, max_slots=4).generate([b, b, b], max_new_tokens=8, group_size=3)
    assert grp == ind == want
    assert grp[0] == grp[1] == grp[2]


def test_group_fork_sampled_matches_jax(port_model, jax_model, collator):
    """Forks sample their first tokens from the primary's last logits with
    the next prefill seed, then decode with the chunk keys: the JAX tokens."""
    b = collator([PROMPTS[2]])
    kw = dict(max_slots=4, do_sample=True, temperature=1.0, seed=5)
    want = _jax_engine(jax_model, **kw).generate([b] * 3, max_new_tokens=8, group_size=3)
    got = _engine(port_model, **kw).generate([b] * 3, max_new_tokens=8, group_size=3)
    assert got == want
    assert len({tuple(t) for t in got}) > 1  # the siblings differ


def test_group_fork_shares_prompt_pages(port_model, collator):
    b = collator([PROMPTS[2]])  # longest prompt: several full pages
    eng = _engine(port_model, max_slots=4)
    eng.submit_group(b, 3, max_new_tokens=8)
    eng._admit()
    plen = int(np.asarray(b["attention_mask"]).sum())
    n_full = plen // eng.kv.page_size
    assert n_full >= 1
    rows = eng.kv.page_table[:3]
    # full prompt pages are the same page ids in every slot of the group
    for j in range(n_full):
        assert rows[1, j] == rows[0, j] and rows[2, j] == rows[0, j]
        assert eng.kv.page_ref[rows[0, j]] == 3
    # decode and tail pages are private
    for j in range(n_full, int(eng.kv.slot_num_pages[0])):
        assert len({int(rows[i, j]) for i in range(3)}) == 3
    eng.run()
    assert eng.kv.page_ref.sum() == 0
    assert len(eng.kv.free_pages) == eng.kv.num_pages - 1


def test_group_fork_one_layer_one_kv_head(collator):
    """A forked pair on a one-layer, one-K/V-head decoder, over a prompt that
    ends inside a page: the sibling's copy of the tail page, whose source
    page is then the whole of its slice of the pool, gives the JAX engine's
    tokens."""
    cfg = tiny_mm_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=1,
                                                           num_kv_heads=1))
    jmodel = MultimodalModel(cfg)
    jmodel.config.eos_token_idx = 2
    params = jmodel.init_params(jax.random.PRNGKey(1))
    tmodel = tm.MultimodalModel(tm.MultimodalConfig.from_dict(jmodel.config.to_dict()),
                                device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    b = collator([PROMPTS[0]])
    assert int(np.asarray(b["attention_mask"]).sum()) % BASE["page_size"] != 0
    want = JServingEngine(jmodel, params, JEngineConfig(**BASE)).generate(
        [b, b], max_new_tokens=8, group_size=2)
    assert _engine(tmodel).generate([b, b], max_new_tokens=8, group_size=2) == want


@pytest.mark.parametrize("spec_k", [0, 2])
def test_group_fork_long_prompt_chunked(port_model, jax_model, collator, spec_k):
    """A forked group whose prompt takes the chunked path; with speculation
    the forks inherit the primary's token history."""
    b = collator([_text("repeat " * 90)])
    kw = dict(max_slots=4, speculative_k=spec_k, **LONG)
    want = _jax_engine(jax_model, **{**kw, "speculative_k": 0}).generate(
        [b, b], max_new_tokens=6, group_size=2)
    ind = _engine(port_model, **kw).generate([b, b], max_new_tokens=6)
    grp = _engine(port_model, **kw).generate([b, b], max_new_tokens=6, group_size=2)
    assert ind == grp == want


def test_group_fork_waits_for_slots(port_model, collator):
    """A group wider than the free slots waits (FIFO) and is admitted once
    slots free up; max_slots bounds the group size."""
    b = collator([PROMPTS[0]])
    eng = _engine(port_model, max_slots=2)
    with pytest.raises(ValueError, match="max_slots"):
        eng.submit_group(b, 3)
    first = eng.submit(b, max_new_tokens=16)
    eng._admit()
    group = eng.submit_group(b, 2, max_new_tokens=4)
    eng._admit()
    assert eng.queue == [group[0]]  # one slot is free, the group needs two
    eng.run()
    assert first.done and all(r.done for r in group)
    assert all(len(r.tokens) == 4 for r in group)


def test_spec_group_fork_copies_history(port_model, collator):
    """With speculation a fork's token history is the primary's prompt plus
    its own first token."""
    b = collator([PROMPTS[2]])
    eng = _engine(port_model, max_slots=4, speculative_k=2)
    reqs = eng.submit_group(b, 3, max_new_tokens=8)
    eng._admit()
    plen = int(np.asarray(b["attention_mask"]).sum())
    hist = eng.state["history"].numpy()
    ids = np.asarray(b["input_ids"])[0, :plen]
    for slot, req in enumerate(reqs):
        np.testing.assert_array_equal(hist[slot, :plen], ids)
        assert hist[slot, plen] == req.tokens[0]
    eng.run()
    assert all(r.done for r in reqs)


# ----------------------------------------------------------------------
# Staggered admission
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec_k", [0, 2])
def test_staggered_admission_parity(port_model, jax_model, collator, monkeypatch, spec_k):
    """prefill_group_cap=1 admits one request per step with 1-step chunks
    between groups: the JAX staggered engine's tokens, those of admitting
    everything at once, and prefill groups of one."""
    batches = [collator([p]) for p in (PROMPTS + PROMPTS)]
    want = _jax_engine(jax_model, max_slots=4, prefill_group_cap=1).generate(
        batches, max_new_tokens=6)
    base = _engine(port_model, max_slots=4, speculative_k=spec_k).generate(
        batches, max_new_tokens=6)
    sizes = []
    prefill_group = te.ServingEngine._prefill_group

    def recording(self, group, *args, **kw):
        sizes.append(len(group))
        return prefill_group(self, group, *args, **kw)

    monkeypatch.setattr(te.ServingEngine, "_prefill_group", recording)
    stag = _engine(port_model, max_slots=4, prefill_group_cap=1, speculative_k=spec_k)
    assert stag.generate(batches, max_new_tokens=6) == base == want
    assert sizes and max(sizes) == 1
