"""Port parity: speculative decoding in the paged engine against the JAX paged
engine, f32, on the CPU. Repeats tests/test_spec_decode.py in paged mode:
greedy output equals the plain greedy decode for every k; pages are released;
budget and capacity finish; sampled output equals the JAX engine's and is
independent of k; temperature 0 is greedy; a request joins mid-flight."""

import numpy as np
import pytest
import torch

from multimeditron_torch.profiling import tracer
from multimeditron_torch.serve import engine as te
from multimeditron_tpu.serve.engine import EngineConfig as JEngineConfig
from multimeditron_tpu.serve.engine import ServingEngine as JServingEngine
from tests.test_spec_decode import PROMPTS
from tests.test_torch_engine import jax_model, port_model  # noqa: F401 (fixtures)

BASE = dict(max_slots=4, max_seq_len=96, max_new_tokens=24, prefill_buckets=(16, 32),
            do_sample=False, kv_mode="paged")
SAMPLED = dict(do_sample=True, temperature=1.3, seed=7)


def _batch(ids):
    ids = np.asarray([ids], np.int32)
    return {"input_ids": ids, "attention_mask": np.ones_like(ids)}


BATCHES = [_batch(p) for p in PROMPTS]


def _engine(tmodel, spec_k=0, **kw):
    return te.ServingEngine(tmodel, te.EngineConfig(**{**BASE, "speculative_k": spec_k, **kw}))


def _jax(jax_model, batches, spec_k=0, max_new_tokens=24, **kw):
    jmodel, params = jax_model
    cfg = JEngineConfig(**{**BASE, "speculative_k": spec_k, **kw})
    return JServingEngine(jmodel, params, cfg).generate(batches, max_new_tokens=max_new_tokens)


@pytest.fixture(scope="module")
def plain(jax_model):
    """The JAX paged engine's plain greedy tokens for PROMPTS."""
    return _jax(jax_model, BATCHES)


@pytest.mark.parametrize("k", [2, 4])
def test_spec_greedy_matches_jax_plain_greedy(port_model, plain, k):
    eng = _engine(port_model, spec_k=k)
    assert eng.generate(BATCHES, max_new_tokens=24) == plain
    assert eng.spec_verify_steps > 0 and eng.spec_emitted >= eng.spec_slot_steps
    assert eng.n_decode_steps == 0  # the plain chunk never ran


def test_plain_greedy_matches_jax(port_model, plain):
    assert _engine(port_model).generate(BATCHES, max_new_tokens=24) == plain


def test_spec_run_records_the_decode_spans(port_model):
    """A speculative run records the plain path's spans: verify steps in
    ``decode.step`` (``ran``) inside ``decode.chunk``, and the replay's
    ``emitted`` counts, which sum to ``spec_emitted``."""
    tracer.enable()
    try:
        eng = _engine(port_model, spec_k=2)
        eng.generate(BATCHES, max_new_tokens=12)
        spans = tracer.spans()
    finally:
        tracer.disable()
    names = {s["name"] for s in spans}
    assert {"decode.chunk", "decode.step", "decode.wait", "decode.forward", "decode.sample",
            "decode.fold", "engine.replay"} <= names
    steps = [s for s in spans if s["name"] == "decode.step"]
    by_index = {s["index"]: s for s in spans}
    assert all(by_index[s["parent"]]["name"] == "decode.chunk" for s in steps)
    assert sum(s["attrs"]["ran"] for s in steps) == eng.spec_verify_steps > 0
    emitted = sum(n for s in spans if s["name"] == "engine.replay"
                  for n in s["attrs"]["emitted"].values())
    assert emitted == eng.spec_emitted > 0


def test_spec_paged_releases_pages(port_model):
    eng = _engine(port_model, spec_k=3)
    total_free = len(eng.kv.free_pages)
    eng.generate(BATCHES, max_new_tokens=10)
    assert len(eng.kv.free_pages) == total_free
    assert np.all(eng.kv.slot_num_pages == 0) and eng.kv.page_ref.sum() == 0


def test_spec_budget_respected(port_model, plain):
    eng = _engine(port_model, spec_k=3)
    reqs = [eng.submit(b, max_new_tokens=5) for b in BATCHES[:2]]
    eng.run()
    for r, want in zip(reqs, plain):
        assert len(r.tokens) <= 5
        assert r.done and r.finish_reason in ("budget", "eos")
        assert r.tokens == want[:len(r.tokens)]


def test_spec_capacity_finish_matches_jax(port_model, jax_model):
    want = _jax(jax_model, BATCHES[:1], spec_k=3, max_new_tokens=64, max_seq_len=40)
    eng = _engine(port_model, spec_k=3, max_seq_len=40, max_new_tokens=64)
    req = eng.submit(BATCHES[0], max_new_tokens=64)
    eng.run()
    assert req.done and req.finish_reason in ("capacity", "eos")
    assert len(req.tokens) <= 40 - 12 + 1
    assert [req.tokens] == want


def test_spec_sampling_matches_jax_and_is_independent_of_k(port_model, jax_model):
    """Position-keyed sampling: the port's k = 2, 4 and 5 engines emit the
    JAX k = 2 engine's tokens."""
    want = _jax(jax_model, BATCHES, spec_k=2, max_new_tokens=20, **SAMPLED)
    for k in (2, 4, 5):
        assert _engine(port_model, spec_k=k, **SAMPLED).generate(
            BATCHES, max_new_tokens=20) == want
    greedy = _engine(port_model, spec_k=2, seed=7).generate(BATCHES, max_new_tokens=20)
    assert want != greedy  # it actually samples at this temperature


def test_spec_sampling_respects_temperature_zero(port_model, plain):
    eng = _engine(port_model, spec_k=3, do_sample=True, temperature=0.0)
    out = eng.generate(BATCHES[:2], max_new_tokens=12, temperature=0.0)
    assert out == [t[:12] for t in plain[:2]]


def test_spec_continuous_batching_joins(port_model, plain):
    """A request admitted mid-flight decodes correctly beside running
    speculative slots."""
    eng = _engine(port_model, spec_k=3, max_slots=2)
    r1 = eng.submit(BATCHES[0], max_new_tokens=20)
    eng.step()
    eng.step()
    r2 = eng.submit(BATCHES[1], max_new_tokens=12)
    eng.run()
    assert r1.done and r2.done
    assert r1.tokens == plain[0][:20]
    assert r2.tokens == plain[1][:12]


def test_draft_prefers_the_latest_trigram(port_model):
    """The n-gram draft: a trigram match outranks a later bigram match, the
    most recent match wins within a rank, no match repeats the last token."""
    eng = _engine(port_model, spec_k=2)
    Lh = eng.state["history"].shape[1]
    hist = np.zeros((3, Lh), np.int32)
    # committed tokens hist[b, :length + 1]; the draft continues their last n-gram
    hist[0, :11] = [3, 5, 6, 1, 2, 5, 6, 8, 3, 5, 6]  # trigram (3,5,6)@2 beats bigram (5,6)@6
    hist[1, :10] = [4, 5, 6, 7, 8, 3, 5, 6, 9, 4]     # no earlier (9, 4)
    hist[2, :10] = [9, 5, 7, 7, 9, 5, 6, 1, 9, 5]     # bigram (9, 5) at 1 and at 5
    h = torch.from_numpy(hist)
    length = torch.tensor([10, 9, 9], dtype=torch.int32)
    last = h.gather(1, length.long()[:, None])[:, 0]
    got = eng._draft(h, length, last).numpy()
    assert got[0].tolist() == [1, 2]   # after the trigram, not the later bigram
    assert got[1].tolist() == [4, 4]   # no match: the last token, repeated
    assert got[2].tolist() == [6, 1]   # after the most recent bigram
