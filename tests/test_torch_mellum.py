"""The Mellum2 decoder (``model_type: "mellum"``: sliding-window and full
layers, YaRN on the full ones, a 64-expert top-8 mixture in every layer) at a
tiny size on the CPU, in float32, against the plain reference of the
benchmark (``bench_torch/reference/mellum.py``, loaded by its path), which
shares no code with the port.

Tolerances: the port and the reference compute in float32 in other orders
(attention by GQA groups and masked softmax against repeated heads and
-inf; experts gathered and summed by slot against ``index_add_``; RoPE
angles from float32 against float64 frequencies): 2e-5 on hidden states and
logits of order 1, about 100 float32 ulps. A window of 8 below the
sequences' lengths makes the sliding layers drop keys.
"""

import dataclasses
import importlib.util
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from multimeditron_torch.models.llama import Llama, LlamaConfig
from multimeditron_torch.models.moe import MoE
from multimeditron_torch.models.multimodal import MultimodalConfig, MultimodalModel
from multimeditron_torch.models import common
from multimeditron_torch.ops import grouped_experts as ge
from multimeditron_torch.ops import paged_attention as paged
from multimeditron_torch.profiling import tracer
from multimeditron_torch.serve.engine import EngineConfig, ServingEngine

BENCH = Path(__file__).resolve().parents[1] / "bench_torch"
TOL = 2e-5
S, FULL = "sliding_attention", "full_attention"
ROPE = {FULL: {"rope_type": "yarn", "rope_theta": 500000, "factor": 4,
               "original_max_position_embeddings": 32, "beta_fast": 32, "beta_slow": 1,
               "attention_factor": 1.1386294361119891},
        S: {"rope_type": "default", "rope_theta": 500000}}
HF = dict(model_type="mellum", vocab_size=97, hidden_size=64, intermediate_size=96,
          num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
          rms_norm_eps=1e-6, tie_word_embeddings=False, max_position_embeddings=4096,
          layer_types=[S, S, S, FULL], mlp_layer_types=["sparse"] * 4, sliding_window=8,
          rope_parameters=ROPE, num_experts=8, num_experts_per_tok=2,
          moe_intermediate_size=32, norm_topk_prob=True, attention_bias=False,
          use_sliding_window=True)
EOS = 96


@pytest.fixture(scope="module")
def ref():
    """``reference/mellum.py`` by its path (its ``reference.model`` import
    needs the benchmark's directory on the path while it loads)."""
    sys.path.insert(0, str(BENCH))
    try:
        spec = importlib.util.spec_from_file_location("mellum_reference",
                                                      BENCH / "reference" / "mellum.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(BENCH))
    return mod


def _dims(**over):
    hf = {**HF, **over}
    return types.SimpleNamespace(
        H=hf["num_attention_heads"], Hkv=hf["num_key_value_heads"], Dh=hf["head_dim"],
        E=hf["num_experts"], K=hf["num_experts_per_tok"], window=hf["sliding_window"],
        norm_topk=hf["norm_topk_prob"], kinds_of=tuple(hf["layer_types"]),
        rope=hf["rope_parameters"], eps=hf["rms_norm_eps"])


def _model(seed=0, **over):
    cfg = dataclasses.replace(LlamaConfig.from_hf_dict({**HF, **over}), dtype=torch.float32)
    model = MultimodalModel(MultimodalConfig(llm=cfg, eos_token_idx=EOS), device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _layer_weights(layer):
    W = {k: getattr(layer, n).weight for k, n in
         (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "o_proj"))}
    W.update(router=layer.moe.router.weight, gate=layer.moe.w_gate, up=layer.moe.w_up,
             down=layer.moe.w_down)
    return {k: v.detach().float() for k, v in W.items()}


def _ref_logits(ref, model, ids):
    """The reference's full forward over one sequence: (n, V) logits."""
    llm, d = model.llm, _dims()
    with torch.no_grad():
        x = llm.embed_tokens.weight[torch.as_tensor(ids)].float()
        tables = ref.rope_tables(d, len(ids), "cpu")
        for i, layer in enumerate(llm.layers):
            x = ref.decoder_layer(i, x, _layer_weights(layer), d, tables)
        x = x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + d.eps)
        return x @ llm.lm_head.weight.float().t()


def test_config_reads_mellum():
    cfg = LlamaConfig.from_hf_dict(HF)
    assert [cfg.layer_window(i) for i in range(4)] == [8, 8, 8, 0]
    assert cfg.layer_rope(3) == (500000.0, ROPE[FULL]) and cfg.layer_rope(0) == (500000.0, None)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size) == (8, 2, 32)
    assert cfg.windowed and not cfg.use_qk_norm
    model = Llama(cfg, device="meta")
    # attention, router, 8 experts of 3 x 64 x 32 and 2 norms a layer; no dense MLP
    per_layer = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 8 * 64 + 8 * 3 * 64 * 32 + 2 * 64
    assert sum(p.numel() for p in model.parameters()) == 4 * per_layer + 2 * 97 * 64 + 64


@pytest.mark.parametrize("over,what", [
    (dict(model_type="mixtral"), "model_type 'mixtral'"),
    (dict(attention_bias=True), "attention_bias"),
    (dict(scoring_func="sigmoid"), "scoring_func"),
    (dict(mlp_layer_types=["sparse", "dense", "sparse", "sparse"]), "mlp_layer_types"),
    (dict(shared_expert_intermediate_size=64), "shared experts"),
    (dict(layer_types=[S, S, "chunked_attention", FULL]), "layer_types"),
    (dict(sliding_window=None), "sliding_window"),
    (dict(rope_parameters={**ROPE, FULL: {"rope_type": "dynamic", "rope_theta": 1e4}}),
     "rope_type 'dynamic'"),
    (dict(model_type="qwen3", use_sliding_window=True, num_experts=0, layer_types=None,
          rope_parameters=None), "use_sliding_window"),
    (dict(model_type="llama", layer_types=None, rope_parameters=None), "num_experts"),
])
def test_from_hf_dict_refuses_what_it_cannot_honour(over, what):
    with pytest.raises(NotImplementedError, match=what):
        LlamaConfig.from_hf_dict({**HF, **over})


def test_yarn_frequencies_against_their_closed_form():
    """Mellum2's full layers: head dim 128, theta 5e5, factor 16 over 8,192
    positions, beta 32 / 1. The correction dims are floor(18.08) = 18 and
    ceil(34.98) = 35: pairs below 18 keep theta^(-2i/d), pairs past 35 are
    divided by 16, the ramp blends the pairs between; cos and sin are scaled
    by 0.1 ln 16 + 1."""
    p = {"rope_type": "yarn", "factor": 16, "original_max_position_embeddings": 8192,
         "beta_fast": 32, "beta_slow": 1}
    got = common.rope_frequencies(128, 500000.0, p).double()
    i = torch.arange(64, dtype=torch.float64)
    base = 500000.0 ** (-2 * i / 128)
    lo = 128 * math.log(8192 / (32 * 2 * math.pi)) / (2 * math.log(500000.0))
    hi = 128 * math.log(8192 / (1 * 2 * math.pi)) / (2 * math.log(500000.0))
    assert (math.floor(lo), math.ceil(hi)) == (18, 35)
    ramp = ((i - 18) / (35 - 18)).clamp(0, 1)
    want = base * (1 - ramp) + base / 16 * ramp
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)  # float32 frequencies
    torch.testing.assert_close(got[:18], base[:18], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[36:], base[36:] / 16, rtol=1e-6, atol=0)
    assert common.rope_attention_factor(p) == pytest.approx(1.2772588722239782, abs=1e-15)
    assert common.rope_attention_factor({**p, "attention_factor": 1.5}) == 1.5
    assert common.rope_attention_factor({"rope_type": "llama3"}) == 1.0


def test_yarn_table_matches_the_reference(ref):
    d = _dims()
    cos, sin = ref.rope_tables(d, 40, "cpu")[FULL]
    x = torch.randn(1, 2, 40, 16, generator=torch.Generator().manual_seed(1))
    inv = common.rope_frequencies(16, 500000.0, ROPE[FULL])
    got = common.apply_rope(x, torch.arange(40)[None], inv, common.rope_attention_factor(ROPE[FULL]))
    torch.testing.assert_close(got[0], ref._rotate(x[0], cos, sin), rtol=0, atol=TOL)


def test_moe_layer_alone(ref):
    """The expert layer against the reference's loop over experts, and its
    counters: experts with a token and assignments, added on the device."""
    cfg = dataclasses.replace(LlamaConfig.from_hf_dict(HF), dtype=torch.float32)
    moe = MoE(cfg, device="cpu")
    moe.init_weights(torch.Generator().manual_seed(3))
    h = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(4))
    stats = torch.zeros(2, dtype=torch.int64)
    with torch.no_grad():
        got = moe(h, stats)
        W = {"router": moe.router.weight, "gate": moe.w_gate, "up": moe.w_up, "down": moe.w_down}
        want = ref.experts(h.reshape(-1, 64), W, _dims())
    torch.testing.assert_close(got.reshape(-1, 64), want, rtol=0, atol=TOL)
    ids, _ = moe.route(h.reshape(-1, 64))
    assert stats.tolist() == [len(set(ids.flatten().tolist())), 18 * 2]


def test_grouped_experts_twin_against_every_expert_dense():
    """The twin against all experts applied to all tokens, weighted by a
    dense routing matrix (zero off the top k), with an expert no token
    chose; bf16 rounds silu(g) * u before down in both."""
    g = torch.Generator().manual_seed(5)
    N, D, F_, E, k = 11, 32, 16, 6, 2
    x = torch.randn(N, D, generator=g).bfloat16()
    wg, wu = (torch.randn(E, F_, D, generator=g).bfloat16() for _ in range(2))
    wd = torch.randn(E, D, F_, generator=g).bfloat16()
    ids = torch.randint(0, E - 1, (N, k), generator=g)  # expert E - 1 gets no token
    ids[:, 1] = (ids[:, 0] + 1) % (E - 1)
    w = torch.rand(N, k, generator=g)
    dense = torch.zeros(N, E).scatter_(1, ids, w)
    xf = x.float()
    act = (torch.nn.functional.silu(torch.einsum("nd,efd->enf", xf, wg.float()))
           * torch.einsum("nd,efd->enf", xf, wu.float())).bfloat16().float()
    want = torch.einsum("enf,edf,ne->nd", act, wd.float(), dense)
    stats = torch.zeros(2, dtype=torch.int64)
    got = ge.grouped_experts(x, ids, w, wg, wu, wd, stats)
    assert got.dtype == torch.bfloat16 and ge.launches["grouped_experts"] == 0
    torch.testing.assert_close(got.float(), want.bfloat16().float(), rtol=0, atol=0.05)
    assert stats.tolist() == [E - 1, N * k]


def test_prefill_logits_match_the_reference(ref):
    """The decoder's forward over a 21-token prompt (past the window of 8)
    against the reference's."""
    model = _model()
    ids = np.random.default_rng(6).integers(0, 96, 21)
    with torch.no_grad():
        got, _ = model.llm(input_ids=torch.as_tensor(ids)[None])
    torch.testing.assert_close(got[0], _ref_logits(ref, model, ids), rtol=0, atol=TOL)


def _serve(model, prompts, groups=None, **engine):
    """Serve greedily, recording the logits that every sampling call saw and
    the slot each request was admitted to."""
    ecfg = EngineConfig(**{**dict(max_slots=3, max_seq_len=48, prefill_buckets=(16, 32),
                                  page_size=16, decode_chunk=4, max_new_tokens=14,
                                  do_sample=False), **engine})
    eng = ServingEngine(model, ecfg)
    seen, slots = [], {}
    sample, admit = eng._sample, eng._admit_on_host

    def recording(logits, *a):
        seen.append(logits.detach().float().clone())
        return sample(logits, *a)

    def admitted(req, slot, *a):
        slots[req.request_id] = slot
        return admit(req, slot, *a)
    eng._sample, eng._admit_on_host = recording, admitted
    reqs = []
    for ids, group in zip(prompts, groups or [1] * len(prompts)):
        batch = {"input_ids": ids[None].astype(np.int32),
                 "attention_mask": np.ones((1, len(ids)), np.int32)}
        reqs += eng.submit_group(batch, group) if group > 1 else [eng.submit(batch)]
    eng.run()
    return eng, reqs, seen, slots


def test_prefill_then_paged_decode_match_the_reference(ref):
    """One request, 13 prompt tokens and 14 served: the logits of the
    prefill and of each paged decode step (one slot live) against the
    reference's full forward at the same positions; the sliding layers'
    windows of 8 drop keys from the 9th position on."""
    model = _model(seed=1)
    ids = np.random.default_rng(7).integers(0, 96, 13)
    eng, (req,), seen, _ = _serve(model, [ids], max_slots=1)
    assert req.finish_reason == "budget" and len(req.tokens) == 14
    want = _ref_logits(ref, model, np.concatenate([ids, req.tokens[:-1]]))
    got = torch.stack([s[0] for s in seen])
    torch.testing.assert_close(got, want[12:], rtol=0, atol=TOL)
    assert eng.n_decode_steps == 13


def test_forked_group_matches_the_reference(ref):
    """A forked group of 3 over a 21-token prompt (a full shared page and a
    copied tail page) and a request of 10 tokens beside it: each slot's
    logits at each decode step against the reference, and the expert
    counters read back with the tokens: every row of every expert-layer
    call (bucket rows in a prefill, every slot in a decode step) makes 2
    assignments in each of the 4 layers."""
    model = _model(seed=2)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 96, 21), rng.integers(0, 96, 10)]
    tracer.enable()
    try:
        eng, reqs, seen, slots = _serve(model, prompts, groups=[3, 1], max_slots=6,
                                        max_new_tokens=12)
        chunks = [s for s in tracer.spans() if s["name"] == "decode.chunk"]
        prefills = [s for s in tracer.spans() if s["name"] == "engine.prefill"]
    finally:
        tracer.disable()
    assert len(reqs) == 4 and all(r.finish_reason == "budget" for r in reqs)
    assert reqs[0].tokens == reqs[1].tokens == reqs[2].tokens
    steps = [s for s in seen if s.shape[0] == 6]  # the decode steps over the 6 slots
    assert len(steps) == eng.n_decode_steps == 11
    for r, ids in ((reqs[0], prompts[0]), (reqs[2], prompts[0]), (reqs[3], prompts[1])):
        want = _ref_logits(ref, model, np.concatenate([ids, r.tokens[:-1]]))
        got = torch.stack([s[slots[r.request_id]] for s in steps])
        torch.testing.assert_close(got, want[len(ids):], rtol=0, atol=TOL)
    L, k = 4, 2
    assert sum(p["attrs"]["expert_assignments"] for p in prefills) == L * k * (32 + 16)
    assert sum(c["attrs"]["expert_assignments"] for c in chunks) == L * k * 6 * 11
    assert eng.n_expert_assignments == L * k * (32 + 16 + 6 * 11)
    assert all(0 < c["attrs"]["experts_touched"] <= L * 8 * 4 for c in chunks)
    assert eng.n_experts_touched == sum(s["attrs"]["experts_touched"] for s in chunks + prefills)


def test_ring_decode_window_twin_against_masked_attention():
    """K4's twin with a window against attention over the keys at positions
    lengths - window + 1 .. lengths gathered by hand (pages, then ring)."""
    g = torch.Generator().manual_seed(9)
    B, H, Hkv, D, P, pm, T = 3, 4, 2, 16, 16, 4, 16
    n_pages = 1 + B * pm
    kp, vp = (torch.randn(1, Hkv, n_pages, P, D, generator=g) for _ in range(2))
    kr, vr = (torch.randn(1, B, Hkv, T, D, generator=g) for _ in range(2))
    q = torch.randn(B, H, D, generator=g)
    table = torch.arange(1, n_pages, dtype=torch.int32).reshape(B, pm).flip(1).contiguous()
    plen = torch.tensor([5, 40, 33], dtype=torch.int32)
    lengths = plen + torch.tensor([3, 0, 10], dtype=torch.int32)
    for window in (4, 8, 30, 0):
        got = paged.ring_decode_attention(q, kp, vp, kr, vr, table, plen, lengths, 0,
                                          window=window)
        for b in range(B):
            keys, vals = [], []
            for pos in range(int(lengths[b]) + 1):
                if window and pos <= int(lengths[b]) - window:
                    continue
                if pos < int(plen[b]):
                    page = int(table[b, pos // P])
                    keys.append(kp[0, :, page, pos % P])
                    vals.append(vp[0, :, page, pos % P])
                else:
                    keys.append(kr[0, b, :, pos - int(plen[b])])
                    vals.append(vr[0, b, :, pos - int(plen[b])])
            k, v = torch.stack(keys, 1), torch.stack(vals, 1)  # (Hkv, n, D)
            k, v = k.repeat_interleave(H // Hkv, 0), v.repeat_interleave(H // Hkv, 0)
            p = torch.softmax((q[b][:, None] * k).sum(-1) * D ** -0.5, dim=-1)
            torch.testing.assert_close(got[b], (p[:, :, None] * v).sum(1), rtol=0, atol=TOL)


def test_paths_without_windows_or_experts_refuse():
    """Slab decode, speculation, the int8 decoder, generate() and training
    raise NotImplementedError naming what is missing."""
    from multimeditron_torch.models.generation import generate
    from multimeditron_torch.train.trainer import MultimodalTrainer, TrainerConfig

    model = _model()
    for engine, what in ((dict(kv_mode="slab"), "slab decode"),
                         (dict(speculative_k=2), "speculative"),
                         (dict(quantize_llm=True), "quantize_llm")):
        with pytest.raises(NotImplementedError, match=what):
            ServingEngine(model, EngineConfig(max_slots=2, max_seq_len=32,
                                              prefill_buckets=(16,), page_size=16, **engine))
    ids = np.random.default_rng(1).integers(0, 96, (1, 12)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    with pytest.raises(NotImplementedError, match=r"generate\(\)"):
        generate(model, batch, max_new_tokens=2)
    tb = {"input_ids": torch.as_tensor(ids).long(), "attention_mask": torch.ones(1, 12),
          "labels": torch.as_tensor(ids).long()}
    with pytest.raises(NotImplementedError, match="training"):
        model(tb)
    with pytest.raises(NotImplementedError, match="training"):
        MultimodalTrainer(model, TrainerConfig(total_steps=1)).train_step(tb)
