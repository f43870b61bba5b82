"""Every configuration file builds through the program's public entry
points with the parameter counts it states."""

import pytest
import torch

import spec
import weights

CONFIGS = ["apertus-8b-clip-l14", "qwen3-4b-clip-l14"]
PUBLISHED = {"apertus-8b-clip-l14": 8.05e9, "qwen3-4b-clip-l14": 4.02e9}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_with_its_counts(name):
    import unittest.mock as mock

    from multimeditron_torch.models.llama import LlamaConfig

    import program

    cfg = spec.load_config(name)
    d = spec.dims(cfg)
    llm = LlamaConfig.from_hf_dict(cfg["decoder"])
    assert (llm.hidden_size, llm.num_layers, llm.num_heads, llm.num_kv_heads, llm.head_dim_,
            llm.intermediate_size, llm.vocab_size) == (d.D, d.L, d.H, d.Hkv, d.Dh, d.F, d.V)
    assert llm.use_qk_norm and llm.mlp_gate == d.gated and llm.tie_word_embeddings == d.tied
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    # the program's own model, built on the meta device: no memory
    with mock.patch.object(program, "fill"):
        model = program.build_model(cfg, d, 0, "meta")
    counts = {"decoder": sum(p.numel() for p in model.llm.parameters()),
              "tower": sum(p.numel() for p in model.modalities["image"].embedder.parameters()),
              "projector": sum(p.numel() for p in
                               model.modalities["image"].projector.parameters())}
    assert counts == cfg["params"]
    assert counts["decoder"] == d.decoder_params
    assert counts["tower"] == d.tower_params
    assert counts["projector"] == d.projector_params
    assert counts["decoder"] == pytest.approx(PUBLISHED[name], rel=0.005)
    assert counts["tower"] == pytest.approx(0.30e9, rel=0.02)


def test_weight_blocks_are_remade_exactly():
    cfg = spec.shrink(spec.load_config("qwen3-4b-clip-l14"), hidden_size=32,
                      num_hidden_layers=2, intermediate_size=48, vocab_size=64)
    d = spec.dims(cfg)
    a = weights.decoder_layer(5, d, 1, "cpu")
    b = weights.decoder_layer(5, d, 1, "cpu")
    c = weights.decoder_layer(5, d, 0, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["q"], c["q"])
    assert a["q"].dtype == torch.bfloat16
    assert float(a["up"].float().std()) == pytest.approx(32 ** -0.5, rel=0.15)
