"""Every configuration file builds through the program's public entry
points with the parameter counts it states, and its architecture's weight
blocks are the ones the benchmark has always drawn."""

import hashlib
import unittest.mock as mock

import pytest
import torch

import rehearse
import spec
import weights

CONFIGS = sorted(p.stem for p in (spec.ROOT / "configs").glob("*.json"))
DENSE = [name for name in CONFIGS if spec.load_config(name)["arch"] == "dense"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_with_its_counts(name):
    import program

    cfg = spec.load_config(name)
    d = spec.dims(cfg)
    assert len(cfg["source"]) <= 200
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
    published = cfg["published_params"]
    assert counts["decoder"] == pytest.approx(published["decoder"], rel=0.005)
    assert counts["tower"] == pytest.approx(published["tower"], rel=0.02)


@pytest.mark.parametrize("name", DENSE)
def test_dense_config_is_the_programs_llama(name):
    from multimeditron_torch.models.llama import LlamaConfig

    cfg = spec.load_config(name)
    d = spec.dims(cfg)
    llm = LlamaConfig.from_hf_dict(cfg["decoder"])
    assert (llm.hidden_size, llm.num_layers, llm.num_heads, llm.num_kv_heads, llm.head_dim_,
            llm.intermediate_size, llm.vocab_size) == (d.D, d.L, d.H, d.Hkv, d.Dh, d.F, d.V)
    assert llm.use_qk_norm and llm.mlp_gate == d.gated and llm.tie_word_embeddings == d.tied
    assert cfg["reduced"] == []


def test_a_missing_architecture_names_those_there():
    with pytest.raises(FileNotFoundError, match=r"no architecture 'nope'.*'dense'"):
        spec.architecture("nope")


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


# sha256 of each block (its entries' names and bf16 bytes, in order) at the
# rehearsals' tiny sizes and seed 3,000,000,019, as the harness drew them
# before the decoder's layout moved into arch/dense.py
PINNED = {
    "apertus-8b-clip-l14": {
        "decoder.layer.0": "1155993c0f0f104a5939a75b5250ce0053753caf7e22a6d576676f59757e1414",
        "decoder.layer.1": "bc1c7d9074e5f117e4674d884139d8c83a76a4ef67fa238c7ba112cf65ca46b5",
        "decoder.embed": "f535029ef31223f48f7c55bdc2cfbde90858be74ba0b9c080d8ffe04608a6f45",
        "decoder.head": "20619b64eacab78c7a66b0c2f7b6075618d77ff2412badaa66790070f7d7ccd3",
        "tower.stem": "3380dca2a3e533f7fdd0cbf7290e2082033ecaa8d5996f154a2254fe5456ed21",
        "tower.layer.0": "dfc4d190bc6efb5a8a06e5d594145687041526bf81b128dcdf99c60fe0bdaa00",
        "tower.layer.1": "3b9993c95ddd5d02b38559cae01b6497cb2c79ecf7512a75fef092194ef81961",
        "projector": "abae1c7ca6572d607a49aa2b61f3e1331ea102fb3755c30edae3fa079b064137"},
    "qwen3-4b-clip-l14": {
        "decoder.layer.0": "73c3235c3cf81d28585cf4ce2e1650e3e589d68be7da046698efcf4e97aa00bf",
        "decoder.layer.1": "12c137e238d8f72aebc09a28c41f189711fc5a985c438c5ad4f668add3cf8501",
        "decoder.embed": "f535029ef31223f48f7c55bdc2cfbde90858be74ba0b9c080d8ffe04608a6f45",
        "tower.stem": "3380dca2a3e533f7fdd0cbf7290e2082033ecaa8d5996f154a2254fe5456ed21",
        "tower.layer.0": "dfc4d190bc6efb5a8a06e5d594145687041526bf81b128dcdf99c60fe0bdaa00",
        "tower.layer.1": "3b9993c95ddd5d02b38559cae01b6497cb2c79ecf7512a75fef092194ef81961",
        "projector": "abae1c7ca6572d607a49aa2b61f3e1331ea102fb3755c30edae3fa079b064137"},
}


def _sha(block):
    m = hashlib.sha256()
    for k, v in block.items():
        m.update(k.encode())
        m.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    return m.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weight_blocks_match_their_pinned_bytes(name):
    cfg = spec.load_config(name)
    cfg = spec.shrink(cfg, **spec.architecture(cfg["arch"]).TINY, **rehearse.TINY_TOWER)
    d, seed = spec.dims(cfg), 3_000_000_019
    got = {f"decoder.layer.{i}": _sha(weights.decoder_layer(seed, d, i, "cpu"))
           for i in range(d.L)}
    got["decoder.embed"] = _sha({"embed": weights.embed(seed, d, "cpu")})
    if not d.tied:
        got["decoder.head"] = _sha({"head": weights.head(seed, d, "cpu")})
    got["tower.stem"] = _sha(weights.tower_stem(seed, d, "cpu"))
    got.update({f"tower.layer.{j}": _sha(weights.tower_layer(seed, d, j, "cpu"))
                for j in range(d.Lv)})
    got["projector"] = _sha(weights.projector(seed, d, "cpu"))
    assert got == PINNED[name]
