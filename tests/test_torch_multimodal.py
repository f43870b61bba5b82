"""Port parity: the multimodal config, embed splice (with dropped padded
slots) and resize_embeddings against JAX, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.convert import export_jax_params, load_jax_params
from multimeditron_torch.models import multimodal as tm
from multimeditron_tpu.models import multimodal as jm
from tests.test_multimodal import tiny_mm_config
from tests.test_torch_vit import perturbed

TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(seed=0):
    jmodel = jm.MultimodalModel(tiny_mm_config())
    params = perturbed(jmodel.init_params(jax.random.PRNGKey(seed)), seed=seed)
    tmodel = tm.MultimodalModel(tm.MultimodalConfig.from_dict(jmodel.config.to_dict()),
                                device="cpu")
    load_jax_params(tmodel, params)
    return jmodel, params, tmodel


def test_config_dict_roundtrip_matches_jax():
    jcfg = tiny_mm_config()
    d = jcfg.to_dict()
    tcfg = tm.MultimodalConfig.from_dict(d)
    assert tcfg.llm.dtype == torch.float32
    # from_dict(to_dict()) of either package writes the same dict
    assert tcfg.to_dict() == jm.MultimodalConfig.from_dict(d).to_dict()
    assert type(tcfg.modalities[0]).__name__ == "ImageConfig"


def test_embed_splice_drops_padded_slots():
    jmodel, params, tmodel = _pair()
    rng = np.random.default_rng(1)
    B, S, n_emb = 2, 12, 4
    ids = rng.integers(0, 4096, (B, S)).astype(np.int32)
    values = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    # image 0 -> row 0, image 1 -> row 1, image 2 is a padded slot (row B)
    batch_idx = np.repeat(np.array([0, 1, B], np.int32), n_emb)
    token_pos = np.concatenate([np.arange(2, 6), np.arange(5, 9),
                                np.arange(0, 4)]).astype(np.int32)
    mm = {"values": values, "batch_idx": batch_idx, "token_pos": token_pos}
    want = jmodel.embed(params, jnp.asarray(ids),
                        {"image": {k: jnp.asarray(v) for k, v in mm.items()}})
    with torch.inference_mode():
        got = tmodel.embed(torch.from_numpy(ids),
                           {"image": {k: torch.from_numpy(v) for k, v in mm.items()}})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the padded slot wrote nothing: row 0's positions 0..1 are token embeddings
    with torch.inference_mode():
        plain = tmodel.embed(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy()[0, :2], plain.numpy()[0, :2])


@pytest.mark.parametrize("new_vocab", [4096 + 5, 4000])
def test_resize_embeddings_matches_jax(new_vocab):
    jmodel, params, tmodel = _pair(seed=2)
    want = jm.resize_embeddings(params["llm"], jmodel.config.llm, new_vocab)
    tm.resize_embeddings(tmodel.llm, new_vocab)
    got = export_jax_params(tmodel.llm)
    for key in ("embed_tokens", "lm_head"):
        assert got[key].shape == np.asarray(want[key]).shape
        np.testing.assert_allclose(got[key], np.asarray(want[key]), **TOL)
    assert tmodel.llm.cfg.vocab_size == new_vocab


def test_init_weights_is_seeded():
    cfg = tm.MultimodalConfig.from_dict(tiny_mm_config().to_dict())
    a, b = tm.MultimodalModel(cfg, device="cpu"), tm.MultimodalModel(cfg, device="cpu")
    a.init_weights(torch.Generator().manual_seed(7))
    b.init_weights(torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    # JAX init distributions: unit norms, zero biases, N(0, 1/fan_in) weights
    assert torch.all(a.llm.final_norm.weight == 1)
    assert torch.all(a.modalities["image"].projector.fc1.bias == 0)
    w = a.llm.layers[0].down_proj.weight.detach()
    assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1.0) < 0.1
