"""Port parity: ViT towers, projector and the image modality against JAX,
f32, with weights moved by multimeditron_torch.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.convert import export_jax_params, load_jax_params
from multimeditron_torch.modalities.image_clip import ImageConfig as TImageConfig
from multimeditron_torch.modalities.image_clip import ImageModality as TImageModality
from multimeditron_torch.models.projector import MLPProjector
from multimeditron_torch.models.vit import ViT, ViTConfig
from multimeditron_tpu.modalities.image_clip import ImageModality as JImageModality
from multimeditron_tpu.models import projector as jproj
from multimeditron_tpu.models import vit as jvit
from tests.test_multimodal import tiny_image_config

TOL = dict(atol=1e-5, rtol=1e-5)


def perturbed(params, seed=0, scale=0.05):
    """Numpy copy of a JAX tree with every leaf moved off its init value, so
    biases and norm weights are exercised too."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=a.shape)).astype(a.dtype), params)


def _vit_cfg(kind):
    d = dict(image_size=16, patch_size=8, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64)
    if kind == "clip":
        return jvit.ViTConfig.clip_from_hf_dict(d)
    return jvit.ViTConfig.siglip_from_hf_dict(d)


def _port_vit(jcfg, params):
    cfg = ViTConfig(**{**dataclasses.asdict(jcfg), "dtype": torch.float32})
    vit = ViT(cfg, device="cpu")
    load_jax_params(vit, params)
    return vit


@pytest.mark.parametrize("kind,drop_cls", [("clip", True), ("clip", False), ("siglip", True)])
def test_vit_matches_jax(kind, drop_cls):
    jcfg = _vit_cfg(kind)
    params = perturbed(jvit.init_vit_params(jax.random.PRNGKey(0), jcfg))
    pixels = np.random.default_rng(1).normal(size=(3, 16, 16, 3)).astype(np.float32)
    want = jvit.vit_forward(params, jcfg, jnp.asarray(pixels), drop_cls=drop_cls)
    with torch.inference_mode():
        got = _port_vit(jcfg, params)(torch.from_numpy(pixels), drop_cls=drop_cls)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_projector_matches_jax():
    params = perturbed(jproj.init_mlp_projector(jax.random.PRNGKey(2), 32, 48, jnp.float32))
    x = np.random.default_rng(3).normal(size=(2, 5, 32)).astype(np.float32)
    proj = MLPProjector(32, 48, dtype=torch.float32, device="cpu")
    load_jax_params(proj, params)
    with torch.inference_mode():
        got = proj(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jproj.mlp_projector_forward(params, x)),
                               **TOL)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_image_modality_encode_matches_jax(wire):
    jcfg = dataclasses.replace(tiny_image_config(), wire_dtype=wire)
    jmod = JImageModality(jcfg)
    params = perturbed(jmod.init_params(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(5)
    if wire == "uint8":
        values = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    else:
        values = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    tmod = TImageModality(TImageConfig(**dataclasses.asdict(jcfg)), device="cpu")
    load_jax_params(tmod, params)
    with torch.inference_mode():
        got = tmod.encode(torch.from_numpy(values))
    want = jmod.encode(params, jnp.asarray(values))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_convert_roundtrip_and_int8_refusal():
    jcfg = tiny_image_config()
    jmod = JImageModality(jcfg)
    params = perturbed(jmod.init_params(jax.random.PRNGKey(6)))
    tmod = TImageModality(TImageConfig(**dataclasses.asdict(jcfg)), device="cpu")
    load_jax_params(tmod, params)
    back = export_jax_params(tmod)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # both int8 tower trees round-trip, int8 leaves bitwise
    calib = np.random.default_rng(7).normal(size=(2, 16, 16, 3)).astype(np.float32)
    for fused in (False, True):
        qparams = jax.tree.map(np.asarray, jmod.quantize_params(
            params, calibration_values=calib if fused else None, fused=fused))
        qmod = TImageModality(TImageConfig(**dataclasses.asdict(jcfg)), device="cpu")
        load_jax_params(qmod, qparams)
        qback = export_jax_params(qmod)
        assert jax.tree.structure(qback) == jax.tree.structure(qparams)
        jax.tree.map(np.testing.assert_array_equal, qback, qparams)
    # a whole multimodal tree with an int8 LLM (quantize_llm) round-trips too
    from multimeditron_tpu.models.llama_quant import quantize_llama_params
    from multimeditron_tpu.models.multimodal import MultimodalModel as JModel
    from multimeditron_torch.models.llama import Int8Linear
    from multimeditron_torch.models.multimodal import MultimodalConfig, MultimodalModel
    from tests.test_multimodal import tiny_mm_config

    jmodel = JModel(tiny_mm_config())
    mm = jmodel.init_params(jax.random.PRNGKey(8))
    mm["llm"] = quantize_llama_params(mm["llm"], jmodel.config.llm)
    mm = jax.tree.map(np.asarray, mm)
    tmodel = MultimodalModel(MultimodalConfig.from_dict(jmodel.config.to_dict()), device="cpu")
    load_jax_params(tmodel, mm)
    assert isinstance(tmodel.llm.layers[0].qkv, Int8Linear)
    mback = export_jax_params(tmodel)
    assert jax.tree.structure(mback) == jax.tree.structure(mm)
    jax.tree.map(np.testing.assert_array_equal, mback, mm)
