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
    vit = ViT(cfg)
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
    proj = MLPProjector(32, 48, dtype=torch.float32)
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
    tmod = TImageModality(TImageConfig(**dataclasses.asdict(jcfg)))
    load_jax_params(tmod, params)
    with torch.inference_mode():
        got = tmod.encode(torch.from_numpy(values))
    want = jmod.encode(params, jnp.asarray(values))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_convert_roundtrip_and_int8_refusal():
    jcfg = tiny_image_config()
    jmod = JImageModality(jcfg)
    params = perturbed(jmod.init_params(jax.random.PRNGKey(6)))
    tmod = TImageModality(TImageConfig(**dataclasses.asdict(jcfg)))
    load_jax_params(tmod, params)
    back = export_jax_params(tmod)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # an int8 tower tree is refused, naming the ROADMAP item
    qparams = jax.tree.map(np.asarray, jmod.quantize_params(params))
    with pytest.raises(NotImplementedError, match="quantized paths"):
        load_jax_params(tmod, qparams)
