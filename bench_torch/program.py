"""The system under test, built through its public entry points: a
``MultimodalModel`` from the configuration's published keys (the decoder's
config as its architecture builds it, ``arch/<name>.py``, and the image
modality's config), its weights filled from the seed block by block
(``weights.py``)."""

from __future__ import annotations

import torch

import weights
from spec import Dims


def build_model(cfg: dict, d: Dims, seed: int, device):
    from multimeditron_torch.modalities.image_clip import ImageConfig
    from multimeditron_torch.models.multimodal import MultimodalConfig, MultimodalModel

    llm = d.program_config(cfg)
    t = cfg["tower"]
    img = ImageConfig(model_type=t["model_type"], hidden_size=llm.hidden_size,
                      clip_name=t["clip_name"], image_size=t["image_size"],
                      patch_size=t["patch_size"], vision_hidden_size=t["hidden_size"],
                      vision_layers=t["num_hidden_layers"],
                      vision_heads=t["num_attention_heads"],
                      vision_intermediate_size=t["intermediate_size"],
                      param_dtype="bfloat16", wire_dtype="uint8")
    model = MultimodalModel(MultimodalConfig(llm=llm, modalities=[img], eos_token_idx=d.eos),
                            device=device)
    fill(model, d, seed)
    return model


@torch.no_grad()
def fill(model, d: Dims, seed: int) -> None:
    """Every parameter from the seed (the values the reference makes)."""
    dev = next(model.parameters()).device
    llm = model.llm
    llm.embed_tokens.weight.copy_(weights.embed(seed, d, dev))
    if llm.lm_head is not None:
        llm.lm_head.weight.copy_(weights.head(seed, d, dev))
    llm.final_norm.weight.fill_(1.0)
    for i, layer in enumerate(llm.layers):
        d.fill_layer(layer, weights.decoder_layer(seed, d, i, dev), i)
    image = model.modalities["image"]
    vit = image.embedder
    stem = weights.tower_stem(seed, d, dev)
    vit.patch_proj.weight.copy_(stem["patch"])
    vit.position_embedding.copy_(stem["position"])
    vit.cls_token.copy_(stem["cls"])
    for ln in (vit.pre_ln, vit.post_ln):
        ln.weight.fill_(1.0)
        ln.bias.zero_()
    for j, layer in enumerate(vit.layers):
        W = weights.tower_layer(seed, d, j, dev)
        for key, mod in (("q", layer.q_proj), ("k", layer.k_proj), ("v", layer.v_proj),
                         ("o", layer.o_proj), ("fc1", layer.fc1), ("fc2", layer.fc2)):
            mod.weight.copy_(W[key])
            mod.bias.copy_(W[key + "_b"])
        for ln in (layer.ln1, layer.ln2):
            ln.weight.fill_(1.0)
            ln.bias.zero_()
    P = weights.projector(seed, d, dev)
    for key in ("fc1", "fc2", "fc3"):
        lin = getattr(image.projector, key)
        lin.weight.copy_(P[key])
        lin.bias.copy_(P[key + "_b"])


def projector_leaves(model) -> dict:
    """The trained leaves under the reference's names."""
    proj = model.modalities["image"].projector
    out = {}
    for key in ("fc1", "fc2", "fc3"):
        lin = getattr(proj, key)
        out[key], out[key + "_b"] = lin.weight, lin.bias
    return out
