"""Parameter conversion between the JAX package's trees and the port's modules.

A JAX parameter tree (as numpy arrays, e.g. ``jax.tree.map(np.asarray,
params)``) stacks the layers of a tower or decoder on a leading axis and
keeps projection matrices as (in, out); the port has one module per layer
and ``nn.Linear`` weights as (out, in). :func:`load_jax_params` unstacks and
transposes into a module; :func:`export_jax_params` does the reverse (as
float32 numpy arrays when the module is bf16).

An image modality's W8A8 tower trees load too, fused (``wqkv_q``, ...,
``act_scales`` beside the embedder) and unfused (``q_proj_q`` / ``_s``, ...):
they become the modality's ``embedder_q`` (``ViTInt8Fused`` or ``ViTInt8``),
with int8 matrices transposed to the port's (N, K) layout and every other
leaf as it is; the float tower keeps its parameters. ``export_jax_params``
writes such a modality's int8 tower back.

Int8 LLM trees (``quantize_llama_params``: fused ``qkv_q`` / ``gateup_q`` or
unfused ``q_proj_q`` ..., with ``_s`` scales, and ``lm_head_q`` /
``lm_head_s``, tied heads included) load into a decoder whose projections
become :class:`~multimeditron_torch.models.llama.Int8Linear` in the tree's
layout, int8 matrices transposed to (N, K); export writes them back.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimeditron_torch.modalities.image_clip import ImageModality
from multimeditron_torch.models.llama import Llama
from multimeditron_torch.models.llama_quant import set_int8_layout
from multimeditron_torch.models.multimodal import MultimodalModel
from multimeditron_torch.models.projector import MLPProjector
from multimeditron_torch.models.vit import ViT
from multimeditron_torch.models.vit_quant import ViTInt8
from multimeditron_torch.ops.vit_int8_fused import ViTInt8Fused

_INT8_PROJ = ("qkv", "gateup", "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
              "down_proj")
# JAX leaf name -> (port parameter or buffer name, transpose)
_LLAMA_TOP = {
    "embed_tokens": ("embed_tokens.weight", False),
    "lm_head": ("lm_head.weight", True),
    "final_norm": ("final_norm.weight", False),
    "lm_head_q": ("lm_head.weight_q", True),
    "lm_head_s": ("lm_head.scale", False),
}
_LLAMA_LAYER = {
    "input_norm": ("input_norm.weight", False),
    "q_proj": ("q_proj.weight", True),
    "k_proj": ("k_proj.weight", True),
    "v_proj": ("v_proj.weight", True),
    "o_proj": ("o_proj.weight", True),
    "post_attn_norm": ("post_attn_norm.weight", False),
    "up_proj": ("up_proj.weight", True),
    "down_proj": ("down_proj.weight", True),
    "gate_proj": ("gate_proj.weight", True),
    "q_norm": ("q_norm.weight", False),
    "k_norm": ("k_norm.weight", False),
    "xielu_alpha_p": ("xielu_alpha_p", False),
    "xielu_alpha_n": ("xielu_alpha_n", False),
    **{f"{p}_q": (f"{p}.weight_q", True) for p in _INT8_PROJ},
    **{f"{p}_s": (f"{p}.scale", False) for p in _INT8_PROJ},
}
_VIT_TOP = {
    "patch_proj": ("patch_proj.weight", True),
    "patch_bias": ("patch_proj.bias", False),
    "position_embedding": ("position_embedding", False),
    "cls_token": ("cls_token", False),
    "pre_ln_w": ("pre_ln.weight", False),
    "pre_ln_b": ("pre_ln.bias", False),
    "post_ln_w": ("post_ln.weight", False),
    "post_ln_b": ("post_ln.bias", False),
}
_VIT_LAYER = {
    "ln1_w": ("ln1.weight", False),
    "ln1_b": ("ln1.bias", False),
    "ln2_w": ("ln2.weight", False),
    "ln2_b": ("ln2.bias", False),
    **{f"{p}_proj": (f"{p}_proj.weight", True) for p in "qkvo"},
    **{f"{p}_bias": (f"{p}_proj.bias", False) for p in "qkvo"},
    "fc1": ("fc1.weight", True),
    "fc1_bias": ("fc1.bias", False),
    "fc2": ("fc2.weight", True),
    "fc2_bias": ("fc2.bias", False),
}
_PROJECTOR_TOP = {
    "fc1": ("fc1.weight", True), "b1": ("fc1.bias", False),
    "fc2": ("fc2.weight", True), "b2": ("fc2.bias", False),
    "fc3": ("fc3.weight", True), "b3": ("fc3.bias", False),
}

# (JAX path, port parameter name, transpose, layer index or None)
_Entry = Tuple[Tuple[str, ...], str, bool, Optional[int]]


def _entries(module: nn.Module) -> List[_Entry]:
    """Every parameter of ``module`` paired with its place in the JAX tree."""
    if isinstance(module, MultimodalModel):
        out = [(("llm",) + p, "llm." + n, t, i) for p, n, t, i in _entries(module.llm)]
        for mtype, mod in module.modalities.items():
            out += [(("modalities", mtype) + p, f"modalities.{mtype}.{n}", t, i)
                    for p, n, t, i in _entries(mod)]
        return out
    if isinstance(module, ImageModality):
        return ([(("embedder",) + p, "embedder." + n, t, i)
                 for p, n, t, i in _entries(module.embedder)]
                + [(("projector",) + p, "projector." + n, t, i)
                   for p, n, t, i in _entries(module.projector)])
    if isinstance(module, Llama):
        top, per_layer = _LLAMA_TOP, _LLAMA_LAYER
    elif isinstance(module, ViT):
        top, per_layer = _VIT_TOP, _VIT_LAYER
    elif isinstance(module, MLPProjector):
        top, per_layer = _PROJECTOR_TOP, {}
    else:
        raise TypeError(f"no JAX parameter layout for {type(module).__name__}")
    names = dict(module.named_parameters())
    if isinstance(module, Llama):
        names.update(module.named_buffers())  # Int8Linear's weight_q and scale
    out = [((j,), n, t, None) for j, (n, t) in top.items() if n in names]
    layers = getattr(module, "layers", [])
    for j, (n, t) in per_layer.items():
        if layers and f"layers.0.{n}" in names:
            out += [(("layers", j), f"layers.{i}.{n}", t, i) for i in range(len(layers))]
    return out


def _to_torch(arr) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a writable, C-contiguous copy (of a swapped view too)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _image_modalities(module: nn.Module) -> Dict[Tuple[str, ...], ImageModality]:
    """JAX path prefix -> each image modality of ``module``."""
    if isinstance(module, ImageModality):
        return {(): module}
    if isinstance(module, MultimodalModel):
        return {("modalities", m): mod for m, mod in module.modalities.items()
                if isinstance(mod, ImageModality)}
    return {}


def _int8_tower(mod: ImageModality, sub: Dict):
    """The W8A8 tower a modality subtree holds, or None for a float tower."""
    emb = sub.get("embedder", {})
    device, dtype = mod.pixel_mean.device, mod.vit_cfg.dtype

    def tensors(tree, carried):
        # on the modality's device; int8 matrices JAX (..., K, N) -> port (..., N, K).
        # Leaves both packings carry over from the float tower keep the
        # tower's dtype (export_jax_params writes bf16 as float32).
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = tensors(v, _VIT_LAYER if k == "layers" else ())
                continue
            v = np.asarray(v)
            t = _to_torch(np.swapaxes(v, -1, -2) if v.dtype == np.int8 else v).to(device)
            out[k] = t.to(dtype) if k in carried and t.is_floating_point() else t
        return out

    scales = sub.get("act_scales")
    scales = None if scales is None else _to_torch(scales).to(device)
    if "wqkv_q" in emb:
        return ViTInt8Fused(mod.vit_cfg, tensors(emb, _VIT_TOP), scales)
    if "q_proj_q" in emb.get("layers", {}):
        return ViTInt8(mod.vit_cfg, tensors(emb, _VIT_TOP), scales)
    return None


def _decoders(module: nn.Module) -> Dict[Tuple[str, ...], Llama]:
    """JAX path prefix -> the decoder of ``module``."""
    if isinstance(module, Llama):
        return {(): module}
    if isinstance(module, MultimodalModel):
        return {("llm",): module.llm}
    return {}


def load_jax_params(module: nn.Module, tree: Dict) -> None:
    """Copy a JAX parameter tree (numpy leaves) into ``module`` in place; an
    int8 LLM tree turns the decoder's projections into int8 ones first."""
    for prefix, llm in _decoders(module).items():
        sub = tree
        for key in prefix:
            sub = sub.get(key, {})
        layers = sub.get("layers", {})
        if "qkv_q" in layers or "q_proj_q" in layers:
            set_int8_layout(llm, fuse="qkv_q" in layers)
    towers = {}
    for prefix, mod in _image_modalities(module).items():
        sub = tree
        for key in prefix:
            sub = sub.get(key, {})
        q = _int8_tower(mod, sub)
        if q is not None:
            towers[prefix] = (mod, q)
    leaves = dict(_leaves(tree))
    tower_paths = {p for p in leaves for prefix in towers
                   if p[:len(prefix) + 1] in (prefix + ("embedder",), prefix + ("act_scales",))}
    kept = tuple(_tower_name(prefix) for prefix in towers)
    state, used = {}, set(tower_paths)
    for path, name, transpose, layer in _entries(module):
        if name.startswith(kept):
            continue  # the float tower of a modality loaded as int8 keeps its parameters
        if path not in leaves:
            raise KeyError(f"JAX tree has no {'/'.join(path)} for {name}")
        arr = leaves[path] if layer is None else leaves[path][layer]
        t = _to_torch(arr)
        state[name] = t.T if transpose else t
        used.add(path)
    unused = sorted("/".join(p) for p in leaves if p not in used)
    if unused:
        raise KeyError(f"JAX tree leaves with no place in {type(module).__name__}: {unused}")
    missing, unexpected = module.load_state_dict(state, strict=False)
    missing = [n for n in missing if not n.startswith(kept)]
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, unexpected {unexpected}")
    for mod, q in towers.values():
        mod.embedder_q = q


def _tower_name(prefix: Tuple[str, ...]) -> str:
    """Parameter-name prefix of the float tower of the modality at ``prefix``."""
    return "".join(f"{k}." for k in prefix) + "embedder."


def export_jax_params(module: nn.Module) -> Dict:
    """The reverse of :func:`load_jax_params`: a JAX-layout tree of numpy
    arrays (bf16 parameters come out as float32). A modality with an int8
    tower (``embedder_q``) exports that tower, as its JAX tree holds it."""
    params = dict(module.named_parameters())
    params.update(module.named_buffers())
    stacked: Dict[Tuple[str, ...], list] = {}
    tree: Dict = {}
    towers = {p: m.embedder_q for p, m in _image_modalities(module).items()
              if m.embedder_q is not None}
    skip = tuple(_tower_name(prefix) for prefix in towers)

    def put(path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    def numpy(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().contiguous().numpy()

    for path, name, transpose, layer in _entries(module):
        if name.startswith(skip):
            continue
        t = params[name].detach()
        arr = numpy(t.T if transpose else t)
        if layer is None:
            put(path, arr)
        else:
            stacked.setdefault(path, []).append(arr)
    for path, arrs in stacked.items():
        put(path, np.stack(arrs))
    for prefix, q in towers.items():
        for path, t in _leaves(q.tree()):
            put(prefix + ("embedder",) + path,
                numpy(t.transpose(-1, -2) if t.dtype == torch.int8 else t))
        if q.act_scales is not None:
            put(prefix + ("act_scales",), numpy(q.act_scales))
    return tree
