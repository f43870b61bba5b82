"""Parameter conversion between the JAX package's trees and the port's modules.

A JAX parameter tree (as numpy arrays, e.g. ``jax.tree.map(np.asarray,
params)``) stacks the layers of a tower or decoder on a leading axis and
keeps projection matrices as (in, out); the port has one module per layer
and ``nn.Linear`` weights as (out, in). :func:`load_jax_params` unstacks and
transposes into a module; :func:`export_jax_params` does the reverse (as
float32 numpy arrays when the module is bf16).

Quantized (int8) trees are refused: the int8 paths are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimeditron_torch.modalities.image_clip import ImageModality
from multimeditron_torch.models.llama import Llama
from multimeditron_torch.models.multimodal import MultimodalModel
from multimeditron_torch.models.projector import MLPProjector
from multimeditron_torch.models.vit import ViT

# JAX leaf name -> (port parameter name, transpose)
_LLAMA_TOP = {
    "embed_tokens": ("embed_tokens.weight", False),
    "lm_head": ("lm_head.weight", True),
    "final_norm": ("final_norm.weight", False),
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
    out = [((j,), n, t, None) for j, (n, t) in top.items() if n in names]
    layers = getattr(module, "layers", [])
    for j, (n, t) in per_layer.items():
        if layers and f"layers.0.{n}" in names:
            out += [(("layers", j), f"layers.{i}.{n}", t, i) for i in range(len(layers))]
    return out


def _to_torch(arr) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def load_jax_params(module: nn.Module, tree: Dict) -> None:
    """Copy a JAX parameter tree (numpy leaves) into ``module`` in place."""
    quantized = [p for p, _ in _leaves(tree)
                 if p[-1].endswith("_q") or "act_scales" in p]
    if quantized:
        raise NotImplementedError(
            f"int8 parameter trees (e.g. {'/'.join(quantized[0])}) are not ported "
            "yet (ROADMAP queue 1, quantized paths)")
    leaves = dict(_leaves(tree))
    state, used = {}, set()
    for path, name, transpose, layer in _entries(module):
        if path not in leaves:
            raise KeyError(f"JAX tree has no {'/'.join(path)} for {name}")
        arr = leaves[path] if layer is None else leaves[path][layer]
        t = _to_torch(arr)
        state[name] = t.T if transpose else t
        used.add(path)
    unused = sorted("/".join(p) for p in leaves if p not in used)
    if unused:
        raise KeyError(f"JAX tree leaves with no place in {type(module).__name__}: {unused}")
    module.load_state_dict(state, strict=True)


def export_jax_params(module: nn.Module) -> Dict:
    """The reverse of :func:`load_jax_params`: a JAX-layout tree of numpy
    arrays (bf16 parameters come out as float32)."""
    params = dict(module.named_parameters())
    stacked: Dict[Tuple[str, ...], list] = {}
    tree: Dict = {}

    def put(path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for path, name, transpose, layer in _entries(module):
        t = params[name].detach()
        t = t.T if transpose else t
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().contiguous().numpy()
        if layer is None:
            put(path, arr)
        else:
            stacked.setdefault(path, []).append(arr)
    for path, arrs in stacked.items():
        put(path, np.stack(arrs))
    return tree
