"""Weight-only int8 quantisation of the Llama decoder (serving).

Counterpart of ``multimeditron_tpu/models/llama_quant.py``: per-output-
channel symmetric int8 on every projection (q/k/v/o, gate/up/down and the
lm_head, built from the embedding when it is tied); activations, norms,
RoPE and the embedding gather stay in the model's dtype (W8A16, kernel K9).
``fuse=True`` concatenates q|k|v into ``qkv`` and gate|up into ``gateup``
(a gateless MLP fuses only qkv): one streamed weight per layer instead of
three (two). The training path never sees a quantised decoder.

A quantised decoder is a :class:`Llama` whose projections are
:class:`Int8Linear` modules (weights (out, in), K contiguous) and which
shares the source decoder's embedding, norms, q/k norms and xIELU
parameters. Its JAX tree (``convert.export_jax_params``) is the JAX
``quantize_llama_params`` layout.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multimeditron_torch import default_device
from multimeditron_torch.models.common import RMSNorm
from multimeditron_torch.models.llama import Int8Linear, Llama, LlamaConfig

_SHARED = ("input_norm", "post_attn_norm", "q_norm", "k_norm", "xielu_alpha_p", "xielu_alpha_n")


def _quantize_rows(w: torch.Tensor):
    """(N, K) weight -> int8 (N, K) and (N,) float32 scales, one per output
    channel: ``max|w| / 127`` floored at 1e-8, ``round(w / scale)``
    (a division, half to even) clipped to +-127, in float32."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def set_int8_layout(llm: Llama, fuse: bool = True) -> None:
    """Replace ``llm``'s projections and head IN PLACE by empty
    :class:`Int8Linear` modules on its device, in the fused or unfused
    layout (the loader fills them)."""
    cfg = llm.cfg
    D, F_, Dh = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    Dq, Dkv = cfg.num_heads * Dh, cfg.num_kv_heads * Dh
    device = llm.embed_tokens.weight.device
    for layer in llm.layers:
        if fuse:
            layer.qkv = Int8Linear(D, Dq + 2 * Dkv, device=device)
            layer.q_proj = layer.k_proj = layer.v_proj = None
        else:
            layer.qkv = None
            layer.q_proj = Int8Linear(D, Dq, device=device)
            layer.k_proj = Int8Linear(D, Dkv, device=device)
            layer.v_proj = Int8Linear(D, Dkv, device=device)
        layer.o_proj = Int8Linear(Dq, D, device=device)
        if fuse and cfg.mlp_gate:
            layer.gateup = Int8Linear(D, 2 * F_, device=device)
            layer.gate_proj = layer.up_proj = None
        else:
            layer.gateup = None
            layer.up_proj = Int8Linear(D, F_, device=device)
            if cfg.mlp_gate:
                layer.gate_proj = Int8Linear(D, F_, device=device)
        layer.down_proj = Int8Linear(F_, D, device=device)
    llm.lm_head = Int8Linear(D, cfg.vocab_size, device=device)


def _skeleton(cfg: LlamaConfig, embed_tokens: nn.Embedding, final_norm: RMSNorm) -> Llama:
    """A decoder with the given embedding and final norm and no weights of
    its own yet (built on the meta device)."""
    llm = Llama(cfg, device="meta")
    llm.embed_tokens, llm.final_norm = embed_tokens, final_norm
    return llm


def _check_no_meta(llm: Llama) -> Llama:
    left = [n for n, t in list(llm.named_parameters()) + list(llm.named_buffers())
            if t.is_meta]
    if left:
        raise RuntimeError(f"quantised decoder left without values: {left}")
    return llm


@torch.no_grad()
def quantize_llama(llm: Llama, fuse: bool = True) -> Llama:
    """A new quantised decoder from ``llm`` (the JAX
    ``quantize_llama_params``); ``llm`` is not changed. Quantised layer by
    layer, so the float32 transient is one projection, not a stack."""
    cfg = llm.cfg
    q = _skeleton(cfg, llm.embed_tokens, llm.final_norm)
    for qlayer, layer in zip(q.layers, llm.layers):
        for name in _SHARED:
            if hasattr(layer, name):
                setattr(qlayer, name, getattr(layer, name))
    set_int8_layout(q, fuse)

    def put(mod: Int8Linear, *sources: nn.Linear) -> None:
        # per-row scales: the rows of a concatenation quantise as they do alone
        parts = [_quantize_rows(src.weight) for src in sources]
        mod.weight_q.copy_(torch.cat([p[0] for p in parts]))
        mod.scale.copy_(torch.cat([p[1] for p in parts]))

    for qlayer, layer in zip(q.layers, llm.layers):
        if fuse:
            put(qlayer.qkv, layer.q_proj, layer.k_proj, layer.v_proj)
        else:
            for name in ("q_proj", "k_proj", "v_proj"):
                put(getattr(qlayer, name), getattr(layer, name))
        put(qlayer.o_proj, layer.o_proj)
        if qlayer.gateup is not None:
            put(qlayer.gateup, layer.gate_proj, layer.up_proj)
        else:
            put(qlayer.up_proj, layer.up_proj)
            if cfg.mlp_gate:
                put(qlayer.gate_proj, layer.gate_proj)
        put(qlayer.down_proj, layer.down_proj)
    put(q.lm_head, llm.lm_head if llm.lm_head is not None else llm.embed_tokens)
    return _check_no_meta(q)


def is_quantized(llm: Llama) -> bool:
    return any(isinstance(m, Int8Linear) for m in llm.modules())


@torch.no_grad()
def init_quantized_llama(cfg: LlamaConfig, generator: torch.Generator, fuse: bool = True,
                         *, device=None) -> Llama:
    """A random, already-int8 decoder (the JAX
    ``init_quantized_llama_params``), with no float master copy: int8
    values uniform in [-127, 127] (std ~73) with scales ``fan_in**-0.5 / 73``
    so the dequantised weights have the float init's spread, an embedding
    drawn N(0, 1/D), norms of one. ``generator`` lives on ``device``."""
    device = default_device(device)
    D = cfg.hidden_size
    kw = dict(device=device, dtype=cfg.dtype)
    embed = nn.Embedding(cfg.vocab_size, D, **kw)
    embed.weight.copy_(torch.randn(cfg.vocab_size, D, generator=generator, device=device,
                                   dtype=torch.float32) * D ** -0.5)
    llm = _skeleton(cfg, embed, RMSNorm(D, cfg.rms_norm_eps, **kw))
    for layer in llm.layers:
        layer.input_norm = RMSNorm(D, cfg.rms_norm_eps, **kw)
        layer.post_attn_norm = RMSNorm(D, cfg.rms_norm_eps, **kw)
        if cfg.use_qk_norm:
            layer.q_norm = RMSNorm(cfg.head_dim_, cfg.rms_norm_eps, **kw)
            layer.k_norm = RMSNorm(cfg.head_dim_, cfg.rms_norm_eps, **kw)
        if cfg.hidden_act == "xielu":
            f32 = dict(device=device, dtype=torch.float32)
            layer.xielu_alpha_p = nn.Parameter(torch.full((1,), math.log(math.expm1(0.8)), **f32))
            layer.xielu_alpha_n = nn.Parameter(torch.full((1,), math.log(math.expm1(0.3)), **f32))
    set_int8_layout(llm, fuse)
    for mod in llm.modules():
        if isinstance(mod, Int8Linear):
            mod.weight_q.copy_(torch.randint(-127, 128, mod.weight_q.shape, generator=generator,
                                             device=device, dtype=torch.int8))
            mod.scale.fill_(mod.in_features ** -0.5 / 73.0)
    return _check_no_meta(llm)
