"""Llama-architecture decoder (Llama-2/3, Qwen3/Apertus-compatible GQA).

Counterpart of ``multimeditron_tpu/models/llama.py`` for the serving path:
the decoder without a cache, with a contiguous cache in prefill mode (the
serving engine's local prefill cache), and the paged single-token decode
step against a page pool + per-chunk ring (kernel K4). Supports GQA, RoPE
with HF llama3 scaling and 2-D position ids, optional QK-norm, gated and
plain MLPs (activation in float32) and tied embeddings.

Not ported yet, and refused with ``NotImplementedError``: sequence, ring and
pipeline parallelism, W8A8/W8A16 weights, the speculative verify block
(S > 1 against a paged cache) and contiguous-cache decode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimeditron_torch.models.common import (
    RMSNorm,
    apply_rope,
    init_dense_,
    rope_frequencies,
    xielu,
)
from multimeditron_torch.ops.attention import attention
from multimeditron_torch.ops.paged_attention import ring_decode_attention

Cache = Dict[str, torch.Tensor]

# Plain (gateless) MLP activations, named as in ``jax.nn`` (whose ``gelu``
# defaults to the tanh approximation).
_PLAIN_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 8192
    use_qk_norm: bool = False  # Qwen3/Apertus-style per-head RMSNorm on q/k
    attention_bias: bool = False  # carried for config parity; unused, as in JAX
    mlp_gate: bool = True
    hidden_act: str = "silu"
    hf_arch: str = "llama"
    sequence_parallel: bool = False
    ring_attention: bool = False
    pipeline_parallel: int = 1
    pipeline_microbatches: Optional[int] = None
    w8a8_min_rows: int = 0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def from_hf_dict(d: dict) -> "LlamaConfig":
        """Build from an HF ``config.json`` dict (llama/qwen3/apertus)."""
        mt = d.get("model_type", "llama")
        return LlamaConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=d.get("head_dim"),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=d.get("rope_scaling"),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            max_position_embeddings=d.get("max_position_embeddings", 8192),
            use_qk_norm=mt in ("qwen3", "apertus"),
            attention_bias=d.get("attention_bias", False),
            mlp_gate=mt != "apertus",
            hidden_act=d.get("hidden_act", "silu"),
            hf_arch=mt if mt in ("llama", "qwen3", "apertus") else "llama",
        )


def _refuse_unported(cfg: LlamaConfig) -> None:
    if cfg.sequence_parallel or cfg.ring_attention or cfg.pipeline_parallel > 1:
        raise NotImplementedError(
            "sequence/ring/pipeline parallelism is not ported yet "
            "(ROADMAP queue 1, parallelism)")
    if cfg.w8a8_min_rows:
        raise NotImplementedError(
            "W8A8 prefill is not ported yet (ROADMAP queue 1, quantized paths)")
    if not cfg.mlp_gate and cfg.hidden_act != "xielu" and cfg.hidden_act not in _PLAIN_ACTS:
        raise NotImplementedError(f"plain-MLP activation {cfg.hidden_act!r}")


# ----------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------
def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None, device=None) -> Cache:
    """Contiguous per-sample cache (L, B, Hkv, max_len, Dh)."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim_)
    dtype = dtype or cfg.dtype
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_paged_kv_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                        pages_max: int, batch: int, ring_size: int = 8,
                        dtype: Optional[torch.dtype] = None, device=None) -> Cache:
    """Paged KV pool + per-slot page tables + per-chunk decode ring.

    Page 0 is the TRASH page: never allocated to a slot, it absorbs writes
    for padded positions. ``ring_k/ring_v`` hold the tokens generated within
    the current decode chunk; ``pages_length`` counts the tokens per slot
    covered by the pages. The ring is rounded up to 16 rows, as in the JAX
    package, so the two share one cache layout.
    """
    Dh, L, Hkv = cfg.head_dim_, cfg.num_layers, cfg.num_kv_heads
    dtype = dtype or cfg.dtype
    ring_size = max(16, -(-ring_size // 16) * 16)
    kw = dict(dtype=dtype, device=device)
    ints = dict(dtype=torch.int32, device=device)
    return {
        "k": torch.zeros((L, Hkv, num_pages, page_size, Dh), **kw),
        "v": torch.zeros((L, Hkv, num_pages, page_size, Dh), **kw),
        "ring_k": torch.zeros((L, batch, Hkv, ring_size, Dh), **kw),
        "ring_v": torch.zeros((L, batch, Hkv, ring_size, Dh), **kw),
        "page_table": torch.zeros((batch, pages_max), **ints),
        "pages_length": torch.zeros((batch,), **ints),
        "length": torch.zeros((batch,), **ints),
    }


# ----------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------
class LlamaLayer(nn.Module):
    """One decoder layer (the JAX ``_layer``)."""

    def __init__(self, cfg: LlamaConfig, *, device=None):
        super().__init__()
        D, F_, Dh = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        kw = dict(device=device, dtype=cfg.dtype)
        self.cfg = cfg
        self.input_norm = RMSNorm(D, cfg.rms_norm_eps, **kw)
        self.q_proj = nn.Linear(D, H * Dh, bias=False, **kw)
        self.k_proj = nn.Linear(D, Hkv * Dh, bias=False, **kw)
        self.v_proj = nn.Linear(D, Hkv * Dh, bias=False, **kw)
        self.o_proj = nn.Linear(H * Dh, D, bias=False, **kw)
        self.post_attn_norm = RMSNorm(D, cfg.rms_norm_eps, **kw)
        self.up_proj = nn.Linear(D, F_, bias=False, **kw)
        self.down_proj = nn.Linear(F_, D, bias=False, **kw)
        self.gate_proj = nn.Linear(D, F_, bias=False, **kw) if cfg.mlp_gate else None
        if cfg.use_qk_norm:
            self.q_norm = RMSNorm(Dh, cfg.rms_norm_eps, **kw)
            self.k_norm = RMSNorm(Dh, cfg.rms_norm_eps, **kw)
        if cfg.hidden_act == "xielu":
            f32 = dict(device=device, dtype=torch.float32)
            self.xielu_alpha_p = nn.Parameter(torch.empty(1, **f32))
            self.xielu_alpha_n = nn.Parameter(torch.empty(1, **f32))

    def _paged_decode(self, q, k, v, cache: Cache, layer_index: int) -> torch.Tensor:
        # Pages are read-only within a decode chunk: this step's K/V row goes
        # into ring row t (the in-chunk step index, uniform over the slots
        # still active), then K4 attends over pages + ring. The engine folds
        # the ring into the pages between chunks.
        pages_len, lengths = cache["pages_length"], cache["length"]
        rk, rv = cache["ring_k"], cache["ring_v"]
        T = rk.shape[3]
        # clamped like the start index of the JAX dynamic_update_slice
        t = (lengths - pages_len).max().clamp(0, T - 1).long().view(1)
        rk[layer_index].index_copy_(2, t, k.to(rk.dtype))
        rv[layer_index].index_copy_(2, t, v.to(rv.dtype))
        out = ring_decode_attention(
            q[:, :, 0, :].contiguous(), cache["k"], cache["v"], rk, rv,
            cache["page_table"], pages_len, lengths, layer_index)
        return out[:, :, None, :]

    def _prefill_into_cache(self, q, k, v, cache: Cache, layer_index: int) -> torch.Tensor:
        # Write this call's K/V at each sample's current length, then attend
        # causally over the whole (masked) cache with the per-sample length
        # as causal offset.
        ck, cv = cache["k"][layer_index], cache["v"][layer_index]
        B, _, S, _ = k.shape
        max_len = ck.shape[2]
        lengths = cache["length"]
        pos = lengths[:, None].long() + torch.arange(S, device=k.device)[None, :]
        b_idx = torch.arange(B, device=k.device)[:, None]
        ck[b_idx, :, pos] = k.transpose(1, 2).to(ck.dtype)
        cv[b_idx, :, pos] = v.transpose(1, 2).to(cv.dtype)
        kv_mask = (torch.arange(max_len, device=k.device)[None, :]
                   < (lengths + S)[:, None])
        return attention(q, ck, cv, kv_mask=kv_mask, causal=True, causal_offset=lengths)

    def forward(self, x: torch.Tensor, position_ids: torch.Tensor,
                attention_mask: torch.Tensor, inv_freq: torch.Tensor,
                cache: Optional[Cache] = None, layer_index: int = 0,
                prefill: bool = False) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        h = self.input_norm(x)
        q = self.q_proj(h).view(B, S, H, Dh)
        k = self.k_proj(h).view(B, S, Hkv, Dh)
        v = self.v_proj(h).view(B, S, Hkv, Dh)
        if cfg.use_qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        q = apply_rope(q, position_ids, inv_freq)
        k = apply_rope(k, position_ids, inv_freq)

        if cache is None:
            out = attention(q, k, v, kv_mask=attention_mask, causal=True)
        elif "page_table" in cache:
            if S != 1:
                raise NotImplementedError(
                    "multi-token steps against a paged cache (speculative "
                    "verify, kernel K6) are not ported yet")
            out = self._paged_decode(q, k, v, cache, layer_index)
        elif prefill:
            out = self._prefill_into_cache(q, k, v, cache, layer_index)
        else:
            raise NotImplementedError(
                "decode against a contiguous cache (generation.py, slab mode) "
                "is not ported yet")
        x = x + self.o_proj(out.transpose(1, 2).reshape(B, S, H * Dh))

        h = self.post_attn_norm(x)
        up = self.up_proj(h).float()
        if cfg.mlp_gate:
            act = F.silu(self.gate_proj(h).float()) * up
        elif cfg.hidden_act == "xielu":
            act = xielu(up, self.xielu_alpha_p, self.xielu_alpha_n)
        else:
            act = _PLAIN_ACTS[cfg.hidden_act](up)
        return x + self.down_proj(act.to(h.dtype))


class Llama(nn.Module):
    """The decoder; ``forward`` is the JAX ``llama_forward``."""

    def __init__(self, cfg: LlamaConfig, *, device=None):
        super().__init__()
        _refuse_unported(cfg)
        kw = dict(device=device, dtype=cfg.dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(LlamaLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **kw))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init with the JAX ``init_llama_params`` distributions."""
        D = self.cfg.hidden_size
        init_dense_(self.embed_tokens.weight, D, generator)
        for module in self.modules():
            if isinstance(module, RMSNorm):
                module.weight.fill_(1.0)
            elif isinstance(module, nn.Linear):
                init_dense_(module.weight, module.in_features, generator)
        for layer in self.layers:
            if self.cfg.hidden_act == "xielu":
                # softplus-inverse of the HF defaults (alpha_p=0.8, alpha_n-beta=0.3)
                layer.xielu_alpha_p.fill_(math.log(math.expm1(0.8)))
                layer.xielu_alpha_n.fill_(math.log(math.expm1(0.3)))

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embedding (the JAX ``embed_tokens``)."""
        return self.embed_tokens(input_ids)

    def lm_head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Vocab projection of final-normed hidden states."""
        if self.lm_head is None:
            return F.linear(x, self.embed_tokens.weight)
        return self.lm_head(x)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        kv_cache: Optional[Cache] = None,
        prefill: bool = False,
        return_hidden: bool = False,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """Run the decoder. Returns (logits, updated_cache_or_None).

        The cache tensors are updated IN PLACE; the returned cache dict holds
        them with ``length`` advanced by the call's sequence length. A cache
        carrying a ``page_table`` runs the paged decode step.

        ``return_hidden=True`` returns (final-normed hidden states, cache)
        instead of logits: XLA drops the JAX version's unused logits, eager
        PyTorch would compute them, so the caller projects only the rows it
        needs with :meth:`lm_head_logits`.
        """
        x = self.embed(input_ids) if inputs_embeds is None else inputs_embeds
        B, S, _ = x.shape
        dev = x.device
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        if position_ids is None:
            if kv_cache is not None:
                position_ids = (kv_cache["length"][:, None].long()
                                + torch.arange(S, device=dev)[None, :])
            else:
                position_ids = torch.cumsum(attention_mask.long(), dim=-1) - 1
                position_ids = torch.where(attention_mask == 0, 0, position_ids)
        inv_freq = rope_frequencies(self.cfg.head_dim_, self.cfg.rope_theta,
                                    self.cfg.rope_scaling, device=dev)
        for i, layer in enumerate(self.layers):
            x = layer(x, position_ids, attention_mask, inv_freq, kv_cache, i, prefill)
        x = self.final_norm(x)
        new_cache = None
        if kv_cache is not None:
            new_cache = {**kv_cache, "length": kv_cache["length"] + S}
        if return_hidden:
            return x, new_cache
        return self.lm_head_logits(x), new_cache

