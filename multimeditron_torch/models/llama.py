"""Llama-architecture decoder (Llama-2/3, Qwen3/Apertus-compatible GQA).

Counterpart of ``multimeditron_tpu/models/llama.py`` for the serving and
training paths: the decoder without a cache (optionally rematerialised per
layer for training); with a contiguous cache (L, B, Hkv, max_len, Dh), a
prefill (causal at per-sample offsets: the serving engine's local prefill
cache, chunked prefill and the slab engine's verify block) or a decode step
(``generate``, the slab engine; kernel K1 on the card); and the paged steps
against a page pool + per-chunk ring: a single-token decode step (kernel K4)
and the speculative verify block of S > 1 tokens (kernel K6).
Supports GQA, RoPE with HF llama3 scaling and 2-D position ids, optional
QK-norm, gated and plain MLPs (activation in float32) and tied embeddings.

Projections are ``nn.Linear`` or, in a decoder quantised by
``models/llama_quant.py``, :class:`Int8Linear` (W8A16 through kernel K9),
with q|k|v and gate|up fused into one weight each. The W8A8 row gate
(``w8a8_min_rows``, the JAX ``_maybe_quantize_act``) quantises each
activation once per row and feeds every int8 projection that reads it when
a call has at least that many (padded) rows.

Not ported yet, and refused with ``NotImplementedError``: sequence, ring and
pipeline parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimeditron_torch import default_device
from multimeditron_torch.models.common import (
    RMSNorm,
    apply_rope,
    init_dense_,
    rope_frequencies,
    xielu,
)
from multimeditron_torch.ops.attention import attention
from multimeditron_torch.ops.paged_attention import ring_decode_attention, ring_verify_attention
from multimeditron_torch.ops.wo_matmul import quantize_rows, w8a8_matmul, wo_matmul

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


def _write_at_lengths(cache: torch.Tensor, x: torch.Tensor, lengths: torch.Tensor) -> None:
    """Write ``x`` (B, Hkv, S, Dh) into one layer's cache (B, Hkv, max_len,
    Dh) at rows lengths[b] + j, in place. Rows at or past ``max_len`` are
    dropped, as JAX's out-of-range scatter drops them (an inactive slot at
    capacity still runs the step; a verify block or a chunk can reach past
    the end). Without a host sync: such a row is written to position
    (lengths[b] + j) % max_len with the value already there. Those positions
    lie below lengths[b], clear of this call's kept rows, and are distinct
    while S <= max_len; a row j >= max_len is past the end for any length
    and is cut off first."""
    B, _, max_len, _ = cache.shape
    S = min(x.shape[2], max_len)
    pos = lengths[:, None].long() + torch.arange(S, device=x.device)[None, :]
    idx, keep = pos % max_len, (pos < max_len)[:, :, None, None]
    b_idx = torch.arange(B, device=x.device)[:, None]
    rows = x[:, :, :S].transpose(1, 2).to(cache.dtype)  # (B, S, Hkv, Dh)
    cache[b_idx, :, idx] = torch.where(keep, rows, cache[b_idx, :, idx])


# ----------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------
class Int8Linear(nn.Module):
    """A projection with int8 weights ``weight_q`` (out, in), K contiguous,
    and per-output-channel float32 ``scale`` (out,): W8A16 through
    :func:`wo_matmul`, or W8A8 through :func:`w8a8_matmul` when the caller
    passes the quantised activation ``act_q``."""

    def __init__(self, in_features: int, out_features: int, *, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.empty(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(
            (out_features,), dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, act_q=None) -> torch.Tensor:
        if act_q is not None:
            return w8a8_matmul(act_q[0], act_q[1], self.weight_q, self.scale, x.dtype)
        return wo_matmul(x, self.weight_q, self.scale)


def _proj(mod: nn.Module, h: torch.Tensor, act_q=None) -> torch.Tensor:
    return mod(h) if act_q is None else mod(h, act_q)


def _maybe_quantize_act(h: torch.Tensor, probe: nn.Module, min_rows: int):
    """(int8 rows, scales) for the W8A8 products that read ``h``, or None:
    needs a gate, an int8 projection and at least ``min_rows`` rows of
    ``h`` as it is shaped (padding included, as JAX counts its static
    shape)."""
    if not min_rows or not isinstance(probe, Int8Linear):
        return None
    if h.numel() // h.shape[-1] < min_rows:
        return None
    return quantize_rows(h)


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
        # fused int8 q|k|v and gate|up of a quantised decoder (llama_quant)
        self.qkv: Optional[Int8Linear] = None
        self.gateup: Optional[Int8Linear] = None
        if cfg.hidden_act == "xielu":
            f32 = dict(device=device, dtype=torch.float32)
            self.xielu_alpha_p = nn.Parameter(torch.empty(1, **f32))
            self.xielu_alpha_n = nn.Parameter(torch.empty(1, **f32))

    def _paged_step(self, q, k, v, cache: Cache, layer_index: int) -> torch.Tensor:
        # Pages are read-only within a decode chunk: this step's S K/V rows go
        # into ring rows [t, t + S) (t the in-chunk step index, uniform over
        # the slots still active), then K4 (S = 1) or K6 (the speculative
        # verify block, S = k + 1) attends over pages + ring. The engine folds
        # the ring into the pages between chunks, and after every verify step,
        # so a verify block always lands at t = 0.
        pages_len, lengths = cache["pages_length"], cache["length"]
        rk, rv = cache["ring_k"], cache["ring_v"]
        T, S = rk.shape[3], q.shape[2]
        # clamped like the start index of the JAX dynamic_update_slice
        t = (lengths - pages_len).max().clamp(0, T - S).long()
        rows = t + torch.arange(S, device=t.device)
        rk[layer_index].index_copy_(2, rows, k.to(rk.dtype))
        rv[layer_index].index_copy_(2, rows, v.to(rv.dtype))
        args = (cache["k"], cache["v"], rk, rv, cache["page_table"], pages_len, lengths,
                layer_index)
        if S == 1:
            return ring_decode_attention(q[:, :, 0, :].contiguous(), *args)[:, :, None, :]
        return ring_verify_attention(q.contiguous(), *args)

    def _contiguous_step(self, q, k, v, cache: Cache, layer_index: int,
                         prefill: bool) -> torch.Tensor:
        # Write this call's K/V at each sample's current length, then attend
        # over the whole (masked) cache: a prefill causally with the
        # per-sample length as offset (plain attention, as in the JAX
        # package); a decode step (S = 1, or a multi-token step) without
        # causal masking, which on the card is kernel K1.
        ck, cv = cache["k"][layer_index], cache["v"][layer_index]
        lengths, S, max_len = cache["length"], q.shape[2], ck.shape[2]
        _write_at_lengths(ck, k, lengths)
        _write_at_lengths(cv, v, lengths)
        kv_mask = torch.arange(max_len, device=q.device)[None, :] < (lengths + S)[:, None]
        if prefill:
            return attention(q, ck, cv, kv_mask=kv_mask, causal=True, causal_offset=lengths)
        return attention(q, ck, cv, kv_mask=kv_mask, causal=False)

    def forward(self, x: torch.Tensor, position_ids: torch.Tensor,
                attention_mask: torch.Tensor, inv_freq: torch.Tensor,
                cache: Optional[Cache] = None, layer_index: int = 0,
                prefill: bool = False, w8a8_min_rows: int = 0) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        gate = w8a8_min_rows  # the W8A8 row gate of this call
        h = self.input_norm(x)
        if self.qkv is not None:
            qkv = _proj(self.qkv, h, _maybe_quantize_act(h, self.qkv, gate))
            Dq, Dkv = H * Dh, Hkv * Dh
            q = qkv[..., :Dq].reshape(B, S, H, Dh)
            k = qkv[..., Dq:Dq + Dkv].reshape(B, S, Hkv, Dh)
            v = qkv[..., Dq + Dkv:].reshape(B, S, Hkv, Dh)
        else:
            hq = _maybe_quantize_act(h, self.q_proj, gate)  # shared by q, k and v
            q = _proj(self.q_proj, h, hq).view(B, S, H, Dh)
            k = _proj(self.k_proj, h, hq).view(B, S, Hkv, Dh)
            v = _proj(self.v_proj, h, hq).view(B, S, Hkv, Dh)
        if cfg.use_qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        q = apply_rope(q, position_ids, inv_freq)
        k = apply_rope(k, position_ids, inv_freq)

        if cache is None:
            out = attention(q, k, v, kv_mask=attention_mask, causal=True)
        elif "page_table" in cache:
            out = self._paged_step(q, k, v, cache, layer_index)
        else:
            out = self._contiguous_step(q, k, v, cache, layer_index, prefill)
        out = out.transpose(1, 2).reshape(B, S, H * Dh)
        x = x + _proj(self.o_proj, out, _maybe_quantize_act(out, self.o_proj, gate))

        h = self.post_attn_norm(x)
        if self.gateup is not None:
            gu = _proj(self.gateup, h, _maybe_quantize_act(h, self.gateup, gate)).float()
            inter = gu.shape[-1] // 2
            act = F.silu(gu[..., :inter]) * gu[..., inter:]
        else:
            hq = _maybe_quantize_act(h, self.up_proj, gate)  # shared by up and gate
            up = _proj(self.up_proj, h, hq).float()
            if cfg.mlp_gate:
                act = F.silu(_proj(self.gate_proj, h, hq).float()) * up
            elif cfg.hidden_act == "xielu":
                act = xielu(up, self.xielu_alpha_p, self.xielu_alpha_n)
            else:
                act = _PLAIN_ACTS[cfg.hidden_act](up)
        act = act.to(h.dtype)
        return x + _proj(self.down_proj, act, _maybe_quantize_act(act, self.down_proj, gate))


class Llama(nn.Module):
    """The decoder; ``forward`` is the JAX ``llama_forward``. Built on
    ``device`` (default: the card)."""

    def __init__(self, cfg: LlamaConfig, *, device=None):
        super().__init__()
        _refuse_unported(cfg)
        device = default_device(device)
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
        """Vocab projection of final-normed hidden states (an int8 head runs
        W8A16, never W8A8)."""
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
        remat: bool = False,
        w8a8_min_rows: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """Run the decoder. Returns (logits, updated_cache_or_None).

        The cache tensors are updated IN PLACE; the returned cache dict holds
        them with ``length`` advanced by the call's sequence length. A cache
        carrying a ``page_table`` runs the paged decode step; a contiguous
        cache runs a prefill with ``prefill=True`` and a decode step without.

        ``return_hidden=True`` returns (final-normed hidden states, cache)
        instead of logits: XLA drops the JAX version's unused logits, eager
        PyTorch would compute them, so the caller projects only the rows it
        needs with :meth:`lm_head_logits`.

        ``remat=True`` on the no-cache forward keeps only each layer's input
        for the backward pass and recomputes the layer there (the JAX
        ``jax.checkpoint(scan_body)``).

        ``w8a8_min_rows`` overrides the config's W8A8 row gate for this call
        (the JAX engine's prefill-only config); 0 turns it off.
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
        gate = self.cfg.w8a8_min_rows if w8a8_min_rows is None else w8a8_min_rows
        checkpointed = remat and kv_cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if checkpointed:
                x = checkpoint(layer, x, position_ids, attention_mask, inv_freq, None, i, False,
                               gate, use_reentrant=False)
            else:
                x = layer(x, position_ids, attention_mask, inv_freq, kv_cache, i, prefill, gate)
        x = self.final_norm(x)
        new_cache = None
        if kv_cache is not None:
            new_cache = {**kv_cache, "length": kv_cache["length"] + S}
        if return_hidden:
            return x, new_cache
        return self.lm_head_logits(x), new_cache

