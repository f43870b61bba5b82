"""The plain reference of the ``mellum`` architecture (``arch/mellum.py``):
one Mellum2-12B-A2.5B decoder layer in float32 with plain ``torch`` ops.

    x' = h + MoE(RMSNorm(h)),   h = x + o(Attn(RMSNorm(x)))

Attention: grouped-query (32 query heads over 4 K/V heads of 128), no
QK-norm, half-split RoPE; a full layer (``layer_types`` "full_attention")
attends every earlier key with YaRN RoPE, cos and sin multiplied by the
attention factor; a sliding layer attends the keys j with p - window < j <= p
(HF's mask) with default RoPE. MoE: a softmax over the experts of the
router's scores, the top k, their weights renormalised (``norm_topk_prob``),
and a loop over the experts, each a SiLU-gated MLP on the tokens routed to
it.

It imports nothing of the program and no JAX; the YaRN frequencies are
written here from the published formula (HF ``_compute_yarn_parameters``).
``prec="fp8"`` rounds the inputs of every linear layer, router and experts
included, as ``reference/model.py`` states.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference.model import linear, rms_norm


def yarn_inv_freq(head_dim: int, p: dict) -> torch.Tensor:
    """YaRN's inverse frequencies (float64): each pair of dimensions blends
    theta^(-2i/d) / factor and theta^(-2i/d) by a ramp between the dims that
    turn beta_fast and beta_slow times over the original context."""
    theta, factor = float(p["rope_theta"]), float(p["factor"])
    old = float(p["original_max_position_embeddings"])

    def dim_of(rot):
        return head_dim * math.log(old / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(dim_of(p.get("beta_fast", 32))), 0)
    high = min(math.ceil(dim_of(p.get("beta_slow", 1))), head_dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(head_dim // 2, dtype=torch.float64)
    base = theta ** (-2 * i / head_dim)
    keep = 1 - ((i - low) / (high - low)).clamp(0, 1)  # 1: the original frequency
    return base / factor * (1 - keep) + base * keep


def attention_factor(p: dict) -> float:
    if p.get("rope_type") != "yarn":
        return 1.0
    if p.get("attention_factor") is not None:
        return float(p["attention_factor"])
    return 0.1 * math.log(float(p["factor"])) + 1.0


def rope_tables(d, n: int, device) -> Dict[str, tuple]:
    """(cos, sin) of each kind of layer over positions 0..n-1."""
    out = {}
    for kind, p in d.rope.items():
        if p.get("rope_type") == "yarn":
            f = yarn_inv_freq(d.Dh, p)
        else:
            f = float(p["rope_theta"]) ** (-torch.arange(0, d.Dh, 2, dtype=torch.float64) / d.Dh)
        pos = torch.arange(n, dtype=torch.float32, device=device)
        ang = pos[:, None] * f.float().to(device)[None, :]
        ang = torch.cat([ang, ang], dim=-1)
        s = attention_factor(p)
        out[kind] = (ang.cos() * s, ang.sin() * s)
    return out


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def attention(q, k, v, d, window: int) -> torch.Tensor:
    """q (H, n, Dh), k and v (Hkv, n, Dh): causal softmax attention over the
    keys j <= p, and j > p - window where window > 0."""
    rep = d.H // d.Hkv
    k, v = k.repeat_interleave(rep, dim=0), v.repeat_interleave(rep, dim=0)
    n = q.shape[1]
    s = (q @ k.transpose(1, 2)) * d.Dh ** -0.5
    p = torch.arange(n, device=q.device)
    seen = p[:, None] >= p[None, :]
    if window > 0:
        seen &= p[:, None] - p[None, :] < window
    s = s.masked_fill(~seen, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def experts(h: torch.Tensor, W: Dict[str, torch.Tensor], d, prec: str = "f32") -> torch.Tensor:
    """The routed mixture over h (n, D): softmax router, top k, renormalised,
    a loop over the experts."""
    scores = torch.softmax(linear(h, W["router"], prec=prec), dim=-1)
    top, ids = torch.topk(scores, d.K, dim=-1)
    if d.norm_topk:
        top = top / top.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(d.E):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        he = F.silu(linear(xe, W["gate"][e], prec=prec)) * linear(xe, W["up"][e], prec=prec)
        y.index_add_(0, tok, linear(he, W["down"][e], prec=prec) * top[tok, slot, None])
    return y


def decoder_layer(i: int, x: torch.Tensor, W: Dict[str, torch.Tensor], d, tables,
                  prec: str = "f32") -> torch.Tensor:
    """Layer i over one sequence x (n, D)."""
    n, kind = x.shape[0], d.kinds_of[i]
    h = rms_norm(x, d.eps)
    q = linear(h, W["q"], prec=prec).view(n, d.H, d.Dh).transpose(0, 1)
    k = linear(h, W["k"], prec=prec).view(n, d.Hkv, d.Dh).transpose(0, 1)
    v = linear(h, W["v"], prec=prec).view(n, d.Hkv, d.Dh).transpose(0, 1)
    cos, sin = tables[kind]
    q, k = _rotate(q, cos[:n], sin[:n]), _rotate(k, cos[:n], sin[:n])
    window = d.window if kind == "sliding_attention" else 0
    o = attention(q, k, v, d, window).transpose(0, 1).reshape(n, d.H * d.Dh)
    x = x + linear(o, W["o"], prec=prec)
    return x + experts(rms_norm(x, d.eps), W, d, prec)
