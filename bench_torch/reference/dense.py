"""The plain reference of the ``dense`` architecture (``arch/dense.py``): one
Llama-family decoder layer in float32 with plain ``torch`` ops.

Grouped-query attention, RMSNorm, half-split RoPE (with the llama3 scaling
that Apertus states), QK-norm over each head (Qwen3, Apertus), and either
Apertus' gateless xIELU MLP or Qwen3's SiLU-gated one. Every layer is alike
and attends the whole causal sequence.

It imports nothing of the program. ``prec="fp8"`` rounds the inputs of every
linear layer as ``reference/model.py`` states.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference.model import linear, rms_norm

# xIELU's alphas at their published initial values (softplus-inverse of 0.8
# and 0.3): the values the seeded weights give the program too
XIELU_ALPHA_P = math.log(math.expm1(0.8))
XIELU_ALPHA_N = math.log(math.expm1(0.3))


def inv_freq(d, device) -> torch.Tensor:
    """RoPE inverse frequencies, with HF's llama3 rule when the config
    states it."""
    f = 1.0 / (d.rope_theta ** (torch.arange(0, d.Dh, 2, dtype=torch.float64) / d.Dh))
    sc = d.rope_scaling
    if sc and sc.get("rope_type", sc.get("type")) == "llama3":
        factor, lo, hi = sc["factor"], sc["low_freq_factor"], sc["high_freq_factor"]
        old = sc["original_max_position_embeddings"]
        wavelen = 2 * math.pi / f
        g = torch.where(wavelen > old / lo, f / factor, f)
        smooth = (old / wavelen - lo) / (hi - lo)
        smoothed = (1 - smooth) * g / factor + smooth * g
        medium = (wavelen >= old / hi) & (wavelen <= old / lo)
        f = torch.where(medium, smoothed, g)
    return f.float().to(device)


def rope_tables(d, n: int, device):
    pos = torch.arange(n, dtype=torch.float32, device=device)
    ang = pos[:, None] * inv_freq(d, device)[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def xielu(x: torch.Tensor, beta: float = 0.5, eps: float = -1e-6) -> torch.Tensor:
    ap = float(F.softplus(torch.tensor(XIELU_ALPHA_P)))
    an = beta + float(F.softplus(torch.tensor(XIELU_ALPHA_N)))
    return torch.where(x > 0, ap * x * x + beta * x,
                       (torch.expm1(torch.clamp(x, max=eps)) - x) * an + beta * x)


ACTS = {"silu": F.silu, "xielu": xielu}  # the configs' hidden_act


def causal_attention(q, k, v, d) -> torch.Tensor:
    """q (H, n, Dh), k and v (Hkv, n, Dh): causal softmax attention, each KV
    head shared by H / Hkv query heads."""
    rep = d.H // d.Hkv
    k, v = k.repeat_interleave(rep, dim=0), v.repeat_interleave(rep, dim=0)
    n = q.shape[1]
    s = (q @ k.transpose(1, 2)) * d.Dh ** -0.5
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def decoder_layer(x: torch.Tensor, W: Dict[str, torch.Tensor], d, cos, sin,
                  prec: str = "f32") -> torch.Tensor:
    """One decoder layer over one sequence x (n, D)."""
    n = x.shape[0]
    h = rms_norm(x, d.eps)
    q = linear(h, W["q"], prec=prec).view(n, d.H, d.Dh)
    k = linear(h, W["k"], prec=prec).view(n, d.Hkv, d.Dh)
    v = linear(h, W["v"], prec=prec).view(n, d.Hkv, d.Dh)
    q, k = rms_norm(q, d.eps), rms_norm(k, d.eps)  # QK-norm over each head
    q = _rotate(q.transpose(0, 1), cos[:n], sin[:n])
    k = _rotate(k.transpose(0, 1), cos[:n], sin[:n])
    o = causal_attention(q, k, v.transpose(0, 1), d).transpose(0, 1).reshape(n, d.H * d.Dh)
    x = x + linear(o, W["o"], prec=prec)
    h = rms_norm(x, d.eps)
    up = linear(h, W["up"], prec=prec)
    act = ACTS[d.act]
    h = act(linear(h, W["gate"], prec=prec)) * up if d.gated else act(up)
    return x + linear(h, W["down"], prec=prec)
