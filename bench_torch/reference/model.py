"""The plain reference: the model in float32 with plain ``torch`` ops.

It follows the published descriptions: the Llama-family decoder with
grouped-query attention, RMSNorm, half-split RoPE (with the llama3 scaling
that Apertus states), QK-norm over each head (Qwen3, Apertus), and either
Apertus' gateless xIELU MLP or Qwen3's SiLU-gated one; the CLIP ViT-L/14
tower (pre-LayerNorm encoder, quick_gelu, CLS dropped, no post-norm on the
patch states); and the MLP projector (Linear, GELU, Linear, GELU, Linear).
The image's patch states replace the prompt's embeddings at its token
positions.

It imports nothing of the program and takes none of its tensors: every
weight is made again here, block by block, from the run's seed
(``weights.py``), in the served dtype and then widened to float32. TF32 is
switched off while it runs. ``prec="fp8"`` rounds both inputs of every
linear layer to float8 e4m3 (a scale per output row of the weight and per
token row of the input): the control, one precision below the configuration's
bf16.

Departures from the published models: the patch vector is ordered (row,
column, channel), the layout the repo's converter gives the HF convolution;
the weights are random.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

import weights
from spec import Dims

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Round rows of ``x`` to e4m3 with a scale per row; back in float32.
    The gradient passes straight through (the backward stays float32)."""
    s = x.detach().abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           prec: str = "f32") -> torch.Tensor:
    if prec == "fp8":
        x, w = _fp8(x), _fp8(w)
    y = x @ w.t()
    return y if b is None else y + b


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).pow(2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def inv_freq(d: Dims, device) -> torch.Tensor:
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


def rope_tables(d: Dims, n: int, device):
    pos = torch.arange(n, dtype=torch.float32, device=device)
    ang = pos[:, None] * inv_freq(d, device)[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def xielu(x: torch.Tensor, beta: float = 0.5, eps: float = -1e-6) -> torch.Tensor:
    ap = float(F.softplus(torch.tensor(weights.XIELU_ALPHA_P)))
    an = beta + float(F.softplus(torch.tensor(weights.XIELU_ALPHA_N)))
    return torch.where(x > 0, ap * x * x + beta * x,
                       (torch.expm1(torch.clamp(x, max=eps)) - x) * an + beta * x)


ACTS = {"silu": F.silu, "xielu": xielu}  # the configs' hidden_act


def causal_attention(q, k, v, d: Dims) -> torch.Tensor:
    """q (H, n, Dh), k and v (Hkv, n, Dh): causal softmax attention, each KV
    head shared by H / Hkv query heads."""
    rep = d.H // d.Hkv
    k, v = k.repeat_interleave(rep, dim=0), v.repeat_interleave(rep, dim=0)
    n = q.shape[1]
    s = (q @ k.transpose(1, 2)) * d.Dh ** -0.5
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def decoder_layer(x: torch.Tensor, W: Dict[str, torch.Tensor], d: Dims, cos, sin,
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


def f32(block: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in block.items()}


# ----------------------------------------------------------------------
# Tower and projector
# ----------------------------------------------------------------------
def tower(images: torch.Tensor, seed: int, d: Dims, prec: str = "f32") -> torch.Tensor:
    """uint8 images (N, S, S, 3) -> patch states (N, patches, Dv), CLS
    dropped."""
    dev = images.device
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    x = (images.float() / 255.0 - mean) / std
    N, S, _, C = x.shape
    P, g = d.patch, S // d.patch
    x = x.reshape(N, g, P, g, P, C).permute(0, 1, 3, 2, 4, 5).reshape(N, g * g, P * P * C)
    stem = f32(weights.tower_stem(seed, d, dev))
    x = linear(x, stem["patch"], prec=prec)
    x = torch.cat([stem["cls"].expand(N, 1, d.Dv), x], dim=1) + stem["position"]
    x = layer_norm(x, d.eps_v)
    Dh = d.Dv // d.Hv
    for j in range(d.Lv):
        W = f32(weights.tower_layer(seed, d, j, dev))
        h = layer_norm(x, d.eps_v)
        q, k, v = (linear(h, W[n], W[n + "_b"], prec).view(N, -1, d.Hv, Dh).transpose(1, 2)
                   for n in ("q", "k", "v"))
        a = torch.softmax((q @ k.transpose(-1, -2)) * Dh ** -0.5, dim=-1) @ v
        x = x + linear(a.transpose(1, 2).reshape(N, -1, d.Dv), W["o"], W["o_b"], prec)
        h = linear(layer_norm(x, d.eps_v), W["fc1"], W["fc1_b"], prec)
        h = h * torch.sigmoid(1.702 * h)  # quick_gelu
        x = x + linear(h, W["fc2"], W["fc2_b"], prec)
    return x[:, 1:]


def project(x: torch.Tensor, P: Dict[str, torch.Tensor], prec: str = "f32") -> torch.Tensor:
    x = F.gelu(linear(x, P["fc1"], P["fc1_b"], prec))
    x = F.gelu(linear(x, P["fc2"], P["fc2_b"], prec))
    return linear(x, P["fc3"], P["fc3_b"], prec)
