"""Shared building blocks: norms, rotary embeddings, the loss, activations, init.

Counterpart of ``multimeditron_tpu/models/common.py``. Computations that
affect numerics (norms, rotary, activations) run in float32 whatever the
storage dtype, and cast back, exactly where the JAX functions do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimeditron_torch.constants import IGNORE_TOKEN_INDEX


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    """Affine layer norm computed in float32 (``common.layer_norm``)."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


# ----------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     scaling: Optional[dict] = None,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies (float32), with optional HF llama3 scaling."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    if scaling and scaling.get("rope_type", scaling.get("type")) == "llama3":
        factor = scaling["factor"]
        low_factor = scaling["low_freq_factor"]
        high_factor = scaling["high_freq_factor"]
        old_len = scaling["original_max_position_embeddings"]
        low_wavelen = old_len / low_factor
        high_wavelen = old_len / high_factor
        wavelen = 2 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        inv_freq = torch.where(
            wavelen < high_wavelen, inv_freq,
            torch.where(wavelen > low_wavelen, scaled, smoothed))
    return inv_freq


def _rotate(block: torch.Tensor, pos: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    # block: (B, H, S, d) float32; pos: (B, S); freqs: (d/2,)
    angles = pos.float()[:, None, :, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    half = block.shape[-1] // 2
    x1, x2 = block[..., :half], block[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, position_ids: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, S, D) by positions (B, S) — HF half-split convention.

    With (B, S, 2) position ids the head dim splits in half and each half
    rotates with its own position channel (2-D image patch positions).
    """
    D = x.shape[-1]
    x32 = x.float()
    if position_ids.dim() == 2:
        out = _rotate(x32, position_ids, inv_freq)
    elif position_ids.dim() == 3 and position_ids.shape[-1] == 2:
        half = D // 2
        freqs_half = inv_freq[: half // 2] * 2.0  # keep wavelength coverage
        out = torch.cat([
            _rotate(x32[..., :half], position_ids[..., 0], freqs_half),
            _rotate(x32[..., half:], position_ids[..., 1], freqs_half),
        ], dim=-1)
    else:
        raise ValueError(
            f"position_ids must be (B,S) or (B,S,2), got {tuple(position_ids.shape)}")
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE_TOKEN_INDEX) -> torch.Tensor:
    """Mean next-token cross entropy over non-ignored positions, in float32.

    logits (B, S, V) and labels (B, S); the causal shift (predict labels[t+1]
    from logits[t]) happens here, as in the JAX ``cross_entropy_loss``.
    """
    logits = logits[:, :-1, :].float()
    targets = labels[:, 1:].long()
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, 0)
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe_targets[..., None])[..., 0]
    nll = (logz - picked) * valid
    return nll.sum() / valid.sum().clamp(min=1)


# ----------------------------------------------------------------------
# Activations
# ----------------------------------------------------------------------
def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x)


def xielu(x: torch.Tensor, alpha_p: torch.Tensor, alpha_n: torch.Tensor,
          beta: float = 0.5, eps: float = -1e-6) -> torch.Tensor:
    """xIELU activation (arXiv:2411.13010) as used by Apertus' gateless MLP;
    ``alpha_p`` / ``alpha_n`` are stored in the softplus-inverse domain."""
    x = x.float()
    ap = F.softplus(alpha_p.float()).reshape(())
    an = beta + F.softplus(alpha_n.float()).reshape(())
    return torch.where(
        x > 0,
        ap * x * x + beta * x,
        (torch.expm1(torch.clamp(x, max=eps)) - x) * an + beta * x,
    )


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------
@torch.no_grad()
def init_dense_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """N(0, 1/fan_in) drawn in float32, then cast (the JAX package's ``dense``)."""
    w = torch.empty(weight.shape, dtype=torch.float32, device=weight.device)
    w.normal_(generator=generator).div_(math.sqrt(fan_in))
    weight.copy_(w)


@torch.no_grad()
def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    init_dense_(layer.weight, layer.in_features, generator)
    if layer.bias is not None:
        layer.bias.zero_()
