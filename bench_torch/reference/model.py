"""The plain reference: the model in float32 with plain ``torch`` ops.

It follows the published descriptions: the decoder's layers as their
architecture states them (the ``ref_layer`` of ``arch/<name>.py``, named by
the configuration's ``"arch"``, whose arithmetic is plain ``torch`` under
``reference/``), RMSNorm before the head; the CLIP ViT-L/14
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
