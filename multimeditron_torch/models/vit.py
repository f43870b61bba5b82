"""ViT vision towers (CLIP / SigLIP / BiomedCLIP-style).

Counterpart of ``multimeditron_tpu/models/vit.py``: patchify is a reshape +
matmul, every layer calls the encoder-attention kernel K3 in model layout,
and the residual stream is cast back to the tower dtype after each layer.
Output: ``last_hidden_state`` patch tokens, CLS dropped for CLIP.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from multimeditron_torch.models.common import LayerNorm, init_dense_, init_linear_
from multimeditron_torch.ops.encoder_attention import encoder_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # clip: quick_gelu; siglip: gelu_pytorch_tanh
    use_cls_token: bool = True      # clip: True; siglip: False
    use_pre_layernorm: bool = True  # clip: True; siglip: False
    post_layernorm_output: bool = False  # siglip normalizes last_hidden_state
    patch_bias: bool = False        # clip: False; siglip: True
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)

    @staticmethod
    def clip_from_hf_dict(d: dict) -> "ViTConfig":
        v = d.get("vision_config", d)
        return ViTConfig(
            image_size=v["image_size"], patch_size=v["patch_size"],
            hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"],
            intermediate_size=v["intermediate_size"],
            layer_norm_eps=v.get("layer_norm_eps", 1e-5),
            hidden_act=v.get("hidden_act", "quick_gelu"),
            use_cls_token=True, use_pre_layernorm=True,
            post_layernorm_output=False, patch_bias=False,
        )

    @staticmethod
    def siglip_from_hf_dict(d: dict) -> "ViTConfig":
        v = d.get("vision_config", d)
        return ViTConfig(
            image_size=v["image_size"], patch_size=v["patch_size"],
            hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"],
            intermediate_size=v["intermediate_size"],
            layer_norm_eps=v.get("layer_norm_eps", 1e-6),
            hidden_act=v.get("hidden_act", "gelu_pytorch_tanh"),
            use_cls_token=False, use_pre_layernorm=False,
            post_layernorm_output=True, patch_bias=True,
        )


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    if name == "quick_gelu":
        y = x32 * torch.sigmoid(1.702 * x32)
    elif name in ("gelu_pytorch_tanh", "gelu_new"):
        y = torch.nn.functional.gelu(x32, approximate="tanh")
    elif name == "gelu":
        y = torch.nn.functional.gelu(x32)
    else:
        raise ValueError(f"Unknown activation {name!r}")
    return y.to(x.dtype)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, N, P*P*3) patch vectors."""
    B, H, W, C = images.shape
    P = patch_size
    x = images.reshape(B, H // P, P, W // P, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // P) * (W // P), P * P * C)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        D, F, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        kw = dict(device=device, dtype=cfg.dtype)
        self.cfg = cfg
        self.ln1 = LayerNorm(D, eps, **kw)
        self.q_proj = nn.Linear(D, D, **kw)
        self.k_proj = nn.Linear(D, D, **kw)
        self.v_proj = nn.Linear(D, D, **kw)
        self.o_proj = nn.Linear(D, D, **kw)
        self.ln2 = LayerNorm(D, eps, **kw)
        self.fc1 = nn.Linear(D, F, **kw)
        self.fc2 = nn.Linear(F, D, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln1(x)
        o = encoder_attention(self.q_proj(h), self.k_proj(h), self.v_proj(h),
                              self.cfg.num_heads)
        x = x + self.o_proj(o)
        h = _act(self.cfg.hidden_act, self.fc1(self.ln2(x)))
        x = x + self.fc2(h)
        # pin the residual dtype (mixed-precision params must not widen it)
        return x.to(self.cfg.dtype)


class ViT(nn.Module):
    """The tower; ``forward`` is the JAX ``vit_forward``."""

    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        D, P = cfg.hidden_size, cfg.patch_size
        kw = dict(device=device, dtype=cfg.dtype)
        self.cfg = cfg
        self.patch_proj = nn.Linear(P * P * 3, D, bias=cfg.patch_bias, **kw)
        self.position_embedding = nn.Parameter(torch.empty(cfg.seq_len, D, **kw))
        self.cls_token = (nn.Parameter(torch.empty(D, **kw))
                          if cfg.use_cls_token else None)
        self.pre_ln = (LayerNorm(D, cfg.layer_norm_eps, **kw)
                       if cfg.use_pre_layernorm else None)
        self.layers = nn.ModuleList(ViTLayer(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.post_ln = LayerNorm(D, cfg.layer_norm_eps, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init with the JAX ``init_vit_params`` distributions."""
        D = self.cfg.hidden_size
        init_linear_(self.patch_proj, generator)
        init_dense_(self.position_embedding, D, generator)
        if self.cls_token is not None:
            init_dense_(self.cls_token, D, generator)
        for module in self.modules():
            if isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        for layer in self.layers:
            for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.o_proj,
                        layer.fc1, layer.fc2):
                init_linear_(lin, generator)

    def forward(self, pixel_values: torch.Tensor, drop_cls: bool = True) -> torch.Tensor:
        """Encode NHWC pixel_values -> (B, N[, +1], D) hidden states."""
        cfg = self.cfg
        B = pixel_values.shape[0]
        x = self.patch_proj(patchify(pixel_values.to(cfg.dtype), cfg.patch_size))
        if self.cls_token is not None:
            cls = self.cls_token.to(x.dtype).expand(B, 1, cfg.hidden_size)
            x = torch.cat([cls, x], dim=1)
        x = x + self.position_embedding
        if self.pre_ln is not None:
            x = self.pre_ln(x)
        for layer in self.layers:
            x = layer(x)
        if cfg.post_layernorm_output:
            x = self.post_ln(x)
        if self.cls_token is not None and drop_cls:
            x = x[:, 1:, :]
        return x

