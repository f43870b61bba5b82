"""W8A8 int8 path of the ViT towers (the unfused one) and the int8 rules
every quantised path of the port shares.

Counterpart of ``multimeditron_tpu/models/vit_quant.py``. The rules:

- round half to even (``torch.round``), clip to [-127, 127];
- scale floors of 1e-8;
- per-output-channel weight scales (``_quantize_weight``) times a
  per-tensor static activation scale, or a per-row dynamic one;
- int8 weights are stored (N, K), K contiguous, one row per output channel
  (the JAX trees keep them (K, N); ``convert.py`` transposes at load).

Parameters are JAX-layout trees of tensors (:func:`vit_params_tree`):
matrices (in, out), layers stacked on a leading axis. The int8 products go
to ``torch._int_mm`` (:func:`int8_matmul`), as the JAX package leaves them to
XLA; the tower's attention is the encoder-attention kernel K3.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from multimeditron_torch.models.common import layer_norm
from multimeditron_torch.models.vit import ViT, ViTConfig, _act, patchify
from multimeditron_torch.ops.encoder_attention import encoder_attention

Params = Dict[str, Any]

_QUANT_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj", "fc1", "fc2")
# JAX layer leaf -> port ViTLayer attribute path
_LAYER_LEAVES = {
    "ln1_w": "ln1.weight", "ln1_b": "ln1.bias", "ln2_w": "ln2.weight", "ln2_b": "ln2.bias",
    **{f"{p}_proj": f"{p}_proj.weight" for p in "qkvo"},
    **{f"{p}_bias": f"{p}_proj.bias" for p in "qkvo"},
    "fc1": "fc1.weight", "fc1_bias": "fc1.bias", "fc2": "fc2.weight", "fc2_bias": "fc2.bias",
}


def _get(module: torch.nn.Module, path: str) -> torch.Tensor:
    for part in path.split("."):
        module = getattr(module, part)
    return module


def vit_params_tree(vit: ViT) -> Params:
    """The JAX ``init_vit_params`` tree of a port tower: matrices (in, out),
    layers stacked on axis 0, every leaf in the module's dtype, detached, on
    the module's device (a copy: the module is not touched)."""
    cfg = vit.cfg
    tree: Params = {
        "patch_proj": vit.patch_proj.weight.detach().t().contiguous(),
        "position_embedding": vit.position_embedding.detach().clone(),
        "post_ln_w": vit.post_ln.weight.detach().clone(),
        "post_ln_b": vit.post_ln.bias.detach().clone(),
    }
    if cfg.patch_bias:
        tree["patch_bias"] = vit.patch_proj.bias.detach().clone()
    if vit.cls_token is not None:
        tree["cls_token"] = vit.cls_token.detach().clone()
    if vit.pre_ln is not None:
        tree["pre_ln_w"] = vit.pre_ln.weight.detach().clone()
        tree["pre_ln_b"] = vit.pre_ln.bias.detach().clone()
    layers = {}
    for leaf, path in _LAYER_LEAVES.items():
        ts = [_get(layer, path).detach() for layer in vit.layers]
        layers[leaf] = torch.stack([t.t() if t.dim() == 2 else t for t in ts])
    tree["layers"] = layers
    return tree


# ----------------------------------------------------------------------
# int8 rules
# ----------------------------------------------------------------------
def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 ``a`` (..., K) and int8 weights ``w``
    (N, K): (..., N). On the card ``torch._int_mm`` takes more than 16 rows,
    so a short ``a`` is padded with zero rows that are then dropped."""
    lead, K = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, K)
    M = a2.shape[0]
    if a.device.type == "cuda" and M <= 16:
        a2 = torch.cat([a2, a2.new_zeros(32 - M, K)])
    out = torch._int_mm(a2, w.t())
    return out[:M].reshape(*lead, w.shape[0])


def _quantize_weight(w: torch.Tensor):
    """(..., in, out) weight -> int8 values (..., in, out) and per-output-
    channel float32 scales (..., 1, out)."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_vit_params(params: Params) -> Params:
    """Quantise the layer matmul weights; everything else stays as it is.
    ``<name>_q`` is (L, out, in) int8, ``<name>_s`` (L, 1, out) float32."""
    qlayers = dict(params["layers"])
    for key in _QUANT_KEYS:
        q, s = _quantize_weight(qlayers.pop(key))
        qlayers[key + "_q"] = q.transpose(-1, -2).contiguous()
        qlayers[key + "_s"] = s
    return {**params, "layers": qlayers}


def _quantize_act(x: torch.Tensor, xs=None):
    """Quantise an activation once; (xq, xs) is reused by every product that
    reads the same tensor. ``xs`` None: dynamic per-row scales."""
    xf = x.float()
    if xs is None:
        xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def _qdot_pre(xq: torch.Tensor, xs, wq: torch.Tensor, ws: torch.Tensor,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 product of a quantised activation and (N, K) int8 weights."""
    acc = int8_matmul(xq, wq)
    return (acc.float() * xs * ws.reshape(-1)).to(out_dtype)


def _qdot(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, xs=None) -> torch.Tensor:
    """int8 product with dynamic per-row (xs None) or static per-tensor
    activation scales."""
    xq, xs = _quantize_act(x, xs)
    return _qdot_pre(xq, xs, wq, ws, out_dtype=x.dtype)


# ----------------------------------------------------------------------
# Forward on a tree
# ----------------------------------------------------------------------
def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's dtype promotion (a bf16 activation times a
    float32 folded weight runs in float32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def embed_patches(params: Params, cfg: ViTConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """patchify -> patch projection (+bias) -> CLS -> positions -> pre-LN."""
    B, D = pixel_values.shape[0], cfg.hidden_size
    x = mm(patchify(pixel_values.to(cfg.dtype), cfg.patch_size), params["patch_proj"])
    if cfg.patch_bias:
        x = x + params["patch_bias"]
    if cfg.use_cls_token:
        x = torch.cat([params["cls_token"].to(x.dtype).expand(B, 1, D), x], dim=1)
    x = x + params["position_embedding"]
    if cfg.use_pre_layernorm:
        x = layer_norm(x, params["pre_ln_w"], params["pre_ln_b"], cfg.layer_norm_eps)
    return x


def finish(params: Params, cfg: ViTConfig, x: torch.Tensor, drop_cls: bool) -> torch.Tensor:
    if cfg.post_layernorm_output:
        x = layer_norm(x, params["post_ln_w"], params["post_ln_b"], cfg.layer_norm_eps)
    if cfg.use_cls_token and drop_cls:
        x = x[:, 1:, :]
    return x


def vit_forward_int8(qparams: Params, cfg: ViTConfig, pixel_values: torch.Tensor,
                     drop_cls: bool = True,
                     act_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 twin of the bf16 tower; ``act_scales`` (L, 4) calibrated, or
    None for dynamic per-row scales."""
    Hn, eps = cfg.num_heads, cfg.layer_norm_eps
    x = embed_patches(qparams, cfg, pixel_values)
    lp = qparams["layers"]
    for i in range(cfg.num_layers):
        s0, s1, s2, s3 = (None,) * 4 if act_scales is None else act_scales[i, :4]
        h = layer_norm(x, lp["ln1_w"][i], lp["ln1_b"][i], eps)
        hq, hs = _quantize_act(h, s0)  # once for q, k and v
        q = _qdot_pre(hq, hs, lp["q_proj_q"][i], lp["q_proj_s"][i], x.dtype) + lp["q_bias"][i]
        k = _qdot_pre(hq, hs, lp["k_proj_q"][i], lp["k_proj_s"][i], x.dtype) + lp["k_bias"][i]
        v = _qdot_pre(hq, hs, lp["v_proj_q"][i], lp["v_proj_s"][i], x.dtype) + lp["v_bias"][i]
        o = encoder_attention(q, k, v, Hn)
        x = x + _qdot(o, lp["o_proj_q"][i], lp["o_proj_s"][i], s1) + lp["o_bias"][i]
        h = layer_norm(x, lp["ln2_w"][i], lp["ln2_b"][i], eps)
        h = _act(cfg.hidden_act, _qdot(h, lp["fc1_q"][i], lp["fc1_s"][i], s2) + lp["fc1_bias"][i])
        x = x + _qdot(h, lp["fc2_q"][i], lp["fc2_s"][i], s3) + lp["fc2_bias"][i]
    return finish(qparams, cfg, x, drop_cls)


class TreeBuffers(nn.Module):
    """A flat tree of tensors held as non-persistent buffers: they follow
    ``.to()`` and stay out of ``state_dict`` and ``parameters()``."""

    def __init__(self, tensors: Params):
        super().__init__()
        for name, t in tensors.items():
            self.register_buffer(name, t, persistent=False)

    def tree(self) -> Params:
        return dict(self.named_buffers(recurse=False))


class ViTInt8(nn.Module):
    """The unfused W8A8 tower as a module (a :func:`quantize_vit_params`
    tree as buffers, optional (L, 4) static scales); ``forward`` is
    :func:`vit_forward_int8`."""

    def __init__(self, cfg: ViTConfig, qparams: Params,
                 act_scales: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.top = TreeBuffers({k: v for k, v in qparams.items() if k != "layers"})
        self.layers = TreeBuffers(qparams["layers"])
        self.register_buffer("act_scales", act_scales, persistent=False)

    def tree(self) -> Params:
        return {**self.top.tree(), "layers": self.layers.tree()}

    def forward(self, pixel_values: torch.Tensor, drop_cls: bool = True) -> torch.Tensor:
        return vit_forward_int8(self.tree(), self.cfg, pixel_values, drop_cls, self.act_scales)


def float_layer(lp: Params, i: int, cfg: ViTConfig, x: torch.Tensor):
    """Layer ``i`` of the float tower on a tree (JAX dtype promotion, K3
    attention); returns the residual stream, pinned to the tower dtype, and
    the intermediates that calibration and smoothing read."""
    eps = cfg.layer_norm_eps
    h1 = layer_norm(x, lp["ln1_w"][i], lp["ln1_b"][i], eps)
    q = mm(h1, lp["q_proj"][i]) + lp["q_bias"][i]
    k = mm(h1, lp["k_proj"][i]) + lp["k_bias"][i]
    v = mm(h1, lp["v_proj"][i]) + lp["v_bias"][i]
    o = encoder_attention(q, k, v, cfg.num_heads)
    x = x + (mm(o, lp["o_proj"][i]) + lp["o_bias"][i])
    h2 = layer_norm(x, lp["ln2_w"][i], lp["ln2_b"][i], eps)
    g = _act(cfg.hidden_act, mm(h2, lp["fc1"][i]) + lp["fc1_bias"][i])
    x = x + (mm(g, lp["fc2"][i]) + lp["fc2_bias"][i])
    # float32 folded weights must not widen the residual stream
    return x.to(cfg.dtype), dict(h1=h1, q=q, k=k, v=v, o=o, h2=h2, g=g)


def amax(h: torch.Tensor) -> torch.Tensor:
    return h.float().abs().amax()


@torch.no_grad()
def calibrate_act_scales(params: Params, cfg: ViTConfig, pixel_values: torch.Tensor,
                         margin: float = 1.1) -> torch.Tensor:
    """Float forward over a calibration batch recording each layer's max
    |activation| at the four quantised-product inputs (ln1 out, attention
    out, ln2 out, activation out): (L, 4) static scales."""
    x = embed_patches(params, cfg, pixel_values)
    stats = []
    for i in range(cfg.num_layers):
        x, t = float_layer(params["layers"], i, cfg, x)
        stats.append(torch.stack([amax(t[k]) for k in ("h1", "o", "h2", "g")]))
    return torch.clamp(torch.stack(stats) * margin / 127.0, min=1e-8)
