"""Modality -> LLM embedding-space projector.

Counterpart of ``multimeditron_tpu/models/projector.py`` (bf16/f32 path):
Linear(m, m) -> GELU -> Linear(m, H) -> GELU -> Linear(H, H), biased, exact
(erf) GELU; and its W8A8 twin (``quantize_mlp_projector``,
``mlp_projector_forward_int8``): per-output-channel int8 weights, dynamic
per-row activation scales, int8 products through ``torch._int_mm`` as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from multimeditron_torch import default_device
from multimeditron_torch.models.common import gelu, init_linear_
from multimeditron_torch.models.vit_quant import Params, _qdot, _quantize_weight


class MLPProjector(nn.Module):
    """``forward`` is the JAX ``mlp_projector_forward``. Built on ``device``
    (default: the card)."""

    def __init__(self, modality_size: int, projected_size: int, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = default_device(device)
        kw = dict(device=device, dtype=dtype)
        self.fc1 = nn.Linear(modality_size, modality_size, **kw)
        self.fc2 = nn.Linear(modality_size, projected_size, **kw)
        self.fc3 = nn.Linear(projected_size, projected_size, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init with the JAX ``init_mlp_projector`` distributions."""
        for lin in (self.fc1, self.fc2, self.fc3):
            init_linear_(lin, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.fc1(x))
        x = gelu(self.fc2(x))
        return self.fc3(x)


def mlp_projector_tree(proj: MLPProjector) -> Params:
    """The JAX ``init_mlp_projector`` tree of a projector: fc* (in, out)."""
    tree = {}
    for i, lin in enumerate((proj.fc1, proj.fc2, proj.fc3), start=1):
        tree[f"fc{i}"] = lin.weight.detach().t()
        tree[f"b{i}"] = lin.bias.detach()
    return tree


@torch.no_grad()
def quantize_mlp_projector(params: Params) -> Params:
    """W8A8 serving twin of the projector: ``fc*_q`` (out, in) int8 and
    ``fc*_s`` (1, out) float32 per-output-channel scales; biases as they are."""
    out = dict(params)
    for key in ("fc1", "fc2", "fc3"):
        q, s = _quantize_weight(out.pop(key))
        out[key + "_q"] = q.t().contiguous()
        out[key + "_s"] = s
    return out


def mlp_projector_forward_int8(qparams: Params, x: torch.Tensor) -> torch.Tensor:
    x = gelu(_qdot(x, qparams["fc1_q"], qparams["fc1_s"]) + qparams["b1"])
    x = gelu(_qdot(x, qparams["fc2_q"], qparams["fc2_s"]) + qparams["b2"])
    return _qdot(x, qparams["fc3_q"], qparams["fc3_s"]) + qparams["b3"]
