"""Modality -> LLM embedding-space projector.

Counterpart of ``multimeditron_tpu/models/projector.py`` (bf16/f32 path):
Linear(m, m) -> GELU -> Linear(m, H) -> GELU -> Linear(H, H), biased, exact
(erf) GELU. The int8 variants are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from multimeditron_torch.models.common import gelu, init_linear_


class MLPProjector(nn.Module):
    """``forward`` is the JAX ``mlp_projector_forward``."""

    def __init__(self, modality_size: int, projected_size: int, *,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
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
