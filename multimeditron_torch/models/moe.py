"""The routed mixture of SiLU-gated experts that replaces a decoder layer's
MLP (Mellum2-12B-A2.5B: 64 experts of width 896, 8 a token).

It has no counterpart in ``multimeditron_tpu``. Per token x (its layer's
post-attention RMSNorm output):

    s = softmax(W_r x) over the experts (float32), the top k (e, s_e),
    w_e = s_e / sum of the top k's s (``norm_topk_prob``; else s_e),
    y = sum_e w_e * down_e(silu(gate_e x) * up_e x),

the router in float32 on the input's values, the experts through
``ops.grouped_experts`` (its kernel on the card, its plain twin on the CPU).
Inside a prefill (``trace=True``) the two parts record the spans
``moe.route`` and ``moe.experts``; a decode step records none (its graph
replays on the card). ``stats`` receives the call's (experts touched,
assignments) on the device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimeditron_torch.models.common import init_dense_
from multimeditron_torch.ops.grouped_experts import grouped_experts
from multimeditron_torch.profiling import tracer


class MoE(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        D, F_, E = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
        kw = dict(device=device, dtype=cfg.dtype)
        self.top_k, self.norm_topk = cfg.num_experts_per_tok, cfg.norm_topk_prob
        self.router = nn.Linear(D, E, bias=False, **kw)
        self.w_gate = nn.Parameter(torch.empty(E, F_, D, **kw))
        self.w_up = nn.Parameter(torch.empty(E, F_, D, **kw))
        self.w_down = nn.Parameter(torch.empty(E, D, F_, **kw))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 1/fan_in) for the router and every expert matrix."""
        init_dense_(self.router.weight, self.router.in_features, generator)
        for w in (self.w_gate, self.w_up, self.w_down):
            init_dense_(w, w.shape[-1], generator)

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, D) -> the top-k experts (N, k) int64 and their weights (N, k)
        float32."""
        scores = torch.softmax(F.linear(x.float(), self.router.weight.float()), dim=-1)
        weights, ids = torch.topk(scores, self.top_k, dim=-1)
        if self.norm_topk:
            weights = weights / weights.sum(dim=-1, keepdim=True)
        return ids, weights

    def forward(self, h: torch.Tensor, stats: Optional[torch.Tensor] = None,
                trace: bool = False) -> torch.Tensor:
        x = h.reshape(-1, h.shape[-1])
        with tracer.span("moe.route") if trace else contextlib.nullcontext():
            ids, weights = self.route(x)
        with tracer.span("moe.experts") if trace else contextlib.nullcontext():
            y = grouped_experts(x, ids, weights, self.w_gate, self.w_up, self.w_down, stats)
        return y.view(h.shape)

