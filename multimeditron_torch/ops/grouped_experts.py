"""The grouped-expert layer of a mixture-of-experts decoder.

``grouped_experts`` runs every token's top-k SiLU-gated experts and sums
them with the router's weights,

    y[t] = sum_j w[t, j] * down_e(silu(gate_e x[t]) * up_e x[t]),  e = ids[t, j],

on a CUDA tensor through ``csrc/grouped_experts.cu`` (route, gate-up, down
and combine: four launches, no host synchronisation, so the decode step's
CUDA graph captures them), on a CPU tensor through its plain twin
``grouped_experts_plain``. Both round silu(g) * u to the input's dtype
before the down projection, as the dense MLP does, apply the routing weight
in float32 and round each token's sum once.

``stats``, when given, is an int64 (2,) tensor on the input's device to
which a call adds (experts with at least one assignment, assignments): the
engine reads it back with what it reads anyway.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from multimeditron_torch import _build

# Launches of the CUDA entry point (the plain twin does not count), counted by
# the calls made on the host: a captured CUDA graph counts once, at capture.
launches = {"grouped_experts": 0}

MAX_EXPERTS = 256
MAX_TOKENS = 65535  # the combine's grid rows


def grouped_experts_plain(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                          w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                          stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Loop over the experts, each on the token rows routed to it."""
    N, D = x.shape
    k = ids.shape[1]
    flat = ids.reshape(-1)
    token = torch.arange(N, device=x.device).repeat_interleave(k)
    out = torch.zeros((N * k, D), dtype=torch.float32, device=x.device)
    touched = 0
    for e in range(w_gate.shape[0]):
        rows = (flat == e).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        touched += 1
        xe = x[token[rows]].float()
        h = F.silu(xe @ w_gate[e].float().t()) * (xe @ w_up[e].float().t())
        h = h.to(x.dtype).float()
        out[rows] = (h @ w_down[e].float().t()) * weights.reshape(-1)[rows, None].float()
    if stats is not None:
        stats += torch.tensor([touched, N * k], dtype=stats.dtype, device=stats.device)
    return out.view(N, k, D).sum(dim=1).to(x.dtype)


def grouped_experts(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                    stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, D); ids (N, k) int64 experts in [0, E); weights (N, k) float32;
    w_gate, w_up (E, F, D); w_down (E, D, F) -> (N, D) in x's dtype."""
    if x.dim() != 2 or ids.dim() != 2 or ids.shape[0] != x.shape[0] \
            or weights.shape != ids.shape:
        raise ValueError(f"x (N, D), ids and weights (N, k) expected, got {tuple(x.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(weights.shape)}")
    N, D = x.shape
    E, F_, Dg = w_gate.shape
    k = ids.shape[1]
    if Dg != D or w_up.shape != w_gate.shape or w_down.shape != (E, D, F_):
        raise ValueError(f"w_gate and w_up (E, F, {D}) and w_down (E, {D}, F) expected, got "
                         f"{tuple(w_gate.shape)}, {tuple(w_up.shape)}, {tuple(w_down.shape)}")
    if stats is not None and (stats.shape != (2,) or stats.dtype != torch.int64):
        raise ValueError("stats must be an int64 (2,) tensor")
    tensors = (ids, weights, w_gate, w_up, w_down) + (() if stats is None else (stats,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("inputs, weights and stats must lie on one device")
    if x.device.type == "cpu":
        return grouped_experts_plain(x, ids, weights, w_gate, w_up, w_down, stats)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_experts runs on cpu or cuda, not {x.device}")
    if not (x.dtype == w_gate.dtype == w_up.dtype == w_down.dtype == torch.bfloat16):
        raise ValueError("the kernel takes bfloat16 inputs and weights")
    if D % 128 or F_ % 64 or not 1 <= E <= MAX_EXPERTS or not 1 <= k <= E or N > MAX_TOKENS:
        raise ValueError(f"the kernel takes D % 128 == 0, F % 64 == 0, 1 <= E <= "
                         f"{MAX_EXPERTS}, k <= E and N <= {MAX_TOKENS}, got D={D}, F={F_}, "
                         f"E={E}, k={k}, N={N}")
    if ids.dtype != torch.int64 or weights.dtype != torch.float32:
        raise ValueError("ids must be int64 and weights float32")
    x, ids, weights = x.contiguous(), ids.contiguous(), weights.contiguous()
    if not all(t.is_contiguous() for t in (w_gate, w_up, w_down)):
        raise ValueError("expert weights must be contiguous")
    A, dev = N * k, x.device
    ints = dict(dtype=torch.int32, device=dev)
    counts, offsets, perm = (torch.empty(E, **ints), torch.empty(E + 1, **ints),
                             torch.empty(A, **ints))
    h = torch.empty((A, F_), dtype=x.dtype, device=dev)
    ybuf = torch.empty((A, D), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    lib = _build.library()
    code = lib.mmt_grouped_experts(
        x.data_ptr(), ids.data_ptr(), weights.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), counts.data_ptr(), offsets.data_ptr(), perm.data_ptr(),
        h.data_ptr(), ybuf.data_ptr(), None if stats is None else stats.data_ptr(),
        y.data_ptr(), N, D, F_, E, k, _build.stream_handle(dev))
    _build.check("grouped_experts", code)
    launches["grouped_experts"] += 1
    return y
