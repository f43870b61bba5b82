"""The grouped-expert layer of a mixture-of-experts decoder.

``grouped_experts`` runs every token's top-k SiLU-gated experts and sums
them with the router's weights,

    y[t] = sum_j w[t, j] * down_e(silu(gate_e x[t]) * up_e x[t]),  e = ids[t, j],

on a CUDA tensor through ``csrc/grouped_experts.cu`` (route, gate-up and
down in one persistent launch, combine: three launches, no host
synchronisation, so the decode step's CUDA graph captures them), on a CPU
tensor through its plain twin
``grouped_experts_plain``. Both round silu(g) * u to the input's dtype
before the down projection, as the dense MLP does, apply the routing weight
in float32 and round each token's sum once.

The host chooses the kernel's token tile from the call's shape alone
(:func:`token_tile`); the kernel narrows its products to each expert's rows
on the device.

``stats``, when given, is an int64 (2,) tensor on the input's device to
which a call adds (experts with at least one assignment, assignments): the
engine reads it back with what it reads anyway.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from multimeditron_torch import _build

TOKEN_TILES = (16, 32, 64)  # the kernel's token tiles (wgmma's widest N)

# Launches of the CUDA entry point (the plain twin does not count), counted by
# the calls made on the host: a captured CUDA graph counts once, at capture.
# "tile<T>" counts the launches at token tile T.
launches = {"grouped_experts": 0, **{f"tile{t}": 0 for t in TOKEN_TILES}}

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


@functools.lru_cache(maxsize=None)
def token_tile(N: int, k: int, E: int) -> int:
    """Tokens a tile of the kernel (wgmma's widest N): the smallest of
    ``TOKEN_TILES`` that holds twice the mean assignments an expert, N k / E
    (routing is uneven), else the largest. A 128-slot decode step of 64
    experts, top 8, takes 32; a prefill chunk of 256 tokens or more 64."""
    want = 2 * -(-N * k // E)
    return next((t for t in TOKEN_TILES if t >= want), TOKEN_TILES[-1])


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
    if x.data_ptr() % 16:  # the kernel gathers 16-byte pieces of x's rows
        x = x.clone()
    if not all(t.is_contiguous() for t in (w_gate, w_up, w_down)):
        raise ValueError("expert weights must be contiguous")
    A, dev = N * k, x.device
    ints = dict(dtype=torch.int32, device=dev)
    # counters: the kernel's unit queue and per-expert counts (the route
    # launch zeroes them)
    counts, offsets, perm, counters = (torch.empty(E, **ints), torch.empty(E + 1, **ints),
                                       torch.empty(A, **ints), torch.empty(1 + E, **ints))
    h = torch.empty((A, F_), dtype=x.dtype, device=dev)
    ybuf = torch.empty((A, D), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    stream = _build.stream_handle(dev)
    tile = token_tile(N, k, E)
    code = _build.library().mmt_grouped_experts(
        x.data_ptr(), ids.data_ptr(), weights.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), counts.data_ptr(), offsets.data_ptr(), perm.data_ptr(),
        h.data_ptr(), ybuf.data_ptr(), counters.data_ptr(),
        None if stats is None else stats.data_ptr(), y.data_ptr(), N, D, F_, E, k, tile, stream)
    _build.check("grouped_experts", code)
    launches["grouped_experts"] += 1
    launches[f"tile{tile}"] += 1
    return y
