"""Peaks of the card, and the operations and bytes that each model step and
each kernel needs.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense:
989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM. A card set
below 700 W (``nvidia-smi --query-gpu=power.limit``) runs slower; the run
prints its name and limit beside every share.

Counts follow what the inputs need, never the most they could need, so that
no share can pass 100%: padding is not counted, a causal query counts only
the keys at or before it, the lm_head counts only at positions whose logits
are used, the embedding lookup counts 0, recomputation (remat) counts 0 in
the model's FLOPs. A multiply-add is 2 operations.
"""

from __future__ import annotations

from typing import Iterable

from spec import Dims

PEAK_BF16 = 989e12  # FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16 = 2  # bytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the memory rate, whichever is longer."""
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)


def causal_pairs(n: int) -> int:
    """(query, key) pairs of a causal sequence of n tokens."""
    return n * (n + 1) // 2


# ----------------------------------------------------------------------
# Model FLOPs
# ----------------------------------------------------------------------
def attn_fwd_flops(d: Dims, pairs: int) -> float:
    """Causal attention's forward in one layer: QK^T and PV over the pairs."""
    return 4.0 * pairs * d.H * d.Dh


def tower_flops(d: Dims) -> float:
    """One image through the tower: the patch projection, each layer's
    matrices over the patches and CLS, and its attention."""
    S, Dv, Fv = d.tower_seq, d.Dv, d.Fv
    per_layer = 2.0 * S * (4 * Dv * Dv + 2 * Dv * Fv) + 4.0 * S * S * Dv
    return 2.0 * d.n_patches * d.patch ** 2 * 3 * Dv + d.Lv * per_layer


def projector_matmul_params(d: Dims) -> int:
    return d.Dv * d.Dv + d.Dv * d.D + d.D * d.D


def projector_flops(d: Dims) -> float:
    return 2.0 * d.n_patches * projector_matmul_params(d)


def prefill_flops(d: Dims, prompt_len: int, images: int) -> float:
    """One prompt's prefill: its images through the tower and projector,
    every token through the body, causal attention, and the lm_head at the
    last position only."""
    return (images * (tower_flops(d) + projector_flops(d))
            + 2.0 * d.body_params * prompt_len
            + d.L * attn_fwd_flops(d, causal_pairs(prompt_len))
            + 2.0 * d.V * d.D)


def decode_step_flops(d: Dims, n_live: int, keys: int) -> float:
    """One decode step over ``n_live`` slots attending over ``keys`` keys in
    all (each slot's new token included)."""
    return n_live * 2.0 * (d.body_params + d.V * d.D) + d.L * 4.0 * keys * d.H * d.Dh


def kv_bytes_per_token(d: Dims) -> int:
    """K and V of one token over every layer, bf16."""
    return d.L * 2 * d.Hkv * d.Dh * BF16


def decode_step_bytes(d: Dims, n_live: int, kv_tokens_read: int) -> float:
    """Every decoder weight read once (lm_head included, the embedding table
    not), the K/V of ``kv_tokens_read`` tokens read once, and each live
    slot's new K/V written."""
    weights = (d.body_params + d.V * d.D) * BF16
    return weights + (kv_tokens_read + n_live) * kv_bytes_per_token(d)


def decode_step_bound_s(d: Dims, n_live: int, keys: int, kv_tokens_read: int) -> float:
    return bound_s(decode_step_flops(d, n_live, keys),
                   decode_step_bytes(d, n_live, kv_tokens_read))


def train_step_flops(d: Dims, lens: Iterable[int], labelled: Iterable[int],
                     images: int) -> float:
    """ALIGNMENT step: the decoder's forward and its activations' backward
    (4 per parameter per token), attention forward and backward (2.5x the
    forward), the lm_head forward and backward at labelled positions, the
    frozen tower's forward and the projector's forward and backward (with
    its weight gradient: 6 per parameter per image token)."""
    lens = list(lens)
    dec = sum(4.0 * d.body_params * n + 3.5 * d.L * attn_fwd_flops(d, causal_pairs(n))
              for n in lens)
    head = 4.0 * d.V * d.D * sum(labelled)
    img = images * (tower_flops(d) + 6.0 * d.n_patches * projector_matmul_params(d))
    return dec + head + img


# ----------------------------------------------------------------------
# Kernels
# ----------------------------------------------------------------------
def k3_bound_s(d: Dims, images: int) -> float:
    """K3 (encoder attention) over ``images`` images in one layer: QK^T and
    PV over all S x S pairs of every head; q, k, v read and o written once."""
    S, Dv = d.tower_seq, d.Dv
    return bound_s(images * 4.0 * S * S * Dv, images * 4.0 * S * Dv * BF16)


def k4_bound_s(d: Dims, n_live: int, keys_sum: int, kv_tokens_read: int) -> float:
    """K4 (paged decode attention) in one layer of one step: the live
    slots' K/V read once (``kv_tokens_read`` tokens), q read and o written."""
    flops = 4.0 * keys_sum * d.H * d.Dh
    nbytes = kv_tokens_read * 2 * d.Hkv * d.Dh * BF16 + n_live * 2 * d.H * d.Dh * BF16
    return bound_s(flops, nbytes)


def flash_bounds_s(d: Dims, lens: Iterable[int]) -> dict:
    """K1 (forward), K2a (dQ), K2b (dK, dV) in one layer over rows of valid
    lengths ``lens``: causal pairs over the valid keys. K1: QK^T, PV (4 per
    pair and head dim); K2a: QK^T, dO V^T, dS K (6); K2b: QK^T, dO V^T,
    P^T dO, dS^T Q (8). Bytes: each tensor read or written once."""
    lens = list(lens)
    pairs = sum(causal_pairs(n) for n in lens)
    tok = sum(lens)
    hd = d.H * d.Dh
    kvd = d.Hkv * d.Dh
    fwd_bytes = tok * (2 * hd + 2 * kvd) * BF16 + tok * d.H * 4
    dq_bytes = tok * (3 * hd + 2 * kvd) * BF16 + tok * d.H * 8
    dkv_bytes = tok * (2 * hd + 4 * kvd) * BF16 + tok * d.H * 8
    return {"k1": bound_s(4.0 * pairs * hd, fwd_bytes),
            "k2a": bound_s(6.0 * pairs * hd, dq_bytes),
            "k2b": bound_s(8.0 * pairs * hd, dkv_bytes)}
