"""Peaks of the card, and the operations and bytes that each model step and
each kernel needs.

The decoder's counts are its architecture's (``arch/<name>.py``, see
``spec.Dims``): per kind of layer, summed over the layers of that kind.

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

from typing import Iterable, Optional, Sequence, Tuple

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
# Model FLOPs and bytes: the architecture's per-layer counts (spec.Dims),
# summed over its kinds of layer
# ----------------------------------------------------------------------
def attn_fwd_flops(d: Dims, n: int) -> float:
    """Causal attention's forward over an n-token sequence in every layer:
    QK^T and PV over each layer's pairs."""
    return float(sum(k * d.pair_flops(i) * d.pairs(i, n) for i, k in d.kinds()))


def attended(d: Dims, i: int, n: int) -> int:
    """Keys the last token of an n-token sequence attends in layer i."""
    return d.pairs(i, n) - d.pairs(i, n - 1)


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
            + attn_fwd_flops(d, prompt_len)
            + 2.0 * d.V * d.D)


def step_keys(d: Dims, i: int, lens: Sequence[int],
              shared: Sequence[Tuple[int, int, int]] = ()) -> Tuple[int, int]:
    """(keys attended, K/V tokens read) in layer i by one decode step over
    slots holding ``lens`` keys each, its new token included. ``shared``:
    (slots beyond the first, prefix tokens, keys) of each forked group whose
    shared prefix pages are read once: the part of that prefix the layer
    attends is read once for the group."""
    keys = sum(attended(d, i, n) for n in lens)
    read = keys - sum(extra * max(0, prefix - (n - attended(d, i, n)))
                      for extra, prefix, n in shared)
    return keys, read


def decode_step_flops(d: Dims, lens: Sequence[int]) -> float:
    """One decode step over live slots holding ``lens`` keys each (each
    slot's new token included)."""
    attn = sum(k * d.pair_flops(i) * step_keys(d, i, lens)[0] for i, k in d.kinds())
    return len(lens) * 2.0 * (d.body_params + d.V * d.D) + attn


def kv_bytes_per_token(d: Dims) -> int:
    """K and V of one token over every layer, bf16."""
    return sum(k * d.kv_bytes(i) for i, k in d.kinds())


def decode_step_bytes(d: Dims, lens: Sequence[int], shared: Sequence[Tuple[int, int, int]] = (),
                      counts: Optional[dict] = None) -> float:
    """The weights the step reads (``counts``: the program's report of the
    step, where the architecture reads only some), the K/V each layer reads
    once, and each live slot's new K/V written."""
    kv = sum(k * (step_keys(d, i, lens, shared)[1] + len(lens)) * d.kv_bytes(i)
             for i, k in d.kinds())
    return d.decode_weight_bytes(counts) + kv


def decode_step_bound_s(d: Dims, lens: Sequence[int],
                        shared: Sequence[Tuple[int, int, int]] = (),
                        counts: Optional[dict] = None) -> float:
    return bound_s(decode_step_flops(d, lens), decode_step_bytes(d, lens, shared, counts))


def train_step_flops(d: Dims, lens: Iterable[int], labelled: Iterable[int],
                     images: int) -> float:
    """ALIGNMENT step: the decoder's forward and its activations' backward
    (4 per parameter per token), attention forward and backward (2.5x the
    forward), the lm_head forward and backward at labelled positions, the
    frozen tower's forward and the projector's forward and backward (with
    its weight gradient: 6 per parameter per image token)."""
    lens = list(lens)
    dec = sum(4.0 * d.body_params * n + 3.5 * attn_fwd_flops(d, n) for n in lens)
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


def k4_step_bound_s(d: Dims, lens: Sequence[int],
                    shared: Sequence[Tuple[int, int, int]] = ()) -> float:
    """K4 over every layer of one decode step (one launch a layer)."""
    return sum(k * k4_bound_s(d, len(lens), *step_keys(d, i, lens, shared))
               for i, k in d.kinds())


def flash_bounds_s(d: Dims, lens: Iterable[int], layer: int = 0) -> dict:
    """K1 (forward), K2a (dQ), K2b (dK, dV) in one layer (``layer``'s kind)
    over rows of valid lengths ``lens``: causal pairs over the valid keys.
    K1: QK^T, PV (4 per pair and head dim); K2a: QK^T, dO V^T, dS K (6);
    K2b: QK^T, dO V^T, P^T dO, dS^T Q (8). Bytes: each tensor read or
    written once."""
    lens = list(lens)
    pairs = sum(d.pairs(layer, n) for n in lens)
    tok = sum(lens)
    hd = d.H * d.Dh
    kvd = d.Hkv * d.Dh
    fwd_bytes = tok * (2 * hd + 2 * kvd) * BF16 + tok * d.H * 4
    dq_bytes = tok * (3 * hd + 2 * kvd) * BF16 + tok * d.H * 8
    dkv_bytes = tok * (2 * hd + 4 * kvd) * BF16 + tok * d.H * 8
    return {"k1": bound_s(4.0 * pairs * hd, fwd_bytes),
            "k2a": bound_s(6.0 * pairs * hd, dq_bytes),
            "k2b": bound_s(8.0 * pairs * hd, dkv_bytes)}
