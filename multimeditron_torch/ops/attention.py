"""Attention in plain PyTorch ops: the LLM prefill path.

Counterpart of ``multimeditron_tpu/ops/attention.py``. On the serving path
the JAX package computes prefill attention with ``attention_xla`` (per-sample
``causal_offset`` forces it, ``ops/attention.py:109-112``), outside any
Pallas kernel, so the port computes it in plain tensor ops too.

Contract (shared with the JAX package):
  q: (B, H, Sq, D)   k, v: (B, Hkv, Skv, D) with H % Hkv == 0 (GQA)
  kv_mask: optional (B, Skv) — nonzero for valid key/value positions
  causal: lower-triangular masking aligned to the END of the kv sequence
          when Sq != Skv, or to per-sample ``causal_offset`` (B,).
Returns (B, H, Sq, D) in q.dtype. Rows with no valid key return zeros.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    causal_offset: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Masked softmax attention with float32 scores and accumulation.

    GQA folds the query group into the query axis instead of repeating K/V.
    """
    B, H, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if H % Hkv:
        raise ValueError(f"GQA requires H % Hkv == 0, got H={H} Hkv={Hkv}")
    group = H // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5

    qg = q.reshape(B, Hkv, group * Sq, D)
    # float32 scores: the JAX reference uses preferred_element_type=f32
    s = torch.matmul(qg.float(), k.float().transpose(-1, -2)) * sm_scale
    s = s.reshape(B, Hkv, group, Sq, Skv)

    mask = torch.ones((B, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        offset = (Skv - Sq) if causal_offset is None else causal_offset
        k_pos = torch.arange(Skv, device=q.device)
        if isinstance(offset, torch.Tensor) and offset.dim() == 1:
            q_pos = offset.to(q.device)[:, None] + torch.arange(Sq, device=q.device)[None, :]
            mask = mask & (q_pos[:, :, None] >= k_pos)[:, None, None]
        else:
            q_pos = torch.arange(Sq, device=q.device) + int(offset)
            mask = mask & (q_pos[:, None] >= k_pos)
    if kv_mask is not None:
        mask = mask & kv_mask.bool()[:, None, None, None, :]

    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    # p is rounded to v's dtype before the PV product, as in the reference
    pv = torch.matmul(p.to(v.dtype).float().reshape(B, Hkv, group * Sq, Skv), v.float())
    out = pv.reshape(B, Hkv, group, Sq, D) / torch.clamp(l, min=1e-30)
    out = torch.where(l > 0, out, 0.0)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    causal_offset: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Entry point the models call. The serving path's prefill takes the
    plain branch on every device, as in the JAX package; the flash kernel
    (K1/K2, training and long-sequence decode) joins here when it is ported.
    """
    return attention_plain(q, k, v, kv_mask=kv_mask, causal=causal,
                           sm_scale=sm_scale, causal_offset=causal_offset)
