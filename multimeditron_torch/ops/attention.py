"""LLM attention: dispatch between the flash kernels and plain tensor ops.

Counterpart of ``multimeditron_tpu/ops/attention.py``. Dispatch rule of
:func:`attention`:

- a CUDA tensor with a scalar or absent ``causal_offset`` (the no-cache
  forward: training, scoring) goes to ``ops.flash_attention`` (kernels K1,
  K2a, K2b), at every sequence length;
- a per-sample ``causal_offset`` (B,) — the serving engine's prefill into its
  cache — stays on :func:`attention_plain`, as in the JAX package, whose
  flash kernel takes one static offset (``ops/attention.py:109-112``);
- a CPU tensor runs :func:`attention_plain`.

Contract (shared with the JAX package):
  q: (B, H, Sq, D)   k, v: (B, Hkv, Skv, D) with H % Hkv == 0 (GQA)
  kv_mask: optional (B, Skv) — nonzero for valid key/value positions
  causal: lower-triangular masking aligned to the END of the kv sequence
          when Sq != Skv, or to per-sample ``causal_offset`` (B,).
  window: with ``causal``, a query at position p sees only the keys at
          positions > p - window (a sliding-window layer); 0: all. The flash
          kernels take no window: a windowed call on the card needs a
          per-sample offset (the serving prefill), else it raises.
Returns (B, H, Sq, D) in q.dtype. Rows with no valid key return zeros.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from multimeditron_torch.ops.flash_attention import flash_attention

NEG_INF = -1e30


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    causal_offset: Optional[Union[int, torch.Tensor]] = None,
    window: int = 0,
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
            seen = q_pos[:, :, None] >= k_pos
            if window > 0:
                seen = seen & (q_pos[:, :, None] - k_pos < window)
            mask = mask & seen[:, None, None]
        else:
            q_pos = torch.arange(Sq, device=q.device) + int(offset)
            seen = q_pos[:, None] >= k_pos
            if window > 0:
                seen = seen & (q_pos[:, None] - k_pos < window)
            mask = mask & seen
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
    window: int = 0,
) -> torch.Tensor:
    """Entry point the models call; the dispatch rule is in the module
    docstring. The JAX package's 1024-key crossover was measured on a TPU,
    so no length threshold is carried over."""
    per_sample = isinstance(causal_offset, torch.Tensor) and causal_offset.dim() >= 1
    if q.device.type == "cuda" and not per_sample:
        if window > 0 and causal:
            raise NotImplementedError("the flash kernels (K1, K2) take no sliding window")
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               kv_mask=kv_mask, causal=causal, sm_scale=sm_scale,
                               causal_offset=causal_offset)
    return attention_plain(q, k, v, kv_mask=kv_mask, causal=causal,
                           sm_scale=sm_scale, causal_offset=causal_offset, window=window)
