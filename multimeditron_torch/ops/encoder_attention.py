"""Non-causal encoder attention for the ViT towers (kernel K3).

Counterpart of ``multimeditron_tpu/ops/encoder_attention.py``: q, k, v and
the output stay in the projections' model layout (B, S, H*Dh); every query
attends to every key below ``kv_len``. Query rows >= ``kv_len`` are garbage
the caller drops.

``encoder_attention`` runs the CUDA kernel ``csrc/encoder_attention.cu`` on a
CUDA tensor and the plain twin ``encoder_attention_plain`` on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimeditron_torch import _build

# Launches of the CUDA kernel (the plain twin does not count).
launches = {"encoder_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int, sm_scale: float,
                            kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (the JAX ``_encoder_attention_xla``)."""
    B, S, D = q.shape
    dh = D // num_heads

    def split(x):
        return x.reshape(B, S, num_heads, dh).transpose(1, 2).float()

    s = torch.matmul(split(q), split(k).transpose(-1, -2)) * sm_scale
    if kv_len is not None and kv_len < S:
        s = torch.where(torch.arange(S, device=q.device) < kv_len, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), split(v)) / l
    return o.transpose(1, 2).reshape(B, S, D).to(q.dtype)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      num_heads: int, sm_scale: Optional[float] = None,
                      kv_len: Optional[int] = None) -> torch.Tensor:
    """Full (non-causal) attention over short sequences, (B, S, H*Dh) in/out."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (B, S, H*Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, D = q.shape
    if D % num_heads:
        raise ValueError(f"hidden {D} is not a multiple of num_heads={num_heads}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share a dtype in {_DTYPES}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    dh = D // num_heads
    if sm_scale is None:
        sm_scale = dh ** -0.5
    if kv_len is None:
        kv_len = S
    if not 1 <= kv_len <= S:
        raise ValueError(f"kv_len={kv_len} must lie in [1, {S}]")

    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, num_heads, sm_scale, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention runs on cpu or cuda, not {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("encoder_attention needs contiguous q, k, v")
    if dh % 2:
        raise ValueError(f"the kernel takes an even head dim, got {dh}")

    lib = _build.library()
    o = torch.empty_like(q)
    code = lib.mmt_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, num_heads, dh, kv_len, float(sm_scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check("encoder_attention", code)
    launches["encoder_attention"] += 1
    return o
