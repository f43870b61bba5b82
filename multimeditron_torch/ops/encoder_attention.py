"""Non-causal encoder attention for the ViT towers: kernel K3, and K10 over
int8 q, k, v.

Counterpart of ``multimeditron_tpu/ops/encoder_attention.py``: q, k, v and
the output stay in the projections' model layout (B, S, H*Dh); every query
attends to every key below ``kv_len``. Query rows >= ``kv_len`` are garbage
the caller drops.

``encoder_attention`` runs the CUDA kernel ``csrc/encoder_attention.cu`` on a
CUDA tensor and the plain twin ``encoder_attention_plain`` on a CPU tensor.
bf16 runs on the tensor cores (``mma.sync``; any even head dim up to 128,
padded with zero columns inside the kernel); float32 on the CUDA cores in
exact float32 (any even head dim).
On the card the kernel sits in a ``torch.autograd.Function`` whose backward
recomputes through the plain twin and returns its vjp, as the JAX
``custom_vjp`` recomputes through its XLA reference: the JAX package has no
backward kernel for K3, so neither has the port.

``encoder_attention_int8`` (K10, ``csrc/encoder_attention_int8.cu``) is the
counterpart of the JAX ``encoder_attention_int8``: statically quantised int8
q, k, v, both products on the int8 tensor cores. As in the JAX package,
nothing calls it yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multimeditron_torch import _build

# Launches of the CUDA kernel (the plain twin does not count).
launches = {"encoder_attention": 0, "encoder_attention_int8": 0}

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
    check_kernel_head_dim(q.dtype, dh)
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("the bf16 kernel needs 16-byte aligned q, k, v")

    return _EncoderAttention.apply(q, k, v, num_heads, float(sm_scale), kv_len)


def check_kernel_head_dim(dtype: torch.dtype, dh: int) -> None:
    """Raise unless the CUDA kernel takes head dim ``dh`` in ``dtype``."""
    if dh % 2:
        raise ValueError(f"the kernel takes an even head dim, got {dh}")
    if dtype == torch.bfloat16 and dh > 128:
        raise ValueError(f"the bf16 kernel takes a head dim up to 128, got {dh}")


def _kernel(q, k, v, num_heads: int, sm_scale: float, kv_len: int) -> torch.Tensor:
    B, S, D = q.shape
    o = torch.empty_like(q)
    code = _build.library().mmt_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, num_heads, D // num_heads, kv_len, sm_scale,
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check("encoder_attention", code)
    launches["encoder_attention"] += 1
    return o


class _EncoderAttention(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: vjp of the plain twin, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, sm_scale, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.args = (num_heads, sm_scale, kv_len)
        return _kernel(q, k, v, num_heads, sm_scale, kv_len)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            o = encoder_attention_plain(*qkv, *ctx.args)
            dq, dk, dv = torch.autograd.grad(o, qkv, do)
        return dq, dk, dv, None, None, None


def encoder_attention_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 num_heads: int, qk_scale: float, pv_scale: float,
                                 kv_len: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch twin of K10 (the JAX ``_kernel_i8``): s = (q . k) *
    qk_scale masked at ``kv_len``, p = exp(s - max), l = sum(p), p quantised
    to round(p * 127) (half to even), o = (p8 . v) * pv_scale / l. The int8
    products are exact in float32 (every partial sum is an integer below
    2^24)."""
    B, S, D = q.shape
    dh = D // num_heads

    def split(x):
        return x.reshape(B, S, num_heads, dh).transpose(1, 2).float()

    s = torch.matmul(split(q), split(k).transpose(-1, -2)) * qk_scale
    if kv_len < S:
        s = torch.where(torch.arange(S, device=q.device) < kv_len, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(torch.round(p * 127.0), split(v)) * pv_scale / l
    return o.transpose(1, 2).reshape(B, S, D).to(out_dtype)


def encoder_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                           qk_scale, pv_scale, kv_len: Optional[int] = None,
                           out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K10: encoder attention over statically quantised int8 q, k, v
    (B, S, H*Dh); qk_scale = sq sk Dh**-0.5, pv_scale = sv / 127 (float32
    values). Returns (B, S, H*Dh) in ``out_dtype``."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (B, S, H*Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.int8):
        raise ValueError("encoder_attention_int8 takes int8 q, k, v")
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be one of {_DTYPES}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    B, S, D = q.shape
    if D % num_heads:
        raise ValueError(f"hidden {D} is not a multiple of num_heads={num_heads}")
    kv_len = S if kv_len is None else kv_len
    if not 1 <= kv_len <= S:
        raise ValueError(f"kv_len={kv_len} must lie in [1, {S}]")
    qk_scale, pv_scale = (float(np.float32(x.item() if torch.is_tensor(x) else x))
                          for x in (qk_scale, pv_scale))
    if q.device.type == "cpu":
        return encoder_attention_int8_plain(q, k, v, num_heads, qk_scale, pv_scale, kv_len,
                                            out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention_int8 runs on cpu or cuda, not {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("encoder_attention_int8 needs contiguous q, k, v")
    if D // num_heads != 64:
        raise ValueError(f"encoder_attention_int8: the kernel takes head dim 64, "
                         f"got {D // num_heads}")
    o = torch.empty(B, S, D, dtype=out_dtype, device=q.device)
    code = _build.library().mmt_encoder_attention_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, num_heads, 64, kv_len,
        qk_scale, pv_scale, _build.DTYPE_CODES[out_dtype], _build.stream_handle(q.device))
    _build.check("encoder_attention_int8", code)
    launches["encoder_attention_int8"] += 1
    return o
