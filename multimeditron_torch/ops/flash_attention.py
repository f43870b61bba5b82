"""Flash attention, forward (kernel K1) and backward (kernels K2a and K2b).

Counterpart of ``multimeditron_tpu/ops/flash_attention.py``, with its
contract: q (B, H, Sq, D); k, v (B, Hkv, Skv, D) with H % Hkv == 0 (GQA,
K/V never repeated); an optional kv mask (B, Skv), nonzero for a valid key;
causal masking aligned to the END of the kv axis unless ``causal_offset``
(query position = local position + offset) is given. A query with no valid
key returns zeros and gets zero gradients; masked keys get zero dk and dv.

``flash_attention`` is a ``torch.autograd.Function``. On a CUDA tensor its
forward launches K1 (``csrc/flash_fwd.cu``), which saves o and the base-2
logsumexp ``lse``: in bf16 with at least 64 query rows on ``wgmma`` with
K/V brought in by TMA (128-row query tiles), with fewer rows (the decode
form, Sq = 1) on ``mma.sync`` (64-row tiles), in float32 on the CUDA cores.
The C entry point chooses by dtype and rows; each call counts as one K1
launch. Its backward computes ``di = rowsum(o * do)`` as a plain op, as the
JAX wrapper does, then launches K2a (dq) and K2b (dk, dv) from
``csrc/flash_bwd.cu``: bf16 on ``wgmma`` with every tile brought in by TMA
(K2a: 128-query blocks over 64-key tiles; K2b: 64-key blocks over 64-query
tiles, dV and dK in two warpgroups), float32 on the CUDA cores; the C entry
points choose by dtype, and both are deterministic (no atomics). On a CPU
tensor both directions run the plain twins
``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain``, which are
written from the kernels' math. Any other device, dtype, head dim or layout
raises.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from multimeditron_torch import _build

LOG2_E = 1.4426950408889634
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # lse of a row with no valid key
HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)

# Launches of each CUDA kernel (the plain twins do not count).
launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}


def _offset(q: torch.Tensor, k: torch.Tensor, causal_offset) -> int:
    return k.shape[2] - q.shape[2] if causal_offset is None else int(causal_offset)


def _valid(q, k, kv_mask, causal: bool, offset: int) -> torch.Tensor:
    """Bool mask broadcastable to the grouped scores (B, Hkv, G, Sq, Skv)."""
    B, Sq, Skv = q.shape[0], q.shape[2], k.shape[2]
    valid = torch.ones((1, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + offset
        valid = valid & (q_pos >= torch.arange(Skv, device=q.device)[None, :])
    if kv_mask is not None:
        valid = valid & (kv_mask.reshape(B, 1, 1, 1, Skv) != 0)
    return valid


def _grouped_scores(q, k, sm_scale: float) -> torch.Tensor:
    """Base-2 scores (B, Hkv, G, Sq, Skv) in float32, without repeating K."""
    B, H, Sq, D = q.shape
    Hkv = k.shape[1]
    qg = q.float().reshape(B, Hkv, H // Hkv * Sq, D)
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * (sm_scale * LOG2_E)
    return s.reshape(B, Hkv, H // Hkv, Sq, -1)


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None, causal: bool = True,
    sm_scale: Optional[float] = None, causal_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K1: (o in q.dtype, lse float32 (B, H, Sq), base 2)."""
    B, H, Sq, D = q.shape
    Hkv = k.shape[1]
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    valid = _valid(q, k, kv_mask, causal, _offset(q, k, causal_offset))
    s = torch.where(valid, _grouped_scores(q, k, sm_scale), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == float("-inf"), 0.0, m)
    p = torch.exp2(s - m)  # masked scores give exact zeros
    l = p.sum(dim=-1, keepdim=True)
    # p is rounded to v's dtype before the PV product, as in the kernel
    pv = torch.matmul(p.to(v.dtype).float().reshape(B, Hkv, -1, p.shape[-1]), v.float())
    o = pv.reshape(B, Hkv, H // Hkv, Sq, D) / torch.clamp(l, min=1e-30)
    o = torch.where(l > 0, o, 0.0)
    lse = torch.where(l > 0, m + torch.log2(torch.clamp(l, min=1e-30)), MASK_VALUE)
    return o.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_mask: Optional[torch.Tensor], o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True, sm_scale: Optional[float] = None,
    causal_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K2a and K2b: (dq, dk, dv) from the saved o and lse."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    sm_scale = D ** -0.5 if sm_scale is None else sm_scale
    valid = _valid(q, k, kv_mask, causal, _offset(q, k, causal_offset))
    s = _grouped_scores(q, k, sm_scale)
    lse_g = lse.float().reshape(B, Hkv, G, Sq, 1)
    p = torch.where(valid, torch.exp2(s - lse_g), 0.0)
    do_g = do.float().reshape(B, Hkv, G * Sq, D)
    di = (o.float() * do.float()).sum(dim=-1).reshape(B, Hkv, G, Sq, 1)
    dp = torch.matmul(do_g, v.float().transpose(-1, -2)).reshape(B, Hkv, G, Sq, Skv)
    ds = p * (dp - di) * sm_scale
    # p and ds are rounded to the input dtype before their products
    p_r = p.to(do.dtype).float().reshape(B, Hkv, G * Sq, Skv)
    ds_r = ds.to(q.dtype).float().reshape(B, Hkv, G * Sq, Skv)
    dv = torch.matmul(p_r.transpose(-1, -2), do_g)
    dq = torch.matmul(ds_r, k.float())
    dk = torch.matmul(ds_r.transpose(-1, -2), q.float().reshape(B, Hkv, G * Sq, D))
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


# ----------------------------------------------------------------------
# Kernel launches
# ----------------------------------------------------------------------
def _check_kernel_inputs(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous inputs")
        if t.data_ptr() % 16:
            raise ValueError("flash attention kernels need 16-byte aligned inputs")


def _mask_ptr(kv_mask: Optional[torch.Tensor]):
    return None if kv_mask is None else kv_mask.data_ptr()


def _fwd_kernel(q, k, v, kv_mask, causal, sm_scale, offset):
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    code = _build.library().mmt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(kv_mask), o.data_ptr(),
        lse.data_ptr(), B, H, Hkv, Sq, Skv, D, int(causal), offset, float(sm_scale),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check("flash_attention_fwd", code)
    launches["flash_attention_fwd"] += 1
    return o, lse


def _dq_kernel(q, k, v, kv_mask, lse, di, do, causal, sm_scale, offset):
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    code = _build.library().mmt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), _mask_ptr(kv_mask), dq.data_ptr(), B, H, Hkv, Sq, Skv, D,
        int(causal), offset, float(sm_scale), _build.DTYPE_CODES[q.dtype],
        _build.stream_handle(q.device))
    _build.check("flash_attention_bwd_dq", code)
    launches["flash_attention_bwd_dq"] += 1
    return dq


def _dkv_kernel(q, k, v, kv_mask, lse, di, do, causal, sm_scale, offset):
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = _build.library().mmt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), _mask_ptr(kv_mask), dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Sq, Skv,
        D, int(causal), offset, float(sm_scale), _build.DTYPE_CODES[q.dtype],
        _build.stream_handle(q.device))
    _build.check("flash_attention_bwd_dkv", code)
    launches["flash_attention_bwd_dkv"] += 1
    return dk, dv


def _bwd_kernel(q, k, v, kv_mask, o, lse, do, causal, sm_scale, offset):
    _check_kernel_inputs(do)
    di = (o.float() * do.float()).sum(dim=-1)  # a plain op, as in the JAX wrapper
    args = (q, k, v, kv_mask, lse, di, do, causal, sm_scale, offset)
    return (_dq_kernel(*args), *_dkv_kernel(*args))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, sm_scale, offset):
        if q.device.type == "cuda":
            o, lse = _fwd_kernel(q, k, v, kv_mask, causal, sm_scale, offset)
        else:
            o, lse = flash_attention_fwd_plain(q, k, v, kv_mask, causal, sm_scale, offset)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.sm_scale, ctx.offset = causal, sm_scale, offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        args = (ctx.causal, ctx.sm_scale, ctx.offset)
        if q.device.type == "cuda":
            dq, dk, dv = _bwd_kernel(q, k, v, kv_mask, o, lse, do.contiguous(), *args)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, *args)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    causal_offset: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Differentiable flash attention; see the module docstring for the contract."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, H, Sq, D) and k, v (B, Hkv, Skv, D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, Hkv, Skv, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if H % Hkv:
        raise ValueError(f"GQA requires H % Hkv == 0, got H={H} Hkv={Hkv}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share a dtype in {_DTYPES}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Skv):
        raise ValueError(f"kv_mask must be (B, Skv) = {(B, Skv)}, got {tuple(kv_mask.shape)}")
    if isinstance(causal_offset, torch.Tensor):
        if causal_offset.dim():
            raise ValueError("flash_attention takes one scalar causal_offset; per-sample "
                             "offsets go through ops.attention.attention_plain")
        causal_offset = int(causal_offset)
    sm_scale = D ** -0.5 if sm_scale is None else float(sm_scale)
    offset = _offset(q, k, causal_offset)

    if q.device.type == "cuda":
        if D not in HEAD_DIMS:
            raise ValueError(f"the flash kernels take head dims {HEAD_DIMS}, got {D}")
        if kv_mask is not None:
            kv_mask = kv_mask.to(device=q.device, dtype=torch.int32).contiguous()
        _check_kernel_inputs(q, k, v, *(() if kv_mask is None else (kv_mask,)))
    elif q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _FlashAttention.apply(q, k, v, kv_mask, bool(causal), sm_scale, offset)
