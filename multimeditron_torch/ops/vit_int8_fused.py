"""Fused W8A8 ViT tower: kernels K7a-K7g and their host side.

Counterpart of ``multimeditron_tpu/ops/vit_int8_fused.py``. The calibration
(``act_scales``) picks the layer body, as in the JAX package:

- (L, 8): the static softmax stabiliser (column 7). By default the
  denominator comes from the bf16-rounded p (``fuse_l``), the attention
  output is int8 (``int8_o``) and, for ``quick_gelu``, the sigmoid is the
  exp2 + approximate-reciprocal one;
- (L, 7): the same merged body with the row max taken in the kernel and a
  float attention output;
- (L, 4), the unfused calibrator's scales: a separate QKV projection (K7b)
  and the float encoder attention K3, with the exact activation.

One layer is

    K7g  qkv_attn_int8     xq -> QKV projection + int8-QK / bf16-PV attention -> o
      or K7b qkv_int8 + K3 encoder_attention                                   -> o
    K7c  oproj_ln_quant    o, x -> x' = x + dequant(quant(o) W_o) + b;  quant(ln2(x'))
    K7d  fc1_gelu_quant    xq2 -> quant(act(dequant(xq2 W_1) + b))
    K7e  fc2_res_ln_quant  hq, x' -> x'' = x' + dequant(hq W_2) + b;  quant(ln1_next(x''))

with K7a ``ln_quant`` (layer 0's ln1, quantised) once per forward. K7g's
attention has three compile-time forms (the Pallas kernel's consume paths):
``fuse_l`` with int8 or float output, the static stabiliser without
``fuse_l``, and the row max. K7f ``mlp_fused`` (K7d and K7e in one kernel)
has no caller, as in the JAX package.

Each wrapper runs its CUDA kernel (``csrc/vit_int8_*.cu``) on a CUDA tensor
and its plain PyTorch twin (``*_plain``) on a CPU tensor; nothing falls back.
Int8 weights are (N, K), K contiguous (the JAX trees keep (K, N)). Scalars
(activation scales and their reciprocals) are Python floats holding float32
values, computed on the host in float32 as the JAX package computes them, so
a forward reads the calibration from the card once, not once per layer.

Rounding follows the reference as it runs on the CPU: XLA contracts
``a * b + c`` into one fused multiply-add (the dequantise-and-bias, the
LayerNorm's affine step, the attention score's shift), so the twins compute
those in one rounding (``fma``) and the kernels with ``fmaf``. The
approximate reciprocal of the Pallas kernels (``pl.reciprocal(x,
approx=True)``) runs in interpret mode, which the CPU parity tests use, as
an exact float32 reciprocal of ``x`` rounded to bf16; the twins and the
kernels compute exactly that. The port does not pad the 257-token sequence
to 264 (a TPU sublane layout): rows are M = B * S and attention masks keys
at ``kv_len = S``.

Not ported: the flags that measured as washes on the TPU, ``bf16_qk``,
``store_p``, ``bf16_scores``, ``ph_exp2``, ``allow_packed`` and ``fast_ln``
(ROADMAP queue 2). They raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from multimeditron_torch import _build
from multimeditron_torch.models.vit import ViTConfig
from multimeditron_torch.ops.encoder_attention import encoder_attention
from multimeditron_torch.models.vit_quant import (
    Params,
    TreeBuffers,
    _quantize_weight,
    amax,
    embed_patches,
    finish,
    float_layer,
    int8_matmul,
)

# Launches of the CUDA kernels (the plain twins do not count).
# K7g's forms count apart: the (L, 8) default (fuse_l, int8 output), fuse_l
# with a float output, the static stabiliser without fuse_l, the row max.
ATTENTION_FORMS = {("fused", True): "qkv_attn_int8",
                   ("fused", False): "qkv_attn_int8_float_out",
                   ("static", False): "qkv_attn_int8_static",
                   ("rowmax", False): "qkv_attn_int8_rowmax"}
# ``qkv_project`` counts the projection kernel that every K7g form launches.
launches = {"ln_quant": 0, "qkv_int8": 0, "qkv_project": 0,
            **{n: 0 for n in ATTENTION_FORMS.values()}, "oproj_ln_quant": 0,
            "oproj_ln_quant_float": 0, "fc1_gelu_quant": 0, "fc2_res_ln_quant": 0,
            "mlp_fused": 0}

ACTIVATIONS = {"quick_gelu_approx": 0, "quick_gelu": 1, "gelu_pytorch_tanh": 2, "gelu_new": 2,
               "gelu": 3}
WIDTHS = (128, 256, 768, 1024)  # tower widths the row kernels are built for
HEAD_DIM = 64                   # the attention kernel's head dim
LOG2E = 1.4426950408889634
_UNPORTED = "is not ported (ROADMAP queue 2: the flags that measured as washes on the TPU)"


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def f32_inv(x) -> float:
    """1 / x in float32 (the JAX package's ``1.0 / scale`` on a float32 scalar)."""
    return float(np.float32(1.0) / np.float32(x))


# ----------------------------------------------------------------------
# Plain twins (the Pallas kernel bodies, in PyTorch)
# ----------------------------------------------------------------------
def _quant(h: torch.Tensor, inv_s: float) -> torch.Tensor:
    return torch.clamp(torch.round(h * inv_s), -127, 127).to(torch.int8)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add (the product
    of two float32 values is exact in float64)."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).float()


def _ln_f32(x32: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """Two-pass LayerNorm in float32; 1 / sqrt as the kernels compute it."""
    d = x32 - x32.mean(dim=-1, keepdim=True)
    var = (d * d).mean(dim=-1, keepdim=True)
    return fma(d * (1.0 / torch.sqrt(var + eps)), w.float().reshape(-1), b.float().reshape(-1))


def _dequant(acc: torch.Tensor, ws: torch.Tensor, s: float, bias: torch.Tensor) -> torch.Tensor:
    """acc * (ws * s) + b, in the Pallas kernels' association."""
    return fma(acc.float(), ws.float().reshape(-1) * s, bias.float().reshape(-1))


def activate(g: torch.Tensor, act: str) -> torch.Tensor:
    """The activations of ``_fc1_kernel`` on float32 ``g``."""
    if act == "quick_gelu_approx":
        den = (1.0 + torch.exp2(-2.4554396102104056 * g)).to(torch.bfloat16).float()
        return g * (1.0 / den)
    if act == "quick_gelu":
        return g * torch.sigmoid(1.702 * g)
    if act in ("gelu_pytorch_tanh", "gelu_new"):
        inner = fma(g * g * g, f32(0.044715), g)
        return g * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * inner)))
    if act == "gelu":
        return 0.5 * g * torch.special.erfc(-g * 0.7071067811865476)
    raise ValueError(f"Unknown activation {act!r}")


def ln_quant_plain(x, ln_w, ln_b, inv_s: float, eps: float) -> torch.Tensor:
    return _quant(_ln_f32(x.float(), ln_w, ln_b, eps), inv_s)


def res_ln_quant_plain(a8, x_res, wq, ws, bias, ln_w, ln_b, s: float, inv_s: float, eps: float):
    """K7c / K7e: x' = acc * (ws * s) + b + x_res; (x' in x_res's dtype,
    quant(LN(x')) int8)."""
    x32 = _dequant(int8_matmul(a8, wq), ws, s, bias) + x_res.float()
    return x32.to(x_res.dtype), _quant(_ln_f32(x32, ln_w, ln_b, eps), inv_s)


def fc1_gelu_quant_plain(xq, wq, ws, bias, s: float, inv_s: float, act: str) -> torch.Tensor:
    return _quant(activate(_dequant(int8_matmul(xq, wq), ws, s, bias), act), inv_s)


def _qkv_parts(xq, wq, ws, bias, s0: float) -> List[torch.Tensor]:
    """xq (M, K) int8 against wq (3, D, K): q, k and v (M, D), each
    acc * (ws * s0) + b in float32."""
    D = wq.shape[1]
    val = _dequant(int8_matmul(xq, wq.reshape(3 * D, -1)), ws, s0, bias)
    return [val[:, j * D:(j + 1) * D] for j in range(3)]


def qkv_int8_plain(xq, wq, ws, bias, s0: float, out_dtype: torch.dtype,
                   inv3: Optional[Sequence[float]] = None):
    """K7b: q, k, v (M, D) of ``_qkv_parts`` in ``out_dtype``, or quantised
    by ``inv3`` to int8."""
    parts = _qkv_parts(xq, wq, ws, bias, s0)
    if inv3 is not None:
        return tuple(_quant(x, inv) for x, inv in zip(parts, inv3))
    return tuple(x.to(out_dtype).contiguous() for x in parts)


def qkv_project_plain(xq, wq, ws, bias, s0: float, inv_q: float, inv_k: float):
    """K7g's projection: q8, k8 (M, D) int8 (quantised by inv_q, inv_k) and
    v (M, D) bf16 of ``_qkv_parts``."""
    q, k, v = _qkv_parts(xq, wq, ws, bias, s0)
    return _quant(q, inv_q), _quant(k, inv_k), v.to(torch.bfloat16)


def qkv_attn_int8_plain(xq3, wq, ws, bias, scales6: Sequence[float], num_heads: int,
                        kv_len: int, *, mode: str = "fused",
                        out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """K7g: QKV projection (q, k int8; v bf16) + attention -> (B, S, D) in
    ``out_dtype`` (int8: quantised by 1/s1). ``scales6``: s0, 1/sq, 1/sk,
    smax log2(e), sq sk sm_scale, 1/s1. ``mode``: "fused" (static
    stabiliser folded into one fma, denominator from the bf16-rounded p),
    "static" (stabiliser subtracted after the multiply, f32 denominator) or
    "rowmax" (the row's maximum as stabiliser, f32 denominator)."""
    B, S, D = xq3.shape
    H, dh = num_heads, D // num_heads
    s0, inv_q, inv_k, shift, qk_scale, inv_s1 = scales6
    a = f32(np.float32(qk_scale) * np.float32(LOG2E))
    q8, k8, v = qkv_project_plain(xq3.reshape(B * S, D), wq.reshape(3, D, D), ws, bias, s0,
                                  inv_q, inv_k)

    def heads(t):
        return t.reshape(B, S, H, dh).transpose(1, 2).float()

    # int8 q.k over dh = 64 stays below 2^24: exact in float32
    acc = heads(q8) @ heads(k8).transpose(-1, -2)
    valid = torch.arange(S, device=acc.device) < kv_len
    if mode == "fused":
        p = torch.exp2(fma(acc, a, -shift)).to(torch.bfloat16).float()
        p = torch.where(valid, p, 0.0)
        l = p.sum(dim=-1, keepdim=True)
    else:
        s = acc * a
        m = shift if mode == "static" else torch.where(valid, s, -1e30).amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp2(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        p = p.to(torch.bfloat16).float()
    inv_l = 1.0 / torch.clamp(l, min=1e-30).to(torch.bfloat16).float()
    o = ((p @ heads(v)) * inv_l).transpose(1, 2).reshape(B, S, D)
    return _quant(o, inv_s1) if out_dtype == torch.int8 else o.to(out_dtype)


def mlp_fused_plain(xq, x_res, w1, w1_s, b1, w2, w2_s, b2, ln_w, ln_b, s2: float, inv_s3: float,
                    s3: float, inv_s0n: float, eps: float, act: str):
    """K7f: the split pair K7d then K7e (fc2's int32 sum over F in chunks is
    exact, so the chunked kernel computes the same values)."""
    hq = fc1_gelu_quant_plain(xq, w1, w1_s, b1, s2, inv_s3, act)
    return res_ln_quant_plain(hq, x_res, w2, w2_s, b2, ln_w, ln_b, s3, inv_s0n, eps)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------
def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (after checking they are contiguous on one
    device); False for CPU tensors; raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return True


def _check_int8(name: str, **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.int8:
            raise ValueError(f"{name}: {key} must be int8, got {t.dtype}")


def _vec(t: torch.Tensor, n: int, name: str) -> torch.Tensor:
    t = t.reshape(-1)
    if t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} values, expected {n}")
    return t.float().contiguous()


def _check_width(name: str, D: int) -> None:
    if D not in WIDTHS:
        raise ValueError(f"{name}: the kernel is built for widths {WIDTHS}, got {D}")


def ln_quant(x: torch.Tensor, ln_w, ln_b, scale: float, eps: float) -> torch.Tensor:
    """K7a: (M, D) -> LayerNorm -> quantise by ``scale`` -> (M, D) int8."""
    M, D = x.shape
    inv_s = f32_inv(scale)
    if not _on_card("ln_quant", x, ln_w, ln_b):
        return ln_quant_plain(x, ln_w, ln_b, inv_s, eps)
    _check_width("ln_quant", D)
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"ln_quant takes float32 or bfloat16, got {x.dtype}")
    ln_w, ln_b = _vec(ln_w, D, "ln_w"), _vec(ln_b, D, "ln_b")
    out = torch.empty(M, D, dtype=torch.int8, device=x.device)
    code = _build.library().mmt_int8_ln_quant(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), out.data_ptr(), M, D, eps, inv_s,
        _build.DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    _build.check("ln_quant", code)
    launches["ln_quant"] += 1
    return out


def _res_ln_quant(name: str, a, x_res, wq, ws, bias, ln_w, ln_b, s: float, s_next: float,
                  eps: float):
    """K7c / K7e. ``a`` is int8, or (K7c's ``oproj_ln_quant_float``) a float
    o in x_res's dtype that the kernel quantises by 1/s as it stages it. An
    int8 ``a`` runs ``csrc/vit_int8_fc2.cu`` (a cluster of D / 256 blocks a
    row block, int8 wgmma + TMA), a float o ``csrc/vit_int8_rowln.cu``."""
    M, K = a.shape
    D = wq.shape[0]
    inv_s = f32_inv(s_next)
    quantise_a = name == "oproj_ln_quant_float"
    _check_int8(name, wq=wq, **({} if quantise_a else {"a8": a}))
    if wq.shape != (D, K) or x_res.shape != (M, D):
        raise ValueError(f"{name}: a {tuple(a.shape)}, wq {tuple(wq.shape)} and x_res "
                         f"{tuple(x_res.shape)} do not fit (M, K) x (D, K) -> (M, D)")
    if not _on_card(name, a, x_res, wq, ws, bias, ln_w, ln_b):
        a8 = _quant(a.float(), f32_inv(s)) if quantise_a else a
        return res_ln_quant_plain(a8, x_res, wq, ws, bias, ln_w, ln_b, s, inv_s, eps)
    _check_width(name, D)
    if K % 64:
        raise ValueError(f"{name}: K={K} is not a multiple of 64")
    if x_res.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: the residual must be float32 or bfloat16, got {x_res.dtype}")
    if quantise_a and a.dtype != x_res.dtype:
        raise ValueError(f"{name}: o must have the residual's dtype {x_res.dtype}, got {a.dtype}")
    ws, bias = _vec(ws, D, "ws"), _vec(bias, D, "bias")
    ln_w, ln_b = _vec(ln_w, D, "ln_w"), _vec(ln_b, D, "ln_b")
    x_out = torch.empty_like(x_res)
    xq = torch.empty(M, D, dtype=torch.int8, device=a.device)
    lib = _build.library()
    pointers = (a.data_ptr(), wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), x_res.data_ptr(),
                ln_w.data_ptr(), ln_b.data_ptr(), x_out.data_ptr(), xq.data_ptr(), M, K, D, f32(s))
    tail = (inv_s, eps, _build.DTYPE_CODES[x_res.dtype], _build.stream_handle(a.device))
    if quantise_a:
        code = lib.mmt_float_res_ln_quant(*pointers, f32_inv(s), *tail)
    else:
        code = lib.mmt_int8_fc2_res_ln_quant(*pointers, *tail)
    _build.check(name, code)
    launches[name] += 1
    return x_out, xq


def oproj_ln_quant(o, x_res, wq, ws, bias, ln_w, ln_b, s1: float, s2: float, eps: float):
    """K7c: x' = x_res + dequant(quant(o) @ wq) + b; returns (x' in x_res's
    dtype, quant(ln2(x'), s2) int8). ``o`` is K7g's int8 output, taken as it
    is, or a float o (K3's or K7g's float output) that the kernel quantises
    by 1/s1 as it reads it."""
    name = "oproj_ln_quant" if o.dtype == torch.int8 else "oproj_ln_quant_float"
    return _res_ln_quant(name, o, x_res, wq, ws, bias, ln_w, ln_b, s1, s2, eps)


def fc2_res_ln_quant(hq, x_res, wq, ws, bias, ln_w, ln_b, s3: float, s0_next: float,
                     eps: float):
    """K7e: x'' = x_res + dequant(hq @ wq) + b; returns (x'', quant of the
    next layer's ln1(x'') by s0_next)."""
    return _res_ln_quant("fc2_res_ln_quant", hq, x_res, wq, ws, bias, ln_w, ln_b, s3, s0_next,
                         eps)


def fc1_gelu_quant(xq, wq, ws, bias, s2: float, s3: float, act: str) -> torch.Tensor:
    """K7d: quant(act(xq @ wq * ws * s2 + b), s3) -> (M, N) int8
    (``csrc/vit_int8_fc1.cu``, persistent int8 wgmma + TMA)."""
    M, K = xq.shape
    N = wq.shape[0]
    if act not in ACTIVATIONS:
        raise ValueError(f"Unknown activation {act!r}")
    _check_int8("fc1_gelu_quant", xq=xq, wq=wq)
    if wq.shape != (N, K):
        raise ValueError(f"fc1_gelu_quant: wq {tuple(wq.shape)} is not (N, {K})")
    inv_s = f32_inv(s3)
    if not _on_card("fc1_gelu_quant", xq, wq, ws, bias):
        return fc1_gelu_quant_plain(xq, wq, ws, bias, s2, inv_s, act)
    if K % 64 or N % 128:
        raise ValueError(f"fc1_gelu_quant: K={K} must be a multiple of 64 and N={N} of 128")
    ws, bias = _vec(ws, N, "ws"), _vec(bias, N, "bias")
    out = torch.empty(M, N, dtype=torch.int8, device=xq.device)
    code = _build.library().mmt_int8_fc1_act_quant(
        xq.data_ptr(), wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), out.data_ptr(), M, K, N,
        f32(s2), inv_s, ACTIVATIONS[act], _build.stream_handle(xq.device))
    _build.check("fc1_gelu_quant", code)
    launches["fc1_gelu_quant"] += 1
    return out


def qkv_int8(xq, wq, ws, bias, s0: float, *, out_dtype: torch.dtype = torch.bfloat16,
             qkv_scales: Optional[Sequence[float]] = None):
    """K7b: xq (M, K) int8 @ wq (3, D, K) -> three (M, D) tensors q, k, v,
    each acc * (ws * s0) + b in ``out_dtype``; with ``qkv_scales`` (static
    q, k, v activation scales) each is quantised to int8 at its scale."""
    M, K = xq.shape
    D = wq.shape[1]
    _check_int8("qkv_int8", xq=xq, wq=wq)
    if wq.shape != (3, D, K):
        raise ValueError(f"qkv_int8: wq {tuple(wq.shape)} is not (3, D, {K})")
    inv3 = None if qkv_scales is None else [f32_inv(x) for x in qkv_scales]
    out_dtype = torch.int8 if inv3 is not None else out_dtype
    if not _on_card("qkv_int8", xq, wq, ws, bias):
        return qkv_int8_plain(xq, wq, ws, bias, s0, out_dtype, inv3)
    codes = {**_build.DTYPE_CODES, torch.int8: 2}
    if out_dtype not in codes:
        raise ValueError(f"qkv_int8: out_dtype must be float32, bfloat16 or int8, got {out_dtype}")
    if K % 64 or D % 128:
        raise ValueError(f"qkv_int8: K={K} must be a multiple of 64 and D={D} of 128")
    ws, bias = _vec(ws, 3 * D, "ws"), _vec(bias, 3 * D, "bias")
    q, k, v = (torch.empty(M, D, dtype=out_dtype, device=xq.device) for _ in range(3))
    inv_q, inv_k, inv_v = inv3 if inv3 is not None else (1.0, 1.0, 1.0)
    code = _build.library().mmt_int8_qkv_split(
        xq.data_ptr(), wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), M, K, D, f32(s0), inv_q, inv_k, inv_v, codes[out_dtype],
        _build.stream_handle(xq.device))
    _build.check("qkv_int8", code)
    launches["qkv_int8"] += 1
    return q, k, v


def _qkv_project(xq, wq, ws, bias, s0: float, inv_q: float, inv_k: float):
    """K7g's projection alone (``qkv_attn_int8`` launches it before the
    attention): xq (M, D) int8 @ wq (3, D, D) -> q8, k8 (M, D) int8 and v
    (M, D) bf16, in ``csrc/vit_int8_gemm.cu``'s persistent int8 wgmma + TMA
    kernel on the card, by ``qkv_project_plain`` on the CPU."""
    M, D = xq.shape
    _check_int8("qkv_project", xq=xq, wq=wq)
    if wq.numel() != 3 * D * D:
        raise ValueError(f"qkv_project: wq {tuple(wq.shape)} is not (3, {D}, {D})")
    if not _on_card("qkv_project", xq, wq, ws, bias):
        return qkv_project_plain(xq, wq.reshape(3, D, D), ws, bias, s0, inv_q, inv_k)
    if D % 128:
        raise ValueError(f"qkv_project: width {D} must be a multiple of 128")
    ws, bias = _vec(ws, 3 * D, "ws"), _vec(bias, 3 * D, "bias")
    q8 = torch.empty(M, D, dtype=torch.int8, device=xq.device)
    k8 = torch.empty_like(q8)
    v = torch.empty(M, D, dtype=torch.bfloat16, device=xq.device)
    code = _build.library().mmt_int8_qkv_project(
        xq.data_ptr(), wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), q8.data_ptr(),
        k8.data_ptr(), v.data_ptr(), M, D, D, f32(s0), inv_q, inv_k,
        _build.stream_handle(xq.device))
    _build.check("qkv_project", code)
    launches["qkv_project"] += 1
    return q8, k8, v


def qkv_attn_int8(xq3, wq, ws, bias, scales6: Sequence[float], num_heads: int, kv_len: int,
                  *, static_smax: bool = True, fuse_l: bool = True,
                  out_dtype: torch.dtype = torch.int8, bf16_qk: bool = False,
                  store_p: bool = False, bf16_scores: bool = False, ph_exp2: bool = False,
                  allow_packed: bool = False) -> torch.Tensor:
    """K7g: xq3 (B, S, D) int8 -> QKV projection and attention -> (B, S, D)
    in ``out_dtype`` (int8: quantised by 1/s1). ``wq`` (3, D, D) int8 (q, k,
    v output rows), ``ws`` and ``bias`` 3 * D floats; ``scales6`` as in the
    plain twin. The consume path follows the JAX gating: ``fuse_l`` holds
    only with ``static_smax`` and a head dim below 128, and an int8 output
    needs it; without ``static_smax`` the row max is the stabiliser."""
    if bf16_qk or store_p or bf16_scores or ph_exp2 or allow_packed:
        raise NotImplementedError(f"qkv_attn_int8's bf16_qk, store_p, bf16_scores, ph_exp2 and "
                                  f"allow_packed {_UNPORTED}")
    B, S, D = xq3.shape
    _check_int8("qkv_attn_int8", xq3=xq3, wq=wq)
    if wq.numel() != 3 * D * D or D % num_heads:
        raise ValueError(f"qkv_attn_int8: wq {tuple(wq.shape)} is not (3, {D}, {D}) or "
                         f"{num_heads} heads do not divide {D}")
    if not 1 <= kv_len <= S:
        raise ValueError(f"kv_len={kv_len} must lie in [1, {S}]")
    fuse_l = fuse_l and static_smax and D // num_heads < 128
    if out_dtype == torch.int8 and not fuse_l:
        raise ValueError(
            "qkv_attn_int8: int8 out_dtype requires the fuse_l consume path after effective "
            f"flag gating; got effective fuse_l={fuse_l} (static_smax={static_smax})")
    mode = "fused" if fuse_l else ("static" if static_smax else "rowmax")
    name = ATTENTION_FORMS[mode, out_dtype == torch.int8]
    scales6 = [f32(x) for x in (scales6.tolist() if torch.is_tensor(scales6) else scales6)]
    if not _on_card(name, xq3, wq, ws, bias):
        return qkv_attn_int8_plain(xq3, wq, ws, bias, scales6, num_heads, kv_len, mode=mode,
                                   out_dtype=out_dtype)
    if D // num_heads != HEAD_DIM:
        raise ValueError(f"qkv_attn_int8: the kernel takes head dim {HEAD_DIM}, "
                         f"got {D // num_heads}")
    if D % 64 or (3 * D) % 128:
        raise ValueError(f"qkv_attn_int8: width {D} must be a multiple of 128")
    if out_dtype != torch.int8 and out_dtype not in _build.DTYPE_CODES:
        raise ValueError(f"qkv_attn_int8: out_dtype must be int8, float32 or bfloat16, "
                         f"got {out_dtype}")
    s0, inv_q, inv_k, shift, qk_scale, inv_s1 = scales6
    q8, k8, v = _qkv_project(xq3.view(B * S, D), wq, ws, bias, s0, inv_q, inv_k)
    o = torch.empty(B, S, D, dtype=out_dtype, device=xq3.device)
    code = _build.library().mmt_int8_attention(
        q8.data_ptr(), k8.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, num_heads, HEAD_DIM,
        kv_len, f32(np.float32(qk_scale) * np.float32(LOG2E)), shift, inv_s1,
        ("fused", "static", "rowmax").index(mode),
        2 if out_dtype == torch.int8 else _build.DTYPE_CODES[out_dtype],
        _build.stream_handle(xq3.device))
    _build.check(f"{name} (attention)", code)
    launches[name] += 1
    return o


def mlp_fused(xq, x_res, w1, w1_s, b1, w2, w2_s, b2, ln_w, ln_b, s2: float, s3: float,
              s0_next: float, eps: float, act: str):
    """K7f: fc1 -> act -> quant -> fc2 -> residual -> LN -> quant in one
    kernel (the int8 hidden stays in shared memory); a drop-in for
    fc1_gelu_quant + fc2_res_ln_quant. xq (M, D) int8, w1 (F, D), w2 (D, F)
    int8. Returns (x'' in x_res's dtype, xq_next int8). Nothing calls it, as
    in the JAX package; the approximate sigmoid is refused, as there."""
    M, D = xq.shape
    F = w1.shape[0]
    if act not in ACTIVATIONS or act == "quick_gelu_approx":
        raise ValueError(f"Unknown activation {act!r}")
    _check_int8("mlp_fused", xq=xq, w1=w1, w2=w2)
    if w1.shape != (F, D) or w2.shape != (D, F) or x_res.shape != (M, D):
        raise ValueError(f"mlp_fused: xq {tuple(xq.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)} and x_res {tuple(x_res.shape)} do not fit")
    inv_s3, inv_s0n = f32_inv(s3), f32_inv(s0_next)
    if not _on_card("mlp_fused", xq, x_res, w1, w1_s, b1, w2, w2_s, b2, ln_w, ln_b):
        return mlp_fused_plain(xq, x_res, w1, w1_s, b1, w2, w2_s, b2, ln_w, ln_b, s2, inv_s3,
                               s3, inv_s0n, eps, act)
    _check_width("mlp_fused", D)
    if F % 128:
        raise ValueError(f"mlp_fused: F={F} is not a multiple of 128")
    if x_res.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"mlp_fused: the residual must be float32 or bfloat16, got {x_res.dtype}")
    w1_s, b1 = _vec(w1_s, F, "w1_s"), _vec(b1, F, "b1")
    w2_s, b2 = _vec(w2_s, D, "w2_s"), _vec(b2, D, "b2")
    ln_w, ln_b = _vec(ln_w, D, "ln_w"), _vec(ln_b, D, "ln_b")
    x_out = torch.empty_like(x_res)
    xq_out = torch.empty(M, D, dtype=torch.int8, device=xq.device)
    code = _build.library().mmt_int8_mlp_fused(
        xq.data_ptr(), x_res.data_ptr(), w1.data_ptr(), w1_s.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), w2_s.data_ptr(), b2.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
        x_out.data_ptr(), xq_out.data_ptr(), M, D, F, f32(s2), inv_s3, f32(s3), inv_s0n, eps,
        ACTIVATIONS[act], _build.DTYPE_CODES[x_res.dtype], _build.stream_handle(xq.device))
    _build.check("mlp_fused", code)
    launches["mlp_fused"] += 1
    return x_out, xq_out


# ----------------------------------------------------------------------
# Host side: smoothing, calibration, packing, forward
# ----------------------------------------------------------------------
def pack_vit_int8_fused(params: Params) -> Params:
    """Pack a float tower tree into the fused layout (leading axis L):
    wqkv_q (L, 3, D, D) int8 [(out, in)], wqkv_s / qkv_b (L, 3, 1, D);
    wo_q (L, D, D), w1_q (L, F, D), w2_q (L, D, F) int8 with their (L, 1, N)
    scales and float32 biases; the LayerNorm vectors, and ln1n = ln1 rolled by
    -1 (the next layer's). Non-layer leaves are carried through."""
    lp = params["layers"]

    def qstack(key):
        q, s = _quantize_weight(lp[key])  # (L, K, N), (L, 1, N)
        return q.transpose(-1, -2).contiguous(), s

    def b(key):
        return lp[key].float()[:, None, :]

    (q_q, q_s), (k_q, k_s), (v_q, v_s) = qstack("q_proj"), qstack("k_proj"), qstack("v_proj")
    o_q, o_s = qstack("o_proj")
    f1_q, f1_s = qstack("fc1")
    f2_q, f2_s = qstack("fc2")
    packed = {
        "wqkv_q": torch.stack([q_q, k_q, v_q], dim=1),
        "wqkv_s": torch.stack([q_s, k_s, v_s], dim=1),
        "qkv_b": torch.stack([b("q_bias"), b("k_bias"), b("v_bias")], dim=1),
        "wo_q": o_q, "wo_s": o_s, "o_b": b("o_bias"),
        "w1_q": f1_q, "w1_s": f1_s, "b1": b("fc1_bias"),
        "w2_q": f2_q, "w2_s": f2_s, "b2": b("fc2_bias"),
        "ln1_w": lp["ln1_w"], "ln1_b": lp["ln1_b"],
        "ln2_w": lp["ln2_w"], "ln2_b": lp["ln2_b"],
        "ln1n_w": torch.roll(lp["ln1_w"], -1, dims=0),
        "ln1n_b": torch.roll(lp["ln1_b"], -1, dims=0),
    }
    packed.update((k, v) for k, v in params.items() if k != "layers")
    return packed


@torch.no_grad()
def calibrate_vit_int8_fused(params: Params, cfg: ViTConfig, pixel_values: torch.Tensor,
                             margin: float = 1.1) -> torch.Tensor:
    """Float calibration forward (the port's tower with K3) recording each
    layer's static scales at seven points [ln1 out, attention out, ln2 out,
    activation out, q, k, v] and, in column 7, the layer's maximum attention
    logit (q.k * sm_scale, natural-log domain, + 2.0 margin) that the
    attention kernel uses as its static stabiliser: (L, 8) float32. The
    logit max is taken one image at a time ((H, S, S), not (B, H, S, S)), so
    memory stays flat in B."""
    B = pixel_values.shape[0]
    Hn, dh = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    x = embed_patches(params, cfg, pixel_values)
    S = x.shape[1]
    stats, smax = [], []
    for i in range(cfg.num_layers):
        x, t = float_layer(params["layers"], i, cfg, x)
        stats.append(torch.stack([amax(t[k]) for k in ("h1", "o", "h2", "g", "q", "k", "v")]))
        qh = t["q"].float().reshape(B, S, Hn, dh)
        kh = t["k"].float().reshape(B, S, Hn, dh)
        per_image = [torch.einsum("shd,thd->hst", qh[b], kh[b]).amax() for b in range(B)]
        smax.append(torch.stack(per_image).amax() * dh ** -0.5)
    scales = torch.clamp(torch.stack(stats) * margin / 127.0, min=1e-8)
    return torch.cat([scales, torch.stack(smax)[:, None] + 2.0], dim=1)


@torch.no_grad()
def smooth_vit_params(params: Params, cfg: ViTConfig, pixel_values: torch.Tensor,
                      alpha: float = 0.65, clip: tuple = (0.0625, 16.0)) -> Params:
    """SmoothQuant-style outlier migration (the JAX ``smooth_vit_params``):
    four exact folds of per-channel factors, ln1 -> q/k/v, q <-> k, v -> o and
    ln2 -> fc1, measured on ``pixel_values``. Folded leaves are float32 (a
    bf16 re-rounding of large fold factors costs ~5e-3 cosine); the others
    keep their dtype. Call before calibrating and packing."""
    x = embed_patches(params, cfg, pixel_values)

    def camax(h):  # per-channel max |h| over images and tokens
        return h.float().abs().amax(dim=(0, 1))

    c1, qc, kc, oc, c2 = [], [], [], [], []
    for i in range(cfg.num_layers):
        x, t = float_layer(params["layers"], i, cfg, x)
        for acc, key in ((c1, "h1"), (qc, "q"), (kc, "k"), (oc, "o"), (c2, "h2")):
            acc.append(camax(t[key]))
    c1, qc, kc, oc, c2 = (torch.stack(c) for c in (c1, qc, kc, oc, c2))

    lp = dict(params["layers"])
    eps = 1e-6

    def rowmax(*keys):  # (L, in): max |w| over the output columns of each input row
        return torch.stack([lp[k].float().abs().amax(dim=-1) for k in keys]).amax(dim=0)

    def factor(c_act, c_w):
        s = (torch.pow(torch.clamp(c_act, min=eps), alpha)
             / torch.pow(torch.clamp(c_w, min=eps), 1.0 - alpha))
        s = s / torch.exp(torch.mean(torch.log(s), dim=-1, keepdim=True))
        return torch.clamp(s, clip[0], clip[1])

    def scale_rows(key, s):  # w (L, in, out): input channels
        lp[key] = lp[key].float() * s[:, :, None]

    def scale_cols(key, bkey, s):  # output channels and their bias
        lp[key] = lp[key].float() * s[:, None, :]
        lp[bkey] = lp[bkey].float() * s

    def scale_vec(key, s):
        lp[key] = lp[key].float() * s

    s1 = factor(c1, rowmax("q_proj", "k_proj", "v_proj"))  # 1. ln1 -> qkv
    scale_vec("ln1_w", 1.0 / s1)
    scale_vec("ln1_b", 1.0 / s1)
    for key in ("q_proj", "k_proj", "v_proj"):
        scale_rows(key, s1)
    t = torch.clamp(torch.sqrt(torch.clamp(qc, min=eps) / torch.clamp(kc, min=eps)),
                    clip[0], clip[1])  # 2. q/k range balance
    scale_cols("q_proj", "q_bias", 1.0 / t)
    scale_cols("k_proj", "k_bias", t)
    so = factor(oc, rowmax("o_proj"))  # 3. v -> o
    scale_cols("v_proj", "v_bias", 1.0 / so)
    scale_rows("o_proj", so)
    s2 = factor(c2, rowmax("fc1"))  # 4. ln2 -> fc1
    scale_vec("ln2_w", 1.0 / s2)
    scale_vec("ln2_b", 1.0 / s2)
    scale_rows("fc1", s2)
    return {**params, "layers": lp}


def layer_scalars(act_scales: torch.Tensor, cfg: ViTConfig,
                  int8_o: bool = True) -> List[Dict[str, Any]]:
    """Per-layer float32 scalars of the fused forward, computed on the host
    in float32 as the JAX package does, from an (L, 4), (L, 7) or (L, 8)
    calibration. ``merged`` (7 columns or more): the layer runs K7g, with
    ``scales6`` = [s0, 1/sq, 1/sk, smax log2(e), sq sk sm_scale, 1/s1 or
    sv/127 without ``int8_o``]; ``static_smax`` (8 columns): column 7 is
    the static stabiliser, else the column is zero (the JAX pad) and the
    kernel takes the row max. Otherwise the layer runs K7b and K3."""
    sc = act_scales.detach().float().cpu().numpy().astype(np.float32)
    if sc.ndim != 2 or sc.shape[1] not in (4, 7, 8):
        raise ValueError(f"act_scales of shape {tuple(sc.shape)}: expected (L, 4), (L, 7) or "
                         f"(L, 8)")
    merged, static_smax = sc.shape[1] >= 7, sc.shape[1] >= 8
    if not static_smax:
        sc = np.concatenate([sc, np.zeros((sc.shape[0], 8 - sc.shape[1]), np.float32)], axis=1)
    sm_scale = np.float32((cfg.hidden_size // cfg.num_heads) ** -0.5)
    one, log2e = np.float32(1.0), np.float32(LOG2E)
    L = sc.shape[0]
    out = []
    for i, r in enumerate(sc):
        row5 = one / r[1] if int8_o else r[6] / np.float32(127.0)
        out.append(dict(
            s0=float(r[0]), s1=float(r[1]), s2=float(r[2]), s3=float(r[3]),
            s0_next=float(sc[(i + 1) % L, 0]), merged=merged, static_smax=static_smax,
            scales6=(float(r[0]), float(one / r[4]), float(one / r[5]), float(r[7] * log2e),
                     float(r[4] * r[5] * sm_scale), float(row5)) if merged else None))
    return out


def vit_forward_int8_fused(packed: Params, cfg: ViTConfig, pixel_values: torch.Tensor,
                           act_scales: torch.Tensor, drop_cls: bool = True, *,
                           scalars: Optional[List[Dict[str, Any]]] = None,
                           approx_gelu: bool = True, int8_o: bool = True, fuse_l: bool = True,
                           bf16_qk: bool = False, store_p: bool = False,
                           bf16_scores: bool = False, ph_exp2: bool = False,
                           fast_ln: bool = False) -> torch.Tensor:
    """The fused W8A8 tower on NHWC ``pixel_values`` -> (B, N[, +1], D).
    ``scalars``: :func:`layer_scalars` of ``act_scales`` (with ``int8_o``),
    precomputed (else read from ``act_scales`` here, one device-to-host
    copy). The layer body follows the calibration's shape, as in the JAX
    package: (L, 7) and (L, 8) run K7g (int8 output only with ``int8_o``,
    the static stabiliser and ``fuse_l``), (L, 4) runs K7b, K3 and K7d with
    the exact activation."""
    if bf16_qk or store_p or bf16_scores or ph_exp2 or fast_ln:
        raise NotImplementedError(f"vit_forward_int8_fused's bf16_qk, store_p, bf16_scores, "
                                  f"ph_exp2 and fast_ln {_UNPORTED}")
    scalars = scalars if scalars is not None else layer_scalars(act_scales, cfg, int8_o)
    eps, D, H = cfg.layer_norm_eps, cfg.hidden_size, cfg.num_heads
    approx = ("quick_gelu_approx" if approx_gelu and cfg.hidden_act == "quick_gelu"
              else cfg.hidden_act)
    x = embed_patches(packed, cfg, pixel_values)
    B, S, _ = x.shape
    M = B * S
    x2d = x.reshape(M, D).contiguous()
    xq = ln_quant(x2d, packed["ln1_w"][0], packed["ln1_b"][0], scalars[0]["s0"], eps)
    for i, sc in enumerate(scalars):
        wqkv, wqkv_s, qkv_b = packed["wqkv_q"][i], packed["wqkv_s"][i], packed["qkv_b"][i]
        if sc["merged"]:
            use_int8_o = int8_o and sc["static_smax"] and fuse_l and D // H < 128
            o = qkv_attn_int8(xq.view(B, S, D), wqkv, wqkv_s, qkv_b, sc["scales6"], H, S,
                              static_smax=sc["static_smax"], fuse_l=fuse_l,
                              out_dtype=torch.int8 if use_int8_o else x2d.dtype)
            act = approx
        else:
            q, k, v = qkv_int8(xq, wqkv, wqkv_s, qkv_b, sc["s0"], out_dtype=x2d.dtype)
            o = encoder_attention(q.view(B, S, D), k.view(B, S, D), v.view(B, S, D), H, kv_len=S)
            act = cfg.hidden_act
        xp, xq2 = oproj_ln_quant(o.view(M, D), x2d, packed["wo_q"][i], packed["wo_s"][i],
                                 packed["o_b"][i], packed["ln2_w"][i], packed["ln2_b"][i],
                                 sc["s1"], sc["s2"], eps)
        hq = fc1_gelu_quant(xq2, packed["w1_q"][i], packed["w1_s"][i], packed["b1"][i],
                            sc["s2"], sc["s3"], act)
        x2d, xq = fc2_res_ln_quant(hq, xp, packed["w2_q"][i], packed["w2_s"][i],
                                   packed["b2"][i], packed["ln1n_w"][i], packed["ln1n_b"][i],
                                   sc["s3"], sc["s0_next"], eps)
    return finish(packed, cfg, x2d.view(B, S, D), drop_cls)


_LN_LEAVES = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "ln1n_w", "ln1n_b")


class ViTInt8Fused(nn.Module):
    """The fused W8A8 tower as a module: the packed tree as buffers (the
    LayerNorm vectors in float32, as the kernels read them), the (L, 4),
    (L, 7) or (L, 8) calibration, and its host scalars. It holds no parameters and takes no
    gradient; ``forward`` is :func:`vit_forward_int8_fused`."""

    def __init__(self, cfg: ViTConfig, packed: Params, act_scales: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.packed = TreeBuffers({k: v.float() if k in _LN_LEAVES else v
                                   for k, v in packed.items()})
        self.register_buffer("act_scales", act_scales.float(), persistent=False)
        self.scalars = layer_scalars(act_scales, cfg)

    def tree(self) -> Params:
        return self.packed.tree()

    def forward(self, pixel_values: torch.Tensor, drop_cls: bool = True) -> torch.Tensor:
        return vit_forward_int8_fused(self.tree(), self.cfg, pixel_values, self.act_scales,
                                      drop_cls, scalars=self.scalars)
