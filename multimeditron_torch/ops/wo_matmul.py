"""Weight-only int8 matmul (kernel K9) and the W8A8 prefill product.

Counterpart of ``multimeditron_tpu/ops/wo_matmul.py``:

- :func:`wo_matmul` computes ``x @ dequant(w_q, w_s)`` with float32
  accumulation: the int8 weight widened to the activation's type, the
  product summed in float32, each output column scaled by its float32
  scale, then one cast to ``x.dtype``. A CUDA tensor launches the CUDA
  kernel K9 (``csrc/wo_matmul.cu``); a CPU tensor runs the plain twin
  :func:`wo_matmul_plain`. Every int8 projection of the quantised decoder
  and its lm_head goes through it.
- :func:`quantize_rows` and :func:`w8a8_matmul`: the W8A8 prefill path
  (dynamic per-row int8 activations, an int8 x int8 -> int32 product, a
  per-row times per-column rescale). Plain PyTorch, as the JAX package
  leaves them to XLA; the product is ``torch._int_mm``
  (:func:`multimeditron_torch.models.vit_quant.int8_matmul`).

Weight layout: ``w_q`` is (N, K) int8, K contiguous, one row per output
column (the JAX package keeps (K, N); ``convert.py`` transposes at load
and at export). ``w_s`` holds N float32 scales.
"""

from __future__ import annotations

import functools

import torch

from multimeditron_torch import _build
from multimeditron_torch.models.vit_quant import int8_matmul

# Launches of K9, and calls of the W8A8 product (not a kernel of its own:
# counted so that a run shows where W8A8 fired), made on the host: a CUDA
# graph's replays count none.
launches = {"wo_matmul": 0, "w8a8_matmul": 0}

K_CHUNK = 64      # K values per pipeline stage of the kernel (K must be a multiple)
BLOCK_N = 128     # output columns per block of the bf16 kernel
MIN_CHUNKS = 4    # fewest K chunks a split-K slice takes
TOKEN_TILES = (8, 16, 32, 64)  # token tiles at decode and verify; 128 and 256 above


def wo_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """The twin: (..., K) x (N, K) int8 -> (..., N) in x's dtype. The
    widened weight and the product in float32 (a bf16 product is exact in
    float32), then ``* w_s`` in float32 and one cast."""
    acc = x.float() @ w_q.t().float()
    return (acc * w_s.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def token_tile(M: int) -> int:
    """Tokens a tile of the bf16 kernel (wgmma's N): the smallest of 8, 16,
    32 and 64 that holds M, else 128 up to 128 tokens and 256 above."""
    for tile in TOKEN_TILES:
        if M <= tile:
            return tile
    return 128 if M <= 128 else 256


UNIT_COST = 6  # a work unit's fixed cost (fill, drain, split sum), in K chunks


@functools.lru_cache(maxsize=None)
def split_k(M: int, K: int, N: int, sm_count: int) -> tuple:
    """(splits, chunks per split) of the bf16 kernel's K loop. The kernel's
    persistent blocks, one an SM, take the work units (token tile, column
    tile, split) in turns, so a call lasts about as many rounds of units as
    the busiest SM runs, each round a unit's K chunks plus its fixed cost
    (``UNIT_COST`` chunk times, fitted to a sweep of split counts on the
    H100): the split count (each split at least ``MIN_CHUNKS`` chunks of K,
    none empty) minimises rounds x (chunks + ``UNIT_COST``); ties keep
    fewer splits."""
    chunks = K // K_CHUNK
    tiles = -(-M // token_tile(M)) * -(-N // BLOCK_N)
    best = None
    for want in range(1, max(1, chunks // MIN_CHUNKS) + 1):
        per = -(-chunks // want)
        splits = -(-chunks // per)
        cost = -(-tiles * splits // sm_count) * (per + UNIT_COST)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def wo_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor) -> torch.Tensor:
    """``x @ (w_q * w_s)``: x (..., K) float32 or bfloat16, w_q (N, K) int8,
    w_s (N,) float32 -> (..., N) in x's dtype, float32 accumulation."""
    lead, K = x.shape[:-1], x.shape[-1]
    N = w_q.shape[0]
    if w_q.dtype != torch.int8 or w_q.shape != (N, K):
        raise ValueError(f"wo_matmul: w_q {tuple(w_q.shape)} {w_q.dtype} is not (N, {K}) int8")
    if w_s.numel() != N:
        raise ValueError(f"wo_matmul: w_s has {w_s.numel()} scales for {N} columns")
    device = x.device
    if w_q.device != device or w_s.device != device:
        raise ValueError(f"wo_matmul: tensors lie on several devices: "
                         f"{ {device, w_q.device, w_s.device} }")
    if device.type == "cpu":
        return wo_matmul_plain(x, w_q, w_s)
    if device.type != "cuda":
        raise ValueError(f"wo_matmul runs on cpu or cuda, not {device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"wo_matmul takes float32 or bfloat16 activations, got {x.dtype}")
    if K % K_CHUNK or not w_q.is_contiguous() or w_q.data_ptr() % 16:
        raise ValueError(f"wo_matmul: K={K} must be a multiple of {K_CHUNK} and w_q "
                         f"contiguous and 16-byte aligned")
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous() or x2.data_ptr() % 16:  # the kernel reads 16-byte rows by TMA
        x2 = x2.clone(memory_format=torch.contiguous_format)
    M = x2.shape[0]
    if w_s.dtype != torch.float32 or not w_s.is_contiguous():
        w_s = w_s.reshape(N).float().contiguous()
    out = torch.empty(M, N, dtype=x.dtype, device=device)
    if M == 0:
        return out.reshape(*lead, N)
    stream = _build.stream_handle(device)
    tile, splits, per = 0, 1, K // K_CHUNK
    work = counters = None
    if x.dtype == torch.bfloat16:
        tile = token_tile(M)
        splits, per = split_k(M, K, N, _sm_count(device.index or 0))
        if splits > 1:
            tiles = -(-M // tile) * -(-N // BLOCK_N)
            work = _build.workspace(device, stream, tiles * splits * tile * BLOCK_N)
            counters = _build.zeroed_counters(device, stream, tiles)
    code = _build.library().mmt_wo_matmul(
        x2.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(), M, K, N, tile, splits, per,
        _build.DTYPE_CODES[x.dtype], stream)
    _build.check("wo_matmul", code)
    launches["wo_matmul"] += 1
    return out.reshape(*lead, N)


def quantize_rows(x: torch.Tensor):
    """Dynamic per-row int8 quantisation: (..., K) -> ((..., K) int8,
    (..., 1) float32 scale) with x ~= q * scale. The row max is taken in
    x's dtype; the scale is ``1 / (127 / amax)``, as the JAX package
    computes it."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    # a true division: ``127.0 / tensor`` would be 127 * reciprocal(tensor)
    r = torch.div(torch.full_like(amax, 127.0), torch.clamp(amax, min=1e-6))
    q = torch.clamp(torch.round(x.float() * r), -127, 127).to(torch.int8)
    return q, torch.reciprocal(r)


def w8a8_matmul(x_q: torch.Tensor, x_s: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 (..., K) rows with (..., 1) scales times (N, K) int8 weights
    with (N,) scales: the exact int32 product, then ``(acc * x_s) * w_s``
    in float32 and one cast."""
    lead, K = x_q.shape[:-1], x_q.shape[-1]
    N = w_q.shape[0]
    acc = int8_matmul(x_q.reshape(-1, K), w_q)
    out = (acc.float() * x_s.reshape(-1, 1) * w_s.float().reshape(1, N)).to(out_dtype)
    launches["w8a8_matmul"] += 1
    return out.reshape(*lead, N)
