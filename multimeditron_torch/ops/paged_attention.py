"""Paged + ring decode attention and the ring fold (kernels K4 and K5).

Counterpart of ``multimeditron_tpu/ops/paged_attention.py``. The serving
engine splits the decode KV cache in two:

- PAGES ``(L, Hkv, n_pages, P, D)`` hold the tokens that existed when the
  current decode chunk started (prompt + earlier chunks), read through each
  slot's ``page_table (B, pages_max)``; page 0 is the trash page, never
  allocated to a slot;
- a small RING ``(L, B, Hkv, T, D)`` holds the tokens generated within the
  chunk: step t writes row t.

``ring_decode_attention`` computes one step's attention over [pages, ring]
per slot; at the end of the chunk ``fold_ring_into_pages`` moves the ring
rows into the pages, in place. On a CUDA tensor each runs its kernel
(``csrc/ring_decode.cu``, ``csrc/fold_ring.cu``); on a CPU tensor its plain
twin (``*_plain``, the JAX ``*_xla`` references).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimeditron_torch import _build

# Launches of the CUDA kernels (the plain twins do not count).
launches = {"ring_decode_attention": 0, "fold_ring_into_pages": 0}

MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
_DTYPES = (torch.float32, torch.bfloat16)


# ======================================================================
# K4: ring decode attention
# ======================================================================
def ring_decode_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    k_ring: torch.Tensor, v_ring: torch.Tensor, page_table: torch.Tensor,
    pages_len: torch.Tensor, lengths: torch.Tensor, layer_index: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-based twin: concat [gathered pages, ring] and attend.

    Valid keys of slot b: page positions < pages_len[b] and ring rows
    r <= lengths[b] - pages_len[b].
    """
    B, H, D = q.shape
    _, Hkv, _, P, _ = k_pages.shape
    pm = page_table.shape[1]
    T = k_ring.shape[3]
    if sm_scale is None:
        sm_scale = D ** -0.5
    table = page_table.long()
    # (Hkv, B, pm, P, D) -> (B, Hkv, pm*P, D)
    k = k_pages[layer_index][:, table].transpose(0, 1).reshape(B, Hkv, pm * P, D)
    v = v_pages[layer_index][:, table].transpose(0, 1).reshape(B, Hkv, pm * P, D)
    k = torch.cat([k, k_ring[layer_index].to(k.dtype)], dim=2)
    v = torch.cat([v, v_ring[layer_index].to(v.dtype)], dim=2)

    dev = q.device
    page_mask = torch.arange(pm * P, device=dev)[None, :] < pages_len[:, None]
    ring_mask = torch.arange(T, device=dev)[None, :] <= (lengths - pages_len)[:, None]
    mask = torch.cat([page_mask, ring_mask], dim=1)[:, None, None, :]  # (B,1,1,N)

    group = H // Hkv
    qg = q.reshape(B, Hkv, group, D).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2))  # (B, Hkv, group, N)
    s = torch.where(mask, s * sm_scale, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def _check_pool(k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths):
    L, Hkv, n_pages, P, D = k_pages.shape
    B, _ = page_table.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages must share a shape")
    if (k_ring.dim() != 5 or v_ring.shape != k_ring.shape
            or k_ring.shape[:3] != (L, B, Hkv) or k_ring.shape[4] != D):
        raise ValueError(f"ring must be (L, B, Hkv, T, D) = ({L}, {B}, {Hkv}, T, {D}), "
                         f"got {tuple(k_ring.shape)} / {tuple(v_ring.shape)}")
    if pages_len.shape != (B,) or lengths.shape != (B,):
        raise ValueError("pages_len and lengths must be (B,)")
    if not (k_pages.dtype == v_pages.dtype == k_ring.dtype == v_ring.dtype) \
            or k_pages.dtype not in _DTYPES:
        raise ValueError(f"pool and ring must share a dtype in {_DTYPES}")
    tensors = (k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths)
    if any(t.device != k_pages.device for t in tensors):
        raise ValueError("pool, ring and tables must lie on one device")
    return tensors


def _check_cuda_ints(*ints):
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in ints):
        raise ValueError("page_table, pages_len and lengths must be contiguous int32")


def ring_decode_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    k_ring: torch.Tensor, v_ring: torch.Tensor, page_table: torch.Tensor,
    pages_len: torch.Tensor, lengths: torch.Tensor, layer_index: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode query per slot over [pages < pages_len, ring rows <=
    lengths - pages_len] of layer ``layer_index``. q: (B, H, D) -> (B, H, D).

    ``lengths`` counts the tokens before this step's token; ring row
    ``lengths - pages_len`` already holds this step's K/V. Inactive slots
    (stale tables and lengths) give garbage rows the caller discards.
    """
    _check_pool(k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths)
    L, Hkv, n_pages, P, D = k_pages.shape
    B, pm = page_table.shape
    T = k_ring.shape[3]
    if q.shape[0] != B or q.dim() != 3 or q.shape[2] != D or q.shape[1] % Hkv:
        raise ValueError(f"q must be (B={B}, H, D={D}) with H % {Hkv} == 0, "
                         f"got {tuple(q.shape)}")
    if q.dtype != k_pages.dtype or q.device != k_pages.device:
        raise ValueError("q must match the pool's dtype and device")
    if not 0 <= layer_index < L:
        raise ValueError(f"layer_index {layer_index} outside [0, {L})")
    H = q.shape[1]
    if sm_scale is None:
        sm_scale = D ** -0.5

    if q.device.type == "cpu":
        return ring_decode_attention_plain(
            q, k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths,
            layer_index, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"ring_decode_attention runs on cpu or cuda, not {q.device}")
    if H // Hkv > 16 or D % 2:
        raise ValueError(f"the kernel takes an even head dim and at most 16 query "
                         f"heads per kv head, got D={D}, {H // Hkv} heads")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, k_ring, v_ring)):
        raise ValueError("q, pool and ring must be contiguous")
    _check_cuda_ints(page_table, pages_len, lengths)

    lib = _build.library()
    # the kernel cuts each slot's keys into splits and merges their partial
    # softmax sums through this float32 scratch
    n_splits = -(-(pm * P + T) // lib.mmt_ring_decode_split_keys())
    partial = torch.empty((B, Hkv, n_splits, H // Hkv, D + 2), dtype=torch.float32,
                          device=q.device)
    o = torch.empty_like(q)
    code = lib.mmt_ring_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_ring.data_ptr(),
        v_ring.data_ptr(), page_table.data_ptr(), pages_len.data_ptr(),
        lengths.data_ptr(), partial.data_ptr(), o.data_ptr(),
        B, H, Hkv, D, n_pages, P, pm, T, int(layer_index), float(sm_scale), n_splits,
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check("ring_decode_attention", code)
    launches["ring_decode_attention"] += 1
    return o


# ======================================================================
# K5: fold the ring into the pages
# ======================================================================
def fold_ring_into_pages_plain(
    k_pages: torch.Tensor, v_pages: torch.Tensor, k_ring: torch.Tensor,
    v_ring: torch.Tensor, page_table: torch.Tensor, pages_len: torch.Tensor,
    rows: int, lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter twin (the JAX XLA fold), in place: ring row r of slot b lands
    at position pages_len[b] + r; rows at positions >= lengths[b] go to the
    trash page 0."""
    B, pm = page_table.shape
    P = k_pages.shape[3]
    pos = pages_len[:, None].long() + torch.arange(rows, device=k_pages.device)[None, :]
    page_idx = torch.clamp(pos // P, max=pm - 1)
    pid = torch.gather(page_table.long(), 1, page_idx)
    pid = torch.where(pos < lengths[:, None], pid, 0)
    off = pos % P
    # (L, B, Hkv, rows, D) -> (L, Hkv, B, rows, D), the layout of k_pages[:, :, pid, off]
    k_pages[:, :, pid, off] = k_ring[:, :, :, :rows].transpose(1, 2).to(k_pages.dtype)
    v_pages[:, :, pid, off] = v_ring[:, :, :, :rows].transpose(1, 2).to(v_pages.dtype)
    return k_pages, v_pages


def fold_ring_into_pages(
    k_pages: torch.Tensor, v_pages: torch.Tensor, k_ring: torch.Tensor,
    v_ring: torch.Tensor, page_table: torch.Tensor, pages_len: torch.Tensor,
    rows: int, lengths: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the first ``min(max(lengths - pages_len, 0), rows)`` ring rows of
    every (layer, slot) into the page pool, IN PLACE; returns the pools.

    The kernel writes no row at a position >= lengths; the twin sends such
    rows to the trash page, so the two agree on every page but page 0.
    """
    _check_pool(k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths)
    L, Hkv, n_pages, P, D = k_pages.shape
    B, pm = page_table.shape
    T = k_ring.shape[3]
    if not 0 <= rows <= T:
        raise ValueError(f"rows={rows} must lie in [0, ring size {T}]")
    if T > P:
        raise ValueError(f"ring ({T} rows) must fit one page ({P})")

    if k_pages.device.type == "cpu":
        return fold_ring_into_pages_plain(
            k_pages, v_pages, k_ring, v_ring, page_table, pages_len, rows, lengths)
    if k_pages.device.type != "cuda":
        raise ValueError(f"fold_ring_into_pages runs on cpu or cuda, not {k_pages.device}")
    if not all(t.is_contiguous() for t in (k_pages, v_pages, k_ring, v_ring)):
        raise ValueError("pool and ring must be contiguous")
    _check_cuda_ints(page_table, pages_len, lengths)

    lib = _build.library()
    code = lib.mmt_fold_ring_into_pages(
        k_pages.data_ptr(), v_pages.data_ptr(), k_ring.data_ptr(), v_ring.data_ptr(),
        page_table.data_ptr(), pages_len.data_ptr(), lengths.data_ptr(),
        L, B, Hkv, D, n_pages, P, pm, T, rows,
        _build.DTYPE_CODES[k_pages.dtype], _build.stream_handle(k_pages.device))
    _build.check("fold_ring_into_pages", code)
    launches["fold_ring_into_pages"] += 1
    return k_pages, v_pages
