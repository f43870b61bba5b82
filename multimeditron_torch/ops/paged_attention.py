"""Paged decode attention (kernel K8), paged + ring decode and verify
attention and the ring fold (kernels K4, K6 and K5).

Counterpart of ``multimeditron_tpu/ops/paged_attention.py``.
``paged_attention`` is one decode step's attention straight against one
layer's page pool ``(Hkv, n_pages, P, D)`` through each slot's page table,
``lengths`` counting the step's own token; nothing in the serving engine
calls it. The serving engine splits the decode KV cache in two:

- PAGES ``(L, Hkv, n_pages, P, D)`` hold the tokens that existed when the
  current decode chunk started (prompt + earlier chunks), read through each
  slot's ``page_table (B, pages_max)``; page 0 is the trash page, never
  allocated to a slot;
- a small RING ``(L, B, Hkv, T, D)`` holds the tokens generated within the
  chunk: step t writes row t.

``ring_decode_attention`` computes one step's attention over [pages, ring]
per slot; ``ring_verify_attention`` does the same for a speculative block
of S query rows, causal within the block; ``fold_ring_into_pages`` moves the
ring rows into the pages, in place, at the end of a chunk (after every
verify step). On a CUDA tensor each runs its kernel (``csrc/ring_decode.cu``
for K8 and K4, ``csrc/ring_verify.cu``, ``csrc/fold_ring.cu``); on a CPU
tensor its plain twin (``*_plain``, the JAX ``*_xla`` references).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimeditron_torch import _build

# Launches of the CUDA kernels (the plain twins do not count), counted by the
# calls made on the host: a captured CUDA graph counts its kernels once, at
# capture, and its replays not at all.
launches = {"paged_attention": 0, "ring_decode_attention": 0,
            "ring_verify_attention": 0, "fold_ring_into_pages": 0}

MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
_DTYPES = (torch.float32, torch.bfloat16)


# ======================================================================
# K8: paged decode attention (no ring)
# ======================================================================
def paged_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    page_table: torch.Tensor, lengths: torch.Tensor, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-based twin (the JAX ``paged_attention_xla``): float32 scores,
    p rounded to v's dtype before PV, zeros for a slot of length 0."""
    B, H, D = q.shape
    Hkv, _, P, _ = k_pages.shape
    pm = page_table.shape[1]
    if sm_scale is None:
        sm_scale = D ** -0.5
    table = page_table.long()
    # (Hkv, B, pm, P, D) -> (B, Hkv, pm*P, D)
    k = k_pages[:, table].transpose(0, 1).reshape(B, Hkv, pm * P, D)
    v = v_pages[:, table].transpose(0, 1).reshape(B, Hkv, pm * P, D)
    mask = (torch.arange(pm * P, device=q.device)[None, :] < lengths[:, None])[:, None, None]

    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * sm_scale  # (B, Hkv, group, N)
    s = torch.where(mask, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / torch.clamp(l, min=1e-30)
    out = torch.where(l > 0, out, 0.0)
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    page_table: torch.Tensor, lengths: torch.Tensor, sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """One decode query per slot over the first ``lengths[b]`` positions of
    its pages (the step's own token included) in one layer's pool.
    q: (B, H, D), pools (Hkv, n_pages, P, D), page_table (B, pages_max),
    lengths (B,) -> (B, H, D); a slot of length 0 returns zeros."""
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"q (B, H, D) and pools (Hkv, n_pages, P, D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, H, D = q.shape
    Hkv, n_pages, P, Dk = k_pages.shape
    if Dk != D or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and pool {tuple(k_pages.shape)} disagree "
                         f"(head dim, or H % Hkv != 0)")
    if page_table.dim() != 2 or page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("page_table must be (B, pages_max) and lengths (B,)")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q and pools must share a dtype in {_DTYPES}")
    if any(t.device != q.device for t in (k_pages, v_pages, page_table, lengths)):
        raise ValueError("q, pools and tables must lie on one device")
    pm = page_table.shape[1]
    if sm_scale is None:
        sm_scale = D ** -0.5

    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    _check_decode_shape(B, H, Hkv, D, P, q.dtype)
    _check_cuda_tensors(q, k_pages, v_pages)
    _check_cuda_ints(page_table, lengths)

    lib = _build.library()
    work, counters, max_splits = _decode_scratch(lib, q, B, Hkv, H // Hkv, D, pm * P)
    o = torch.empty_like(q)
    code = lib.mmt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), work.data_ptr(), counters.data_ptr(), o.data_ptr(), B, H, Hkv, D,
        n_pages, P, pm, float(sm_scale), max_splits, _build.DTYPE_CODES[q.dtype],
        _build.stream_handle(q.device))
    _build.check("paged_attention", code)
    launches["paged_attention"] += 1
    return o


# ======================================================================
# K4: ring decode attention
# ======================================================================
def ring_decode_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    k_ring: torch.Tensor, v_ring: torch.Tensor, page_table: torch.Tensor,
    pages_len: torch.Tensor, lengths: torch.Tensor, layer_index: int,
    sm_scale: Optional[float] = None, window: int = 0,
) -> torch.Tensor:
    """Gather-based twin: concat [gathered pages, ring] and attend.

    Valid keys of slot b: page positions < pages_len[b] and ring rows
    r <= lengths[b] - pages_len[b]; with ``window`` > 0 only those at
    positions > lengths[b] - window (ring row r sits at pages_len[b] + r).
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
    mask = torch.cat([page_mask, ring_mask], dim=1)
    if window > 0:
        pos = torch.cat([torch.arange(pm * P, device=dev)[None, :].expand(B, -1),
                         pages_len[:, None] + torch.arange(T, device=dev)[None, :]], dim=1)
        mask = mask & (pos > (lengths - window)[:, None])
    mask = mask[:, None, None, :]  # (B,1,1,N)

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
        raise ValueError("page tables and lengths must be contiguous int32")


# K4 and K8: the head dims (a multiple of DECODE_HEAD_DIM_STEP[dtype], up to
# DECODE_MAX_HEAD_DIM), query heads per kv head and slots the kernel takes.
DECODE_HEAD_DIM_STEP = {torch.bfloat16: 16, torch.float32: 4}
DECODE_MAX_HEAD_DIM = 128
DECODE_MAX_GROUP = 16
DECODE_MAX_SLOTS = 1024


def _check_decode_shape(B, H, Hkv, D, P, dtype):
    step = DECODE_HEAD_DIM_STEP[dtype]
    if (D % step or D > DECODE_MAX_HEAD_DIM or H // Hkv > DECODE_MAX_GROUP
            or B > DECODE_MAX_SLOTS):
        raise ValueError(f"the kernel takes an even head dim (a multiple of {step} in {dtype}, "
                         f"up to {DECODE_MAX_HEAD_DIM}), at most {DECODE_MAX_GROUP} query "
                         f"heads per kv head and {DECODE_MAX_SLOTS} slots, got D={D}, "
                         f"{H // Hkv} heads, {B} slots")
    if P % 8 or (P % 64 and 64 % P):
        raise ValueError(f"the kernel takes pages of a multiple of 8 rows that divides 64 or "
                         f"that 64 divides, got {P}")


def _check_cuda_tensors(*tensors):
    # the kernel copies rows with bulk copies: 16-byte aligned, contiguous
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("q, pool and ring must be contiguous and 16-byte aligned")


def _decode_scratch(lib, q, B, Hkv, group, D, max_keys):
    """The K4 / K8 merge's float32 workspace (one record of ``group`` maxima,
    sums and accumulator rows per (slot, kv head, split); a split takes at
    least ``mmt_ring_decode_split_keys()`` keys of the ``max_keys`` a slot
    may have), its zeroed counters (one a (slot, kv head)) and the split
    bound."""
    max_splits = max(1, -(-max_keys // lib.mmt_ring_decode_split_keys()))
    stream = _build.stream_handle(q.device)
    work = _build.workspace(q.device, stream, B * Hkv * max_splits * group * (D + 2))
    return work, _build.zeroed_counters(q.device, stream, B * Hkv), max_splits


def ring_decode_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    k_ring: torch.Tensor, v_ring: torch.Tensor, page_table: torch.Tensor,
    pages_len: torch.Tensor, lengths: torch.Tensor, layer_index: int,
    sm_scale: Optional[float] = None, window: int = 0,
) -> torch.Tensor:
    """One decode query per slot over [pages < pages_len, ring rows <=
    lengths - pages_len] of layer ``layer_index``. q: (B, H, D) -> (B, H, D).

    ``lengths`` counts the tokens before this step's token; ring row
    ``lengths - pages_len`` already holds this step's K/V. Inactive slots
    (stale tables and lengths) give garbage rows the caller discards. A
    ``window`` > 0 (a sliding-window layer) keeps the keys at positions >
    lengths - window: the kernel does not load the pages before them.
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
            layer_index, sm_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"ring_decode_attention runs on cpu or cuda, not {q.device}")
    _check_decode_shape(B, H, Hkv, D, P, q.dtype)
    _check_cuda_tensors(q, k_pages, v_pages, k_ring, v_ring)
    _check_cuda_ints(page_table, pages_len, lengths)

    lib = _build.library()
    work, counters, max_splits = _decode_scratch(lib, q, B, Hkv, H // Hkv, D, pm * P + T)
    o = torch.empty_like(q)
    code = lib.mmt_ring_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_ring.data_ptr(),
        v_ring.data_ptr(), page_table.data_ptr(), pages_len.data_ptr(),
        lengths.data_ptr(), work.data_ptr(), counters.data_ptr(), o.data_ptr(),
        L, B, H, Hkv, D, n_pages, P, pm, T, int(layer_index), float(sm_scale), max_splits,
        max(int(window), 0), _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check("ring_decode_attention", code)
    launches["ring_decode_attention"] += 1
    return o


# ======================================================================
# K6: ring verify attention (the speculative verify block)
# ======================================================================
def ring_verify_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    k_ring: torch.Tensor, v_ring: torch.Tensor, page_table: torch.Tensor,
    pages_len: torch.Tensor, lengths: torch.Tensor, layer_index: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-based twin (the JAX ``ring_verify_attention_xla``).

    Query i of slot b sits at position lengths[b] + i: it sees page
    positions < pages_len[b] and ring rows r <= lengths[b] - pages_len[b] + i.
    GQA folds the group into the query; K and V are not repeated.
    """
    B, H, S, D = q.shape
    _, Hkv, _, P, _ = k_pages.shape
    pm = page_table.shape[1]
    T = k_ring.shape[3]
    if sm_scale is None:
        sm_scale = D ** -0.5
    table = page_table.long()
    k = k_pages[layer_index][:, table].transpose(0, 1).reshape(B, Hkv, pm * P, D)
    v = v_pages[layer_index][:, table].transpose(0, 1).reshape(B, Hkv, pm * P, D)
    k = torch.cat([k, k_ring[layer_index].to(k.dtype)], dim=2)
    v = torch.cat([v, v_ring[layer_index].to(v.dtype)], dim=2)

    dev = q.device
    qi = torch.arange(S, device=dev)[None, :, None]                       # (1, S, 1)
    page_mask = (torch.arange(pm * P, device=dev)[None, None, :]
                 < pages_len[:, None, None]).expand(B, S, pm * P)
    ring_mask = (torch.arange(T, device=dev)[None, None, :]
                 <= (lengths - pages_len)[:, None, None] + qi)
    mask = torch.cat([page_mask, ring_mask], dim=2)[:, None, None]       # (B,1,1,S,N)

    group = H // Hkv
    qg = q.reshape(B, Hkv, group, S, D).float()
    s = torch.einsum("bigsd,bind->bigsn", qg, k.float())
    s = torch.where(mask, s * sm_scale, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bigsn,bind->bigsd", p.to(v.dtype).float(), v.float())
    out = out / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, S, D).to(q.dtype)


def ring_verify_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    k_ring: torch.Tensor, v_ring: torch.Tensor, page_table: torch.Tensor,
    pages_len: torch.Tensor, lengths: torch.Tensor, layer_index: int,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """The speculative verify block: S query rows per head and slot over
    [pages < pages_len, ring rows <= lengths - pages_len + i] of layer
    ``layer_index``. q: (B, H, S, D) -> (B, H, S, D).

    ``lengths`` counts the tokens before the block; the block's own K/V
    already sit at ring rows lengths - pages_len .. + S - 1. The engine folds
    the ring after every verify step, so it calls with lengths == pages_len;
    other offsets are taken as well.
    """
    _check_pool(k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths)
    L, Hkv, n_pages, P, D = k_pages.shape
    B, pm = page_table.shape
    T = k_ring.shape[3]
    if q.dim() != 4 or q.shape[0] != B or q.shape[3] != D or q.shape[1] % Hkv:
        raise ValueError(f"q must be (B={B}, H, S, D={D}) with H % {Hkv} == 0, "
                         f"got {tuple(q.shape)}")
    if q.dtype != k_pages.dtype or q.device != k_pages.device:
        raise ValueError("q must match the pool's dtype and device")
    if not 0 <= layer_index < L:
        raise ValueError(f"layer_index {layer_index} outside [0, {L})")
    H, S = q.shape[1], q.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5

    if q.device.type == "cpu":
        return ring_verify_attention_plain(
            q, k_pages, v_pages, k_ring, v_ring, page_table, pages_len, lengths,
            layer_index, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"ring_verify_attention runs on cpu or cuda, not {q.device}")
    lib = _build.library()
    rows = H // Hkv * S
    if rows > lib.mmt_ring_verify_max_rows() or D % 2:
        raise ValueError(f"the kernel takes an even head dim and at most "
                         f"{lib.mmt_ring_verify_max_rows()} query rows per kv head, "
                         f"got D={D}, {rows} rows")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, k_ring, v_ring)):
        raise ValueError("q, pool and ring must be contiguous")
    _check_cuda_ints(page_table, pages_len, lengths)

    # splits of each slot's keys, merged through float32 scratch as in K4
    n_splits = -(-(pm * P + T) // lib.mmt_ring_verify_split_keys())
    partial = torch.empty((B, Hkv, n_splits, rows, D + 2), dtype=torch.float32,
                          device=q.device)
    o = torch.empty_like(q)
    code = lib.mmt_ring_verify_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_ring.data_ptr(),
        v_ring.data_ptr(), page_table.data_ptr(), pages_len.data_ptr(),
        lengths.data_ptr(), partial.data_ptr(), o.data_ptr(),
        B, H, Hkv, S, D, n_pages, P, pm, T, int(layer_index), float(sm_scale), n_splits,
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check("ring_verify_attention", code)
    launches["ring_verify_attention"] += 1
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
