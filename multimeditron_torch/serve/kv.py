"""The serving engine's KV layout: a pool of pages (``PagedKV``) or one
contiguous row a slot (``SlabKV``).

``ServingEngine`` builds one from ``EngineConfig.kv_mode`` and leaves to it
everything that depends on the layout: the device cache tensors (``cache``;
the engine's ``state`` holds the same tensors under the same keys), where a
prefill and a chunked prefill write, the ring fold after a decode chunk or a
verify step, what admission reserves and releases, and whether a request or
a forked group fits the pool now or ever.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimeditron_torch.models.llama import (
    init_kv_cache,
    init_paged_kv_cache,
    refuse_windows_or_experts,
)
from multimeditron_torch.ops.paged_attention import fold_ring_into_pages


class KVLayout:
    """What the engine asks of its layout, as a layout with nothing to
    allocate or fold answers it; each layout also writes a group prefill
    (``write_prefill``) and names a chunked prompt's target
    (``chunk_target``). ``graph``: the card replays the plain decode step
    over this layout as a CUDA graph. ``forks``: ``submit_group`` forks a
    group over one prefill (``reserve_forks``, ``copy_page``), else it
    queues n independent requests."""

    cache: Dict[str, torch.Tensor]
    graph = False
    forks = False

    def refuse(self, req, n: int = 1) -> None:
        """ValueError when the layout could never hold ``req`` (``n`` > 1: a
        forked group of ``n`` over its prompt)."""

    def fitting(self, reqs: Sequence, n: int = 1) -> int:
        """How many of ``reqs`` (each with a forked group of ``n``), in
        order, fit now together."""
        return len(reqs)

    def reserve(self, req, slot: int) -> None:
        """Hold what ``req`` needs in ``slot`` until :meth:`release`."""

    def release(self, slot: int) -> None:
        """Free what ``slot`` held (its request finished)."""

    def rows(self, slots: Sequence[int]) -> Optional[torch.Tensor]:
        """The slots' rows on the device, for :meth:`set_rows`; apart so that
        the caller places this copy, which waits for the device."""
        return None

    def set_rows(self, slot_ids: torch.Tensor, lengths: torch.Tensor, rows) -> None:
        """Admitted slots' device rows; their cache holds ``lengths`` tokens."""

    def prefill_dest(self, slots: Sequence[int], bucket: int) -> Optional[torch.Tensor]:
        """Where :meth:`write_prefill` puts each slot's rows, on the device."""
        return None

    def commit_chunks(self, slot: int, target: Dict[str, torch.Tensor]) -> None:
        """Move a chunked prompt from :meth:`chunk_target` into the slot's cache."""

    def fold(self, rows: int) -> None:
        """Absorb the last chunk's or verify block's ``rows`` ring rows."""


class PagedKV(KVLayout):
    """A global pool of pages with per-slot page tables (page 0 is the trash
    page) and a per-chunk decode ring, folded into the pages (kernel K5).
    Requests reserve pages for prompt + decode budget at admission; pages are
    refcounted, so a forked group's slots share its full prompt pages. A
    chunked prompt prefills into a persistent slab, committed once."""

    graph = True
    forks = True

    def __init__(self, llm_cfg, cfg, ring_rows: int, device):
        """``ring_rows``: the most rows a decode chunk or verify block writes
        into the ring between two folds."""
        P = cfg.page_size
        for b in cfg.prefill_buckets:
            if b >= P and b % P != 0:
                raise ValueError(f"prefill bucket {b} must divide into pages of {P}")
        if ring_rows > P:
            raise ValueError(f"ring ({ring_rows} rows) must fit one page ({P})")
        self.cfg, self.device, self.page_size = cfg, device, P
        self.pages_max = -(-cfg.max_seq_len // P)
        self.num_pages = cfg.num_pages or (1 + cfg.max_slots * self.pages_max)
        # host allocator; page 0 is never allocated
        self.page_table = np.zeros((cfg.max_slots, self.pages_max), np.int32)
        self.free_pages: List[int] = list(range(self.num_pages - 1, 0, -1))
        self.page_ref = np.zeros((self.num_pages,), np.int32)
        self.slot_num_pages = np.zeros((cfg.max_slots,), np.int32)
        self.cache = init_paged_kv_cache(llm_cfg, self.num_pages, P, self.pages_max,
                                         cfg.max_slots, ring_size=ring_rows, device=device)
        self._chunk_slab: Optional[Dict[str, torch.Tensor]] = None

    def _pages(self, req, n: int = 1) -> int:
        """Pages ``req`` reserves: prompt + full decode budget, so the decode
        loop never allocates (writes past the reservation land on the trash
        page); for a forked group of ``n``, each sibling's own pages past the
        shared full prompt pages on top."""
        plen = int(np.asarray(req.batch["attention_mask"]).sum())
        need = -(-min(plen + req.max_new_tokens, self.cfg.max_seq_len) // self.page_size)
        return need + (n - 1) * (need - min(plen // self.page_size, need))

    def refuse(self, req, n: int = 1) -> None:
        need, room = self._pages(req, n), self.num_pages - 1
        if need > room:
            what, lower = ("request", "max_new_tokens") if n == 1 else (
                "group", "max_new_tokens/group size")
            raise ValueError(f"{what} needs {need} KV pages but the pool only has {room}; "
                             f"raise num_pages or lower {lower}")

    def fitting(self, reqs: Sequence, n: int = 1) -> int:
        room = len(self.free_pages)
        for i, req in enumerate(reqs):
            room -= self._pages(req, n)
            if room < 0:
                return i
        return len(reqs)

    def _assign(self, slot: int, shared: List[int], n_own: int) -> None:
        """``slot``'s pages: ``shared`` (one more reference each), then
        ``n_own`` newly allocated."""
        own = [self.free_pages.pop() for _ in range(n_own)]
        self.page_ref[shared] += 1
        self.page_ref[own] = 1
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(shared) + n_own] = shared + own
        self.slot_num_pages[slot] = len(shared) + n_own

    def reserve(self, req, slot: int) -> None:
        self._assign(slot, [], self._pages(req))

    def reserve_forks(self, reqs, slots: List[int], parent_slot: int,
                      plen: int) -> Tuple[int, List[int]]:
        """Fork each of ``slots`` off ``parent_slot``'s prompt of ``plen``
        tokens: share its full prompt pages (refcount + 1), allocate its own
        pages for the rest of [plen, plen + budget). Returns the parent's
        partial page and the forks' pages that take a copy of it (0 and []
        when the prompt ends on a page boundary)."""
        P = self.page_size
        src, dsts = 0, []
        for req, slot in zip(reqs, slots):
            need = self._pages(req)
            n_full = min(plen // P, need)
            self._assign(slot, self.page_table[parent_slot, :n_full].tolist(), need - n_full)
            if plen % P != 0 and need > n_full:
                src = int(self.page_table[parent_slot, n_full])
                dsts.append(int(self.page_table[slot, n_full]))
        return src, dsts

    def release(self, slot: int) -> None:
        for p in self.page_table[slot, :int(self.slot_num_pages[slot])]:
            self.page_ref[p] -= 1
            if self.page_ref[p] == 0:
                self.free_pages.append(int(p))
        self.page_table[slot, :] = 0
        self.slot_num_pages[slot] = 0

    def rows(self, slots: Sequence[int]) -> torch.Tensor:
        return torch.from_numpy(self.page_table[np.asarray(slots)]).to(self.device)

    def set_rows(self, slot_ids: torch.Tensor, lengths: torch.Tensor, rows) -> None:
        self.cache["pages_length"][slot_ids] = lengths
        self.cache["page_table"][slot_ids] = rows

    def prefill_dest(self, slots: Sequence[int], bucket: int) -> torch.Tensor:
        """Pool page ids receiving each request's bucket-shaped prefill KV;
        bucket pages beyond a slot's reservation map to the trash page."""
        bp = max(1, bucket // self.page_size)
        ids = np.zeros((len(slots) * bp,), np.int64)
        for j, slot in enumerate(slots):
            used = min(bp, int(self.slot_num_pages[slot]))
            ids[j * bp: j * bp + used] = self.page_table[slot, :used]
        return torch.from_numpy(ids).to(self.device)

    def write_prefill(self, local: Dict[str, torch.Tensor], bucket: int,
                      slot_ids: torch.Tensor, dest: torch.Tensor) -> None:
        """A group prefill's local (L, n, Hkv, bucket, Dh) cache into the
        pool: one scatter of bucket-shaped pages at page ids ``dest``."""
        L, n, Hkv, _, Dh = local["k"].shape
        P = self.page_size
        for name in ("k", "v"):
            if bucket >= P:
                bp = bucket // P
                pages = (local[name].reshape(L, n, Hkv, bp, P, Dh)
                         .permute(0, 2, 1, 3, 4, 5).reshape(L, Hkv, n * bp, P, Dh))
                # unused bucket pages all go to trash page 0: duplicate
                # targets there are harmless (nothing reads page 0 as data)
                self.cache[name].index_copy_(2, dest, pages)
            else:
                # a bucket smaller than a page fills the first rows of one page
                self.cache[name][:, :, dest, :bucket] = local[name].permute(0, 2, 1, 3, 4)

    def chunk_target(self, slot: int) -> Dict[str, torch.Tensor]:
        """Persistent (L, 1, Hkv, pages_max * P, Dh) slab reused by every
        chunked prefill (a chunk attends only positions its prompt wrote)."""
        if self._chunk_slab is None:
            L, Hkv, _, P, Dh = self.cache["k"].shape
            shape = (L, 1, Hkv, self.pages_max * P, Dh)
            kw = dict(dtype=self.cache["k"].dtype, device=self.device)
            self._chunk_slab = {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
        return self._chunk_slab

    def commit_chunks(self, slot: int, target: Dict[str, torch.Tensor]) -> None:
        """The slab into the slot's pages with one scatter."""
        L, _, Hkv, _, Dh = target["k"].shape
        dest = torch.from_numpy(self.page_table[slot].astype(np.int64)).to(self.device)
        for name in ("k", "v"):
            self.cache[name].index_copy_(2, dest, target[name][:, 0].reshape(
                L, Hkv, self.pages_max, self.page_size, Dh))

    def copy_page(self, src: int, dsts: List[int]) -> None:
        """Copy pool page ``src`` into each of ``dsts`` (a fork's tail page)."""
        if not dsts:
            return
        dst = torch.tensor(dsts, dtype=torch.long, device=self.device)
        for name in ("k", "v"):
            pool = self.cache[name]
            # a copy, not a view: with one layer, one K/V head and one
            # destination the expanded source would be the pool itself
            pool.index_copy_(2, dst, pool[:, :, src:src + 1].expand(
                -1, -1, len(dsts), -1, -1).clone())

    def fold(self, rows: int) -> None:
        """K5: rows past a slot's length are not written; the pages then
        cover the slot's length and the next step writes ring row 0."""
        c = self.cache
        fold_ring_into_pages(c["k"], c["v"], c["ring_k"], c["ring_v"], c["page_table"],
                             c["pages_length"], rows, c["length"])
        c["pages_length"].copy_(c["length"])


class SlabKV(KVLayout):
    """One contiguous cache row a slot, (L, slots, Hkv, max_seq_len, Dh), as
    the JAX engine's non-paged branches: admission needs only a free slot
    (any budget is admitted: the cache caps the length), a decode step writes
    at the slot's length (no ring, no fold), a verify block runs as a prefill
    at per-slot causal offsets, and a chunked prompt prefills straight into
    its row."""

    def __init__(self, llm_cfg, cfg, ring_rows: int, device):
        refuse_windows_or_experts(llm_cfg, "slab decode (kernel K1 has no window)")
        self.cache = init_kv_cache(llm_cfg, cfg.max_slots, cfg.max_seq_len, device=device)

    def write_prefill(self, local: Dict[str, torch.Tensor], bucket: int,
                      slot_ids: torch.Tensor, dest) -> None:
        """Each request's row of the local cache into its slot's row."""
        # a bucket can be wider than the slot's row: its prefix is copied
        # (the prompt itself is shorter than max_seq_len)
        width = min(bucket, self.cache["k"].shape[3])
        for name in ("k", "v"):
            self.cache[name][:, slot_ids, :, :width] = local[name][:, :, :, :width]

    def chunk_target(self, slot: int) -> Dict[str, torch.Tensor]:
        """The slot's own row of the cache."""
        return {name: self.cache[name][:, slot:slot + 1] for name in ("k", "v")}
