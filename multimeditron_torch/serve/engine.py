"""Continuous-batching serving engine, paged and slab KV modes.

Counterpart of ``multimeditron_tpu/serve/engine.py``. ``kv_mode="paged"``
(the default):

- a fixed pool of SLOTS and a global pool of KV PAGES, with per-slot page
  tables; page 0 is the trash page. Requests reserve pages for prompt +
  decode budget at admission and queue (FIFO) while the pool is exhausted.
  Pages are refcounted: a forked group shares its prompt's full pages;
- batched PREFILL of same-signature requests (bucketed prompt length +
  modality shapes, group size capped to a power of two, or to
  ``prefill_group_cap`` when admission is staggered): modality encode and
  splice, a causal forward into a local contiguous cache, then one scatter of
  bucket-shaped pages into the pool. Prompts longer than the largest bucket
  prefill in bucket-sized chunks into a persistent slab, folded into the pool
  once;
- FORKED GROUPS (``submit_group(n > 1)``, the GRPO G-per-prompt layout): the
  prompt prefills once; siblings share its full pages, copy its partial tail
  page and sample their first tokens from its last logits;
- chunked DECODE: ``decode_chunk`` single-token steps write into a per-chunk
  ring and attend over pages + ring (kernel K4); slots deactivate in the
  chunk on EOS, exhausted budget or a full cache; at the end of the chunk the
  ring folds into the pages (kernel K5);
- SPECULATIVE decoding (``speculative_k = k > 0``): each step drafts k tokens
  per slot from its token history (n-gram prompt lookup), runs the (k+1)-token
  block through the decoder (kernel K6), commits the longest agreeing prefix
  plus one bonus token and folds the ring (K5). Greedy output is exactly the
  plain greedy decode; sampled output is position-keyed, so a function of
  (prompt, seed) independent of k;
- per-slot temperature / top-k / top-p sampling on the device, with JAX's
  threefry keys (``serve/prng.py``): every sampled token equals the JAX
  engine's for the same logits. On the card the draw (hash, Gumbel noise,
  temperature, greedy and sampled argmax) is one kernel
  (``ops/sampling.py``), after the eager top-k / top-p filter when either
  is on; ``n_kernel_samples`` counts the sampling calls that ran it, graph
  replays included;
- the INT8 LLM (``quantize_llm``): the engine serves a quantised copy of the
  model's decoder (``models/llama_quant.py``; W8A16 through kernel K9, fused
  qkv and gate-up), leaving the caller's model as it is; with
  ``w8a8_prefill`` every prefill call (group prefill and each chunk of a
  chunked prompt) runs W8A8 once its padded rows reach 256, while decode
  and verify stay W8A16.

``kv_mode="slab"`` keeps one contiguous cache row per slot, (L, slots, Hkv,
max_seq_len, Dh), and follows the JAX engine's non-paged branches: a prefill
copies each request's local cache into its slot's row; a decode step writes
at each slot's length and attends over the masked row (kernel K1 on the
card), with no ring and no fold; a verify block runs as a prefill at
per-slot causal offsets (plain attention); a long prompt prefills chunk by
chunk straight into its slot's row; admission needs only a free slot, and
``submit_group`` queues n independent requests. Sampling, speculative
decoding and the int8 LLM work as in paged mode.

Scheduling state lives on the engine's device (the model's device); the host
keeps mirrors for admission, page allocation and finish bookkeeping, and
downloads one token matrix per chunk. Each live decode or verify step costs
one host sync (``active.any()``), where the JAX loop skips dead steps
in-graph. A plain decode step is one function over the state
(``_decode_step``: embedding, decoder, lm_head, sampling, state update, in
place). On the card with paged KV and no speculation it is captured once,
at the first live step, as a CUDA graph and replayed for every live step
(``n_decode_graph_steps`` counts the replays); elsewhere it runs eagerly.

A decoder with routed experts (``models/moe.py``) counts on the device, in
each expert layer's call, the experts that received a token and the
assignments; the counts of a decode chunk and of a prefill call travel home
in the same ``.cpu()`` as its tokens and land in the engine's
``n_experts_touched`` / ``n_expert_assignments`` and on the
``decode.chunk`` and ``engine.prefill`` spans (``experts_touched``,
``expert_assignments``). A decoder with sliding windows or experts serves
through the paged plain path only.

Each phase of a plain step (admission, each prefill call and its parts,
forks, the decode chunk, each decode step and its parts, the fold, the
readback and the host-mirror replay) records a span in
``profiling.tracer``, with counters from the host mirrors; a replayed step
records ``decode.forward`` around the replay (sampling included) and no
``decode.sample``, and its ``decode.step`` carries ``graph``. The
speculative path records only ``engine.step``. The tracer is off unless
enabled.

Not ported yet (``NotImplementedError``): tensor parallelism or an
external mesh, and ``attn_impl``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimeditron_torch.models.llama import (
    init_kv_cache,
    init_paged_kv_cache,
    refuse_windows_or_experts,
)
from multimeditron_torch.models.llama_quant import is_quantized, quantize_llama
from multimeditron_torch.models.multimodal import MultimodalModel, mm_item_count
from multimeditron_torch.ops import sampling
from multimeditron_torch.ops.paged_attention import fold_ring_into_pages
from multimeditron_torch.profiling import tracer
from multimeditron_torch.serve import prng

PAGED_CACHE_KEYS = ("k", "v", "ring_k", "ring_v", "length", "page_table", "pages_length")
SLAB_CACHE_KEYS = ("k", "v", "length")
W8A8_MIN_ROWS = 256  # the JAX engine's prefill row gate


@dataclasses.dataclass
class EngineConfig:
    """Every field and default of the JAX ``EngineConfig``; see that class
    for the meaning of each. The fields whose feature is not ported yet must
    keep their defaults."""

    max_slots: int = 8
    max_seq_len: int = 2048
    max_new_tokens: int = 512
    prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024)
    temperature: float = 0.7
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 disables nucleus sampling
    do_sample: bool = True
    seed: int = 0
    attn_impl: Optional[str] = None
    decode_chunk: int = 8
    kv_mode: str = "paged"
    page_size: int = 128
    quantize_llm: bool = False
    num_pages: Optional[int] = None
    speculative_k: int = 0
    w8a8_prefill: bool = False
    prefill_group_cap: Optional[int] = None
    tp: int = 1


@dataclasses.dataclass
class Request:
    request_id: int
    batch: Dict[str, Any]            # single-sample collated batch (B=1)
    max_new_tokens: int
    temperature: float
    top_p: float = 1.0
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None  # "eos" | "budget" | "capacity"
    # siblings sharing this request's prompt KV pages (forked group);
    # populated by ``submit_group`` on the primary only
    forks: List["Request"] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


def _refuse_unported(cfg: EngineConfig, mesh) -> None:
    refused = [
        (cfg.tp > 1 or mesh is not None, "tp > 1 or an external mesh (parallelism)"),
        (cfg.attn_impl is not None, "attn_impl (the port picks kernels by device)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue 1, serve/engine.py)")


def _wrap_int32(x: int) -> int:
    """``x`` as the JAX engine's int32 state holds it (two's complement)."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


class ServingEngine:
    def __init__(self, model: MultimodalModel, cfg: EngineConfig, mesh=None):
        """``model`` holds the weights and lives on the engine's device."""
        _refuse_unported(cfg, mesh)
        if cfg.w8a8_prefill and not cfg.quantize_llm:
            raise ValueError("w8a8_prefill requires quantize_llm")
        if cfg.kv_mode not in ("paged", "slab"):
            raise ValueError(f"kv_mode must be paged|slab, got {cfg.kv_mode!r}")
        llm_cfg = model.config.llm
        if cfg.kv_mode == "slab":
            refuse_windows_or_experts(llm_cfg, "slab decode (kernel K1 has no window)")
        if cfg.speculative_k > 0:
            refuse_windows_or_experts(llm_cfg, "speculative decoding (the verify block, "
                                      "kernel K6, has no window)")
        if cfg.quantize_llm:
            refuse_windows_or_experts(llm_cfg, "quantize_llm (no int8 experts)")
        self.paged = cfg.kv_mode == "paged"
        self.cache_keys = PAGED_CACHE_KEYS if self.paged else SLAB_CACHE_KEYS
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device
        # the decoder every forward runs: a quantised copy with quantize_llm
        # (fused qkv / gate-up; embedding and norms shared with the model)
        self.llm = model.llm
        if cfg.quantize_llm and not is_quantized(model.llm):
            self.llm = quantize_llama(model.llm, fuse=True)
        llm = model.config.llm
        self.eos_id = model.config.eos_token_idx
        self.decode_chunk = max(1, cfg.decode_chunk)
        self.spec_k = max(0, cfg.speculative_k)
        if self.paged:
            P = cfg.page_size
            for b in cfg.prefill_buckets:
                if b >= P and b % P != 0:
                    raise ValueError(f"prefill bucket {b} must divide into pages of {P}")
            # a verify step writes one (k+1)-token block into the ring, folded
            # after every step; plain decode keeps a chunk's rows
            ring_size = (max(self.decode_chunk, self.spec_k + 2) if self.spec_k
                         else self.decode_chunk)
            if ring_size > P:
                raise ValueError(f"ring ({ring_size} rows) must fit one page ({P})")
            self.page_size = P
            self.pages_max = -(-cfg.max_seq_len // P)
            n_pages = cfg.num_pages or (1 + cfg.max_slots * self.pages_max)
            self.num_pages = n_pages

            # Host-side allocator; page 0 = trash (never allocated). Pages are
            # refcounted: a forked group's slots share its full prompt pages.
            self.page_table = np.zeros((cfg.max_slots, self.pages_max), np.int32)
            self.free_pages: List[int] = list(range(n_pages - 1, 0, -1))
            self.page_ref = np.zeros((n_pages,), np.int32)
            self.slot_num_pages = np.zeros((cfg.max_slots,), np.int32)
        # Host mirrors of the scheduling state, advanced from the downloaded
        # tokens alone.
        self.lengths = np.zeros((cfg.max_slots,), np.int32)
        self.slot_request: List[Optional[Request]] = [None] * cfg.max_slots
        self.slot_budget = np.zeros((cfg.max_slots,), np.int32)
        self.slot_generated = np.zeros((cfg.max_slots,), np.int32)
        self.active = np.zeros((cfg.max_slots,), bool)

        dev, B = self.device, cfg.max_slots
        with torch.inference_mode():
            if self.paged:
                cache = init_paged_kv_cache(llm, n_pages, P, self.pages_max, B,
                                            ring_size=ring_size, device=dev)
            else:
                cache = init_kv_cache(llm, B, cfg.max_seq_len, device=dev)
            ints = dict(dtype=torch.int32, device=dev)
            # Device-resident scheduling state, updated in place by prefill
            # and decode; "remaining" is the token budget left per slot.
            # "seed" seeds the next plain decode chunk's keys (a host int:
            # keys are derived on the host, random bits on the device).
            self.state: Dict[str, Any] = {
                **cache,
                "tokens": torch.zeros((B,), **ints),
                "active": torch.zeros((B,), dtype=torch.bool, device=dev),
                "remaining": torch.zeros((B,), **ints),
                "temps": torch.full((B,), cfg.temperature, dtype=torch.float32, device=dev),
                "top_ps": torch.full((B,), cfg.top_p, dtype=torch.float32, device=dev),
                "seed": _wrap_int32(cfg.seed),
            }
            if self.spec_k:
                # committed tokens (prompt + generated) backing the n-gram
                # draft; the k+2 margin takes the verify block's writes
                self.state["history"] = torch.zeros(
                    (B, cfg.max_seq_len + self.spec_k + 2), **ints)
        self.queue: List[Request] = []
        self._next_id = 0
        self._seed_ctr = 0  # prefill and fork seeds, as the JAX _next_seed
        self._last_prefill_logits: Optional[torch.Tensor] = None
        self._chunk_slab: Optional[Dict[str, torch.Tensor]] = None
        # work counters: prefill calls (chunks of a long prompt count one
        # each), live decode steps, decode chunks, and the speculative
        # verify steps, slot-steps and emitted tokens
        self.n_prefill_calls = 0
        self.n_decode_steps = 0
        self.n_decode_graph_steps = 0  # of n_decode_steps, those run as a graph replay
        self.n_kernel_samples = 0  # sampling calls that ran the sampler kernel, replays included
        self.n_decode_chunks = 0
        self.spec_verify_steps = 0
        self.spec_slot_steps = 0
        self.spec_emitted = 0
        # an expert decoder's (experts touched, assignments), summed over its
        # expert layers' calls, as read back with each chunk and prefill
        self.n_experts_touched = 0
        self.n_expert_assignments = 0
        # the decode step's CUDA graph, captured at the first live step, and
        # its key on the device. The graph serves the card's paged plain
        # decode; elsewhere the key is None and every step runs eagerly
        self._decode_graph = None
        self._graph_samples = 0  # sampler kernel launches in one replay of the graph
        self._graph_key = None
        if self.device.type == "cuda" and self.paged and not self.spec_k:
            self._graph_key = torch.zeros((2,), dtype=torch.int64, device=dev)

    # ------------------------------------------------------------------
    # Page allocator
    # ------------------------------------------------------------------
    def _required_pages(self, req: Request) -> int:
        """Pages to reserve: prompt + full decode budget, so the decode loop
        never allocates (writes past the reservation land on the trash page)."""
        plen = int(np.asarray(req.batch["attention_mask"]).sum())
        total = min(plen + req.max_new_tokens, self.cfg.max_seq_len)
        return -(-total // self.page_size)

    def _alloc_pages(self, n: int) -> List[int]:
        ids = [self.free_pages.pop() for _ in range(n)]
        for p in ids:
            self.page_ref[p] = 1
        return ids

    def _reserve_pages(self, req: Request, slot: int) -> None:
        need = self._required_pages(req)
        ids = self._alloc_pages(need)
        self.page_table[slot, :] = 0
        self.page_table[slot, :need] = ids
        self.slot_num_pages[slot] = need

    def _reserve_fork_pages(self, req: Request, slot: int, parent_slot: int,
                            plen: int) -> int:
        """Fork ``slot`` off ``parent_slot``'s prompt: share the parent's
        full prompt pages (refcount + 1), allocate its own pages for the rest
        of [plen, plen + budget). Returns the parent's partial page to copy
        (0: the prompt is page-aligned, nothing to copy)."""
        P = self.page_size
        total = min(plen + req.max_new_tokens, self.cfg.max_seq_len)
        need = -(-total // P)
        n_full = min(plen // P, need)
        shared = [int(p) for p in self.page_table[parent_slot, :n_full]]
        for p in shared:
            self.page_ref[p] += 1
        own = self._alloc_pages(need - n_full)
        self.page_table[slot, :] = 0
        self.page_table[slot, :need] = shared + own
        self.slot_num_pages[slot] = need
        if plen % P != 0 and need > n_full:
            return int(self.page_table[parent_slot, n_full])
        return 0

    def _release_pages(self, slot: int) -> None:
        used = int(self.slot_num_pages[slot])
        for p in self.page_table[slot, :used]:
            p = int(p)
            self.page_ref[p] -= 1
            if self.page_ref[p] == 0:
                self.free_pages.append(p)
        self.page_table[slot, :] = 0
        self.slot_num_pages[slot] = 0

    def _bucket_page_ids(self, slots: List[int], bucket: int) -> np.ndarray:
        """Pool page ids receiving each request's bucket-shaped prefill KV;
        bucket pages beyond a slot's reservation map to the trash page."""
        bp = max(1, bucket // self.page_size)
        ids = np.zeros((len(slots) * bp,), np.int32)
        for j, slot in enumerate(slots):
            used = int(self.slot_num_pages[slot])
            ids[j * bp: j * bp + min(bp, used)] = self.page_table[slot, :min(bp, used)]
        return ids

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------
    def _filter_logits(self, scaled: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
        """Engine-wide top-k, then per-slot top-p (inclusive of the token
        that crosses the threshold)."""
        cfg = self.cfg
        if cfg.top_k and cfg.top_k > 0:
            kth = torch.topk(scaled, cfg.top_k, dim=-1).values[..., -1:]
            scaled = torch.where(scaled < kth, -torch.inf, scaled)
        if cfg.top_p < 1.0:
            V = scaled.shape[-1]
            sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
            cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
            cutoff_idx = (cum < top_ps[:, None]).sum(dim=-1, keepdim=True)
            cutoff = torch.gather(sorted_logits, -1, cutoff_idx.clamp(max=V - 1))
            scaled = torch.where(scaled < cutoff, -torch.inf, scaled)
        return scaled

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                key: Optional[torch.Tensor]) -> torch.Tensor:
        """(n, V) logits -> (n,) int32 tokens; temperature 0 is greedy.
        ``key``: one key for all rows, or one per row (``prng.categorical``);
        unused when the engine does not sample. Without top-k or top-p the
        whole draw is ``sampling.sample``; with either, the filter runs
        eagerly and ``sampling.gumbel_argmax`` draws from what it leaves."""
        cfg = self.cfg
        if not cfg.do_sample:
            return torch.argmax(logits.float(), dim=-1).to(torch.int32)
        launched = sampling.launches["gumbel_argmax"]
        if not ((cfg.top_k or 0) > 0 or cfg.top_p < 1.0):
            tokens = sampling.sample(logits.contiguous(), temps, key)
        else:
            logits = logits.float()
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)
            scaled = self._filter_logits(logits / torch.clamp(temps, min=1e-6)[:, None], top_ps)
            tokens = torch.where(temps > 1e-6, sampling.gumbel_argmax(scaled, key), greedy)
        self.n_kernel_samples += sampling.launches["gumbel_argmax"] > launched
        return tokens

    def _w8a8_gate(self, jax_rows: int) -> int:
        """The W8A8 row gate of a prefill call whose JAX counterpart has
        ``jax_rows`` padded rows: 1 (every row of the call passes) when that
        call crosses the JAX engine's gate of 256, else 0 (W8A16). A chunk
        cut at the slab's end keeps its bucket's decision."""
        return int(self.cfg.w8a8_prefill and jax_rows >= W8A8_MIN_ROWS)

    def _next_seed(self) -> int:
        """Seed of the next prefill or fork sampler (the JAX ``_next_seed``)."""
        self._seed_ctr += 1
        return (self.cfg.seed + 0x9E3779B1 * self._seed_ctr) & 0x7FFFFFFF

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------
    def _set_slots(self, slot_ids, lengths, first, budgets, temps, top_ps, page_rows,
                   history_rows=None) -> None:
        """Write admitted slots' scheduling rows; a slot starts active unless
        its first token already ends it. ``history_rows`` (n, width) are the
        committed tokens before position ``lengths`` (speculative engines)."""
        st = self.state
        st["length"][slot_ids] = lengths
        st["tokens"][slot_ids] = first
        st["active"][slot_ids] = (first != self.eos_id) & (budgets > 1)
        st["remaining"][slot_ids] = budgets - 1
        st["temps"][slot_ids] = temps
        st["top_ps"][slot_ids] = top_ps
        if self.paged:
            st["pages_length"][slot_ids] = lengths
            st["page_table"][slot_ids] = page_rows
        if "history" in st:
            hist = st["history"]
            width = min(history_rows.shape[1], hist.shape[1])
            hist[slot_ids, :width] = history_rows[:, :width].to(hist.dtype)
            hist[slot_ids, lengths.long()] = first

    def _prefill(self, bucket: int, input_ids, attention_mask, mm_inputs, dest,
                 slot_ids, page_rows, temps, top_ps, budgets, seed: int):
        """Encode + splice + causal prefill of n requests into a local cache,
        then copy it into the engine's cache (paged: one scatter of the
        written pages into the pool at page ids ``dest``; slab: each
        request's row into its slot) and set the admitted slots' scheduling
        rows. Returns (lengths, first_tokens, last_logits); forks sample from
        the last logits without re-running the prompt."""
        llm_cfg = self.model.config.llm
        st, n = self.state, input_ids.shape[0]
        with tracer.span("prefill.embed"):
            embeds = self.model.embed(input_ids, mm_inputs)
        local = init_kv_cache(llm_cfg, n, bucket, dtype=st["k"].dtype, device=self.device)
        with tracer.span("prefill.decoder"):
            hidden, local = self.llm(inputs_embeds=embeds, attention_mask=attention_mask,
                                     kv_cache=local, prefill=True, return_hidden=True,
                                     w8a8_min_rows=self._w8a8_gate(n * bucket))
        lengths = attention_mask.sum(dim=-1).to(torch.int32)
        L, _, Hkv, _, Dh = local["k"].shape
        with tracer.span("prefill.cache_write"):
            for name in ("k", "v"):
                if not self.paged:
                    # a bucket can be wider than the slot's row: its prefix is
                    # copied (the prompt itself is shorter than max_seq_len)
                    width = min(bucket, st[name].shape[3])
                    st[name][:, slot_ids, :, :width] = local[name][:, :, :, :width]
                    continue
                P = self.page_size
                if bucket >= P:
                    bp = bucket // P
                    pages = (local[name].reshape(L, n, Hkv, bp, P, Dh)
                             .permute(0, 2, 1, 3, 4, 5).reshape(L, Hkv, n * bp, P, Dh))
                    # unused bucket pages all go to trash page 0: duplicate
                    # targets there are harmless (nothing reads page 0 as data)
                    st[name].index_copy_(2, dest, pages)
                else:
                    # a bucket smaller than a page fills the first rows of one page
                    st[name][:, :, dest, :bucket] = local[name].permute(0, 2, 1, 3, 4)
        with tracer.span("prefill.sample"):
            last_h = hidden[torch.arange(n, device=self.device), lengths.long() - 1]
            last_logits = self.llm.lm_head_logits(last_h)
            first = self._sample(last_logits, temps, top_ps, prng.prng_key(seed))
        self._set_slots(slot_ids, lengths, first, budgets, temps, top_ps, page_rows,
                        input_ids)
        return lengths, first, last_logits

    def _chunk_mm(self, mm, start: int, length: int, bucket: int):
        """A request's mm pack in chunk-local coordinates: spans outside
        [start, start + length) point past the chunk (dropped by the splice).
        Every chunk encodes the full item stack, as the JAX engine does."""
        if not mm:
            return None
        out = {}
        for mtype, pack in mm.items():
            tp = np.asarray(pack["token_pos"])
            bi = np.asarray(pack["batch_idx"])
            in_chunk = (tp >= start) & (tp < start + length) & (bi < 1)
            out[mtype] = {
                "values": torch.from_numpy(np.asarray(pack["values"])).to(self.device),
                "batch_idx": torch.from_numpy(
                    np.where(in_chunk, 0, 1).astype(np.int32)).to(self.device),
                "token_pos": torch.from_numpy(
                    np.where(in_chunk, tp - start, bucket).astype(np.int32)).to(self.device),
            }
        return out

    def _get_chunk_slab(self) -> Dict[str, torch.Tensor]:
        """Persistent (L, 1, Hkv, pages_max * P, Dh) slab reused by every
        chunked prefill (a chunk attends only positions its prompt wrote)."""
        if self._chunk_slab is None:
            llm = self.model.config.llm
            shape = (llm.num_layers, 1, llm.num_kv_heads, self.pages_max * self.page_size,
                     llm.head_dim_)
            kw = dict(dtype=self.state["k"].dtype, device=self.device)
            self._chunk_slab = {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
        return self._chunk_slab

    def _prefill_chunked(self, req: Request, slot: int, reserve: bool = True) -> None:
        """Prefill a prompt longer than the largest bucket in bucket-sized
        causal chunks at offsets ``start``: paged, into the persistent slab,
        then fold the slab into the slot's pages with one scatter; slab,
        straight into the slot's own row of the cache."""
        ids = np.asarray(req.batch["input_ids"])[0]
        plen = int(np.asarray(req.batch["attention_mask"]).sum())
        ids = ids[:plen]
        W = self.cfg.prefill_buckets[-1]
        mm = req.batch.get("mm_inputs") or {}
        if self.paged:
            if reserve:
                self._reserve_pages(req, slot)
            slab = self._get_chunk_slab()
        else:
            slab = {name: self.state[name][:, slot:slot + 1] for name in ("k", "v")}
        dev, llm = self.device, self.llm
        temps = torch.tensor([req.temperature], dtype=torch.float32, device=dev)
        top_ps = torch.tensor([req.top_p], dtype=torch.float32, device=dev)
        start = 0
        with torch.inference_mode():
            while start < plen:
                c = min(W, plen - start)
                bucket = next(b for b in self.cfg.prefill_buckets if c <= b)
                with tracer.span("engine.prefill") as sp:
                    if sp:
                        sp.set(rids=[req.request_id], tokens=[c],
                               images=[mm_item_count(mm, 1)])
                    # a chunk's padding past the slab's end is dropped by the
                    # cache write, as JAX's out-of-range writes are
                    chunk_ids = np.zeros((1, bucket), np.int64)
                    chunk_ids[0, :c] = ids[start: start + c]
                    chunk_mask = np.zeros((1, bucket), np.int32)
                    chunk_mask[0, :c] = 1
                    seed = self._next_seed()
                    with tracer.span("prefill.embed"):
                        embeds = self.model.embed(torch.from_numpy(chunk_ids).to(dev),
                                                  self._chunk_mm(mm, start, c, bucket))
                    cache = {"k": slab["k"], "v": slab["v"],
                             "length": torch.tensor([start], dtype=torch.int32, device=dev)}
                    with tracer.span("prefill.decoder"):
                        hidden, _ = llm(inputs_embeds=embeds,
                                        attention_mask=torch.from_numpy(chunk_mask).to(dev),
                                        kv_cache=cache, prefill=True, return_hidden=True,
                                        w8a8_min_rows=self._w8a8_gate(bucket))
                    with tracer.span("prefill.sample"):
                        last_logits = llm.lm_head_logits(hidden[:, c - 1])
                        first = self._sample(last_logits, temps, top_ps, prng.prng_key(seed))
                    self.n_prefill_calls += 1
                    start += c
                    if start < plen:
                        continue
                    # the last chunk also folds the prompt into the page pool
                    # once and reads its first token back
                    self._last_prefill_logits = last_logits
                    page_row = None
                    if self.paged:
                        with tracer.span("prefill.cache_write"):
                            L, _, Hkv, _, Dh = slab["k"].shape
                            dest = torch.from_numpy(
                                self.page_table[slot].astype(np.int64)).to(dev)
                            for name in ("k", "v"):
                                self.state[name].index_copy_(2, dest, slab[name][:, 0].reshape(
                                    L, Hkv, self.pages_max, self.page_size, Dh))
                        page_row = torch.from_numpy(self.page_table[slot:slot + 1]).to(dev)
                    self._set_slots(
                        torch.tensor([slot], device=dev),
                        torch.tensor([plen], dtype=torch.int32, device=dev), first,
                        torch.tensor([req.max_new_tokens], dtype=torch.int32, device=dev),
                        temps, top_ps, page_row,
                        torch.from_numpy(ids[None].astype(np.int32)).to(dev))
                    first, moe = self._read_back(first)
                    self._count_experts(sp, moe)
                    first = int(first[0])
        self._admit_on_host(req, slot, plen, first, time.time())

    def _admit_on_host(self, req: Request, slot: int, length: int, first: int,
                       now: float) -> None:
        """Host mirror of an admitted slot (its device row is already set)."""
        req.first_token_time = now
        req.tokens.append(first)
        self.slot_request[slot] = req
        self.lengths[slot] = length
        self.slot_budget[slot] = req.max_new_tokens
        self.slot_generated[slot] = 1
        if first == self.eos_id:
            self._finish(slot, reason="eos")
        elif req.max_new_tokens <= 1:
            self._finish(slot, reason="budget")
        else:
            self.active[slot] = True

    # ------------------------------------------------------------------
    # Forked groups
    # ------------------------------------------------------------------
    def _fork(self, fork_slots: List[int], src_page: int, dst_pages: List[int], plen: int,
              forks: List[Request], seed: int, src_slot: int) -> torch.Tensor:
        """Admit slots sharing a just-prefilled prompt: copy the parent's
        partial last page into each fork's own page and sample the forks'
        first tokens from the primary's saved last logits."""
        st, dev = self.state, self.device
        n = len(fork_slots)
        if src_page:
            dst = torch.tensor(dst_pages, dtype=torch.long, device=dev)
            for name in ("k", "v"):
                src = st[name][:, :, src_page:src_page + 1]
                st[name].index_copy_(2, dst, src.expand(-1, -1, n, -1, -1).contiguous())
        logits = self._last_prefill_logits[0].expand(n, -1)
        temps = torch.tensor([r.temperature for r in forks], dtype=torch.float32, device=dev)
        top_ps = torch.tensor([r.top_p for r in forks], dtype=torch.float32, device=dev)
        budgets = torch.tensor([r.max_new_tokens for r in forks], dtype=torch.int32, device=dev)
        first = self._sample(logits, temps, top_ps, prng.prng_key(seed))
        history = (st["history"][src_slot:src_slot + 1].expand(n, -1).clone()
                   if "history" in st else None)
        self._set_slots(torch.tensor(fork_slots, device=dev),
                        torch.full((n,), plen, dtype=torch.int32, device=dev), first, budgets,
                        temps, top_ps, torch.from_numpy(self.page_table[fork_slots]).to(dev),
                        history)
        return first

    def _try_admit_group(self, primary: Request, free: List[int]) -> bool:
        """Admit a forked group (primary + siblings) atomically: one
        prefill, then the fork. Returns False when slots or pages are short
        (the group waits at the queue head)."""
        forks = primary.forks
        need_slots = 1 + len(forks)
        if len(free) < need_slots:
            return False
        plen = int(np.asarray(primary.batch["attention_mask"]).sum())
        p_need = self._required_pages(primary)
        n_full = min(plen // self.page_size, p_need)
        own = max(p_need - n_full, 0)
        if p_need + len(forks) * own > len(self.free_pages):
            return False
        self.queue.remove(primary)
        slots = [free.pop(0) for _ in range(need_slots)]
        slot0, fork_slots = slots[0], slots[1:]
        # every page is reserved first: the forks' refcounts on the shared
        # prompt pages must exist before the primary might finish and release
        self._reserve_pages(primary, slot0)
        src_page = 0
        for f, s in zip(forks, fork_slots):
            src_page = self._reserve_fork_pages(f, s, slot0, plen) or src_page
        if self._bucket_for(primary.batch["input_ids"].shape[1]) is None:
            self._prefill_chunked(primary, slot0, reserve=False)
        else:
            self._prefill_group([primary], [slot0], self._request_signature(primary),
                                reserve=False)
        dst_pages = [int(self.page_table[s, n_full]) for s in fork_slots]
        with tracer.span("engine.fork"), torch.inference_mode():
            first = self._fork(fork_slots, src_page, dst_pages, plen, forks,
                               self._next_seed(), slot0).cpu().numpy()
        now = time.time()
        for j, (req, slot) in enumerate(zip(forks, fork_slots)):
            self._admit_on_host(req, slot, plen, int(first[j]), now)
        return True

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def _decode_step(self, key: Optional[torch.Tensor]) -> None:
        """One single-token step over the slot pool, in place: reads the
        state's ``tokens``, ``active``, ``remaining`` and ``length``, the
        cache and the step's ``key`` (a host key, or the graph's key on the
        device; None when the engine does not sample), and writes the next
        ``tokens``, ``active``, ``remaining`` and ``length``. It launches
        work and nothing else (no sync, no host tensor), so the eager loop
        runs it and a CUDA graph captures it. EOS, budget and capacity
        deactivate slots; an inactive slot keeps its length and emits EOS."""
        st, eos, llm = self.state, self.eos_id, self.llm
        tokens, active, length = st["tokens"], st["active"], st["length"]
        with tracer.span("decode.forward"):
            logits, new_cache = llm(inputs_embeds=llm.embed(tokens)[:, None, :],
                                    kv_cache={k: st[k] for k in self.cache_keys})
        with tracer.span("decode.sample"):
            nxt = self._sample(logits[:, 0], st["temps"], st["top_ps"], key)
            nxt = torch.where(active, nxt, eos)
        # only active slots advance their cache length; the token just
        # produced consumed one unit of budget
        new_length = torch.where(active, new_cache["length"], length)
        remaining = st["remaining"] - active.to(torch.int32)
        st["active"].copy_(active & (nxt != eos) & (remaining > 0)
                           & (new_length < self.cfg.max_seq_len))
        st["remaining"].copy_(remaining)
        length.copy_(new_length)
        tokens.copy_(nxt)

    def _capture_decode_step(self) -> None:
        """Capture :meth:`_decode_step` as a CUDA graph over the state's
        tensors and the static key, after one eager warm-up step on the
        capture stream whose state writes are undone (the ring row it
        writes, the step writes again before any read; an expert decoder's
        counters are restored). The graph reads
        the decoder's parameters and the state's tensors by address:
        weights updated in place are seen, a tensor replaced is not."""
        st, dev = self.state, self.device
        names = ("tokens", "active", "remaining", "length")
        saved = [st[n].clone() for n in names]
        # an expert decoder's counters, which the warm-up step would count too
        stats = self.llm.moe_stats
        saved_stats = None if stats is None else stats.clone()
        key = self._graph_key if self.cfg.do_sample else None
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._decode_step(key)
            for n, t in zip(names, saved):
                st[n].copy_(t)
            if stats is not None:
                stats.copy_(saved_stats)
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        samples, launched = self.n_kernel_samples, sampling.launches["gumbel_argmax"]
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            self._decode_step(key)
        # the capture ran nothing: the sampler launches it recorded count at
        # each replay
        self._graph_samples = sampling.launches["gumbel_argmax"] - launched
        self.n_kernel_samples = samples
        self._decode_graph = graph

    def _decode_chunk(self, chunk: int) -> torch.Tensor:
        """``chunk`` single-token steps over the slot pool, then (paged) the
        ring fold. A live step runs :meth:`_decode_step`: on the card, with
        paged KV and no speculation, as the replay of one CUDA graph (the
        ring row is found on the device, so one graph serves every step and
        chunk size), else eagerly. Returns the (chunk, slots) token matrix."""
        st, dev = self.state, self.device
        # the JAX chunk splits its key once per step, dead steps included
        key, subs = prng.prng_key(st["seed"]), []
        for _ in range(chunk if self.cfg.do_sample else 0):
            key, sub = prng.split(key)
            subs.append(sub)
        graph = self._graph_key is not None
        if graph and subs:
            # the chunk's keys reach the card in one pinned copy
            subs = torch.stack(subs).pin_memory().to(dev, non_blocking=True)
        toks = torch.empty((chunk, self.cfg.max_slots), dtype=torch.int32, device=dev)
        for i in range(chunk):
            sub = subs[i] if len(subs) else None
            with tracer.span("decode.step") as sp:
                with tracer.span("decode.wait"):
                    ran = bool(st["active"].any())
                sp.set(ran=ran)
                if ran:
                    self.n_decode_steps += 1
                    if not graph:
                        self._decode_step(sub)
                    else:
                        sp.set(graph=True)
                        if self._decode_graph is None:
                            self._capture_decode_step()
                        with tracer.span("decode.forward"):
                            if sub is not None:
                                self._graph_key.copy_(sub)
                            self._decode_graph.replay()
                        self.n_decode_graph_steps += 1
                        self.n_kernel_samples += self._graph_samples
                # a skipped step (every slot done) repeats the last token row
                toks[i].copy_(st["tokens"])
        with tracer.span("decode.fold"):
            if self.paged:
                # absorb the chunk's ring rows into the page pool; rows past a
                # slot's final length are not written
                fold_ring_into_pages(st["k"], st["v"], st["ring_k"], st["ring_v"],
                                     st["page_table"], st["pages_length"], chunk,
                                     st["length"])
                st["pages_length"].copy_(st["length"])
            self.n_decode_chunks += 1
        st["seed"] = _wrap_int32(st["seed"] + 1)
        return toks

    def _draft(self, history: torch.Tensor, length: torch.Tensor,
               last_tok: torch.Tensor) -> torch.Tensor:
        """(B, k) n-gram drafts. Committed tokens are history[:, :length + 1]
        (history[length] == last_tok). The most recent earlier occurrence of
        the current trigram outranks any bigram match; the draft is the k
        tokens that followed it, or the last token repeated when nothing
        matches. Any draft is correct under verification: a miss costs speed."""
        k = self.spec_k
        Lh = history.shape[1]
        pos = torch.arange(Lh, device=history.device)[None, :]
        n = length.long()[:, None]
        prev = history.gather(1, (n - 1).clamp(min=0))
        prev2 = history.gather(1, (n - 2).clamp(min=0))
        m2 = (history.roll(1, dims=1) == prev) & (history == last_tok[:, None])
        m3 = m2 & (history.roll(2, dims=1) == prev2) & (n >= 2)
        valid = (pos >= 1) & (pos <= n - 1) & (n >= 1)
        score = torch.where(m3 & valid, pos + Lh, torch.where(m2 & valid, pos, -1))
        j_s = score.amax(dim=1)
        found = j_s >= 1
        j = torch.where(j_s >= Lh, j_s - Lh, j_s)
        start = (j + 1).clamp(0, Lh - k)
        cand = history.gather(1, start[:, None] + torch.arange(k, device=history.device)[None, :])
        return torch.where(found[:, None], cand, last_tok[:, None])

    def _verify_step(self, cache, history, tokens, active, remaining):
        """One draft -> verify -> accept step over the slot pool (the JAX
        speculative ``one_step``). Returns the new (history, tokens, active,
        remaining) and the step's (B, k+1) tokens and emission mask."""
        st, cfg, k = self.state, self.cfg, self.spec_k
        llm, eos, max_len = self.llm, self.eos_id, cfg.max_seq_len
        B, Lh = history.shape
        length = cache["length"]
        block = torch.cat([tokens[:, None], self._draft(history, length, tokens)], dim=1)
        # a slab cache runs the block as a prefill: causal at per-slot offsets
        logits, new_cache = llm(inputs_embeds=llm.embed(block), kv_cache=cache, prefill=True)
        idx = torch.arange(k + 1, device=self.device)[None, :]
        keys = None
        if cfg.do_sample:
            # position-keyed: the token at position p of slot b draws with
            # fold_in(PRNGKey(seed), b * 2**20 + p), whatever k and the drafts
            ids = (torch.arange(B, device=self.device)[:, None] * (1 << 20)
                   + length[:, None].long() + idx).reshape(-1)
            keys = prng.fold_in(prng.prng_key(_wrap_int32(cfg.seed)), ids)
        # (B, k+1, V) logits: one row a position, each with its slot's settings
        g = self._sample(logits.reshape(B * (k + 1), -1), st["temps"].repeat_interleave(k + 1),
                         st["top_ps"].repeat_interleave(k + 1), keys).reshape(B, k + 1)
        # accept the longest draft prefix the verifier agrees with, plus one
        match = (block[:, 1:] == g[:, :-1]).to(torch.int32)
        a = torch.cumprod(match, dim=1).sum(dim=1)
        emit = idx <= a[:, None]
        # stop at the first EOS (inclusive), the budget and the cache's end
        eos_hit = (g == eos) & emit
        after = torch.cumsum(eos_hit.to(torch.int32), dim=1) - eos_hit.to(torch.int32)
        emit = emit & (after == 0) & (idx < remaining[:, None])
        emit = emit & (length[:, None] + idx <= max_len - 1) & active[:, None]
        n_emit = emit.sum(dim=1, dtype=torch.int32)
        last = g.gather(1, (n_emit.long() - 1).clamp(min=0)[:, None])[:, 0]
        tokens = torch.where(n_emit > 0, last, tokens)
        finished_eos = (eos_hit & emit).any(dim=1)
        new_length = length + n_emit
        remaining = remaining - n_emit
        active = active & ~finished_eos & (remaining > 0) & (new_length < max_len)
        # committed tokens land at length + 1 + i; the others are dropped
        pos = torch.where(emit, length[:, None].long() + 1 + idx, Lh)
        hist = torch.cat([history, history.new_zeros((B, 1))], dim=1)
        history = hist.scatter_(1, pos, g)[:, :Lh]
        if self.paged:
            # fold every verify step: accepted rows land in their pages,
            # rejected rows (past the new length) are not written, and the
            # next block starts at ring row 0 again
            fold_ring_into_pages(st["k"], st["v"], st["ring_k"], st["ring_v"],
                                 st["page_table"], new_cache["pages_length"],
                                 st["ring_k"].shape[3], new_length)
            cache["pages_length"] = new_length
        cache["length"] = new_length
        return history, tokens, active, remaining, g, emit

    def _spec_chunk(self, n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``n_steps`` verify steps; returns the (n_steps, slots, k+1) token
        matrix and emission mask."""
        st = self.state
        cache = {k: st[k] for k in self.cache_keys}
        history, tokens = st["history"], st["tokens"]
        active, remaining = st["active"], st["remaining"]
        B, k = tokens.shape[0], self.spec_k
        gs, emits = [], []
        for _ in range(n_steps):
            if not bool(active.any()):  # every slot is done: skip the step
                gs.append(torch.zeros((B, k + 1), dtype=torch.int32, device=self.device))
                emits.append(torch.zeros((B, k + 1), dtype=torch.bool, device=self.device))
                continue
            history, tokens, active, remaining, g, emit = self._verify_step(
                cache, history, tokens, active, remaining)
            gs.append(g)
            emits.append(emit)
        st["length"].copy_(cache["length"])
        if self.paged:
            st["pages_length"].copy_(cache["pages_length"])
        st["history"].copy_(history)
        st["tokens"].copy_(tokens)
        st["active"].copy_(active)
        st["remaining"].copy_(remaining)
        return torch.stack(gs), torch.stack(emits)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def submit(self, batch: Dict[str, Any], max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None) -> Request:
        """Queue a single-sample collated batch (B=1, right-padded)."""
        if batch["input_ids"].shape[0] != 1:
            raise ValueError("submit() takes B=1 batches")
        if top_p is not None and top_p < 1.0 and self.cfg.top_p >= 1.0:
            raise ValueError(
                "per-request top_p needs the engine built with "
                "EngineConfig(top_p < 1.0) so the nucleus filter is on")
        self._bucket_for(batch["input_ids"].shape[1])  # raises for a prompt too long
        req = Request(
            request_id=self._next_id,
            batch=batch,
            max_new_tokens=max_new_tokens or self.cfg.max_new_tokens,
            temperature=self.cfg.temperature if temperature is None else temperature,
            top_p=self.cfg.top_p if top_p is None else top_p,
            submit_time=time.time(),
        )
        if self.paged and self._required_pages(req) > self.num_pages - 1:
            raise ValueError(
                f"request needs {self._required_pages(req)} KV pages but the "
                f"pool only has {self.num_pages - 1}; raise num_pages or "
                f"lower max_new_tokens")
        self._next_id += 1
        self.queue.append(req)
        return req

    def submit_group(self, batch: Dict[str, Any], n: int, max_new_tokens: Optional[int] = None,
                     temperature: Optional[float] = None,
                     top_p: Optional[float] = None) -> List[Request]:
        """Queue ``n`` requests over one prompt. Paged: the prompt prefills
        once and the n - 1 siblings fork its KV: they share its full pages by
        refcount, each owning its decode pages and a copy of the partial
        tail page. Slab: n independent submissions."""
        if n < 1:
            raise ValueError("submit_group needs n >= 1")
        kw = dict(max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p)
        if not self.paged or n == 1:
            return [self.submit(batch, **kw) for _ in range(n)]
        if n > self.cfg.max_slots:
            raise ValueError(
                f"group of {n} exceeds max_slots={self.cfg.max_slots}; "
                "a forked group is admitted atomically")
        primary = self.submit(batch, **kw)
        plen = int(np.asarray(batch["attention_mask"]).sum())
        p_need = self._required_pages(primary)
        own = max(p_need - min(plen // self.page_size, p_need), 0)
        if p_need + (n - 1) * own > self.num_pages - 1:
            self.queue.remove(primary)
            raise ValueError(
                f"group needs {p_need + (n - 1) * own} KV pages but the "
                f"pool only has {self.num_pages - 1}; raise num_pages or "
                "lower max_new_tokens/group size")
        for _ in range(n - 1):
            primary.forks.append(Request(
                request_id=self._next_id, batch=batch,
                max_new_tokens=primary.max_new_tokens, temperature=primary.temperature,
                top_p=primary.top_p, submit_time=primary.submit_time))
            self._next_id += 1
        return [primary] + primary.forks

    def _bucket_for(self, seq_len: int) -> Optional[int]:
        """Smallest bucket holding ``seq_len``; None -> chunked prefill."""
        for b in self.cfg.prefill_buckets:
            if seq_len <= b:
                return b
        if seq_len >= self.cfg.max_seq_len:
            raise ValueError(
                f"Prompt length {seq_len} exceeds max_seq_len "
                f"{self.cfg.max_seq_len} (no room to decode)")
        return None

    @staticmethod
    def _pad_to(x, target, value=0):
        x = np.asarray(x)
        if x.shape[1] == target:
            return x
        pad = [(0, 0), (0, target - x.shape[1])] + [(0, 0)] * (x.ndim - 2)
        return np.pad(x, pad, constant_values=value)

    def _request_signature(self, req: Request) -> tuple:
        bucket = self._bucket_for(req.batch["input_ids"].shape[1])
        mm = req.batch.get("mm_inputs") or {}
        mm_sig = tuple(sorted(
            (mtype, tuple(np.asarray(p["values"]).shape),
             tuple(np.asarray(p["batch_idx"]).shape))
            for mtype, p in mm.items()))
        return (bucket, mm_sig)

    def _admit(self) -> None:
        """Move queued requests into free slots: same-signature requests
        prefill in one batched call; a forked group is admitted atomically;
        a prompt longer than the largest bucket prefills in chunks. The head
        waits (FIFO) while the page pool cannot host it. With
        ``prefill_group_cap`` one group is admitted per engine step."""
        cap = self.cfg.prefill_group_cap
        free = [s for s in range(self.cfg.max_slots)
                if not self.active[s] and self.slot_request[s] is None]
        while self.queue and free:
            head = self.queue[0]
            if head.forks:
                if not self._try_admit_group(head, free):
                    break
                continue
            if self.paged and self._required_pages(head) > len(self.free_pages):
                break  # pool exhausted: wait for pages, don't starve the head
            if self._bucket_for(head.batch["input_ids"].shape[1]) is None:
                self.queue.remove(head)
                self._prefill_chunked(head, free.pop(0))
                continue
            take = [r for r in self.queue[: len(free)] if not r.forks
                    and self._bucket_for(r.batch["input_ids"].shape[1]) is not None]
            sig = self._request_signature(take[0])
            group = [r for r in take if self._request_signature(r) == sig]
            # the cap bounds the group, else a power of two does, as the JAX
            # engine does (there to bound its compiled variants), so both
            # engines batch alike
            group = group[:cap] if cap else group[: 1 << (len(group).bit_length() - 1)]
            if self.paged:
                # shrink the group to what the free pool can host
                budget, fits = len(self.free_pages), 0
                for r in group:
                    need = self._required_pages(r)
                    if need > budget:
                        break
                    budget -= need
                    fits += 1
                if fits == 0:
                    break
                group = group[:fits]
            for r in group:
                self.queue.remove(r)
            slots, free = free[: len(group)], free[len(group):]
            self._prefill_group(group, slots, sig)
            if cap:
                break  # staggered: this step's decode chunk runs before the next group

    def _prefill_group(self, group: List[Request], slots: List[int], sig,
                       reserve: bool = True) -> None:
        bucket, _ = sig
        with tracer.span("engine.prefill") as sp:
            if sp:
                sp.set(rids=[r.request_id for r in group],
                       tokens=[int(np.asarray(r.batch["attention_mask"]).sum()) for r in group],
                       images=[mm_item_count(r.batch.get("mm_inputs"), 1) for r in group])
            n, dev = len(group), self.device
            input_ids = np.concatenate([self._pad_to(r.batch["input_ids"], bucket) for r in group])
            mask = np.concatenate([self._pad_to(r.batch["attention_mask"], bucket) for r in group])
            mm = None
            if group[0].batch.get("mm_inputs"):
                mm = {}
                for mtype in group[0].batch["mm_inputs"]:
                    packs = [r.batch["mm_inputs"][mtype] for r in group]
                    values = np.concatenate([np.asarray(p["values"]) for p in packs])
                    # local batch row j stays j; padded slots (>= 1 in a B=1
                    # request batch) map to n, which the splice drops
                    batch_idx = np.concatenate([
                        np.where(np.asarray(p["batch_idx"]) < 1, j, n).astype(np.int32)
                        for j, p in enumerate(packs)])
                    token_pos = np.concatenate(
                        [np.asarray(p["token_pos"]) for p in packs]).astype(np.int32)
                    mm[mtype] = {
                        "values": torch.from_numpy(values).to(dev),
                        "batch_idx": torch.from_numpy(batch_idx).to(dev),
                        "token_pos": torch.from_numpy(token_pos).to(dev),
                    }
            if not self.paged:
                dest = page_rows = None  # each request's row goes to its slot
            else:
                if reserve:
                    for req, slot in zip(group, slots):
                        self._reserve_pages(req, slot)
                dest = self._bucket_page_ids(slots, bucket).astype(np.int64)
                page_rows = self.page_table[np.asarray(slots)]

            def t(a, dtype):
                return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

            with torch.inference_mode():
                lengths, first, last_logits = self._prefill(
                    bucket, t(input_ids, torch.long), t(mask, torch.int32), mm,
                    t(dest, torch.long), t(slots, torch.long), t(page_rows, torch.int32),
                    t([r.temperature for r in group], torch.float32),
                    t([r.top_p for r in group], torch.float32),
                    t([r.max_new_tokens for r in group], torch.int32), self._next_seed())
                both, moe = self._read_back(torch.stack([lengths, first]))
                lengths, first = both.numpy()
            self._last_prefill_logits = last_logits
            self.n_prefill_calls += 1
            self._count_experts(sp, moe)

        now = time.time()
        for j, (req, slot) in enumerate(zip(group, slots)):
            self._admit_on_host(req, slot, int(lengths[j]), int(first[j]), now)

    def _read_back(self, x: torch.Tensor):
        """``x`` (int32) on the host and, for an expert decoder, the expert
        counts gathered on the device since the last read, in the same copy
        (their counter is zeroed for the next call); else None."""
        stats = self.llm.moe_stats
        if stats is None:
            return x.cpu(), None
        packed = torch.cat([x.reshape(-1), stats.to(torch.int32)]).cpu()
        stats.zero_()
        return packed[:-2].view(x.shape), packed[-2:].tolist()

    def _count_experts(self, sp, moe) -> None:
        if moe is None:
            return
        self.n_experts_touched += moe[0]
        self.n_expert_assignments += moe[1]
        sp.set(experts_touched=moe[0], expert_assignments=moe[1])

    def _finish(self, slot: int, reason: str = "budget") -> None:
        if self.paged:
            self._release_pages(slot)
        req = self.slot_request[slot]
        if req is not None:
            req.done = True
            req.finish_time = time.time()
            if req.finish_reason is None:
                req.finish_reason = reason
        self.slot_request[slot] = None
        self.active[slot] = False

    def step(self) -> bool:
        """Admit + one decode chunk for all active slots.
        Returns True if any work remains."""
        with tracer.span("engine.step"):
            with tracer.span("engine.admit"):
                self._admit()
            # a slot only ends early when there is no cache room for one more token
            for slot in range(self.cfg.max_slots):
                if self.active[slot] and self.lengths[slot] >= self.cfg.max_seq_len:
                    self._finish(slot, reason="capacity")
            if not self.active.any():
                return bool(self.queue)
            if self.spec_k:
                return self._spec_step()

            # shrink the final chunk to the tightest active slot's headroom, to a
            # power of two as the JAX engine does, so both admit at the same steps
            headroom = min(self.cfg.max_seq_len - int(self.lengths[s])
                           for s in range(self.cfg.max_slots) if self.active[s])
            chunk_now = min(self.decode_chunk, max(1, headroom))
            if self.cfg.prefill_group_cap and self.queue:
                # staggered admission: a 1-step chunk between groups keeps the
                # admitted streams alive without delaying the next group's prefill
                chunk_now = 1
            chunk_now = 1 << (chunk_now.bit_length() - 1)

            active_at_start = self.active.copy()
            with tracer.span("decode.chunk") as sp, torch.inference_mode():
                toks = self._decode_chunk(chunk_now)
                with tracer.span("decode.wait"):
                    toks, moe = self._read_back(toks)
                    toks = toks.numpy()  # (chunk, slots)
                self._count_experts(sp, moe)

            # Advance the host mirrors from the tokens alone, replicating the
            # device's deactivation rules.
            with tracer.span("engine.replay") as sp:
                if sp:
                    live = np.flatnonzero(active_at_start)
                    rids = [self.slot_request[s].request_id for s in live]
                    generated = self.slot_generated[live].copy()
                for slot in range(self.cfg.max_slots):
                    if not active_at_start[slot]:
                        continue
                    req = self.slot_request[slot]
                    for s in range(chunk_now):
                        tok = int(toks[s, slot])
                        req.tokens.append(tok)
                        self.slot_generated[slot] += 1
                        self.lengths[slot] += 1
                        if tok == self.eos_id:
                            self._finish(slot, reason="eos")
                            break
                        if self.slot_generated[slot] >= self.slot_budget[slot]:
                            self._finish(slot, reason="budget")
                            break
                        if self.lengths[slot] >= self.cfg.max_seq_len:
                            # the finish (page release) happens at the top of the
                            # next step, after this chunk's fold used the pages
                            break
                if sp:
                    sp.set(emitted=dict(zip(rids, (self.slot_generated[live]
                                                   - generated).tolist())))
            return bool(self.queue) or bool(self.active.any())

    def _spec_step(self) -> bool:
        """A chunk of verify steps + the host-mirror replay. EOS, budget and
        capacity are enforced on the device by the emission mask; the
        mirrors replay it."""
        n_steps = 1 if (self.cfg.prefill_group_cap and self.queue) else self.decode_chunk
        with torch.inference_mode():
            gs, ems = self._spec_chunk(n_steps)
            gs, ems = gs.cpu().numpy(), ems.cpu().numpy()  # (n_steps, slots, k+1)
        # verify steps with a live slot, live slot-steps and committed
        # tokens: emitted / slot-steps is the tokens each verify yields
        live = ems.any(axis=2)
        self.spec_verify_steps += int(live.any(axis=1).sum())
        self.spec_slot_steps += int(live.sum())
        self.spec_emitted += int(ems.sum())
        for s in range(gs.shape[0]):
            for slot in range(self.cfg.max_slots):
                req = self.slot_request[slot]
                if req is None or not self.active[slot]:
                    continue
                for i in range(gs.shape[2]):
                    if not ems[s, slot, i]:
                        continue
                    tok = int(gs[s, slot, i])
                    req.tokens.append(tok)
                    self.slot_generated[slot] += 1
                    self.lengths[slot] += 1
                    if tok == self.eos_id:
                        self._finish(slot, reason="eos")
                        break
                if self.slot_request[slot] is not None and self.active[slot]:
                    if self.slot_generated[slot] >= self.slot_budget[slot]:
                        self._finish(slot, reason="budget")
                    elif self.lengths[slot] >= self.cfg.max_seq_len:
                        self._finish(slot, reason="capacity")
        return bool(self.queue) or bool(self.active.any())

    def run(self) -> None:
        """Drain the queue completely."""
        while self.step():
            pass

    def generate(self, batches: List[Dict[str, Any]],
                 max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 group_size: Optional[int] = None) -> List[List[int]]:
        """Synchronous batch generation through the continuous-batching path.
        With ``group_size=G`` each run of G batches repeats one prompt (the
        GRPO rollout layout) and goes through ``submit_group``."""
        kw = dict(max_new_tokens=max_new_tokens, temperature=temperature)
        if group_size and group_size > 1:
            if len(batches) % group_size != 0:
                raise ValueError("len(batches) must be a multiple of group_size")
            reqs: List[Request] = []
            for i in range(0, len(batches), group_size):
                reqs.extend(self.submit_group(batches[i], group_size, **kw))
        else:
            reqs = [self.submit(b, **kw) for b in batches]
        self.run()
        return [r.tokens for r in reqs]
