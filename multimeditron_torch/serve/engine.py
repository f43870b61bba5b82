"""Continuous-batching serving engine: the paged, plain-decode subset.

Counterpart of ``multimeditron_tpu/serve/engine.py`` with ``kv_mode="paged"``:

- a fixed pool of SLOTS and a global pool of KV PAGES, with per-slot page
  tables; page 0 is the trash page. Requests reserve pages for prompt +
  decode budget at admission and queue (FIFO) while the pool is exhausted;
- batched PREFILL of same-signature requests (bucketed prompt length +
  modality shapes, group size capped to a power of two): modality encode and
  splice, a causal forward into a local contiguous cache, then one scatter of
  bucket-shaped pages into the pool;
- chunked DECODE: ``decode_chunk`` single-token steps write into a per-chunk
  ring and attend over pages + ring (kernel K4); slots deactivate in the
  chunk on EOS, exhausted budget or a full cache; at the end of the chunk the
  ring folds into the pages (kernel K5);
- per-slot temperature / top-k / top-p sampling on the device.

Scheduling state lives on the engine's device (the model's device); the host
keeps mirrors for admission, page allocation and finish bookkeeping, and
downloads one token matrix per chunk. Each live decode step costs one host
sync (``active.any()``), where the JAX loop skips dead steps in-graph.

Not ported yet (``NotImplementedError``): ``kv_mode="slab"``, speculative
decoding, tensor parallelism or an external mesh, the int8 LLM and W8A8
prefill, staggered admission, forked groups and chunked prefill of prompts
longer than the largest bucket.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimeditron_torch.models.llama import init_kv_cache, init_paged_kv_cache
from multimeditron_torch.models.multimodal import MultimodalModel
from multimeditron_torch.ops.paged_attention import fold_ring_into_pages


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

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


def _refuse_unported(cfg: EngineConfig, mesh) -> None:
    refused = [
        (cfg.kv_mode != "paged", f"kv_mode={cfg.kv_mode!r} (slab engine)"),
        (cfg.speculative_k > 0, "speculative_k > 0 (speculative decoding, kernel K6)"),
        (cfg.tp > 1 or mesh is not None, "tp > 1 or an external mesh (parallelism)"),
        (cfg.quantize_llm, "quantize_llm (quantized paths)"),
        (cfg.w8a8_prefill, "w8a8_prefill (quantized paths)"),
        (cfg.prefill_group_cap is not None, "prefill_group_cap (staggered admission)"),
        (cfg.attn_impl is not None, "attn_impl (the port picks kernels by device)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue 1, serve/engine.py)")


class ServingEngine:
    def __init__(self, model: MultimodalModel, cfg: EngineConfig, mesh=None):
        """``model`` holds the weights and lives on the engine's device."""
        _refuse_unported(cfg, mesh)
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device
        llm = model.config.llm
        self.eos_id = model.config.eos_token_idx
        self.decode_chunk = max(1, cfg.decode_chunk)
        P = cfg.page_size
        for b in cfg.prefill_buckets:
            if b >= P and b % P != 0:
                raise ValueError(f"prefill bucket {b} must divide into pages of {P}")
        if self.decode_chunk > P:
            raise ValueError(f"ring ({self.decode_chunk} rows) must fit one page ({P})")
        self.page_size = P
        self.pages_max = -(-cfg.max_seq_len // P)
        n_pages = cfg.num_pages or (1 + cfg.max_slots * self.pages_max)
        self.num_pages = n_pages

        # Host-side allocator; page 0 = trash (never allocated).
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
            cache = init_paged_kv_cache(llm, n_pages, P, self.pages_max, B,
                                        ring_size=self.decode_chunk, device=dev)
            ints = dict(dtype=torch.int32, device=dev)
            # Device-resident scheduling state, updated in place by prefill
            # and decode; "remaining" is the token budget left per slot.
            self.state: Dict[str, torch.Tensor] = {
                **cache,
                "tokens": torch.zeros((B,), **ints),
                "active": torch.zeros((B,), dtype=torch.bool, device=dev),
                "remaining": torch.zeros((B,), **ints),
                "temps": torch.full((B,), cfg.temperature, dtype=torch.float32, device=dev),
                "top_ps": torch.full((B,), cfg.top_p, dtype=torch.float32, device=dev),
            }
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.queue: List[Request] = []
        self._next_id = 0
        # work counters: prefill calls, live decode steps, decode chunks
        self.n_prefill_calls = 0
        self.n_decode_steps = 0
        self.n_decode_chunks = 0

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

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor,
                top_ps: torch.Tensor) -> torch.Tensor:
        """(n, V) logits -> (n,) int32 tokens; temperature 0 is greedy."""
        logits = logits.float()
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if not self.cfg.do_sample:
            return greedy
        scaled = self._filter_logits(logits / torch.clamp(temps, min=1e-6)[:, None], top_ps)
        probs = torch.softmax(scaled, dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0].to(torch.int32)
        return torch.where(temps > 1e-6, sampled, greedy)

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------
    def _prefill(self, bucket: int, input_ids, attention_mask, mm_inputs, dest,
                 slot_ids, page_rows, temps, top_ps, budgets):
        """Encode + splice + causal prefill of n requests into a local cache,
        then scatter the written pages into the pool and set the admitted
        slots' scheduling rows. Returns (lengths, first_tokens)."""
        llm_cfg = self.model.config.llm
        st, n, P = self.state, input_ids.shape[0], self.page_size
        embeds = self.model.embed(input_ids, mm_inputs)
        local = init_kv_cache(llm_cfg, n, bucket, dtype=st["k"].dtype, device=self.device)
        hidden, local = self.model.llm(inputs_embeds=embeds, attention_mask=attention_mask,
                                       kv_cache=local, prefill=True, return_hidden=True)
        lengths = attention_mask.sum(dim=-1).to(torch.int32)
        L, _, Hkv, _, Dh = local["k"].shape
        for name in ("k", "v"):
            if bucket >= P:
                bp = bucket // P
                pages = (local[name].reshape(L, n, Hkv, bp, P, Dh)
                         .permute(0, 2, 1, 3, 4, 5).reshape(L, Hkv, n * bp, P, Dh))
                # unused bucket pages all go to trash page 0: duplicate targets
                # there are harmless because nothing reads page 0 as data
                st[name].index_copy_(2, dest, pages)
            else:
                # a bucket smaller than a page fills the first rows of one page
                st[name][:, :, dest, :bucket] = local[name].permute(0, 2, 1, 3, 4)
        last_h = hidden[torch.arange(n, device=self.device), lengths.long() - 1]
        first = self._sample(self.model.llm.lm_head_logits(last_h), temps, top_ps)
        # a slot starts active unless the first token already ends it
        st["length"][slot_ids] = lengths
        st["tokens"][slot_ids] = first
        st["active"][slot_ids] = (first != self.eos_id) & (budgets > 1)
        st["remaining"][slot_ids] = budgets - 1
        st["temps"][slot_ids] = temps
        st["top_ps"][slot_ids] = top_ps
        st["pages_length"][slot_ids] = lengths
        st["page_table"][slot_ids] = page_rows
        return lengths, first

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def _decode_chunk(self, chunk: int) -> torch.Tensor:
        """``chunk`` single-token steps over the slot pool, then the ring
        fold. EOS, budget and capacity deactivate slots on the device.
        Returns the (chunk, slots) token matrix."""
        st, eos, max_len = self.state, self.eos_id, self.cfg.max_seq_len
        llm = self.model.llm
        cache = {k: st[k] for k in ("k", "v", "ring_k", "ring_v", "length",
                                    "page_table", "pages_length")}
        tokens, active, remaining = st["tokens"], st["active"], st["remaining"]
        rows = []
        for _ in range(chunk):
            if not bool(active.any()):  # every slot is done: skip the step
                rows.append(tokens)
                continue
            self.n_decode_steps += 1
            logits, new_cache = llm(inputs_embeds=llm.embed(tokens)[:, None, :],
                                    kv_cache=cache)
            nxt = self._sample(logits[:, 0], st["temps"], st["top_ps"])
            nxt = torch.where(active, nxt, eos)
            # only active slots advance their cache length
            cache["length"] = torch.where(active, new_cache["length"], cache["length"])
            # the token just produced consumed one unit of budget
            remaining = remaining - active.to(torch.int32)
            active = active & (nxt != eos) & (remaining > 0) & (cache["length"] < max_len)
            tokens = nxt
            rows.append(tokens)
        # absorb the chunk's ring rows into the page pool; rows past a slot's
        # final length are not written
        fold_ring_into_pages(st["k"], st["v"], st["ring_k"], st["ring_v"],
                             st["page_table"], st["pages_length"], chunk, cache["length"])
        self.n_decode_chunks += 1
        toks = torch.stack(rows)  # before st["tokens"], which rows may hold, changes
        st["length"].copy_(cache["length"])
        st["pages_length"].copy_(cache["length"])
        st["tokens"].copy_(tokens)
        st["active"].copy_(active)
        st["remaining"].copy_(remaining)
        return toks

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
        if self._bucket_for(batch["input_ids"].shape[1]) is None:
            raise NotImplementedError(
                f"a prompt of {batch['input_ids'].shape[1]} tokens exceeds the largest "
                f"prefill bucket {max(self.cfg.prefill_buckets)}; chunked prefill is "
                "not ported yet (ROADMAP queue 1, serve/engine.py)")
        req = Request(
            request_id=self._next_id,
            batch=batch,
            max_new_tokens=max_new_tokens or self.cfg.max_new_tokens,
            temperature=self.cfg.temperature if temperature is None else temperature,
            top_p=self.cfg.top_p if top_p is None else top_p,
            submit_time=time.time(),
        )
        if self._required_pages(req) > self.num_pages - 1:
            raise ValueError(
                f"request needs {self._required_pages(req)} KV pages but the "
                f"pool only has {self.num_pages - 1}; raise num_pages or "
                f"lower max_new_tokens")
        self._next_id += 1
        self.queue.append(req)
        return req

    def submit_group(self, batch: Dict[str, Any], n: int, **kw) -> List[Request]:
        """``n`` requests over one prompt. Only ``n == 1`` is ported: the
        prefix-sharing forks of ``n > 1`` are not yet."""
        if n != 1:
            raise NotImplementedError(
                "submit_group(n > 1) (forked groups) is not ported yet "
                "(ROADMAP queue 1, serve/engine.py)")
        return [self.submit(batch, **kw)]

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
        prefill in one batched call; the head waits (FIFO) while the page
        pool cannot host it."""
        free = [s for s in range(self.cfg.max_slots)
                if not self.active[s] and self.slot_request[s] is None]
        while self.queue and free:
            head = self.queue[0]
            if self._required_pages(head) > len(self.free_pages):
                break  # pool exhausted: wait for pages, don't starve the head
            take = self.queue[: len(free)]
            sig = self._request_signature(take[0])
            group = [r for r in take if self._request_signature(r) == sig]
            # cap the group to a power of two, as the JAX engine does (there to
            # bound its compiled variants), so both engines batch alike
            group = group[: 1 << (len(group).bit_length() - 1)]
            budget, fits = len(self.free_pages), 0
            for r in group:
                need = self._required_pages(r)
                if need > budget:
                    break
                budget -= need
                fits += 1
            group = group[:fits]
            for r in group:
                self.queue.remove(r)
            slots, free = free[: len(group)], free[len(group):]
            self._prefill_group(group, slots, sig)

    def _prefill_group(self, group: List[Request], slots: List[int], sig) -> None:
        bucket, _ = sig
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
        for req, slot in zip(group, slots):
            self._reserve_pages(req, slot)
        dest = self._bucket_page_ids(slots, bucket).astype(np.int64)
        page_rows = self.page_table[np.asarray(slots)]

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

        with torch.inference_mode():
            lengths, first = self._prefill(
                bucket, t(input_ids, torch.long), t(mask, torch.int32), mm,
                t(dest, torch.long), t(slots, torch.long), t(page_rows, torch.int32),
                t([r.temperature for r in group], torch.float32),
                t([r.top_p for r in group], torch.float32),
                t([r.max_new_tokens for r in group], torch.int32))
            lengths, first = lengths.cpu().numpy(), first.cpu().numpy()
        self.n_prefill_calls += 1

        now = time.time()
        for j, (req, slot) in enumerate(zip(group, slots)):
            tok = int(first[j])
            req.first_token_time = now
            req.tokens.append(tok)
            self.slot_request[slot] = req
            self.lengths[slot] = int(lengths[j])
            self.slot_budget[slot] = req.max_new_tokens
            self.slot_generated[slot] = 1
            if tok == self.eos_id:
                self._finish(slot, reason="eos")
            elif req.max_new_tokens <= 1:
                self._finish(slot, reason="budget")
            else:
                self.active[slot] = True

    def _finish(self, slot: int, reason: str = "budget") -> None:
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
        self._admit()
        # a slot only ends early when there is no cache room for one more token
        for slot in range(self.cfg.max_slots):
            if self.active[slot] and self.lengths[slot] >= self.cfg.max_seq_len:
                self._finish(slot, reason="capacity")
        if not self.active.any():
            return bool(self.queue)

        # shrink the final chunk to the tightest active slot's headroom, to a
        # power of two as the JAX engine does, so both admit at the same steps
        headroom = min(self.cfg.max_seq_len - int(self.lengths[s])
                       for s in range(self.cfg.max_slots) if self.active[s])
        chunk_now = min(self.decode_chunk, max(1, headroom))
        chunk_now = 1 << (chunk_now.bit_length() - 1)

        active_at_start = self.active.copy()
        with torch.inference_mode():
            toks = self._decode_chunk(chunk_now).cpu().numpy()  # (chunk, slots)

        # Advance the host mirrors from the tokens alone, replicating the
        # device's deactivation rules.
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
        return bool(self.queue) or bool(self.active.any())

    def run(self) -> None:
        """Drain the queue completely."""
        while self.step():
            pass

    def generate(self, batches: List[Dict[str, Any]],
                 max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 group_size: Optional[int] = None) -> List[List[int]]:
        """Synchronous batch generation through the continuous-batching path."""
        if group_size and group_size > 1:
            raise NotImplementedError(
                "group_size > 1 (forked groups) is not ported yet "
                "(ROADMAP queue 1, serve/engine.py)")
        reqs = [self.submit(b, max_new_tokens=max_new_tokens, temperature=temperature)
                for b in batches]
        self.run()
        return [r.tokens for r in reqs]
