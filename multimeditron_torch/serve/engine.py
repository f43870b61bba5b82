"""Continuous-batching serving engine.

Counterpart of ``multimeditron_tpu/serve/engine.py``. The engine schedules
a fixed pool of SLOTS; the KV layout (``serve/kv.py``, from ``kv_mode``:
``PagedKV``, the default, a refcounted pool of pages and a per-chunk decode
ring; ``SlabKV``, one contiguous row a slot, as the JAX engine's non-paged
branches) owns the cache, its allocator, its writes and what admission may
take. The engine runs:

- batched PREFILL of same-signature requests (bucketed prompt length +
  modality shapes, group size capped to a power of two, or to
  ``prefill_group_cap`` when admission is staggered): modality encode and
  splice, a causal forward into a local contiguous cache, then the layout's
  write. Prompts longer than the largest bucket prefill in bucket-sized
  chunks. Requests queue (FIFO) while the layout cannot hold the head;
- FORKED GROUPS (``submit_group(n > 1)`` over a layout that forks, the GRPO
  G-per-prompt layout): the prompt prefills once; siblings share its full
  pages, copy its partial tail page and sample their first tokens from its
  last logits;
- chunked DECODE: ``decode_chunk`` single-token steps (paged: K4 over pages
  + ring, the ring folded at the chunk's end, K5; slab: K1); slots
  deactivate in the chunk on EOS, exhausted budget or a full cache;
- SPECULATIVE decoding (``speculative_k = k > 0``): each step drafts k tokens
  per slot from its token history (n-gram prompt lookup), verifies the
  (k+1)-token block (paged: K6) and commits the longest agreeing prefix plus
  one bonus token. Greedy output is exactly the plain greedy decode; sampled
  output is position-keyed, so a function of (prompt, seed) independent of k;
- per-slot temperature / top-k / top-p sampling with JAX's threefry keys
  (``serve/prng.py``): every sampled token equals the JAX engine's for the
  same logits. On the card the draw is one kernel (``ops/sampling.py``),
  after the eager top-k / top-p filter when either is on;
  ``n_kernel_samples`` counts the sampling calls that ran it, replays too;
- the INT8 LLM (``quantize_llm``): a quantised copy of the model's decoder
  (``models/llama_quant.py``; W8A16 through kernel K9, fused qkv and
  gate-up); with ``w8a8_prefill`` every prefill call runs W8A8 once its
  padded rows reach 256, while decode and verify stay W8A16.

Scheduling state lives on the engine's device (the model's device); the host
keeps mirrors for admission, page allocation and finish bookkeeping, and
downloads one token block per chunk. One chunk loop (``_decode_chunk``)
runs plain and verify steps, and one replay (``_replay``) advances the host
mirrors from either. Each live step costs one host sync (``active.any()``),
where the JAX loop skips dead steps in-graph. A step is one function over
the state, in place: ``_decode_step`` (embedding, decoder, lm_head,
sampling, state update) or ``_verify_step``. On the card, paged and without
speculation, the plain step is captured once, at the first live step, as a
CUDA graph and replayed for every live step (``n_decode_graph_steps``
counts the replays); elsewhere steps run eagerly.

A decoder with routed experts (``models/moe.py``) counts on the device the
experts that received a token and the assignments; the counts of a decode
chunk and of a prefill call come home in its tokens' ``.cpu()`` and land in
``n_experts_touched`` / ``n_expert_assignments`` and on the ``decode.chunk``
and ``engine.prefill`` spans (``experts_touched``, ``expert_assignments``).
A decoder with sliding windows or experts serves through the paged plain
path only.

Each phase of a step (admission, each prefill call and its parts, forks,
the decode chunk, each decode or verify step and its parts, the fold, the
readback and the host-mirror replay) records a span in
``profiling.tracer``, with counters from the host mirrors; a replayed step
records ``decode.forward`` around the replay (sampling included) and no
``decode.sample``, and its ``decode.step`` carries ``graph``. The tracer is
off unless enabled.

Not ported yet (``NotImplementedError``): tensor parallelism or an
external mesh, and ``attn_impl``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimeditron_torch.models.llama import init_kv_cache, refuse_windows_or_experts
from multimeditron_torch.models.llama_quant import is_quantized, quantize_llama
from multimeditron_torch.models.multimodal import MultimodalModel, mm_item_count
from multimeditron_torch.ops import sampling
from multimeditron_torch.profiling import tracer
from multimeditron_torch.serve import prng
from multimeditron_torch.serve.kv import PagedKV, SlabKV

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
        layout = {"paged": PagedKV, "slab": SlabKV}.get(cfg.kv_mode)
        if layout is None:
            raise ValueError(f"kv_mode must be paged|slab, got {cfg.kv_mode!r}")
        llm_cfg = model.config.llm
        if cfg.speculative_k > 0:
            refuse_windows_or_experts(llm_cfg, "speculative decoding (the verify block, "
                                      "kernel K6, has no window)")
        if cfg.quantize_llm:
            refuse_windows_or_experts(llm_cfg, "quantize_llm (no int8 experts)")
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device
        # the decoder every forward runs: a quantised copy with quantize_llm
        # (fused qkv / gate-up; embedding and norms shared with the model)
        self.llm = model.llm
        if cfg.quantize_llm and not is_quantized(model.llm):
            self.llm = quantize_llama(model.llm, fuse=True)
        self.eos_id = model.config.eos_token_idx
        self.decode_chunk = max(1, cfg.decode_chunk)
        self.spec_k = max(0, cfg.speculative_k)
        # Host mirrors of the scheduling state, advanced from the downloaded
        # tokens alone.
        self.lengths = np.zeros((cfg.max_slots,), np.int32)
        self.slot_request: List[Optional[Request]] = [None] * cfg.max_slots
        self.slot_budget = np.zeros((cfg.max_slots,), np.int32)
        self.slot_generated = np.zeros((cfg.max_slots,), np.int32)
        self.active = np.zeros((cfg.max_slots,), bool)

        dev, B = self.device, cfg.max_slots
        with torch.inference_mode():
            # a verify step writes one (k+1)-token block into the ring, folded
            # after every step; plain decode keeps a chunk's rows
            ring_rows = (max(self.decode_chunk, self.spec_k + 2) if self.spec_k
                         else self.decode_chunk)
            self.kv = layout(llm_cfg, cfg, ring_rows, dev)
            ints = dict(dtype=torch.int32, device=dev)
            # Device-resident scheduling state, updated in place by prefill
            # and decode (the layout's cache tensors under their own keys);
            # "remaining" is the token budget left per slot. "seed" seeds the
            # next plain decode chunk's keys (a host int: keys are derived on
            # the host, random bits on the device).
            self.state: Dict[str, Any] = {
                **self.kv.cache,
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
        if self.device.type == "cuda" and self.kv.graph and not self.spec_k:
            self._graph_key = torch.zeros((2,), dtype=torch.int64, device=dev)

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                key: Optional[torch.Tensor]) -> torch.Tensor:
        """(n, V) logits -> (n,) int32 tokens; temperature 0 is greedy.
        ``key``: one key for all rows, or one per row (``prng.categorical``);
        unused when the engine does not sample. Without top-k or top-p the
        whole draw is ``sampling.sample``; with either, engine-wide top-k and
        per-slot top-p (``sampling.filter_logits``) run eagerly and
        ``sampling.gumbel_argmax`` draws from what they leave."""
        cfg = self.cfg
        if not cfg.do_sample:
            return torch.argmax(logits.float(), dim=-1).to(torch.int32)
        launched = sampling.launches["gumbel_argmax"]
        if not ((cfg.top_k or 0) > 0 or cfg.top_p < 1.0):
            tokens = sampling.sample(logits.contiguous(), temps, key)
        else:
            logits = logits.float()
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)
            scaled = sampling.filter_logits(logits / torch.clamp(temps, min=1e-6)[:, None],
                                            cfg.top_k, top_ps if cfg.top_p < 1.0 else None)
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
    def _set_slots(self, slot_ids, lengths, first, budgets, temps, top_ps, rows,
                   history_rows=None) -> None:
        """Write admitted slots' scheduling rows and the layout's ``rows``
        (``kv.rows``); a slot starts active unless its first token already
        ends it. ``history_rows`` (n, width) are the committed tokens before
        position ``lengths`` (speculative engines)."""
        st = self.state
        st["length"][slot_ids] = lengths
        st["tokens"][slot_ids] = first
        st["active"][slot_ids] = (first != self.eos_id) & (budgets > 1)
        st["remaining"][slot_ids] = budgets - 1
        st["temps"][slot_ids] = temps
        st["top_ps"][slot_ids] = top_ps
        self.kv.set_rows(slot_ids, lengths, rows)
        if "history" in st:
            hist = st["history"]
            width = min(history_rows.shape[1], hist.shape[1])
            hist[slot_ids, :width] = history_rows[:, :width].to(hist.dtype)
            hist[slot_ids, lengths.long()] = first

    def _prefill(self, bucket: int, input_ids, attention_mask, mm_inputs, dest,
                 slot_ids, rows, temps, top_ps, budgets, seed: int):
        """Encode + splice + causal prefill of n requests into a local cache,
        then copy it into the engine's cache (``kv.write_prefill``; ``dest``
        from ``kv.prefill_dest``) and set the admitted slots' scheduling
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
        with tracer.span("prefill.cache_write"):
            self.kv.write_prefill(local, bucket, slot_ids, dest)
        with tracer.span("prefill.sample"):
            last_h = hidden[torch.arange(n, device=self.device), lengths.long() - 1]
            last_logits = self.llm.lm_head_logits(last_h)
            first = self._sample(last_logits, temps, top_ps, prng.prng_key(seed))
        self._set_slots(slot_ids, lengths, first, budgets, temps, top_ps, rows, input_ids)
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

    def _prefill_chunked(self, req: Request, slot: int) -> None:
        """Prefill a prompt longer than the largest bucket in bucket-sized
        causal chunks at offsets ``start`` into the layout's chunk target
        (paged: a persistent slab, committed to the slot's pages with one
        scatter after the last chunk; slab: the slot's own row)."""
        ids = np.asarray(req.batch["input_ids"])[0]
        plen = int(np.asarray(req.batch["attention_mask"]).sum())
        ids = ids[:plen]
        W = self.cfg.prefill_buckets[-1]
        mm = req.batch.get("mm_inputs") or {}
        slab = self.kv.chunk_target(slot)
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
                    cache = {**slab, "length": torch.tensor([start], dtype=torch.int32, device=dev)}
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
                    # the last chunk also commits the prompt to the cache
                    # once and reads its first token back
                    self._last_prefill_logits = last_logits
                    with tracer.span("prefill.cache_write"):
                        self.kv.commit_chunks(slot, slab)
                    rows = self.kv.rows([slot])
                    self._set_slots(
                        torch.tensor([slot], device=dev),
                        torch.tensor([plen], dtype=torch.int32, device=dev), first,
                        torch.tensor([req.max_new_tokens], dtype=torch.int32, device=dev),
                        temps, top_ps, rows,
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
                                    kv_cache=self.kv.cache)
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
        counters are restored). The graph reads the decoder's parameters and
        the state's tensors by address: weights updated in place are seen, a
        tensor replaced is not."""
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

    def _verify_step(self, out: torch.Tensor) -> None:
        """One draft -> verify -> accept step over the slot pool (the JAX
        speculative ``one_step``), in place: reads and writes the state's
        ``history``, ``tokens``, ``active``, ``remaining`` and ``length``,
        folds the ring through the layout, and writes the step's (B, k+1)
        tokens and emission mask into ``out[0]`` and ``out[1]``."""
        st, cfg, k = self.state, self.cfg, self.spec_k
        llm, eos, max_len = self.llm, self.eos_id, cfg.max_seq_len
        history, tokens, active = st["history"], st["tokens"], st["active"]
        length, remaining = st["length"], st["remaining"]
        B = history.shape[0]
        block = torch.cat([tokens[:, None], self._draft(history, length, tokens)], dim=1)
        with tracer.span("decode.forward"):
            # a slab cache runs the block as a prefill: causal at per-slot offsets
            logits, _ = llm(inputs_embeds=llm.embed(block), kv_cache=self.kv.cache,
                            prefill=True)
        idx = torch.arange(k + 1, device=self.device)[None, :]
        keys = None
        if cfg.do_sample:
            # position-keyed: the token at position p of slot b draws with
            # fold_in(PRNGKey(seed), b * 2**20 + p), whatever k and the drafts
            ids = (torch.arange(B, device=self.device)[:, None] * (1 << 20)
                   + length[:, None].long() + idx).reshape(-1)
            keys = prng.fold_in(prng.prng_key(_wrap_int32(cfg.seed)), ids)
        with tracer.span("decode.sample"):
            # (B, k+1, V) logits: one row a position, each with its slot's settings
            g = self._sample(logits.reshape(B * (k + 1), -1),
                             st["temps"].repeat_interleave(k + 1),
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
        finished_eos = (eos_hit & emit).any(dim=1)
        new_length = length + n_emit
        new_remaining = remaining - n_emit
        # committed tokens land at length + 1 + i; the others write back
        # what is there (every position lies below the history's width)
        pos = length[:, None].long() + 1 + idx
        history.scatter_(1, pos, torch.where(emit, g, history.gather(1, pos)))
        tokens.copy_(torch.where(n_emit > 0, last, tokens))
        active.copy_(active & ~finished_eos & (new_remaining > 0) & (new_length < max_len))
        remaining.copy_(new_remaining)
        length.copy_(new_length)
        out[0].copy_(g)
        out[1].copy_(emit)
        with tracer.span("decode.fold"):
            # accepted rows land in their pages, rejected rows (past the new
            # length) are not written, and the next block starts at ring row 0
            self.kv.fold(k + 1)

    def _decode_chunk(self, chunk: int) -> torch.Tensor:
        """``chunk`` steps over the slot pool, then the layout's fold. A live
        step runs :meth:`_verify_step` with speculation, else
        :meth:`_decode_step`: as the replay of one CUDA graph where
        ``_graph_key`` is set (the ring row is found on the device, so one
        graph serves every step and chunk size), else eagerly. Returns the
        int32 block read back: (1, chunk, slots, 1) tokens, or (2, chunk,
        slots, k + 1) tokens and emission mask (zero for a skipped step)."""
        st, dev, k = self.state, self.device, self.spec_k
        # the JAX plain chunk splits its key once per step, dead steps included
        key, subs = prng.prng_key(st["seed"]), []
        for _ in range(chunk if self.cfg.do_sample and not k else 0):
            key, sub = prng.split(key)
            subs.append(sub)
        graph = self._graph_key is not None
        if graph and subs:
            # the chunk's keys reach the card in one pinned copy
            subs = torch.stack(subs).pin_memory().to(dev, non_blocking=True)
        shape = (2 if k else 1, chunk, self.cfg.max_slots, k + 1)
        out = (torch.zeros if k else torch.empty)(shape, dtype=torch.int32, device=dev)
        for i in range(chunk):
            sub = subs[i] if len(subs) else None
            with tracer.span("decode.step") as sp:
                with tracer.span("decode.wait"):
                    ran = bool(st["active"].any())
                sp.set(ran=ran)
                if ran and k:
                    self._verify_step(out[:, i])
                elif ran:
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
                if not k:
                    # a skipped step (every slot done) repeats the last token row
                    out[0, i, :, 0].copy_(st["tokens"])
        with tracer.span("decode.fold"):
            if not k:  # a verify step folds its own block
                self.kv.fold(chunk)
            self.n_decode_chunks += 1
        st["seed"] = _wrap_int32(st["seed"] + 1)
        return out

    def _replay(self, toks: np.ndarray, emits: Optional[np.ndarray], live: np.ndarray) -> None:
        """Advance the host mirrors of the ``live`` slots from a chunk's
        (steps, slots, width) tokens: each slot's tokens in order, or, with
        an emission mask (verify steps), its emitted ones. EOS and the budget
        finish a slot here; the cache's end finishes it at the top of the
        next step, after this chunk's fold used its pages."""
        if emits is not None:
            # verify steps with a live slot, live slot-steps and committed
            # tokens: emitted / slot-steps is the tokens each verify yields
            ran = emits.any(axis=2)
            self.spec_verify_steps += int(ran.any(axis=1).sum())
            self.spec_slot_steps += int(ran.sum())
            self.spec_emitted += int(emits.sum())
        with tracer.span("engine.replay") as sp:
            if sp:
                rids = [self.slot_request[s].request_id for s in live]
                generated = self.slot_generated[live].copy()
            for slot in live:
                req = self.slot_request[slot]
                row = toks[:, slot] if emits is None else toks[:, slot][emits[:, slot]]
                for tok in row.reshape(-1).tolist():
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
                        break
            if sp:
                sp.set(emitted=dict(zip(rids, (self.slot_generated[live]
                                               - generated).tolist())))

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
        self.kv.refuse(req)
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
        if not self.kv.forks or n == 1:
            return [self.submit(batch, **kw) for _ in range(n)]
        if n > self.cfg.max_slots:
            raise ValueError(
                f"group of {n} exceeds max_slots={self.cfg.max_slots}; "
                "a forked group is admitted atomically")
        primary = self.submit(batch, **kw)
        try:
            self.kv.refuse(primary, n)
        except ValueError:
            self.queue.remove(primary)
            raise
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
        waits (FIFO) while the layout cannot hold it. With
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
            if not self.kv.fitting([head]):
                break  # pool exhausted: wait for pages, don't starve the head
            if self._bucket_for(head.batch["input_ids"].shape[1]) is None:
                self.queue.remove(head)
                slot = free.pop(0)
                self.kv.reserve(head, slot)
                self._prefill_chunked(head, slot)
                continue
            take = [r for r in self.queue[: len(free)] if not r.forks
                    and self._bucket_for(r.batch["input_ids"].shape[1]) is not None]
            sig = self._request_signature(take[0])
            group = [r for r in take if self._request_signature(r) == sig]
            # the cap bounds the group, else a power of two does, as the JAX
            # engine does (there to bound its compiled variants), so both
            # engines batch alike
            group = group[:cap] if cap else group[: 1 << (len(group).bit_length() - 1)]
            # shrink the group to what the free pool can host (the head fits)
            group = group[: self.kv.fitting(group)]
            slots, free = free[: len(group)], free[len(group):]
            for r, slot in zip(group, slots):
                self.queue.remove(r)
                self.kv.reserve(r, slot)
            self._prefill_group(group, slots, sig)
            if cap:
                break  # staggered: this step's decode chunk runs before the next group

    def _try_admit_group(self, primary: Request, free: List[int]) -> bool:
        """Admit a forked group (primary + siblings) atomically: one
        prefill, then the fork: each sibling takes a copy of the primary's
        partial last page and samples its first token from the primary's
        saved last logits. Returns False when slots or pages are short (the
        group waits at the queue head)."""
        forks = primary.forks
        need_slots = 1 + len(forks)
        if len(free) < need_slots or not self.kv.fitting([primary], need_slots):
            return False
        self.queue.remove(primary)
        slots = [free.pop(0) for _ in range(need_slots)]
        slot0, fork_slots = slots[0], slots[1:]
        # every page is reserved first: the forks' refcounts on the shared
        # prompt pages must exist before the primary might finish and release
        plen = int(np.asarray(primary.batch["attention_mask"]).sum())
        self.kv.reserve(primary, slot0)
        tail = self.kv.reserve_forks(forks, fork_slots, slot0, plen)
        if self._bucket_for(primary.batch["input_ids"].shape[1]) is None:
            self._prefill_chunked(primary, slot0)
        else:
            self._prefill_group([primary], [slot0], self._request_signature(primary))
        st, dev, n = self.state, self.device, len(forks)
        with tracer.span("engine.fork"), torch.inference_mode():
            self.kv.copy_page(*tail)
            logits = self._last_prefill_logits[0].expand(n, -1)
            temps = torch.tensor([r.temperature for r in forks], dtype=torch.float32, device=dev)
            top_ps = torch.tensor([r.top_p for r in forks], dtype=torch.float32, device=dev)
            budgets = torch.tensor([r.max_new_tokens for r in forks], dtype=torch.int32,
                                   device=dev)
            first = self._sample(logits, temps, top_ps, prng.prng_key(self._next_seed()))
            history = (st["history"][slot0:slot0 + 1].expand(n, -1).clone()
                       if "history" in st else None)
            self._set_slots(torch.tensor(fork_slots, device=dev),
                            torch.full((n,), plen, dtype=torch.int32, device=dev), first,
                            budgets, temps, top_ps, self.kv.rows(fork_slots), history)
            first = first.cpu().numpy()
        now = time.time()
        for j, (req, slot) in enumerate(zip(forks, fork_slots)):
            self._admit_on_host(req, slot, plen, int(first[j]), now)
        return True

    def _prefill_group(self, group: List[Request], slots: List[int], sig) -> None:
        """One batched prefill of ``group`` into its reserved ``slots``."""
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

            def t(a, dtype):
                return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

            with torch.inference_mode():
                lengths, first, last_logits = self._prefill(
                    bucket, t(input_ids, torch.long), t(mask, torch.int32), mm,
                    self.kv.prefill_dest(slots, bucket), t(slots, torch.long),
                    self.kv.rows(slots), t([r.temperature for r in group], torch.float32),
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
        self.kv.release(slot)
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

            if self.cfg.prefill_group_cap and self.queue:
                # staggered admission: a 1-step chunk between groups keeps the
                # admitted streams alive without delaying the next group's prefill
                chunk = 1
            elif self.spec_k:
                chunk = self.decode_chunk  # the emission mask stops a slot at the cache's end
            else:
                # shrink the final chunk to the tightest active slot's headroom, to
                # a power of two as the JAX engine does, so both admit at the same
                # steps
                headroom = min(self.cfg.max_seq_len - int(self.lengths[s])
                               for s in range(self.cfg.max_slots) if self.active[s])
                chunk = 1 << (min(self.decode_chunk, max(1, headroom)).bit_length() - 1)

            live = np.flatnonzero(self.active)
            with tracer.span("decode.chunk") as sp, torch.inference_mode():
                block = self._decode_chunk(chunk)
                with tracer.span("decode.wait"):
                    block, moe = self._read_back(block)
                    block = block.numpy()
                self._count_experts(sp, moe)
            self._replay(block[0], block[1].astype(bool) if self.spec_k else None, live)
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
