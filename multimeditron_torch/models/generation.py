"""Batch autoregressive generation over a contiguous KV cache.

Counterpart of ``multimeditron_tpu/models/generation.py``, with its
semantics: a RIGHT-padded collated batch (each sample's tokens at positions
[0, len)) prefills into ``init_kv_cache(cfg, B, S + max_new_tokens)`` with
the true per-sample lengths; the first token is sampled from each sample's
last valid logits; each decode step then writes one K/V row at each sample's
length and attends over the masked cache (kernel K1 on the card); once a
sample emits EOS its later positions hold EOS, and the loop stops when every
sample has finished. 2-D position ids (B, S, 2) continue from their largest
valid position.

Random numbers are JAX's threefry keys (``serve/prng.py``): the default key
is ``prng_key(0)``, split once before the first token and once per step, and
``categorical`` draws with the split key, so every sampled token equals the
JAX function's for the same key and logits.

The API adapts to modules: ``generate(model, batch, ...)`` takes no
``params`` (the module holds its weights), and ``make_generate_fn(model,
**kw)`` returns ``fn(batch, key, max_new_tokens=128, do_sample=True)``.
PyTorch runs the loop eagerly: the all-finished test costs one host sync a
step, and the JAX loop's last iteration, whose token falls past the output
and is dropped, is not run.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from multimeditron_torch.models.llama import init_kv_cache, refuse_windows_or_experts
from multimeditron_torch.models.multimodal import MultimodalModel
from multimeditron_torch.serve import prng


def sample_tokens(
    logits: torch.Tensor,
    key: torch.Tensor,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 token ids: greedy without ``do_sample``,
    else temperature, a top-k threshold, then the nucleus (inclusive of the
    token that crosses ``top_p``), drawn with one threefry ``key``."""
    if not do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / max(float(temperature), 1e-6)
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return prng.categorical(key, logits).to(torch.int32)


def _to_device(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def generate(
    model: MultimodalModel,
    batch: Dict[str, Any],
    max_new_tokens: int = 512,
    temperature: float = 0.1,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
    key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generate up to ``max_new_tokens`` for a RIGHT-padded collated batch
    (numpy arrays or tensors; ``mm_inputs`` and ``position_ids`` optional).
    Returns (B, max_new_tokens) int32 on the model's device; positions after
    a sample's EOS hold the EOS id."""
    refuse_windows_or_experts(model.config.llm, "generate() (its decode step over a "
                              "contiguous cache is kernel K1, which has no window)")
    key = prng.prng_key(0) if key is None else key
    cfg, llm = model.config.llm, model.llm
    eos = model.config.eos_token_idx
    dev = next(model.parameters()).device

    mask_host = torch.as_tensor(np.asarray(batch["attention_mask"])).to(torch.int32)
    lengths_host = mask_host.sum(dim=-1)
    if bool((mask_host.argmax(dim=-1) != 0).any()) and bool((lengths_host > 0).all()):
        raise ValueError("generate() expects right-padded batches; re-collate with "
                         "padding_side='right'")

    with torch.inference_mode():
        input_ids = _to_device(batch["input_ids"], dev, torch.long)
        attention_mask = mask_host.to(dev)
        lengths = lengths_host.to(dev)
        B, S = input_ids.shape
        mm_inputs = batch.get("mm_inputs")
        if mm_inputs is not None:
            mm_inputs = {m: {k: _to_device(v, dev) for k, v in pack.items()}
                         for m, pack in mm_inputs.items()}
        position_ids = batch.get("position_ids")
        if position_ids is not None:
            position_ids = _to_device(position_ids, dev, torch.long)

        # prefill: encode + splice + causal forward into the cache
        embeds = model.embed(input_ids, mm_inputs)
        cache = init_kv_cache(cfg, B, S + max_new_tokens, device=dev)
        hidden, cache = llm(inputs_embeds=embeds, attention_mask=attention_mask,
                            position_ids=position_ids, kv_cache=cache, prefill=True,
                            return_hidden=True)
        # the true lengths: rows past a sample's length hold padding, masked
        cache = {**cache, "length": lengths}
        # the next token's rope position (2-D ids may compress the stream)
        if position_ids is not None:
            flat = position_ids.amax(dim=-1) if position_ids.dim() == 3 else position_ids
            next_pos = (flat * attention_mask).amax(dim=-1) + 1
        else:
            next_pos = lengths.long()
        pos_is_2d = position_ids is not None and position_ids.dim() == 3

        last_h = hidden[torch.arange(B, device=dev), lengths.long() - 1]
        key, sub = prng.split(key)
        tokens = sample_tokens(llm.lm_head_logits(last_h), sub, temperature, top_k, top_p,
                               do_sample)
        finished = tokens == eos
        out = torch.full((B, max_new_tokens), eos, dtype=torch.int32, device=dev)
        out[:, 0] = tokens

        for step in range(1, max_new_tokens):
            if bool(finished.all()):
                break
            pos = next_pos[:, None]
            if pos_is_2d:
                pos = pos[..., None].expand(B, 1, 2)
            logits, cache = llm(inputs_embeds=llm.embed(tokens[:, None]), position_ids=pos,
                                kv_cache=cache)
            key, sub = prng.split(key)
            nxt = sample_tokens(logits[:, 0], sub, temperature, top_k, top_p, do_sample)
            tokens = torch.where(finished, eos, nxt)
            out[:, step] = tokens
            finished = finished | (tokens == eos)
            next_pos = next_pos + 1
    return out


def make_generate_fn(model: MultimodalModel, **gen_kwargs):
    """``generate`` bound to ``model`` and fixed generation options:
    ``fn(batch, key, max_new_tokens=128, do_sample=True)``."""

    def fn(batch, key, max_new_tokens: int = 128, do_sample: bool = True):
        return generate(model, batch, max_new_tokens=max_new_tokens, do_sample=do_sample,
                        key=key, **gen_kwargs)

    return fn
