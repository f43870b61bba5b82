"""The multimodal causal LM: modality embeddings spliced into the token
stream at attachment positions.

Counterpart of ``multimeditron_tpu/models/multimodal.py`` (config, embed
splice, random init and ``resize_embeddings``). Training (``forward`` with
the loss, ``trainable_mask``) arrives with the training path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from multimeditron_torch.modalities import AutoModality
from multimeditron_torch.modalities.base import BaseModalityConfig
from multimeditron_torch.models.llama import Llama, LlamaConfig


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass
class MultimodalConfig:
    llm: LlamaConfig
    modalities: List[BaseModalityConfig] = dataclasses.field(default_factory=list)
    vocab_size: Optional[int] = None
    pad_token_idx: int = 0
    eos_token_idx: int = 0
    padding_side: str = "right"
    truncation: bool = False
    max_sequence_length: Optional[int] = None
    llm_path: str = ""
    dtype: str = "bfloat16"

    def to_dict(self) -> dict:
        """Same format as the JAX ``MultimodalConfig.to_dict``."""
        return {
            "model_type": "multimodal",
            "llm": dataclasses.asdict(self.llm) | {"dtype": _dtype_name(self.llm.dtype)},
            "modalities": [m.to_dict() for m in self.modalities],
            "vocab_size": self.vocab_size,
            "pad_token_idx": self.pad_token_idx,
            "eos_token_idx": self.eos_token_idx,
            "padding_side": self.padding_side,
            "truncation": self.truncation,
            "max_sequence_length": self.max_sequence_length,
            "llm_path": self.llm_path,
            "dtype": self.dtype,
        }

    @staticmethod
    def from_dict(d: dict) -> "MultimodalConfig":
        """Accepts what either package's ``to_dict`` writes."""
        llm_d = dict(d["llm"])
        dtype = llm_d.pop("dtype", d.get("dtype", "bfloat16"))
        llm = LlamaConfig(**{**llm_d, "dtype": getattr(torch, dtype)})
        mods = [AutoModality.config_from_dict(m) for m in d.get("modalities", [])]
        return MultimodalConfig(
            llm=llm,
            modalities=mods,
            vocab_size=d.get("vocab_size"),
            pad_token_idx=d.get("pad_token_idx", 0),
            eos_token_idx=d.get("eos_token_idx", 0),
            padding_side=d.get("padding_side", "right"),
            truncation=d.get("truncation", False),
            max_sequence_length=d.get("max_sequence_length"),
            llm_path=d.get("llm_path", ""),
            dtype=dtype,
        )


class MultimodalModel(nn.Module):
    """LLM + modality encoders, built on ``device``."""

    def __init__(self, config: MultimodalConfig, *, device=None):
        super().__init__()
        if config.vocab_size is not None and config.vocab_size != config.llm.vocab_size:
            config.llm = dataclasses.replace(config.llm, vocab_size=config.vocab_size)
        self.config = config
        self.llm = Llama(config.llm, device=device)
        self.modalities = nn.ModuleDict()
        for mc in config.modalities:
            if mc.modality_type in self.modalities:
                raise ValueError(f"Modality type {mc.modality_type!r} registered twice")
            self.modalities[mc.modality_type] = AutoModality.from_config(mc, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights (the JAX ``init_params``)."""
        self.llm.init_weights(generator)
        for mod in self.modalities.values():
            mod.init_weights(generator)

    def embed(self, input_ids: torch.Tensor,
              mm_inputs: Optional[Dict[str, Dict[str, torch.Tensor]]] = None) -> torch.Tensor:
        """Token embed + per-modality encode + splice at attachment spans.

        ``mm_inputs[mtype]`` holds ``values`` (N, *value_shape),
        ``batch_idx`` (N * num_embeddings,) — the batch row, or >= B for a
        padded slot, which is dropped — and ``token_pos`` (same shape).
        """
        embeds = self.llm.embed(input_ids)
        if not mm_inputs:
            return embeds
        B, S, D = embeds.shape
        for mtype, pack in mm_inputs.items():
            projected = self.modalities[mtype].encode(pack["values"])
            flat = projected.reshape(-1, D).to(embeds.dtype)
            bi, tp = pack["batch_idx"].long(), pack["token_pos"].long()
            # out-of-range targets are dropped, like JAX's scatter mode="drop"
            keep = (bi >= 0) & (bi < B) & (tp >= 0) & (tp < S)
            embeds[bi[keep], tp[keep]] = flat[keep]
        return embeds


@torch.no_grad()
def resize_embeddings(llm: Llama, new_vocab: int) -> None:
    """Grow (or shrink) token embeddings / lm_head to ``new_vocab`` rows in
    place; new rows are mean-initialised like HF's default."""
    old = llm.embed_tokens.weight
    V, D = old.shape
    if new_vocab == V:
        return
    kw = dict(device=old.device, dtype=old.dtype)
    emb = nn.Embedding(new_vocab, D, **kw)
    if new_vocab < V:
        emb.weight.copy_(old[:new_vocab])
    else:
        emb.weight.copy_(torch.cat([old, old.mean(dim=0, keepdim=True).expand(new_vocab - V, D)]))
    llm.embed_tokens = emb
    if llm.lm_head is not None:
        head = llm.lm_head.weight  # (V, D)
        new_head = nn.Linear(D, new_vocab, bias=False, **kw)
        if new_vocab < V:
            new_head.weight.copy_(head[:new_vocab])
        else:
            new_head.weight.copy_(torch.cat(
                [head, head.mean(dim=0, keepdim=True).expand(new_vocab - V, D)]))
        llm.lm_head = new_head
    llm.cfg = dataclasses.replace(llm.cfg, vocab_size=new_vocab)
