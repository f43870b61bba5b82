"""The multimodal causal LM: modality embeddings spliced into the token
stream at attachment positions.

Counterpart of ``multimeditron_tpu/models/multimodal.py``: config, embed
splice, random init, ``resize_embeddings``, the training forward with its
loss and the staged-freezing masks (``TrainingMode``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimeditron_torch import default_device
from multimeditron_torch.modalities import AutoModality
from multimeditron_torch.modalities.base import BaseModalityConfig
from multimeditron_torch.models.common import cross_entropy_loss
from multimeditron_torch.models.llama import (
    LAYERED_FIELDS,
    Llama,
    LlamaConfig,
    refuse_windows_or_experts,
)
from multimeditron_torch.profiling import tracer


class TrainingMode(str, enum.Enum):
    """Staged SFT modes, with the JAX package's values."""

    ALIGNMENT = "ALIGNMENT"  # projector only
    END2END = "END2END"      # llm + projectors
    LM_ONLY = "LM_ONLY"      # llm only
    FULL = "FULL"            # everything


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _llm_dict(llm: LlamaConfig) -> dict:
    """The decoder's fields, those of layers that differ (windows, experts)
    only where set: the JAX package's config has none of them."""
    defaults = {f.name: f.default for f in dataclasses.fields(LlamaConfig)}
    d = dataclasses.asdict(llm)
    for name in LAYERED_FIELDS:
        if d[name] == defaults[name]:
            del d[name]
    return d | {"dtype": _dtype_name(llm.dtype)}


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
            "llm": _llm_dict(self.llm),
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
    """LLM + modality encoders, built on ``device`` (default: the card)."""

    def __init__(self, config: MultimodalConfig, *, device=None):
        super().__init__()
        device = default_device(device)
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
            embeds[bi[keep], tp[keep]] = flat[keep]  # autograd reaches the projector
        return embeds

    def forward(self, batch: Dict[str, Any],
                remat: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(logits, loss or None) for a collated batch of tensors, as the JAX
        ``MultimodalModel.forward``: the loss when ``labels`` are present.
        Refused for a decoder with sliding windows or experts."""
        refuse_windows_or_experts(self.config.llm, "the no-cache forward (training: kernels "
                                  "K1 and K2 have no window, the expert backward)")
        embeds = self.embed(batch["input_ids"], batch.get("mm_inputs"))
        logits, _ = self.llm(inputs_embeds=embeds, attention_mask=batch.get("attention_mask"),
                             position_ids=batch.get("position_ids"), remat=remat)
        loss = None
        if batch.get("labels") is not None:
            with tracer.span("train.loss"):
                loss = cross_entropy_loss(logits, batch["labels"])
        return logits, loss

    def trainable_mask(self, mode: TrainingMode) -> Dict[str, bool]:
        """Parameter name -> trainable in ``mode``; each parameter's
        ``requires_grad`` is set to match (the JAX ``trainable_mask``)."""
        mode = TrainingMode(mode)
        train_llm = mode in (TrainingMode.END2END, TrainingMode.LM_ONLY, TrainingMode.FULL)
        train_proj = mode in (TrainingMode.ALIGNMENT, TrainingMode.END2END, TrainingMode.FULL)
        train_embedder = mode == TrainingMode.FULL
        mask = {}
        for name, p in self.llm.named_parameters():
            p.requires_grad_(train_llm)
            mask[f"llm.{name}"] = train_llm
        for mtype, mod in self.modalities.items():
            for name, flag in mod.trainable_mask(train_embedder, train_proj).items():
                mask[f"modalities.{mtype}.{name}"] = flag
        return mask


def mm_item_count(mm_inputs: Optional[Dict[str, Dict[str, Any]]], rows: int) -> Optional[int]:
    """Modality items (images) of a collated batch of ``rows`` rows that
    :meth:`MultimodalModel.embed` splices into a row: an item slot whose
    ``batch_idx`` is ``rows`` or more is unused. None for a pack already on
    the device, which is read only by the splice itself."""
    n = 0
    for pack in (mm_inputs or {}).values():
        values, bi = pack["values"], pack["batch_idx"]
        if isinstance(bi, torch.Tensor) and bi.device.type != "cpu":
            return None
        if len(values):
            bi = np.asarray(bi)
            n += int((bi[:: len(bi) // len(values)] < rows).sum())
    return n


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
