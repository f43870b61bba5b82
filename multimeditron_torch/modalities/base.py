"""Modality plugin framework.

Counterpart of ``multimeditron_tpu/modalities/base.py``: a config class and
the modality module, registered in ``AutoModality`` under the same
``model_type`` strings as the JAX package (``meditron_clip``, ...), so a
config written by the JAX ``MultimodalConfig.to_dict`` loads here. The
host-side processors stay in the JAX package's data pipeline; the port takes
the collated batches they produce.
"""

from __future__ import annotations

import abc
import dataclasses

import torch
from torch import nn

from multimeditron_tpu.registry import Registry


@dataclasses.dataclass
class BaseModalityConfig:
    model_type: str = ""
    modality_type: str = ""
    hidden_size: int = 4096  # LLM embedding dim (projection target)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BaseModalityConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


class BaseModality(nn.Module, abc.ABC):
    """Device side: the encoder module and its random init."""

    config_class: type = BaseModalityConfig

    def __init__(self, config: BaseModalityConfig):
        super().__init__()
        self.config = config

    @abc.abstractmethod
    def init_weights(self, generator: torch.Generator) -> None:
        ...

    @abc.abstractmethod
    def encode(self, values: torch.Tensor) -> torch.Tensor:
        """(N, *value_shape) -> (N, num_embeddings, llm_hidden)."""


class _ModalityRegistry(Registry):
    def config_from_dict(self, d: dict) -> BaseModalityConfig:
        if "model_type" not in d:
            raise ValueError("Modality config dict must contain 'model_type'")
        cls = self.get(d["model_type"])
        cfg = cls.config_class.from_dict(d)
        cfg.model_type = d["model_type"]
        return cfg

    def from_config(self, cfg: BaseModalityConfig, device=None) -> BaseModality:
        return self.get(cfg.model_type)(cfg, device=device)


AutoModality = _ModalityRegistry("modality", BaseModality)
