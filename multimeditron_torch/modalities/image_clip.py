"""Single-CLIP image modality (``meditron_clip``, ``meditron_siglip``).

Counterpart of ``multimeditron_tpu/modalities/image_clip.py`` on the
bf16/f32 tower: CLIP or SigLIP ViT, CLS dropped, MLP projector into the LLM
embedding space. A uint8 wire batch is divided by 255 and normalised in
float32 on the device before the tower. The int8 towers are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from multimeditron_torch.modalities.base import AutoModality, BaseModality, BaseModalityConfig
from multimeditron_torch.models.projector import MLPProjector
from multimeditron_torch.models.vit import ViT, ViTConfig

# The HF CLIP / SigLIP image-processor statistics (as in the JAX package's
# data/image_processing.py, which imports PIL and so stays off this path).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass
class ImageConfig(BaseModalityConfig):
    modality_type: str = "image"
    hidden_size: int = 4096
    clip_name: str = "openai/clip-vit-large-patch14"
    projection_type: str = "mlp"
    use_2d_position_ids: bool = False
    tower: str = "clip"  # "clip" | "siglip"
    image_size: int = 224
    patch_size: int = 14
    vision_hidden_size: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    vision_intermediate_size: int = 4096
    param_dtype: str = "bfloat16"
    wire_dtype: str = "float32"  # "uint8": 8-bit pixels, normalised on device

    def vit_config(self) -> ViTConfig:
        base = (ViTConfig.siglip_from_hf_dict if self.tower == "siglip"
                else ViTConfig.clip_from_hf_dict)({
                    "image_size": self.image_size,
                    "patch_size": self.patch_size,
                    "hidden_size": self.vision_hidden_size,
                    "num_hidden_layers": self.vision_layers,
                    "num_attention_heads": self.vision_heads,
                    "intermediate_size": self.vision_intermediate_size,
                })
        return dataclasses.replace(base, dtype=getattr(torch, self.param_dtype))


@AutoModality.register("meditron_clip")
class ImageModality(BaseModality):
    config_class = ImageConfig

    def __init__(self, config: ImageConfig, device=None):
        super().__init__(config)
        self.vit_cfg = config.vit_config()
        self.embedder = ViT(self.vit_cfg, device=device)
        self.projector = MLPProjector(self.vit_cfg.hidden_size, config.hidden_size,
                                      dtype=self.vit_cfg.dtype, device=device)
        if config.tower == "siglip":
            mean, std = SIGLIP_MEAN, SIGLIP_STD
        else:
            mean, std = CLIP_MEAN, CLIP_STD
        self.register_buffer("pixel_mean", torch.tensor(mean, device=device), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(std, device=device), persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        self.embedder.init_weights(generator)
        self.projector.init_weights(generator)

    def _normalize_wire(self, values: torch.Tensor) -> torch.Tensor:
        if values.dtype == torch.uint8:
            # same float32 math and order as the host path
            x = values.float() / 255.0
            values = (x - self.pixel_mean) / self.pixel_std
        return values

    def encode(self, values: torch.Tensor) -> torch.Tensor:
        feats = self.embedder(self._normalize_wire(values), drop_cls=True)
        return self.projector(feats)


@dataclasses.dataclass
class SigLIPImageConfig(ImageConfig):
    tower: str = "siglip"
    clip_name: str = "google/siglip-base-patch16-224"
    patch_size: int = 16
    vision_hidden_size: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_intermediate_size: int = 3072


@AutoModality.register("meditron_siglip")
class SigLIPImageModality(ImageModality):
    config_class = SigLIPImageConfig
