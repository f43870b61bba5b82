"""Single-CLIP image modality (``meditron_clip``, ``meditron_siglip``).

Counterpart of ``multimeditron_tpu/modalities/image_clip.py`` on the
bf16/f32 tower: CLIP or SigLIP ViT, CLS dropped, MLP projector into the LLM
embedding space. A uint8 wire batch is divided by 255 and normalised in
float32 on the device before the tower. The int8 towers are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from multimeditron_torch import default_device
from multimeditron_torch.modalities.base import AutoModality, BaseModality, BaseModalityConfig
from multimeditron_torch.models.projector import MLPProjector
from multimeditron_torch.models.vit import ViT, ViTConfig
from multimeditron_torch.models.vit_quant import (
    ViTInt8,
    calibrate_act_scales,
    quantize_vit_params,
    vit_params_tree,
)
from multimeditron_torch.ops.vit_int8_fused import (
    ViTInt8Fused,
    calibrate_vit_int8_fused,
    pack_vit_int8_fused,
    smooth_vit_params,
)
from multimeditron_torch.profiling import tracer

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
        """Built on ``device`` (default: the card)."""
        super().__init__(config)
        device = default_device(device)
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
        self.embedder_q: Optional[Union[ViTInt8Fused, ViTInt8]] = None

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
        tower = self.embedder if self.embedder_q is None else self.embedder_q
        with tracer.span("tower.encode", images=values.shape[0]):
            return self.projector(tower(self._normalize_wire(values), drop_cls=True))

    @torch.no_grad()
    def quantize_params(self, calibration_values: Optional[torch.Tensor] = None,
                        fused: bool = False) -> Union[ViTInt8Fused, ViTInt8]:
        """W8A8-quantise the tower for inference and serving; ``encode`` then
        runs the int8 tower (returned and kept as ``embedder_q``).

        ``fused=True``: SmoothQuant folds, then an (L, 8) calibration on
        ``calibration_values`` (required: the fused kernels take static
        scales), then the packed layout of the K7 kernels. Otherwise the
        unfused int8 tower, with (L, 4) static scales when calibration
        values are given and dynamic per-row scales when not. The
        calibration runs the float tower (K3) on the tower's device."""
        params = vit_params_tree(self.embedder)
        if fused:
            if calibration_values is None:
                raise ValueError("fused int8 quantization needs calibration_values "
                                 "(static per-layer activation scales)")
            calib = self._normalize_wire(calibration_values.to(self.pixel_mean.device))
            params = smooth_vit_params(params, self.vit_cfg, calib)
            scales = calibrate_vit_int8_fused(params, self.vit_cfg, calib)
            self.embedder_q = ViTInt8Fused(self.vit_cfg, pack_vit_int8_fused(params), scales)
        else:
            scales = None
            if calibration_values is not None:
                calib = calibration_values.to(self.pixel_mean.device)
                scales = calibrate_act_scales(params, self.vit_cfg, calib)
            self.embedder_q = ViTInt8(self.vit_cfg, quantize_vit_params(params), scales)
        return self.embedder_q

    def trainable_mask(self, train_embedder: bool, train_projector: bool) -> Dict[str, bool]:
        mask = {}
        for part, flag in (("embedder", train_embedder), ("projector", train_projector)):
            for name, p in getattr(self, part).named_parameters():
                p.requires_grad_(flag)
                mask[f"{part}.{name}"] = flag
        return mask


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
