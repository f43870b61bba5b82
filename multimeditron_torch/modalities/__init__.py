from multimeditron_torch.modalities.base import (
    AutoModality,
    BaseModality,
    BaseModalityConfig,
)

# Import built-in modalities so they self-register.
from multimeditron_torch.modalities import image_clip as _image_clip  # noqa: F401

__all__ = ["AutoModality", "BaseModality", "BaseModalityConfig"]
