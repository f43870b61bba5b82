"""multimeditron_torch — the PyTorch/CUDA port of ``multimeditron_tpu``.

The JAX package beside this one is the reference. This package mirrors its
module paths (``models/vit.py`` <-> ``multimeditron_torch/models/vit.py``,
and so on) and holds the same numerics, written in PyTorch. Every Pallas
kernel on a ported path is a CUDA C++ kernel for Hopper (``sm_90a``) under
``csrc/``, compiled by ``_build.py`` at first use and bound with ``ctypes``.

Each kernel wrapper has a plain PyTorch twin in the same module. A CPU
tensor goes to the twin; a CUDA tensor goes to the kernel or the wrapper
raises. Nothing falls back.

Modules build on the card unless the caller passes ``device="cpu"``
(:func:`default_device`).

Ported so far: the paged serving path — CLIP/SigLIP ViT tower, MLP
projector, multimodal splice, Llama decoder (no cache, contiguous prefill
cache, paged ring decode and speculative verify) and the paged
continuous-batching engine with speculative decoding, forked groups,
chunked prefill and staggered admission — and the SFT training path: the
training forward with per-layer remat and the flash attention kernels, the
loss, staged freezing and the masked AdamW trainer with checkpoints and a
data loader — and the W8A8 image tower: the fused int8 ViT kernels (K7),
the unfused int8 tower, the int8 projector, the image modality's
``quantize_params`` and the trainer's ``quantize_frozen_towers`` — and the
int8 LLM serving path: the quantised decoder (``models/llama_quant.py``) on
the weight-only int8 matmul (K9) and the engine's ``quantize_llm`` and
``w8a8_prefill``.

This package imports ``torch`` and ``numpy``, and nothing of the JAX
package: the framework-free modules it needs from there
(``constants.py``, ``registry.py``, ``utils/jsonl.py``) are copied.
"""

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """``device`` when given, else the card (``torch.device("cuda")``).

    With no device and no CUDA device this raises: the CPU is reached only
    by asking for it, never by falling back.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available: pass device="cpu" to build on the CPU')
    return torch.device("cuda")
