"""multimeditron_torch — the PyTorch/CUDA port of ``multimeditron_tpu``.

The JAX package beside this one is the reference. This package mirrors its
module paths (``models/vit.py`` <-> ``multimeditron_torch/models/vit.py``,
and so on) and holds the same numerics, written in PyTorch. Every Pallas
kernel on a ported path is a CUDA C++ kernel for Hopper (``sm_90a``) under
``csrc/``, compiled by ``_build.py`` at first use and bound with ``ctypes``.

Each kernel wrapper has a plain PyTorch twin in the same module. A CPU
tensor goes to the twin; a CUDA tensor goes to the kernel or the wrapper
raises. Nothing falls back.

Ported so far: the paged serving path — CLIP/SigLIP ViT tower, MLP
projector, multimodal splice, Llama decoder (no cache, contiguous prefill
cache, paged ring decode) and the paged continuous-batching engine.

This package imports ``torch`` and ``numpy``; from the JAX package only the
framework-free ``multimeditron_tpu.constants`` and
``multimeditron_tpu.registry``.
"""

__version__ = "0.1.0"
