"""Throughput, MFU and the profiler window of the training loop.

Counterpart of ``multimeditron_tpu/profiling.py``: ``ThroughputMeter`` keeps
the JAX package's FLOP model, and the trace window over
``profile_start_step`` .. ``+ profile_num_steps`` is ``torch.profiler``,
enabled by ``ENABLE_TORCH_PROFILER=1``. The named trace ranges of the JAX
module (``step_annotation``, ``annotate``) are not ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from multimeditron_torch import default_device

# Dense bf16 peak FLOP/s of one device, for MFU (NVIDIA's data sheets, SXM
# parts at their full power limit). The CPU value is nominal: an MFU computed
# on the CPU only shows that the meter runs.
PEAK_FLOPS = {
    "h100": 989e12,
    "h200": 989e12,
    "cpu": 1e12,
}


def device_peak_flops(device: Optional[torch.device] = None) -> float:
    """Peak bf16 FLOP/s of ``device`` (default: the card), keyed on
    ``torch.cuda.get_device_name``."""
    device = default_device(device)
    if device.type != "cuda":
        return PEAK_FLOPS["cpu"]
    name = torch.cuda.get_device_name(device).lower()
    for key, flops in PEAK_FLOPS.items():
        if key in name:
            return flops
    raise ValueError(f"no peak FLOP/s known for {name!r}; add it to PEAK_FLOPS")


def profiler_enabled() -> bool:
    return os.environ.get("ENABLE_TORCH_PROFILER") == "1"


class ProfileWindow:
    """A ``torch.profiler`` trace of the host and, if present, the card,
    written as a Chrome trace under ``logdir`` when it stops."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> str:
        self.prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"trace_{os.getpid()}_{int(time.time())}.json")
        self.prof.export_chrome_trace(path)
        return path


class ThroughputMeter:
    """Running tokens/sec and MFU estimate, with the JAX package's FLOP model:

      forward            2 * num_params        (frozen params still run)
      activation bwd     2 * num_params        (grads flow through frozen
                                                layers down to the deepest
                                                trainable param)
      weight bwd         2 * num_params_trainable

    Full fine-tuning recovers the standard 6N. Rematerialised recompute and
    attention's own FLOPs are not counted (model FLOPs, PaLM convention).
    """

    def __init__(self, num_params: Optional[int] = None,
                 num_params_trainable: Optional[int] = None,
                 flops_per_token: Optional[float] = None,
                 device: Optional[torch.device] = None):
        if flops_per_token is None and num_params is not None:
            if num_params_trainable is None:
                num_params_trainable = num_params
            flops_per_token = 4.0 * num_params + 2.0 * num_params_trainable
        self.flops_per_token = flops_per_token
        # one process drives one device; None is the card
        self.peak = device_peak_flops(device)
        self.reset()

    def reset(self):
        self._tokens = 0
        self._t0 = time.perf_counter()

    def update(self, tokens: int) -> Dict[str, float]:
        self._tokens += tokens
        dt = max(time.perf_counter() - self._t0, 1e-9)
        tps = self._tokens / dt
        out = {"tokens_per_sec": tps}
        if self.flops_per_token:
            out["mfu"] = tps * self.flops_per_token / self.peak
        return out
