"""Checkpoints of the training state: {params, opt_state, step}.

Counterpart of ``multimeditron_tpu/train/checkpoint.py`` (Orbax there).
Each step is one ``torch.save`` file, ``<directory>/<step>/state.pt``. A save
is written into a temporary directory and renamed into place, so a reader
never sees half a checkpoint; only the newest ``max_to_keep`` steps are kept.
Tensors are moved to the CPU on save; the caller copies them back onto its
device on restore.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

_STATE = "state.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n, _STATE)))

    def save(self, step: int, params: Dict[str, Any], opt_state: Any = None) -> None:
        state = {"params": _to_cpu(params), "step": int(step)}
        if opt_state is not None:
            state["opt_state"] = _to_cpu(opt_state)
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved {params, opt_state, step} of ``step`` (default: the
        latest), with tensors on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), _STATE),
                          map_location="cpu", weights_only=True)

    def close(self) -> None:
        """Nothing to flush: every save is complete when it returns."""
