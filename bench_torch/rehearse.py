"""A cell at a tiny size on the CPU: the same drivers, traffic generator,
readers and reference as a measured run, on a shrunken copy of the cell's
configuration and traffic. For tests and for trying a change before the
chip; never a measurement (``run.py`` is the measured command).

The tiny model's limits are its own, set from its readings on the CPU
(program: served gap <= 0.03, loss gap <= 1.2e-3, change gap <= 0.05; fp8
control: served gap >= 0.16, loss gap >= 5.5e-3): bf16 rounds a width of 64
far more coarsely than the published widths, where the cells' own limits
hold.
"""

from __future__ import annotations

import copy
import time
from typing import Optional

import torch

import harness
import spec

# the tower's tiny sizes; the decoder's are its architecture's TINY
TINY_TOWER = dict(tower_image_size=28, tower_patch_size=14, tower_hidden_size=32,
                  tower_num_hidden_layers=2, tower_num_attention_heads=2,
                  tower_intermediate_size=64)

TINY_TRAFFIC = {
    "serve_open": {"traffic": {"rate_per_s": 40.0, "ramp_s": 0.2, "drain_s": 20, "image_at": 2,
                               "text_tokens": {"dist": "lognormal", "median": 16, "sigma": 0.5,
                                               "min": 4, "max": 40},
                               "output_tokens": {"dist": "lognormal", "median": 6, "sigma": 0.5,
                                                 "min": 2, "max": 12},
                               "greedy_every": 2},
                   "engine": {"max_slots": 4, "max_seq_len": 96, "prefill_buckets": [32, 64],
                              "page_size": 16, "decode_chunk": 4, "max_new_tokens": 12},
                   "warmup": {"requests": 4, "max_new_tokens": 2},
                   "check": {"limit": 0.1}},
    "serve_backlog": {"traffic": {"group_size": 2, "prompts_per_step": 2, "refill_below": 2,
                                  "groups": 8, "ramp_s": 0.2, "drain_s": 20, "image_at": 2,
                                  "max_new_tokens": 6, "greedy_every": 2,
                                  "text_tokens": {"dist": "lognormal", "median": 16,
                                                  "sigma": 0.5, "min": 4, "max": 40}},
                      "engine": {"max_slots": 4, "max_seq_len": 96, "prefill_buckets": [32, 64],
                                 "page_size": 16, "decode_chunk": 4, "max_new_tokens": 6},
                      "warmup": {"requests": 2, "max_new_tokens": 2},
                      "check": {"limit": 0.1}},
    "train": {"traffic": {"batch_size": 2, "seq_multiple": 16, "max_seq": 64, "image_at": 2,
                          "user_gap": 2, "image_budget": 3, "batches": 6, "block": 3,
                          "sample_tokens": {"dist": "lognormal", "median": 24, "sigma": 0.4,
                                            "min": 10, "max": 64}},
              "check": {"limits": {"loss_gap": 3e-3, "change_gap": 0.2}}},
}


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def tiny(cell: str, overrides: Optional[dict] = None):
    wl = spec.load_workload(cell)
    wl = merge(wl, TINY_TRAFFIC[wl["driver"]])
    if overrides:
        wl = merge(wl, overrides)
    cfg = spec.load_config(wl["config"])
    cfg = spec.shrink(cfg, **spec.architecture(cfg["arch"]).TINY, **TINY_TOWER)
    return wl, cfg


def rehearse(cell: str, seed: int, seconds: float = 1.0, trace: bool = False,
             overrides: Optional[dict] = None, bench: Optional[dict] = None):
    """One tiny run on the CPU: (result line, Run)."""
    wl, cfg = tiny(cell, overrides)
    return run_tiny(cell, wl, cfg, seed, seconds, trace, bench)


def run_tiny(cell: str, wl: dict, cfg: dict, seed: int, seconds: float = 1.0,
             trace: bool = False, bench: Optional[dict] = None):
    """A run of ``wl`` on ``cfg`` on the CPU, reported as ``cell``: (result
    line, Run)."""
    bench = bench or harness.load_benchmark()
    run = harness.Run(workload=wl, cfg=cfg, d=spec.dims(cfg), seed=seed, seconds=seconds,
                      trace=trace, device=torch.device("cpu"), t_process=time.time())
    harness.driver(wl["driver"]).run(run)
    info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return harness.result(run, bench, cell, info), run
