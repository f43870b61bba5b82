"""Readers of an expert decoder's cell (``arch/mellum.py``): the grouped-
expert kernel's roofline share and the decode step's, their weight bytes
and expert operations from the counters the program reports on its spans
(``experts_touched``, ``expert_assignments`` on ``decode.chunk`` and
``engine.prefill``). Where the program reports no such counter (a program
without expert layers, or a run whose tracer is off) they return None.
"""

from __future__ import annotations

from typing import Optional

import devtrace
import progtrace
import readers
import roofline
from harness import Run

MOE = r"grouped_experts_\w+_kernel"
COUNTED = ("decode.chunk", "engine.prefill")


def _counted(spans):
    return [s for s in spans if s["name"] in COUNTED and "expert_assignments" in s["attrs"]]


def moe_roofline(run: Run) -> Optional[float]:
    """Bound of the grouped-expert launches (route, gate-up, down, combine)
    over their device time in the traced stretch: the touched experts'
    weights and the token rows in and out at 3.35 TB/s, or 6 x D x F FLOPs
    per assignment at 989 TFLOP/s, whichever is longer, from the counters
    of the calls inside the stretch, summed (so never above the sum of the
    launches' own bounds)."""
    s = None if run.stretch is None else run.stretch.summary
    if s is None:
        return None
    _, secs = devtrace.kernel_seconds(s, MOE)
    inside = [x for name in COUNTED
              for x in progtrace.stretch_spans(run, progtrace.program_spans(), name)]
    inside = _counted(inside)
    touched = sum(x["attrs"]["experts_touched"] for x in inside)
    assigned = sum(x["attrs"]["expert_assignments"] for x in inside)
    if not assigned:
        return None
    d = run.d
    return readers._pct(roofline.bound_s(d.moe_flops(assigned), d.moe_bytes(touched, assigned)),
                        secs)


def decode_mfu(run: Run) -> Optional[float]:
    """As ``readers.decode_mfu`` with a forked group's shared pages read
    once, each step's weight bytes from the experts the step touched: the
    ``decode.chunk`` counters inside each step() call, over its decode
    steps. A device share: None off the card."""
    if run.device.type != "cuda":
        return None
    chunks = [x for x in _counted(progtrace.program_spans()) if x["name"] == "decode.chunk"]
    if not chunks:
        return None
    d, page, bound, wall = run.d, run.workload["engine"]["page_size"], 0.0, 0.0
    for sp in run.host_spans():
        if sp["admitted"] or not sp["decode_steps"]:
            continue
        t0, t1 = sp["t0"] * 1e9, sp["t1"] * 1e9
        touched = sum(x["attrs"]["experts_touched"] for x in chunks
                      if t0 <= x["t0_ns"] and x["t1_ns"] <= t1)
        counts = {"experts_touched": touched / sp["decode_steps"]}
        for lens, shared in readers.decode_steps(sp, True, page):
            bound += roofline.decode_step_bound_s(d, lens, shared, counts)
        wall += sp["t1"] - sp["t0"]
    return readers._pct(bound, wall)
