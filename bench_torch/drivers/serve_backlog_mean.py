"""``serve_backlog``'s standing queue of forked groups, checked on two numbers.

The traffic, the engine, the window and ``output_tok_s`` are
``serve_backlog``'s, run by that driver itself. Only the check against the
reference differs: beside ``served_gap`` (the widest reference-logit gap of
a served token below the best, which a single altered token breaks) it
holds ``served_gap_mean``, the mean of that gap over every served position
of the sampled greedy requests (``check.mean_limit``).

Why a mean: in a routed mixture of experts bf16 rounding swaps the last
chosen expert for the next one wherever the router's scores nearly tie, and
each swap moves the token's hidden state by a whole expert's share. Such
swaps are discrete, so the widest gap of a sound bf16 run is about a swap's
size, and a computation one precision lower reaches only a few times it.
The mean weighs how often and how far the served tokens leave the
reference's best, which the precision moves far more: on Mellum2-12B (H100,
16,384 served positions) sound runs read about 0.002 and the fp8 control
0.04-0.08.
"""

from __future__ import annotations

import time
import unittest.mock as mock

import torch

import harness
import serving
from harness import Check, Run
from reference import serve as ref_serve


def compare(run: Run, sample) -> None:
    """``served_gap`` and ``served_gap_mean`` of the sampled requests; under
    the control, beside them those of the tokens the fp8 reference puts
    first on the same prompts and served tokens."""
    t0 = time.time()
    check = run.workload["check"]
    seqs = [ref_serve.served_seq(s.prompt.ids, s.prompt.image, s.prompt.image_at, s.req.tokens)
            for s in sample]
    if not seqs:
        run.checks += [Check("served_gap", float("inf"), check["limit"]),
                       Check("served_gap_mean", float("inf"), check["mean_limit"])]
        return
    cols = [s["served"][:, None] for s in seqs]
    if run.control:
        low = ref_serve.logits_at(run.seed, run.d, seqs, run.device, "fp8")
        cols = [torch.stack([s["served"], r["argmax"]], dim=1) for s, r in zip(seqs, low)]
    rows = ref_serve.logits_at(run.seed, run.d, seqs, run.device, "f32", cols)
    # (served positions, 1 or 2): each column's reference gap below the best
    gaps = torch.cat([r["top"][:, None] - r["picked"] for r in rows])
    widest, mean = gaps.amax(dim=0).tolist(), gaps.mean(dim=0).tolist()
    if run.control:
        run.notes["control"] = {"program": widest[0], "fp8": widest[1],
                                "program_mean": mean[0], "fp8_mean": mean[1]}
    run.checks += [Check("served_gap", widest[0], check["limit"]),
                   Check("served_gap_mean", mean[0], check["mean_limit"])]
    run.notes["reference"] = (f"{len(seqs)} requests, {gaps.shape[0]} served tokens, "
                              f"{time.time() - t0:.1f} s")


def run(r: Run) -> None:
    # serve_backlog calls serving.compare once, after the window; it takes
    # this check instead
    with mock.patch.object(serving, "compare", compare):
        harness.driver("serve_backlog").run(r)
