"""The arithmetic that the per-layer metric files share: from the run's host
spans, the counts in ``roofline.py`` and the traced stretch to a number, or
None when the run holds nothing to read."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

import devtrace
import roofline
from harness import Run, nearest_rank

# (keys of each live slot, shared prefixes): roofline.step_keys's arguments
DecodeStep = Tuple[Tuple[int, ...], Tuple[Tuple[int, int, int], ...]]

K3 = r"encoder_attention_(mma_)?kernel"
K4 = r"\bdecode_kernel<"
FLASH = r"flash_fwd_(wgmma_|mma_)?kernel|flash_bwd_(dq|dkv)_(wgmma_)?kernel"


def _pct(num: float, den: float) -> Optional[float]:
    return None if den <= 0 or num <= 0 else 100.0 * num / den


def decode_steps(span: dict, forks_once: bool, page: int) -> List[DecodeStep]:
    """(keys of each live slot, shared prefixes) of each decode step of one
    step() call. A slot holding m tokens at the chunk's start attends over
    prompt + m + j keys at step j, while it still emits; with ``forks_once``
    the full prompt pages a forked group shares are read once: (slots beyond
    the first, the pages' tokens, the group's keys) for each group."""
    items = []
    for s, before, after in span["rows"]:
        m0, dec = (1, after - 1) if before == 0 else (before, after - before)
        items.append((s, m0, dec))
    steps = []
    for j in range(span["decode_steps"]):
        live = [(s, s.prompt.length + m0 + j) for s, m0, dec in items if dec > j]
        if not live:
            continue
        shared = ()
        if forks_once:
            groups = {}
            for s, n in live:
                g = groups.setdefault(s.group, [0, s.prompt.length // page * page, n])
                g[0] += 1
            shared = tuple((k - 1, prefix, n) for k, prefix, n in groups.values() if k > 1)
        steps.append((tuple(n for _, n in live), shared))
    return steps


def _page(run: Run) -> int:
    return run.workload["engine"]["page_size"]


def decode_mfu(run: Run, forks_once: bool) -> Optional[float]:
    """Roofline share of whole decode steps, in step() calls that admitted
    nothing, over their wall time."""
    d, bound, wall = run.d, 0.0, 0.0
    for sp in run.host_spans():
        if sp["admitted"] or not sp["decode_steps"]:
            continue
        for lens, shared in decode_steps(sp, forks_once, _page(run)):
            bound += roofline.decode_step_bound_s(d, lens, shared)
        wall += sp["t1"] - sp["t0"]
    return _pct(bound, wall)


def decode_batch(run: Run) -> Optional[float]:
    """Decode tokens emitted per decode step: the mean live slots."""
    tokens = steps = 0
    for sp in run.host_spans():
        tokens += sum(len(lens) for lens, _ in decode_steps(sp, False, _page(run)))
        steps += sp["decode_steps"]
    return tokens / steps if steps else None


def queue_wait_ms(run: Run) -> Optional[float]:
    """Mean of (start of the step() call that prefilled a request) - its due
    time, over the window's requests."""
    w0, w1 = run.window
    waits = [sp["t0"] - s.due for sp in run.host_spans() for s in sp["admitted"]
             if w0 <= s.due < w1]
    return 1e3 * float(np.mean(waits)) if waits else None


def ttft_p90_ms(run: Run) -> Optional[float]:
    """Nearest-rank p90 of TTFT (first token - due time; +inf for a request
    that failed) over the window's requests due before the traced stretch:
    the profiler slows the host inside it."""
    t = run.stretch.t0 if run.stretch is not None and run.stretch.t0 else float("inf")
    v = [ms for due, ms in run.ttft_ms if due < t]
    return nearest_rank(v, 0.9) if v else None


def prefill_mfu(run: Run) -> Optional[float]:
    """Model FLOPs of the prompts prefilled, over the time from each step()
    call's entry to the last first token it produced."""
    d, flops, wall = run.d, 0.0, 0.0
    for sp in run.host_spans():
        pre = [s for s in sp["admitted"] if s.primary]
        if not pre:
            continue
        for s in pre:
            flops += roofline.prefill_flops(d, s.prompt.length, int(s.prompt.image is not None))
        wall += max(s.req.first_token_time for s in sp["admitted"]) - sp["t0"]
    return _pct(flops / roofline.PEAK_BF16, wall)


def _batch_counts(batch: dict):
    mask = np.asarray(batch["attention_mask"])
    labels = np.asarray(batch["labels"])
    lens = mask.sum(axis=1).tolist()
    labelled = (labels[:, 1:] != -100).sum(axis=1).tolist()
    pack = batch["mm_inputs"]["image"]
    n_emb = len(pack["batch_idx"]) // len(pack["values"])
    images = int((np.asarray(pack["batch_idx"])[::n_emb] < mask.shape[0]).sum())
    return lens, labelled, images


def train_mfu(run: Run) -> Optional[float]:
    """Model FLOPs of the window's steps over their time, over the peak."""
    flops = wall = 0.0
    for sp in run.host_spans():
        lens, labelled, images = _batch_counts(sp["batch"])
        flops += roofline.train_step_flops(run.d, lens, labelled, images)
        wall += sp["t1"] - sp["t0"]
    return _pct(flops / roofline.PEAK_BF16, wall)


def _summary(run: Run):
    st = run.stretch
    return None if st is None else st.summary


def k3_roofline(run: Run) -> Optional[float]:
    """Bound of K3's launches over K3's device time in the stretch: the
    tower runs K3 once a layer over each prefill call's images."""
    s = _summary(run)
    if s is None:
        return None
    images = sum(1 for sp in run.profiled_spans() for x in sp["admitted"]
                 if x.primary and x.prompt.image is not None)
    _, secs = devtrace.kernel_seconds(s, K3)
    return _pct(run.d.Lv * roofline.k3_bound_s(run.d, images), secs) if images else None


def k4_roofline(run: Run, forks_once: bool) -> Optional[float]:
    """Bound of K4's launches (one a layer of each decode step) over K4's
    device time in the stretch."""
    s = _summary(run)
    if s is None:
        return None
    bound = sum(roofline.k4_step_bound_s(run.d, lens, shared)
                for sp in run.profiled_spans()
                for lens, shared in decode_steps(sp, forks_once, _page(run)))
    _, secs = devtrace.kernel_seconds(s, K4)
    return _pct(bound, secs)


def flash_roofline(run: Run) -> Optional[float]:
    """Bound of K1 (forward and remat's recomputed forward), K2a and K2b
    over their device time in the stretch."""
    s = _summary(run)
    if s is None:
        return None
    bound = 0.0
    for sp in run.profiled_spans():
        if sp["t1"] is None:
            continue
        lens, _, _ = _batch_counts(sp["batch"])
        for i, k in run.d.kinds():
            b = roofline.flash_bounds_s(run.d, lens, i)
            bound += k * (2 * b["k1"] + b["k2a"] + b["k2b"])
    _, secs = devtrace.kernel_seconds(s, FLASH)
    return _pct(bound, secs)


def device_idle(run: Run) -> Optional[float]:
    s = _summary(run)
    if s is None or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
