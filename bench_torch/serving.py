"""What the two serving drivers share: the engine built from the cell's
settings, the warm-up, the host span around each ``ServingEngine.step``
call, and the check against the reference once the window has closed."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import devtrace
import program
import traffic
from harness import Check, Run
from reference import serve as ref_serve


class Served:
    """A request as the harness knows it: its prompt, due time and group."""

    __slots__ = ("prompt", "due", "group", "req", "primary")

    def __init__(self, prompt, due: float, group: int, req, primary: bool):
        self.prompt, self.due, self.group, self.req, self.primary = (
            prompt, due, group, req, primary)


def build(run: Run):
    from multimeditron_torch.serve.engine import EngineConfig, ServingEngine

    model = program.build_model(run.cfg, run.d, run.seed, run.device)
    e = dict(run.workload["engine"])
    e["prefill_buckets"] = tuple(e["prefill_buckets"])
    engine = ServingEngine(model, EngineConfig(seed=run.seed % (1 << 31), **e))
    return model, engine


def warm_up(run: Run, engine, groups: int = 0) -> None:
    """A burst of the cell's own shapes (its prompt mix, every slot filled),
    run to the end: allocator, cuBLAS and the kernel library reach their
    steady state before the window."""
    tr, d, w = run.workload["traffic"], run.d, run.workload["warmup"]
    n = w["requests"]
    ps = traffic.prompts(tr, n, run.seed + 0x5EED, d.V, d.img, d.n_patches,
                         out_tokens=np.full(n, w["max_new_tokens"]))
    for p in ps:
        if groups:
            engine.submit_group(p.batch(), groups, max_new_tokens=p.out_tokens)
        else:
            engine.submit(p.batch(), max_new_tokens=p.out_tokens)
    engine.run()


class Recorder:
    """Calls ``engine.step()`` and keeps one span per call: its host times,
    the engine's counter deltas, and for every request live in it the tokens
    before and after (from which the decode steps' live slots and cache
    lengths follow)."""

    def __init__(self, run: Run, engine, served: Dict[int, Served]):
        self.run, self.engine, self.served = run, engine, served
        self.stretch: Optional[devtrace.Stretch] = None

    def busy(self) -> bool:
        e = self.engine
        return bool(e.queue) or bool(e.active.any())

    def step(self) -> dict:
        e = self.engine
        live = [r for r in e.slot_request if r is not None]
        before = {id(r): len(r.tokens) for r in live}
        queued = [r for q in e.queue for r in [q] + q.forks]
        c0 = (e.n_prefill_calls, e.n_decode_steps)
        t0 = time.time()
        e.step()
        t1 = time.time()
        admitted = [r for r in queued if r.first_token_time is not None]
        rows = [(self.served[id(r)], before[id(r)], len(r.tokens)) for r in live]
        rows += [(self.served[id(r)], 0, len(r.tokens)) for r in admitted]
        span = {"t0": t0, "t1": t1, "prefill_calls": e.n_prefill_calls - c0[0],
                "decode_steps": e.n_decode_steps - c0[1], "rows": rows,
                "admitted": [self.served[id(r)] for r in admitted],
                "profiled": self.stretch is not None and self.stretch.running}
        self.run.spans.append(span)
        return span

    def maybe_trace(self, t: float) -> None:
        """Start the traced stretch ``trace_s`` before the window's end and
        stop it after ``trace_s`` (between two step calls): the profiler
        slows the host, and the queue it leaves behind falls after the
        window, outside the host-clock metrics."""
        run = self.run
        if not run.trace:
            return
        w0, w1 = run.window
        length = run.workload.get("trace_s", 3.0)
        if self.stretch is None and t >= max(w0, w1 - length):
            self.stretch = devtrace.Stretch()
            self.stretch.start()
            run.stretch = self.stretch
        elif self.stretch is not None and self.stretch.running and t >= self.stretch.t0 + length:
            self.stretch.stop()


def finish_trace(rec: Recorder) -> None:
    if rec.stretch is not None and rec.stretch.running:
        rec.stretch.stop()


def check_request(s: Served, vocab: int) -> bool:
    """Finished by its budget (or EOS), every token inside the vocab."""
    r = s.req
    if not r.done or r.finish_reason not in ("budget", "eos"):
        return False
    if r.finish_reason == "budget" and len(r.tokens) != s.prompt.out_tokens:
        return False
    return all(0 <= t < vocab for t in r.tokens)


def sample_for_check(run: Run, pool: List[Served], k: int) -> List[Served]:
    """Up to k finished greedy requests drawn from the seed, the longest
    served among them, one a group: a forked group's greedy members serve
    the same tokens, so one of them stands for all. A group's fork is taken
    where one finished (it reads the shared pages and its own tail copy)."""
    pool = [s for s in pool if s.prompt.greedy and s.req.done and len(s.req.tokens) >= 1]
    if not pool:
        return []
    groups = {}
    for s in pool:
        g = groups.setdefault(s.group, s)
        if g.primary and not s.primary:
            groups[s.group] = s
    reps = list(groups.values())
    longest = max(reps, key=lambda s: (len(s.req.tokens), s.prompt.length))
    rest = [s for s in reps if s is not longest]
    r = traffic.rng(run.seed, 7)
    pick = [rest[i] for i in r.permutation(len(rest))[:max(0, k - 1)]]
    return [longest] + pick


def read_peak(run: Run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(run.device))


def release(run: Run) -> None:
    """After the caller dropped the program's objects: return their memory
    before the reference runs."""
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def compare(run: Run, sample: List[Served]) -> None:
    """The widest reference-logit gap of the sampled requests' served
    tokens, against the cell's limit."""
    t0 = time.time()
    seqs = [ref_serve.served_seq(s.prompt.ids, s.prompt.image, s.prompt.image_at, s.req.tokens)
            for s in sample]
    limit = run.workload["check"]["limit"]
    if not seqs:
        run.checks.append(Check("served_gap", float("inf"), limit))
        return
    if run.control:
        gaps = ref_serve.control_gaps(run.seed, run.d, seqs, run.device)
        run.notes["control"] = gaps
        gap = gaps["program"]
    else:
        gap = ref_serve.widest_gap(run.seed, run.d, seqs, run.device)
    run.checks.append(Check("served_gap", gap, limit))
    run.notes["reference"] = (f"{len(seqs)} requests, {sum(len(s['served']) for s in seqs)} "
                              f"served tokens, {time.time() - t0:.1f} s")
