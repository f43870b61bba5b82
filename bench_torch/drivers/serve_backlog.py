"""A standing queue of forked groups: GRPO rollouts.

Each prompt is submitted with ``submit_group(n=group_size)``: it prefills
once and its siblings fork its K/V pages. Whenever fewer than
``refill_below`` completions wait unadmitted, the next ``prompts_per_step``
groups join the queue, so the engine always has work. The window is judged
on the output tokens of the engine's ``step()`` calls inside it (a call
across either end counts pro rata) over its length.
"""

from __future__ import annotations

import time

import serving
import traffic
from harness import Run


def run(r: Run) -> None:
    tr, d = r.workload["traffic"], r.d
    G = tr["group_size"]
    prompts = traffic.group_prompts(tr, tr["groups"], r.seed, d.V, d.img, d.n_patches)
    model, engine = serving.build(r)
    serving.warm_up(r, engine, groups=G)
    if r.trace:
        import devtrace

        devtrace.prime(r.device)
    served = {}
    rec = serving.Recorder(r, engine, served)
    t_start = time.time()
    r.open_window(t_start + tr["ramp_s"])
    w0, w1 = r.window
    nxt, greedy_reqs = 0, []

    def refill():
        nonlocal nxt
        waiting = sum(1 + len(q.forks) for q in engine.queue)
        if waiting >= tr["refill_below"]:
            return
        for _ in range(tr["prompts_per_step"]):
            p = prompts[nxt % len(prompts)]
            reqs = engine.submit_group(p.batch(), G, max_new_tokens=p.out_tokens,
                                       temperature=0.0 if p.greedy else None)
            for j, req in enumerate(reqs):
                s = serving.Served(p, time.time(), nxt, req, j == 0)
                served[id(req)] = s
                if p.greedy:
                    greedy_reqs.append(s)
            nxt += 1

    while True:
        now = time.time()
        if now >= w1:
            if any(s.req.done for s in greedy_reqs) or now >= w1 + tr["drain_s"]:
                break
        else:
            refill()
        rec.maybe_trace(now)
        rec.step()
    serving.finish_trace(rec)
    serving.read_peak(r)

    # the tokens of every step() call, a call across an end of the window
    # pro rata, over the window's length
    tokens = sum(r.in_window(sp) * sum(after - before for _, before, after in sp["rows"])
                 for sp in r.spans)
    in_window = [sp for sp in r.spans if r.in_window(sp) > 0]
    r.end_to_end["output_tok_s"] = tokens / r.seconds
    done = [s for sp in r.spans for s, _, after in sp["rows"] if s.req.done]
    done = list({id(s): s for s in done}.values())
    ok = [serving.check_request(s, d.V) for s in done]
    r.attempted, r.failed = len(done), ok.count(False)
    r.notes["requests"] = (f"{tokens:.1f} tokens in {len(in_window)} steps of the window; "
                           f"{nxt} groups submitted, {len(done)} requests finished, "
                           f"{r.failed} failed")
    sample = serving.sample_for_check(r, greedy_reqs, r.workload["check"]["sample"])
    del model, engine, rec, served
    serving.release(r)
    serving.compare(r, sample)
