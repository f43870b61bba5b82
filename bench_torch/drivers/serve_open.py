"""Open-loop serving: requests arrive on a schedule at a fixed rate,
whether or not earlier ones have finished.

Arrivals start ``ramp_s`` before the window so that it opens in steady
state, and go on through a drain after it until every request due inside
the window has finished or ``drain_s`` has passed. Each request is timed from
its due time, so a stall delays every request due behind it. TTFT and TPOT
are taken over the requests due inside the window; one that fails or is
unfinished at the drain's end counts as +inf.
"""

from __future__ import annotations

import time

import serving
import traffic
from harness import Run, nearest_rank


def run(r: Run) -> None:
    tr, d = r.workload["traffic"], r.d
    offsets, prompts = traffic.open_schedule(tr, r.seconds, r.seed, d.V, d.img, d.n_patches)
    model, engine = serving.build(r)
    serving.warm_up(r, engine)
    if r.trace:
        import devtrace

        devtrace.prime(r.device)
    served = {}
    rec = serving.Recorder(r, engine, served)
    t_sched = time.time()
    r.open_window(t_sched + tr["ramp_s"])
    w0, w1 = r.window
    due = t_sched + offsets
    nxt, window_reqs, all_reqs = 0, [], []
    while True:
        now = time.time()
        while nxt < len(prompts) and due[nxt] <= now:
            p = prompts[nxt]
            req = engine.submit(p.batch(), max_new_tokens=p.out_tokens,
                                temperature=0.0 if p.greedy else None)
            s = serving.Served(p, float(due[nxt]), nxt, req, True)
            served[id(req)] = s
            all_reqs.append(s)
            if w0 <= s.due < w1:
                window_reqs.append(s)
            nxt += 1
        if now >= w1:
            done = all(s.req.done for s in window_reqs) and nxt > 0 and due[nxt - 1] >= w1
            if done or now >= w1 + tr["drain_s"]:
                break
        rec.maybe_trace(now)
        if rec.busy():
            rec.step()
        elif nxt < len(prompts):
            time.sleep(max(0.0, min(due[nxt] - time.time(), 0.05)))
        else:
            break
    serving.finish_trace(rec)
    serving.read_peak(r)

    ok = [serving.check_request(s, d.V) for s in window_reqs]
    r.attempted, r.failed = len(window_reqs), ok.count(False)
    inf = float("inf")
    ttft = [(s.req.first_token_time - s.due) * 1e3 if good else inf
            for s, good in zip(window_reqs, ok)]
    tpot = [(s.req.finish_time - s.req.first_token_time) * 1e3 / (len(s.req.tokens) - 1)
            if good and len(s.req.tokens) > 1 else inf for s, good in zip(window_reqs, ok)]
    r.ttft_ms = [(s.due, t) for s, t in zip(window_reqs, ttft)]
    r.end_to_end["tpot_p90_ms"] = nearest_rank(tpot, 0.9)
    r.notes["requests"] = (f"{len(window_reqs)} due in the window, {r.failed} failed; "
                           f"ttft p50 {nearest_rank(ttft, 0.5):.1f} ms, "
                           f"ttft p90 {nearest_rank(ttft, 0.9):.1f} ms, "
                           f"tpot p50 {nearest_rank(tpot, 0.5):.2f} ms; "
                           f"{nxt} submitted, {len(engine.queue)} queued at the end")
    r.notes["queue"] = queue_halves(r, window_reqs, all_reqs)
    r.notes["ttft_parts"] = ttft_parts(r, window_reqs)
    sample = serving.sample_for_check(r, window_reqs, r.workload["check"]["sample"])
    del model, engine, rec, served
    serving.release(r)
    serving.compare(r, sample)


def queue_halves(r: Run, reqs, all_reqs) -> str:
    """The knee's two tests: TTFT p90 in each half of the window, and the
    requests waiting unadmitted at the window's start and end."""
    w0, w1 = r.window
    mid = (w0 + w1) / 2
    halves = []
    for a, b in ((w0, mid), (mid, w1)):
        v = [(s.req.first_token_time - s.due) * 1e3 if s.req.first_token_time else float("inf")
             for s in reqs if a <= s.due < b]
        halves.append(nearest_rank(v, 0.9))

    def waiting(t):
        return sum(1 for s in all_reqs if s.due <= t and
                   (s.req.first_token_time is None or s.req.first_token_time > t))
    return (f"ttft p90 first half {halves[0]:.1f} ms, second half {halves[1]:.1f} ms; "
            f"waiting at window start {waiting(w0)}, at its end {waiting(w1)}")



def ttft_parts(r: Run, reqs) -> str:
    """TTFT split at the start of the step() call that admitted a request:
    the wait for the call before it to end, and the admission itself; and
    the length of the calls in the window, with and without a prefill."""
    start = {id(s): span["t0"] for span in r.spans for s in span["admitted"]}
    wait = [(start[id(s)] - s.due) * 1e3 for s in reqs if id(s) in start]
    admit = [(s.req.first_token_time - start[id(s)]) * 1e3 for s in reqs if id(s) in start]
    w0, w1 = r.window
    spans = [s for s in r.spans if w0 <= s["t0"] < w1]
    plain = [(s["t1"] - s["t0"]) * 1e3 for s in spans if not s["prefill_calls"]]
    pre = [(s["t1"] - s["t0"]) * 1e3 for s in spans if s["prefill_calls"]]

    def q(v):
        return f"p50 {nearest_rank(v, 0.5):.1f} p90 {nearest_rank(v, 0.9):.1f} ms"
    return (f"wait {q(wait)}; admission {q(admit)}; {len(plain)} calls without a prefill "
            f"{q(plain)}; {len(pre)} with {q(pre)}")
