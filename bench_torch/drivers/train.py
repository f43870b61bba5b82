"""Training steps: ``MultimodalTrainer.train`` over a feed of batches.

Set-up builds one trainer and drives it from the seed through its first
three steps, through the same ``train`` call and feed that the window uses,
on three different batches; the reference follows those three. The window
then hands the same trainer a feed of new batches (made from the seed
before the window) until ``--seconds`` have passed. A step's span runs from
the feed yielding its batch to the feed being asked for the next one (the
trainer reads the step's loss to the host in between). ``train_tok_s`` is
the real tokens of the window's steps, the one running at its end pro rata,
over its length.
"""

from __future__ import annotations

import math
import time

import numpy as np

import devtrace
import program
import serving
import traffic
from harness import Check, Run
from reference import train as ref_train

FIRST_STEPS = 3


class Capture:
    """The trainer's logger interface: keeps each step's metrics."""

    def __init__(self):
        self.records = []

    def log(self, step, metrics):
        self.records.append(dict(metrics, step=step))


def run(r: Run) -> None:
    from multimeditron_torch.models.multimodal import TrainingMode
    from multimeditron_torch.train.trainer import MultimodalTrainer, TrainerConfig

    tr, d, tc = r.workload["traffic"], r.d, r.workload["trainer"]
    batches = traffic.train_batches(tr, tr["batches"], r.seed, d.V, d.img, d.n_patches)
    model = program.build_model(r.cfg, d, r.seed, r.device)
    cfg = dict(tc, training_mode=TrainingMode(tc["training_mode"]))
    trainer = MultimodalTrainer(model, TrainerConfig(**cfg))
    leaves = program.projector_leaves(model)
    p0 = {k: v.detach().float().clone() for k, v in leaves.items()}
    log = Capture()
    trainer.train(iter(batches[:1]), num_steps=1, logger=log)
    mu1 = {k: trainer.opt_state["mu"][n].float().clone()
           for k, n in zip(leaves, _opt_names(model, leaves))}
    trainer.train(iter(batches[1:FIRST_STEPS]), num_steps=FIRST_STEPS, logger=log)
    losses = [rec["loss"] for rec in log.records[:FIRST_STEPS]]
    delta = {k: float((v.detach().float() - p0[k]).norm()) for k, v in leaves.items()}
    grad1 = {k: float(m.norm()) / (1 - tc["b1"]) for k, m in mu1.items()}
    if r.trace:
        devtrace.prime(r.device)

    pool = batches[FIRST_STEPS:]
    spans = r.spans
    state = {"i": 0, "t": None, "stretch": None}
    trace_s = r.workload.get("trace_s", 3.0)

    def feed():
        t0 = time.time()
        r.open_window(t0)
        w0, w1 = r.window
        while True:
            t = time.time()
            if state["t"] is not None:
                spans[-1]["t1"] = t
                st = state["stretch"]
                if st is not None and st.running and t >= st.t0 + trace_s:
                    st.stop()
            if t >= w1:
                return
            if r.trace and state["stretch"] is None and t >= max(w0, w1 - trace_s):
                state["stretch"] = devtrace.Stretch()
                state["stretch"].start()
                r.stretch = state["stretch"]
            b = pool[state["i"] % len(pool)]
            st = state["stretch"]
            spans.append({"t0": time.time(), "t1": None, "batch": b,
                          "profiled": st is not None and st.running})
            state["i"] += 1
            state["t"] = t
            yield b

    trainer.train(feed(), num_steps=10 ** 9, logger=log)
    st = state["stretch"]
    if st is not None and st.running:
        st.stop()
    serving.read_peak(r)
    w0, w1 = r.window
    done = [s for s in spans if s["t1"] is not None and s["t1"] < w1]
    # every step's real tokens, the step running at the window's end pro
    # rata, over the window's length
    real = sum(r.in_window(s) * int(np.asarray(s["batch"]["attention_mask"]).sum())
               for s in spans)
    r.end_to_end["train_tok_s"] = real / r.seconds
    window_losses = [rec["loss"] for rec in log.records[FIRST_STEPS:]]
    r.attempted = len(done)
    r.failed = sum(1 for v in window_losses if not math.isfinite(v))
    r.notes["steps"] = (f"{len(done)} steps in the window, {real:.1f} real tokens, "
                        f"{state['i']} batches fed ({len(pool)} made)")
    r.notes["program"] = f"losses {losses}, grad1 {grad1}, delta {delta}"
    del model, trainer, leaves, mu1, log
    serving.release(r)
    t0 = time.time()
    ref = ref_train.run_steps(r.seed, d, batches[:FIRST_STEPS], tc, r.device)
    r.notes["reference"] = (f"losses {ref['losses']}, grad1 {ref['grad1']}, "
                            f"delta {ref['delta']}, {time.time() - t0:.1f} s")
    if r.control:
        low = ref_train.run_steps(r.seed, d, batches[:FIRST_STEPS], tc, r.device, "fp8")
        r.notes["control"] = readings(low["losses"], low["grad1"], low["delta"], ref)
    # a number with no limit (no control or fault separates it from sound
    # runs) is read and printed, not compared
    limits = r.workload["check"]["limits"]
    for name, value in readings(losses, grad1, delta, ref).items():
        if name in limits:
            r.checks.append(Check(name, value, limits[name]))
        else:
            r.notes[name] = value


def _opt_names(model, leaves):
    """The trainer's optimizer-state names of the projector leaves."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    return [by_id[id(p)] for p in leaves.values()]


def readings(losses, grad1, delta, ref) -> dict:
    """The three numbers compared: the worst step's relative loss gap; the
    worst leaf's gap of first-gradient norms, and of change norms after the
    steps, each over the larger of that leaf's reference norm and the median
    leaf's. Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the change."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    g_med = float(np.median(list(ref["grad1"].values())))
    grad_gap = max(abs(grad1[k] - v) / max(v, g_med) for k, v in ref["grad1"].items())
    moving = [k for k, v in ref["grad1"].items() if v >= 1e-3 * g_med]
    d_med = float(np.median([ref["delta"][k] for k in moving]))
    change_gap = max(abs(delta[k] - ref["delta"][k]) / max(ref["delta"][k], d_med)
                     for k in moving)
    return {"loss_gap": loss_gap, "grad1_gap": grad_gap, "change_gap": change_gap}
