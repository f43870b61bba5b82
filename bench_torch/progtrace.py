"""The program's own spans (``multimeditron_torch.profiling.tracer``) beside
the traced stretch, on one clock: ``time.time_ns()``.

With the tracer on, the engine and the trainer record a span around each
phase of their steps. Read here:

- ``timeline``: the stretch's device intervals with their kernel names and
  the times of their runtime launches, the idle gaps between them, and the
  host's waits on the device, mapped onto the spans' clock through the
  profiler's ``trace_start_ns``;
- ``window_spans``: the spans of the measured window outside the stretch,
  as ``Run.host_spans`` keeps the harness's own;
- ``attribute``: each kernel's device time, and each idle gap, put down to
  the innermost span open on the main thread when the kernel was launched
  (for a gap: the kernel that ended it); a kernel with no launch event
  found goes by its start. Time outside every span is the harness's loop,
  "outside the program".
- the readers below, and :func:`queue_wait_ms`, the twin of the accepted
  ``queue_wait_ms.ttft`` from the request ids of ``engine.prefill``.

A traced run's set-up turns the tracer on (``devtrace.prime``) and its
stretch keeps the timeline (``devtrace.Stretch.read``); untraced runs leave
it off. The parent of a change may have no tracer: every reader then
returns None.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

import torch

import devtrace
import roofline
from harness import Run

OUTSIDE = "outside the program"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def timeline(prof) -> Optional[dict]:
    """The stretch's device activity on the ``time.time_ns()`` clock: an
    event's absolute time is ``trace_start_ns`` + its offset. Device
    intervals are (start, end, name, launch or None); a kernel's launch is
    the runtime call with its correlation id. ``syncs`` are the runtime
    synchronisations and the runtime calls of device-to-host copies."""
    kineto = getattr(prof.profiler, "kineto_results", None)
    if kineto is None:
        return None
    t0 = int(kineto.trace_start_ns())

    def ns(us: float) -> int:
        return t0 + int(round(us * 1e3))

    dev, runtime, syncs = [], {}, []
    for e in prof.events():
        a = e.time_range.start
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((a, e.time_range.end, e.name, e.id))
        elif e.name.startswith("cu"):
            # a CUDA API call (cuda*, cu*): its id is the correlation id
            # that the device activity it started carries
            runtime[e.id] = (a, e.name)
            if e.name in SYNCS:
                syncs.append((ns(a), e.name))
    for a, _, name, i in dev:
        if "DtoH" in name and i in runtime:
            syncs.append((ns(runtime[i][0]), runtime[i][1]))
    _, gaps = devtrace._union([(a, b) for a, b, _, _ in dev])
    device = sorted((ns(a), ns(b), name, ns(runtime[i][0]) if i in runtime else None)
                    for a, b, name, i in dev)
    return {"trace_start_ns": t0, "device": device,
            "gaps": [(ns(a), ns(b)) for a, b in gaps], "syncs": sorted(syncs)}


def enable_tracer() -> None:
    """Turn the program's tracer on (and clear it), where it has one."""
    from multimeditron_torch import profiling

    if hasattr(profiling, "tracer"):
        profiling.tracer.enable()


def program_spans() -> List[dict]:
    """The tracer's closed spans recorded on this thread, the one that drove
    the program; none where the program has no tracer or it is off."""
    from multimeditron_torch import profiling

    tracer = getattr(profiling, "tracer", None)
    if tracer is None or not tracer.on:
        return []
    me = threading.get_native_id()
    return [s for s in tracer.spans() if s["thread"] == me and s["t1_ns"] is not None]


def _stretch_ns(run: Run) -> Tuple[float, float]:
    st = run.stretch
    if st is None or st.t0 is None or st.t1 is None:
        return float("inf"), float("inf")
    return st.t0 * 1e9, st.t1 * 1e9


def window_spans(run: Run) -> List[dict]:
    """Spans ending inside the window and not overlapping the stretch."""
    spans = program_spans()
    w0, w1 = run.window[0] * 1e9, run.window[1] * 1e9
    s0, s1 = _stretch_ns(run)
    return [s for s in spans if w0 <= s["t1_ns"] < w1 and (s["t1_ns"] < s0 or s["t0_ns"] > s1)]


def stretch_spans(run: Run, spans: List[dict], name: str) -> List[dict]:
    """The spans called ``name`` lying wholly inside the stretch."""
    s0, s1 = _stretch_ns(run)
    return [s for s in spans if s["name"] == name and s["t0_ns"] >= s0 and s["t1_ns"] <= s1]


def dur_ns(s: dict) -> int:
    return s["t1_ns"] - s["t0_ns"]


def self_ns(spans: List[dict]) -> Dict[int, int]:
    """Each span's time less the time of its children."""
    out = {s["index"]: dur_ns(s) for s in spans}
    for s in spans:
        if s["parent"] in out:
            out[s["parent"]] -= dur_ns(s)
    return out


def under(spans: List[dict], name: str) -> set:
    """Indexes of the spans called ``name`` and of everything inside them."""
    by_index = {s["index"]: s for s in spans}
    inside = set()
    for s in spans:
        p = s
        while p is not None:
            if p["name"] == name:
                inside.add(s["index"])
                break
            p = by_index.get(p["parent"])
    return inside


def innermost(spans: List[dict]):
    """A function from a time to the index of the innermost span open then
    (None: outside every span). ``spans``: one thread's, in the order they
    opened."""
    starts = [s["t0_ns"] for s in spans]
    by_index = {s["index"]: s for s in spans}

    def owner(t: int) -> Optional[int]:
        i = bisect.bisect_right(starts, t) - 1
        s = spans[i] if i >= 0 else None
        # spans nest: the innermost one open at t is the last one opened
        # before t, or the nearest of its ancestors still open at t
        while s is not None and s["t1_ns"] <= t:
            s = by_index.get(s["parent"])
        return None if s is None else s["index"]
    return owner


def attribute(tl: dict, spans: List[dict]) -> Tuple[Dict, Dict]:
    """(device seconds, idle seconds) by the index of the innermost span
    open at the launch, None for outside every span."""
    owner = innermost(spans)
    device: Dict[Optional[int], float] = {}
    launched_by: Dict[int, Optional[int]] = {}
    for a, b, _, launch in tl["device"]:
        k = owner(a if launch is None else launch)
        device[k] = device.get(k, 0.0) + (b - a) / 1e9
        launched_by.setdefault(a, k)
    idle: Dict[Optional[int], float] = {}
    for g0, g1 in tl["gaps"]:
        k = launched_by[g1]
        idle[k] = idle.get(k, 0.0) + (g1 - g0) / 1e9
    return device, idle


def by_name(spans: List[dict], per_index: Dict) -> Dict[str, float]:
    names = {s["index"]: s["name"] for s in spans}
    out: Dict[str, float] = {}
    for k, v in per_index.items():
        name = OUTSIDE if k is None else names[k]
        out[name] = out.get(name, 0.0) + v
    return out


def _traced(run: Run):
    """(timeline, main-thread spans), or None: no spans, or no device
    kernel in the stretch (the CPU rehearsal)."""
    s = None if run.stretch is None else run.stretch.summary
    tl = None if s is None else s.get("timeline")
    if not tl or not tl["device"]:
        return None
    spans = program_spans()
    sync_note(run, tl, spans)
    return (tl, spans) if spans else None


def sync_note(run: Run, tl: dict, spans: List[dict]) -> None:
    """The host's waits on the device per call into the program in the
    stretch (the harness's own two synchronisations at its ends included),
    by runtime call and, where there are spans, by innermost span."""
    calls = len(run.profiled_spans())
    owner = innermost(spans)
    names = {s["index"]: s["name"] for s in spans}
    calls_by: Dict[str, int] = {}
    spans_by: Dict[str, int] = {}
    for t, name in tl["syncs"]:
        calls_by[name] = calls_by.get(name, 0) + 1
        k = owner(t)
        where = OUTSIDE if k is None else names[k]
        spans_by[where] = spans_by.get(where, 0) + 1
    run.notes["syncs"] = (f"{len(tl['syncs'])} in the stretch over {calls} calls "
                          f"({len(tl['syncs']) / max(calls, 1):.2f} a call): {calls_by}"
                          + (f"; by span {spans_by}" if spans else ""))


def self_note(run: Run, spans: List[dict]) -> None:
    """``self_ms``: the window's self time by span name, in ms per
    ``engine.step``, the ten largest."""
    calls = sum(1 for s in spans if s["name"] == "engine.step")
    if not calls:
        return
    # children that ended before the window still count against a parent
    # that ended inside it
    selfs = self_ns(program_spans())
    per: Dict[str, float] = {}
    for s in spans:
        per[s["name"]] = per.get(s["name"], 0.0) + selfs[s["index"]] / 1e6 / calls
    ten = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    run.notes["self_ms"] = f"per engine.step ({calls} calls): " + ", ".join(
        f"{k} {v:.6f}" for k, v in ten)


def idle_note(run: Run, tl: dict, spans: List[dict], idle: Dict, top: str) -> None:
    """``idle_by_span``: the stretch's idle seconds by innermost span, the
    ten largest and outside the program, beside the gaps' total; and the
    launches that fell outside every ``top`` span."""
    named = by_name(spans, idle)
    outside = named.pop(OUTSIDE, 0.0)
    ten = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    dev = tl["device"]
    total = (max(b for _, b, _, _ in dev) - dev[0][0]) / 1e9 - run.stretch.summary["busy_s"]
    run.notes["idle_by_span"] = (
        f"{sum(idle.values()):.6f} s put down ({len(tl['gaps'])} gaps; the stretch's "
        f"first-to-last kernel less busy {total:.6f} s): "
        + ", ".join(f"{k} {v:.6f}" for k, v in ten) + f", {OUTSIDE} {outside:.6f}")
    tops, owner = under(spans, top), innermost(spans)
    out: Dict[str, int] = {}
    for a, _, name, launch in dev:
        if owner(a if launch is None else launch) not in tops:
            key = devtrace.short_name(name) + ("" if launch is not None else " (no launch)")
            out[key] = out.get(key, 0) + 1
    missing = sum(1 for d in dev if d[3] is None)
    run.notes["launches"] = (f"{len(dev)} device intervals, {missing} with no launch event; "
                             f"outside every {top}: {sum(out.values())} {out}")


# ----------------------------------------------------------------------
# The per-layer readers
# ----------------------------------------------------------------------
def decode_host_ms(run: Run) -> Optional[float]:
    """Mean over the window's decode steps that ran the model of the step's
    time less its waits on the device (``decode.wait``): the host time a
    decode step costs."""
    spans = window_spans(run)
    waits: Dict[int, int] = {}
    for s in program_spans():
        if s["name"] == "decode.wait":
            waits[s["parent"]] = waits.get(s["parent"], 0) + dur_ns(s)
    host = [dur_ns(s) - waits.get(s["index"], 0) for s in spans
            if s["name"] == "decode.step" and s["attrs"].get("ran")]
    self_note(run, spans)
    return sum(host) / len(host) / 1e6 if host else None


def decode_idle_ms(run: Run) -> Optional[float]:
    """Device-idle ms put down to decode steps and their phases, per decode
    step of the stretch that ran the model."""
    got = _traced(run)
    if got is None:
        return None
    tl, spans = got
    _, idle = attribute(tl, spans)
    idle_note(run, tl, spans, idle, "engine.step")
    steps = [s for s in stretch_spans(run, spans, "decode.step") if s["attrs"].get("ran")]
    inside = under(spans, "decode.step")
    return 1e3 * sum(v for k, v in idle.items() if k in inside) / len(steps) if steps else None


def queue_wait_ms(run: Run) -> Optional[float]:
    """``queue_wait_ms``'s twin from inside the program: the mean of (start
    of the first ``engine.prefill`` carrying a request's id) - its due time,
    over the window's requests. It adds admission's own time before the
    prefill to what ``readers.queue_wait_ms`` reads (the entry of the step()
    call); a fork, which no prefill carries, is left out."""
    first: Dict[int, int] = {}
    for s in program_spans():
        if s["name"] == "engine.prefill":
            for rid in s["attrs"]["rids"]:
                first.setdefault(rid, s["t0_ns"])
    w0, w1 = run.window
    waits = [first[s.req.request_id] / 1e9 - s.due for sp in run.host_spans()
             for s in sp["admitted"] if w0 <= s.due < w1 and s.req.request_id in first]
    return 1e3 * sum(waits) / len(waits) if waits else None


def prefill_span_mfu(run: Run) -> Optional[float]:
    """Model FLOPs of the window's prefill calls' prompts and images
    (``engine.prefill``'s attributes) over the calls' summed time, over the
    bf16 peak. A chunk of a long prompt counts its own tokens only."""
    flops = wall = 0.0
    for s in window_spans(run):
        if s["name"] != "engine.prefill":
            continue
        a = s["attrs"]
        flops += sum(roofline.prefill_flops(run.d, n, i) for n, i in zip(a["tokens"], a["images"]))
        wall += dur_ns(s) / 1e9
    if wall <= 0 or flops <= 0:
        return None
    return 100.0 * flops / roofline.PEAK_BF16 / wall


def loss_device_ms(run: Run) -> Optional[float]:
    """Device ms of the kernels launched inside ``train.loss``, per training
    step of the stretch."""
    got = _traced(run)
    if got is None:
        return None
    tl, spans = got
    device, idle = attribute(tl, spans)
    idle_note(run, tl, spans, idle, "train.step")
    steps = stretch_spans(run, spans, "train.step")
    inside = under(spans, "train.loss")
    return 1e3 * sum(v for k, v in device.items() if k in inside) / len(steps) if steps else None
