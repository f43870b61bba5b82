"""Program spans, the profiler window and the throughput meter of the port.

Counterpart of ``multimeditron_tpu/profiling.py``, whose named trace ranges
(``annotate``, ``step_annotation``) become :data:`tracer`: named spans with
attributes, recorded by the serving engine and the trainer where the work
happens, off until ``tracer.enable()``. A span's times come from
``time.time_ns()``, the clock onto which ``torch.profiler`` maps its host
and device events (``trace_start_ns`` + an event's offset), so a span can be
laid over the kernels of a trace without estimating an offset.
:class:`ProfileWindow` is the trace window over ``profile_start_step`` ..
``+ profile_num_steps`` (``ENABLE_TORCH_PROFILER=1``), exported as a Chrome
trace with the window's spans in it; :class:`ThroughputMeter` keeps the JAX
package's FLOP model over real (unpadded) tokens.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from multimeditron_torch import default_device

# Dense bf16 peak FLOP/s of one device, for MFU (NVIDIA's data sheets, SXM
# parts at their full power limit). The CPU value is nominal: an MFU computed
# on the CPU only shows that the meter runs.
PEAK_FLOPS = {
    "h100": 989e12,
    "h200": 989e12,
    "cpu": 1e12,
}


def device_peak_flops(device: Optional[torch.device] = None) -> float:
    """Peak bf16 FLOP/s of ``device`` (default: the card), keyed on
    ``torch.cuda.get_device_name``."""
    device = default_device(device)
    if device.type != "cuda":
        return PEAK_FLOPS["cpu"]
    name = torch.cuda.get_device_name(device).lower()
    for key, flops in PEAK_FLOPS.items():
        if key in name:
            return flops
    raise ValueError(f"no peak FLOP/s known for {name!r}; add it to PEAK_FLOPS")


class _NoSpan:
    """What :meth:`Tracer.span` returns while tracing is off: one shared
    object that is false and does nothing, so a caller computes costly
    attributes only under ``if span:``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()
# spans the ring keeps: over an hour of serving at ~60 spans a second
_RING = 1 << 18


class _Thread:
    """One thread's open spans, innermost last, and its native id (read
    once: it is a system call)."""

    __slots__ = ("tid", "open")

    def __init__(self):
        self.tid = threading.get_native_id()
        self.open: List[dict] = []


class _Span:
    __slots__ = ("_tracer", "_name", "_attrs", "_rec", "_stack")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer, self._name, self._attrs = tracer, name, attrs

    def __enter__(self):
        tr = self._tracer
        th = tr._thread()
        i = next(tr._count)
        self._rec = {"index": i, "name": self._name, "t0_ns": time.time_ns(), "t1_ns": None,
                     "parent": th.open[-1]["index"] if th.open else None,
                     "thread": th.tid, "attrs": self._attrs}
        tr._ring[i % len(tr._ring)] = self._rec
        th.open.append(self._rec)
        self._stack = th.open
        return self

    def __exit__(self, *exc) -> None:
        self._rec["t1_ns"] = time.time_ns()
        self._stack.pop()

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (counts of its outcome)."""
        self._attrs.update(attrs)


class Tracer:
    """Named spans of the program's phases, in a bounded ring.

    Off (the default), :meth:`span` checks one attribute and returns a
    shared no-op. On, each span records its name, ``t0_ns`` and ``t1_ns``
    from ``time.time_ns()``, the index of the span open around it on its
    thread (``parent``), its thread's native id and its attributes. A span
    reads no device tensor and synchronises nothing: every attribute comes
    from host state. The ring keeps the newest ``_RING`` spans.
    """

    def __init__(self):
        self.on = False
        self._ring: List[Optional[dict]] = []
        self._count = itertools.count()
        self._local = threading.local()

    def enable(self) -> None:
        """Clear the ring and record from now on."""
        self._ring = [None] * _RING
        self._count = itertools.count()
        self._local = threading.local()
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str, **attrs):
        """``with tracer.span(name, **attrs) as sp:``; ``sp.set(...)`` adds
        attributes, ``if sp:`` guards work done only for the span."""
        if not self.on:
            return _NO_SPAN
        return _Span(self, name, attrs)

    def spans(self) -> List[dict]:
        """The spans in the ring in the order they opened (``t1_ns`` is None
        while a span is open; a ``parent`` may have left the ring)."""
        return sorted((dict(r) for r in self._ring if r is not None), key=lambda r: r["index"])

    def _thread(self) -> "_Thread":
        th = getattr(self._local, "th", None)
        if th is None:
            th = self._local.th = _Thread()
        return th


# the port's one tracer: the engine and the trainer record into it
tracer = Tracer()


def profiler_enabled() -> bool:
    return os.environ.get("ENABLE_TORCH_PROFILER") == "1"


class ProfileWindow:
    """A ``torch.profiler`` trace of the host and, if present, the card,
    written as a Chrome trace under ``logdir`` when it stops, with the
    tracer's spans of the window on the threads that recorded them."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self._t0_ns = 0

    def start(self) -> None:
        self.prof.start()
        self._t0_ns = time.time_ns()

    def stop(self) -> str:
        self.prof.stop()
        t1 = time.time_ns()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"trace_{os.getpid()}_{int(time.time())}.json")
        self.prof.export_chrome_trace(path)
        spans = [s for s in tracer.spans()
                 if s["t0_ns"] <= t1 and (s["t1_ns"] or t1) >= self._t0_ns]
        if spans:
            _add_spans(path, spans, t1)
        return path


def _add_spans(path: str, spans: List[dict], t_end_ns: int) -> None:
    """Append ``spans`` to a Chrome trace as complete events. The trace's
    timestamps are microseconds after its ``baseTimeNanoseconds`` (absent:
    after the epoch), on the clock the spans share."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for s in spans:
        t1 = s["t1_ns"] or t_end_ns
        trace["traceEvents"].append({
            "ph": "X", "cat": "program_span", "name": s["name"], "pid": pid,
            "tid": s["thread"], "ts": (s["t0_ns"] - base) / 1e3, "dur": (t1 - s["t0_ns"]) / 1e3,
            "args": dict(s["attrs"], index=s["index"], parent=s["parent"])})
    with open(path, "w") as f:
        json.dump(trace, f, default=str)


class ThroughputMeter:
    """Running tokens/sec and MFU estimate, with the JAX package's FLOP model:

      forward            2 * num_params        (frozen params still run)
      activation bwd     2 * num_params        (grads flow through frozen
                                                layers down to the deepest
                                                trainable param)
      weight bwd         2 * num_params_trainable

    Full fine-tuning recovers the standard 6N. Rematerialised recompute and
    attention's own FLOPs are not counted (model FLOPs, PaLM convention).
    ``update`` takes a step's real tokens: padding does no model work.
    """

    def __init__(self, num_params: Optional[int] = None,
                 num_params_trainable: Optional[int] = None,
                 flops_per_token: Optional[float] = None,
                 device: Optional[torch.device] = None):
        if flops_per_token is None and num_params is not None:
            if num_params_trainable is None:
                num_params_trainable = num_params
            flops_per_token = 4.0 * num_params + 2.0 * num_params_trainable
        self.flops_per_token = flops_per_token
        # one process drives one device; None is the card
        self.peak = device_peak_flops(device)
        self.reset()

    def reset(self):
        self._tokens = 0
        self._t0 = time.perf_counter()

    def update(self, tokens: int) -> Dict[str, float]:
        self._tokens += tokens
        dt = max(time.perf_counter() - self._t0, 1e-9)
        tps = self._tokens / dt
        out = {"tokens_per_sec": tps}
        if self.flops_per_token:
            out["mfu"] = tps * self.flops_per_token / self.peak
        return out
