"""The traced run's ``torch.profiler`` stretch and what is read from it.

One stretch of a few seconds inside the traced window, started and stopped
between two calls into the program, and reduced only once the window and
its drain are over (the reduction takes seconds of host time). Read from it: the union of device
activity (busy seconds; the idle share is the rest of the stretch), device
time by kernel name (the kernel rooflines), the ten device operations that
took most time and the ten host operations the longest idle gaps waited on
(the ``breakdown`` of the result line), and the timeline that ``progtrace.py``
lays the program's spans over.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

_ANON = re.compile(r"\(anonymous namespace\)::")


def _profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def prime(device) -> None:
    """Load the profiler's device tracing in set-up, not in the window, and
    turn the program's tracer on: a traced run's set-up (untraced runs,
    which give the end-to-end metrics, never turn it on)."""
    import progtrace

    with _profile():
        torch.ones(8, device=device).sum().item()
    progtrace.enable_tracer()


def short_name(name: str) -> str:
    name = _ANON.sub("", name).replace("void ", "")
    return name.split("(")[0].strip()[:96]


class Stretch:
    """``start`` and ``stop`` between calls into the program; ``summary``
    after ``stop``."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.summary: Optional[dict] = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        _sync()
        self.prof = _profile()
        self.prof.__enter__()
        self.t0 = time.time()

    def stop(self) -> None:
        _sync()
        self.t1 = time.time()
        self.prof.__exit__(None, None, None)

    def read(self) -> None:
        """Reduce the trace (seconds of host work): after the window. The
        device activity on the program's spans' clock is kept as
        ``summary["timeline"]`` (``progtrace.py``)."""
        import progtrace

        if self.prof is not None and self.t1 is not None and self.summary is None:
            self.summary = summarize(self.prof.events(), self.t1 - self.t0)
            self.summary["timeline"] = progtrace.timeline(self.prof)
            self.prof = None


def _union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total covered length and the gaps between covered stretches."""
    busy, gaps, end = 0.0, [], None
    for a, b in sorted(spans):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, gaps


def summarize(events, window_s: float) -> dict:
    """Busy seconds, device time by kernel, and the breakdown lists."""
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((a, b, e.name))
        elif e.cpu_parent is None:
            host.append((a, b, e.name))
    busy_us, gaps = _union([(a, b) for a, b, _ in dev])
    kernels: Dict[str, List[float]] = {}
    for a, b, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    by_short: Dict[str, float] = {}
    for name, (_, s) in kernels.items():
        by_short[short_name(name)] = by_short.get(short_name(name), 0.0) + s
    host.sort()
    starts = [a for a, _, _ in host]
    waits: Dict[str, float] = {}
    for g0, g1 in gaps:
        # the top-level host operation running when the gap closed: what
        # the device waited on
        i = bisect.bisect_right(starts, g1) - 1
        name = host[i][2] if i >= 0 and host[i][1] >= g1 else "host (between operations)"
        waits[name] = waits.get(name, 0.0) + (g1 - g0) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "kernels": kernels,
            "device_ops": top(by_short), "idle_gaps": top(waits), "n_device_events": len(dev)}


def kernel_seconds(summary: dict, pattern: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name matches."""
    rx = re.compile(pattern)
    n, s = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if rx.search(name):
            n += count
            s += secs
    return n, s
