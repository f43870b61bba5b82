"""One run of one cell: what the drivers fill in, and the result line.

A driver (``drivers/<kind>.py``) runs the program and fills a :class:`Run`:
the host spans it kept around each call into the engine or trainer, the
counters it read, the traced stretch, the end-to-end values and the checks
that decide ``correct``. The per-layer metrics are read from the Run by
``metrics/<name>.py``, each found by its name in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import spec

ROOT = spec.ROOT
REPO = ROOT.parent


@dataclasses.dataclass
class Check:
    """One number compared against its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    workload: dict
    cfg: dict
    d: spec.Dims
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float
    window: tuple = (0.0, 0.0)          # host times of the measured window
    setup_s: Optional[float] = None
    spans: List[dict] = dataclasses.field(default_factory=list)
    stretch: Any = None                 # devtrace.Stretch of the traced run
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: List[Check] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    ttft_ms: List[tuple] = dataclasses.field(default_factory=list)  # (due, TTFT ms)
    control: bool = False               # also read the fp8 control (control.py)

    def open_window(self, t: float) -> None:
        self.window = (t, t + self.seconds)
        self.setup_s = t - self.t_process

    def host_spans(self) -> List[dict]:
        """Spans of the window outside the profiled stretch."""
        w0, w1 = self.window
        return [s for s in self.spans
                if w0 <= s["t1"] < w1 and not s.get("profiled")]

    def in_window(self, span: dict) -> float:
        """The share of a span's time that lies inside the window: the work
        of a call that straddles an end of the window counts pro rata."""
        w0, w1 = self.window
        t0, t1 = span["t0"], span["t1"]
        if t1 is None or t1 <= t0:
            return 0.0
        return max(0.0, min(t1, w1) - max(t0, w0)) / (t1 - t0)

    def profiled_spans(self) -> List[dict]:
        return [s for s in self.spans if s.get("profiled")]


def load_benchmark(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return spec.load_module(ROOT / "metrics" / f"{name}.py").read


def driver(kind: str):
    return spec.load_module(ROOT / "drivers" / f"{kind}.py")


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (trace 1)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def result(run: Run, bench: dict, cell: str, device_info: dict) -> dict:
    if run.stretch is not None:
        run.stretch.read()
    metrics = {}
    for m in metrics_for(bench, cell, run.trace):
        if run.trace:
            value = metric_reader(m["name"])(run)
        elif m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = run.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(run.checks) and all(c.ok for c in run.checks) and run.failed == 0
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dict(device_info)}
    if run.trace and run.stretch is not None and run.stretch.summary is not None:
        s = run.stretch.summary
        out["device"]["busy_s"] = s["busy_s"]
        out["device"]["window_s"] = s["window_s"]
        out["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def emit(out: dict, run: Run) -> None:
    """The notes, then the checks as the last lines of stderr; the result as
    the last line of stdout."""
    for k, v in run.notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


JAX_NAMES = ("jax", "jaxlib", "flax", "multimeditron_tpu")


def jax_modules() -> List[str]:
    """The loaded modules' top-level names that are JAX or the JAX package,
    compared whole (``multimeditron_torch`` is the port, not a match)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(JAX_NAMES))


def nearest_rank(values: List[float], q: float) -> float:
    """The q-quantile by nearest rank: a value of the sample, +inf kept."""
    if not values:
        return math.inf
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]

