"""Run one cell of the benchmark once:

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's model and traffic from
``bench_torch/workloads/<cell>.json`` and ``bench_torch/configs/<config>.json``,
warms up, measures for ``--seconds``, checks what the window produced against
the plain reference, and prints one JSON line as the last line of its
standard output: the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics (and the device's busy seconds and a breakdown) with
``--trace 1``. It needs the NVIDIA card: without one it exits with code 2
and prints no result. It prints none either, and exits with code 3, where
JAX or the JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))
# kernel caches at fixed places inside the checkout (the program's own
# library builds into multimeditron_torch/build/, also inside it)
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE.parent / ".bench_cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(HERE.parent / ".bench_cache" / "triton")


def card_info() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness
    import spec

    bench = harness.load_benchmark()
    wl = spec.load_workload(args.workload)
    chips = next(c["chips"] for c in bench["workloads"] if c["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cfg = spec.load_config(wl["config"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.Run(workload=wl, cfg=cfg, d=spec.dims(cfg), seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace), device=device,
                      t_process=T_PROCESS)
    print(f"card: {card_info()}; peaks: 989 TFLOP/s bf16, 3.35 TB/s (H100 SXM, 700 W)",
          file=sys.stderr)
    harness.driver(wl["driver"]).run(run)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": run.memory_peak_bytes}
    out = harness.result(run, bench, args.workload, info)
    found = harness.jax_modules()
    if found:
        print(f"JAX loaded in the measured process: {found}; no result", file=sys.stderr)
        return 3
    harness.emit(out, run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
