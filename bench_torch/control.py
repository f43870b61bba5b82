"""The control of a cell's check, and the program's readings, over seeds:

    python3 bench_torch/control.py --workload <cell> --seeds 11,12,13 --seconds 10

runs the cell's driver once per seed in one process, each with a window of
``--seconds`` at the cell's own load, and prints per seed the numbers the
check compares, read from the program and from the control: the reference
computed one precision below the configuration's (fp8 e4m3 inputs to every
linear layer). The limits in ``workloads/<cell>.json`` are set between the
program's largest reading and the control's smallest. The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", default="", help="a fault of faults.py planted in the program")
    args = ap.parse_args(argv)

    import torch

    import contextlib

    import faults
    import harness
    import spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    wl = spec.load_workload(args.workload)
    cfg = spec.load_config(wl["config"])
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(workload=wl, cfg=cfg, d=spec.dims(cfg), seed=seed,
                          seconds=args.seconds, trace=False, device=device,
                          t_process=time.time(), control=True)
        run.control = not args.fault
        with faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            harness.driver(wl["driver"]).run(run)
        row = {"seed": seed, "fault": args.fault, "program": {c.name: c.value for c in run.checks},
               "control": run.notes.get("control"), "failed": run.failed,
               "attempted": run.attempted, "reference": run.notes.get("reference")}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
