"""The knee of an open-loop serving cell, found once by a sweep of rates:

    python3 bench_torch/sweep.py --workload <cell> --rates 1,2,3 --seconds 20 --seed 5

runs the cell's driver at each rate in turn, in one process, and prints the
knee's two tests per rate: requests waiting unadmitted at the window's start
and end, and TTFT p90 in the window's first and second halves. The knee is
the highest rate at which the queue at the end is no longer than at the
start and p90 TTFT does not grow from the first half to the second; the
cell's rate is 0.8 of it. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import copy
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    import harness
    import spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    base = spec.load_workload(args.workload)
    cfg = spec.load_config(base["config"])
    device = torch.device("cuda", 0)
    for rate in (float(x) for x in args.rates.split(",")):
        wl = copy.deepcopy(base)
        wl["traffic"]["rate_per_s"] = rate
        wl["check"]["sample"] = 2
        run = harness.Run(workload=wl, cfg=cfg, d=spec.dims(cfg), seed=args.seed,
                          seconds=args.seconds, trace=False, device=device,
                          t_process=time.time())
        harness.driver(wl["driver"]).run(run)
        print(json.dumps({"rate_per_s": rate, **run.end_to_end,
                          "failed": run.failed, "attempted": run.attempted,
                          "requests": run.notes["requests"], "queue": run.notes["queue"],
                          "gap": [c.value for c in run.checks]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
