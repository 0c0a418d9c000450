#!/usr/bin/env python3
"""Read the two ends of a cell's correctness limit on the card: the
program's widest logit gap over many seeds (the lower reading) and the
control's over some of them (the upper reading). The benchmark's own
runs never run this.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds <run_seconds>

One process runs every seed: a whole run of the cell (its window at
the cell's own load, untraced), then the reference over the run's
sample and, for a control seed, the control over the same prompts and
served tokens: the reference with every projection's input rounded to
float8 e4m3 by rows (W4A8, the step below the configuration's bf16
activations). Prints one JSON line a seed, then the readings.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)

    import torch

    from bench_port.harness import Bench, run_cell

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = Bench(ROOT)
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    gaps, ctl_gaps = [], []
    t0 = T_PROCESS
    for s in (int(x) for x in a.seeds.split(",")):
        res, checks, msgs = run_cell(
            bench, a.workload, s, a.seconds, False, device, t0,
            control=torch.float8_e4m3fn if s in ctl else None)
        gap = next(c[1] for c in checks if c[0] == "logit_gap")
        gaps.append(gap)
        if res.get("control_gap") is not None:
            ctl_gaps.append(res["control_gap"])
        print(json.dumps({"seed": s, "gap": gap,
                          "control_gap": res.get("control_gap"),
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()},
                          "checks": checks, "msgs": msgs}), flush=True)
        t0 = time.perf_counter()
    print(json.dumps({"workload": a.workload, "lower": max(gaps),
                      "gaps": gaps, "upper": min(ctl_gaps) if ctl_gaps
                      else None, "control_gaps": ctl_gaps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
