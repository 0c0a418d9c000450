#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's card.

    python3 bench_port/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Prints the run's result as one JSON object, the last line of standard
output; the numbers the correctness check compared, each beside its
limit, are the last lines of standard error and the result's last key.
Exits with 2, printing no result, without a CUDA card (or with fewer
than the cell asks for), and with 3 when a module whose top-level name
is ``jax``, ``jaxlib``, ``flax`` or ``quantizations_tpu`` was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, as it prints
    them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"not read (exit {out.returncode})"


def result_line(result: dict, checks, workload: str, seed: int, smi: str,
                torch) -> str:
    """The run's last line: the result, the card's facts, and last the
    numbers compared, each with its limit."""
    out = {k: v for k, v in result.items() if k != "banned_modules"}
    out["workload"] = workload
    out["seed"] = seed
    out["card"] = {"nvidia_smi": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda,
                   "peaks": "989 TFLOP/s bf16, 3.35 TB/s"}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in checks}
    return json.dumps(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from bench_port.harness import Bench, banned_modules, run_cell

    bench = Bench(ROOT)
    chips = bench.cell(a.workload).entry["chips"]
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks, msgs = run_cell(bench, a.workload, a.seed, a.seconds,
                                    bool(a.trace), device, T_PROCESS)
    found = sorted(set(result.pop("banned_modules")) | set(banned_modules()))
    if found:
        print("modules that the run may not load: " + ", ".join(found),
              file=sys.stderr)
        return 3
    line = result_line(result, checks, a.workload, a.seed, power_limit(),
                       torch)
    for m in msgs:
        print(m, file=sys.stderr)
    for n, v, lim, ok in checks:
        print(f"check {n}: {v} limit {lim} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
