"""The decode step of the ``m7b.longgen`` cell in three arms, in one
process on one engine, so that the two mechanisms that shorten its host
enqueue are measured apart:

- ``fused``: the layer's glue as K11-K13 and ``ops/cuda.py launch`` as
  it is;
- ``plain``: the glue's plain versions (``models/llama.py _glue`` bound
  to them), ``launch`` as it is;
- ``old_launch``: K11-K13, with ``launch`` in its earlier form (the
  stream read through ``torch.cuda.current_stream`` under a
  ``torch.cuda.device`` guard on every launch).

The arms take turns every block of engine steps, in ABC / CBA order,
after one warm-up block each. Printed as one JSON line: per arm the
step, its admission, the decode part (the step less its admission), the
decode forward's host enqueue, and the paired differences of the decode
part against ``fused`` with their standard errors over the blocks.

    python3 benchmarks/glue_arms.py SEED BLOCKS STEPS_PER_BLOCK

needs an NVIDIA GPU (Mistral-7B in 4-bit, as the cell builds it).
"""

import importlib
import json
import pkgutil
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import harness as H  # noqa: E402
from bench_port.traffic import Traffic  # noqa: E402
import quantizations_tpu_torch.ops as ops_pkg  # noqa: E402
from quantizations_tpu_torch.models import llama as tl  # noqa: E402
from quantizations_tpu_torch.ops import cuda as qcuda, glue  # noqa: E402
from quantizations_tpu_torch.serve import paged as tpg  # noqa: E402

ARMS = ("fused", "plain", "old_launch")


def old_launch(kernel, fn, device, *args):
    """``ops/cuda.py launch`` before it read the raw stream directly."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(qcuda._libs[kernel.name], fn)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{kernel.name}: CUDA launch failed with error {err}")
    kernel.launches += 1


def main(seed: int, blocks: int, per_block: int) -> dict:
    dev = torch.device("cuda", 0)
    qcuda.build()
    cell = H.Bench().cell("m7b.longgen")
    cfg = H.program_config(cell)
    params = H.build_program(cell, cfg, seed, dev)
    eng = H.make_engine(cell, cfg, params, seed)
    H._warm(eng, cell, seed)

    fused_glue, new_launch = tl._glue, qcuda.launch

    def plain_glue(cd):
        return glue.add_rms_norm_plain, glue.rope_qk_plain, glue.glu_act_plain

    users = [importlib.import_module(f"{ops_pkg.__name__}.{m.name}")
             for m in pkgutil.iter_modules(ops_pkg.__path__)]
    users = [m for m in users if getattr(m, "launch", None) is new_launch]

    def set_arm(arm):
        tl._glue = plain_glue if arm == "plain" else fused_glue
        for m in users:
            m.launch = old_launch if arm == "old_launch" else new_launch

    acc = {"admit": 0.0, "fwd": 0.0}
    admit0, fwd0 = eng._admit, tpg.paged_decode_step

    def admit():
        t = time.perf_counter()
        admit0()
        acc["admit"] += time.perf_counter() - t

    def fwd(*a, **k):
        t = time.perf_counter()
        out = fwd0(*a, **k)
        acc["fwd"] += time.perf_counter() - t
        return out

    eng._admit = admit
    tpg.paged_decode_step = fwd
    traffic = Traffic(cell.traffic, seed, cell.dims.vocab)
    done = []
    eng.on_token = lambda r, tok: (
        done.append(r.uid) if len(r.output_ids) >= r.max_new_tokens
        else None)
    for req in traffic.first_wave():
        eng.submit(req.prompt, max_new_tokens=req.max_new)
    eng.step()

    def run_block(arm):
        set_arm(arm)
        out = []
        for _ in range(per_block):
            acc["admit"] = acc["fwd"] = 0.0
            t0 = time.perf_counter()
            rows = eng.step()
            out.append((time.perf_counter() - t0, acc["admit"], acc["fwd"],
                        rows))
            for uid in done:             # keep the batch full
                eng.finished.pop(uid, None)
                req = traffic.next()
                eng.submit(req.prompt, max_new_tokens=req.max_new)
            done.clear()
        return out

    for arm in ARMS:
        run_block(arm)
    res = {a: [] for a in ARMS}
    diffs = {a: [] for a in ARMS[1:]}
    for b in range(blocks):
        blk = {}
        for arm in (ARMS if b % 2 == 0 else ARMS[::-1]):
            r = run_block(arm)
            res[arm] += r
            blk[arm] = statistics.mean(s - a for s, a, _, _ in r)
        for a in ARMS[1:]:
            diffs[a].append(1e3 * (blk["fused"] - blk[a]))
    set_arm("fused")
    torch.cuda.synchronize()
    summary = {"launch_users": [m.__name__ for m in users]}
    for arm, r in res.items():
        summary[arm] = dict(
            steps=len(r),
            step_ms=1e3 * statistics.mean(s for s, _, _, _ in r),
            admit_ms=1e3 * statistics.mean(a for _, a, _, _ in r),
            decode_ms=1e3 * statistics.mean(s - a for s, a, _, _ in r),
            enqueue_ms=1e3 * statistics.mean(f for _, _, f, _ in r),
            rows=statistics.mean(n for *_, n in r))
    for a, d in diffs.items():
        summary[f"fused_minus_{a}_decode_ms"] = dict(
            mean=statistics.mean(d), se=statistics.stdev(d) / len(d) ** 0.5,
            blocks=len(d))
    summary["card"] = H.card_facts(dev)
    return summary


if __name__ == "__main__":
    print(json.dumps(main(*(int(a) for a in sys.argv[1:4]))))
