"""Least time of the profiled decode steps' 4-bit projections over the
device time of the projection kernels (``kernels/*.json``, group
``linear``) inside ``PagedEngine.step`` and outside its admission, %.
The work is counted from the engine's host state (each step's rows,
``roofline.py``) and the kernels by name, so a decode step replayed as
a CUDA graph still reads."""

from bench_port import roofline

SCALE_ITEM = {"float32": 4, "bfloat16": 2, "bf16x2": 2}


def read(run):
    d, steps = run.device, run.stretch_steps()
    names = run.kernel_groups.get("linear")
    if d is None or not steps or not names:
        return None
    dev_s, _ = d.select("engine.step", "decode", names=names)
    if dev_s <= 0:
        return None
    q, c = run.cell.config["quant"], run.cell.config
    least = sum(roofline.decode_step_linear_least(
        run.cell.dims, rows, bool(c.get("fuse_projections")),
        q["blocksize"], SCALE_ITEM[q["scales_dtype"]],
        q["quantize_lm_head"]) for _, _, rows in steps)
    return least / dev_s * 100
