"""Least time of the profiled decode steps' attention (K and V read at
each row's length, ``roofline.py``) over the device time of the
attention kernels (``kernels/*.json``, group ``attn``) inside
``PagedEngine.step`` and outside its admission, %. The lengths come from
the engine's host state (each token's position), the kernels by name,
so a decode step replayed as a CUDA graph still reads."""

from bench_port import roofline

KV_ITEM = {"bf16": 2, "int8": 1}


def read(run):
    d = run.device
    names = run.kernel_groups.get("attn")
    lengths = run.stretch_lengths()
    if d is None or not lengths or not names:
        return None
    dev_s, _ = d.select("engine.step", "decode", names=names)
    if dev_s <= 0:
        return None
    kv = KV_ITEM[run.cell.config["kv_cache_dtype"]]
    least = sum(roofline.decode_step_attention_least(run.cell.dims, ls, kv)
                for ls in lengths)
    return least / dev_s * 100
