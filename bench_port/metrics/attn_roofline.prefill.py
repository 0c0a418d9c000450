"""Least time of the prefill attention calls of the prefill phase (``roofline.py``,
from shapes) over the device time of the kernels launched inside their
span (``attn.prefill``), in the profiled stretch, %."""


def read(run):
    if run.rec is None or run.device is None:
        return None
    acc = run.rec.acc("attn", "prefill")
    dev_s, _ = run.device.select("attn.prefill", "prefill")
    if not acc.calls or dev_s <= 0:
        return None
    return acc.least_s / dev_s * 100
