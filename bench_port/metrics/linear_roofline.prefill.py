"""Least time of the 4-bit projection calls of the prefill phase (``roofline.py``,
from shapes) over the device time of the kernels launched inside their
span (``linear.4bit``), in the profiled stretch, %."""


def read(run):
    if run.rec is None or run.device is None:
        return None
    acc = run.rec.acc("linear", "prefill")
    dev_s, _ = run.device.select("linear.4bit", "prefill")
    if not acc.calls or dev_s <= 0:
        return None
    return acc.least_s / dev_s * 100
