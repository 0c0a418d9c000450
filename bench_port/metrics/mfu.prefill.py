"""The whole step's share of the peak: model operations served before
the profiler's start (every emitted token's decode row at its length
and the prefill of every prompt first answered then, ``roofline.py``)
over those seconds times 989 TFLOP/s, %."""

from bench_port.roofline import PEAK_FLOPS


def read(run):
    return run.model_ops() / (run.clean_s * PEAK_FLOPS) * 100
