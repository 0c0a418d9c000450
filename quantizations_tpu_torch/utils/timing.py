"""Device timing of short functions (counterpart of
``quantizations_tpu/utils/timing.py``).

``time_scan_chain`` times ``iters`` data-dependent calls: each call's
input is the previous input perturbed by ``1e-30 * sum(output)``, so the
calls run in order and none can be skipped, while x stays numerically
the same. The per-call time is the slope between ``iters`` and
``iters // 2`` calls, which cancels the fixed cost of starting and
ending a chain. The perturbation is three small operations per call (a
sum, a scale and an add: three kernel launches on the card), and their
time is part of the per-call time returned. On the card the chain is
timed with CUDA events; on the CPU, when asked, with
``time.perf_counter``.
"""

from __future__ import annotations

import time
from typing import Callable, Union

import torch

from ..device import resolve_device

__all__ = ["time_scan_chain"]


def time_scan_chain(
    fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    iters: int = 100,
    trials: int = 3,
    min_total_s: float = 0.5,
    max_iters: int = 20000,
    consts: tuple = (),
    device: Union[str, torch.device] = "cuda",
) -> float:
    """Return the best per-call seconds of ``fn(x, *consts)`` over a
    chain of serialized calls, each call's perturbation of x included.

    ``fn`` maps a tensor x (plus ``consts``, passed through) to any
    tensor. The call count grows by 4x until one chain takes at least
    ``min_total_s`` (or reaches ``max_iters``); each chain's time is the
    best of ``trials``. ``x0`` is not modified. ``device`` must be where
    ``x0`` lies: ``"cuda"`` times with CUDA events, ``"cpu"`` with the
    host clock."""
    dev = resolve_device(device)
    if x0.device.type != dev.type:
        raise ValueError(f"time_scan_chain: x0 is on {x0.device}, "
                         f"device is {dev}")
    cuda = dev.type == "cuda"

    def chain(n: int) -> torch.Tensor:
        x = x0.clone()
        for _ in range(n):
            out = fn(x, *consts)
            eps = out.float().sum() * 1e-30
            x = x + eps.to(x.dtype)
        return x.float().sum()

    def total_time(n: int) -> float:
        float(chain(n))       # warm up
        best = float("inf")
        for _ in range(trials):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain(n)
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                float(chain(n))
                t = time.perf_counter() - t0
            best = min(best, t)
        return best

    with torch.inference_mode():
        t = total_time(iters)
        while t < min_total_s and iters < max_iters:
            iters *= 4
            t = total_time(iters)
        # the slope between iters and iters // 2 cancels the fixed cost
        t_half = total_time(max(1, iters // 2))
    return max((t - t_half) / (iters - iters // 2), 1e-12)
