"""Profiling and serving metrics (counterpart of
``quantizations_tpu/utils/profiling.py``).

``trace()`` runs ``torch.profiler`` over the enclosed block (the CPU,
and the card when there is one) and writes a Chrome trace (view it in
Perfetto or ``chrome://tracing``); ``StepMetrics`` reports tokens per
second, the achieved weight bandwidth and the card's memory in use, as
JSON with the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Iterator, Optional, Union

import torch

from ..models.llama import named_tensors

__all__ = ["trace", "StepMetrics", "device_memory_gb", "achieved_bandwidth",
           "model_weight_bytes"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write ``trace.json`` (Chrome trace
    format) into ``log_dir``, made if missing. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_gb(device: Union[str, torch.device, None] = None
                     ) -> Optional[float]:
    """Tensor memory allocated on the card in GiB
    (``torch.cuda.memory_allocated``); None on the CPU or without a
    card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 2 ** 30


def achieved_bandwidth(bytes_touched: int, seconds: float) -> float:
    """GB/s."""
    return bytes_touched / seconds / 1e9


@dataclasses.dataclass
class StepMetrics:
    """Per-step serving metrics, JSON-printable."""

    tokens: int = 0
    step_s: float = 0.0
    weight_bytes: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.step_s if self.step_s else 0.0

    @property
    def hbm_gbps(self) -> Optional[float]:
        if not (self.weight_bytes and self.step_s):
            return None
        return achieved_bandwidth(self.weight_bytes, self.step_s)

    def to_json(self) -> str:
        d = {
            "tokens": self.tokens,
            "step_s": round(self.step_s, 6),
            "tokens_per_s": round(self.tokens_per_s, 2),
        }
        bw = self.hbm_gbps
        if bw is not None:
            d["achieved_hbm_gbps"] = round(bw, 1)
        mem = device_memory_gb()
        if mem is not None:
            d["hbm_in_use_gb"] = round(mem, 3)
        return json.dumps(d)


def model_weight_bytes(params) -> int:
    """Bytes of every tensor of a params tree, the JAX package's count.
    With a dense embedding table this is more than a decode token
    streams: a token reads one row of the table, not all of it."""
    return sum(t.numel() * t.element_size() for _, t in named_tensors(params))
