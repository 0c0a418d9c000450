"""QuantState: what is needed to invert a blockwise quantization
(counterpart of ``quantizations_tpu/quant/state.py``, as a dataclass of
tensors)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["QuantState", "VALID_QUANT_TYPES"]

VALID_QUANT_TYPES = ("fp4", "nf4")


@dataclasses.dataclass
class QuantState:
    """Everything needed to invert a blockwise quantization.

    - ``absmax``: per-block scales, float32 ``[nblocks]``; uint8 codes
      when ``state2`` is set (double quantization).
    - ``code``: the codebook the payload was quantized against.
    - ``offset``: mean of the raw absmax, subtracted before the nested
      8-bit quantization (None when not nested).
    - ``state2``: nested QuantState of the quantized absmax.
    - ``blocksize`` / ``quant_type`` / ``dtype`` / ``shape``: metadata.
    """

    absmax: torch.Tensor
    code: torch.Tensor
    offset: Optional[torch.Tensor] = None
    state2: Optional["QuantState"] = None
    blocksize: int = 64
    quant_type: str = "fp4"
    dtype: Any = torch.bfloat16
    shape: tuple = ()

    @property
    def nested(self) -> bool:
        return self.state2 is not None
