"""QuantState: what is needed to invert a blockwise quantization
(counterpart of ``quantizations_tpu/quant/state.py``, as a dataclass of
tensors).

Serialization uses the bitsandbytes key schema (``valid_qs_keys``), so
bnb checkpoints round-trip: :meth:`QuantState.as_dict` gives the same
numpy arrays and metadata as the JAX package's ``as_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from .codebooks import create_dynamic_map, get_4bit_code

__all__ = ["QuantState", "valid_qs_keys", "VALID_QUANT_TYPES",
           "dtype_name", "dtype_from_name"]

VALID_QUANT_TYPES = ("fp4", "nf4")

# bnb serialization key schema.
valid_qs_keys = [
    "absmax",
    "quant_map",
    "nested_absmax",
    "nested_quant_map",
    "quant_state",
    "quant_type",
    "blocksize",
    "dtype",
    "shape",
    "nested_blocksize",
    "nested_dtype",
    "nested_offset",
]


def dtype_name(dtype: Any) -> str:
    """A dtype's bnb metadata name: ``torch.bfloat16`` -> ``"bfloat16"``
    (a name passes through)."""
    return dtype if isinstance(dtype, str) else str(dtype).rpartition(".")[2]


def dtype_from_name(name: str) -> torch.dtype:
    """Inverse of :func:`dtype_name`."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


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

    def to(self, device: Union[str, torch.device]) -> "QuantState":
        """The same state with every tensor on ``device``."""
        return dataclasses.replace(
            self, absmax=self.absmax.to(device), code=self.code.to(device),
            offset=None if self.offset is None else self.offset.to(device),
            state2=None if self.state2 is None else self.state2.to(device))

    # -- bnb-compatible serialization -------------------------------------

    def as_dict(self, packed: Optional[np.ndarray] = None) -> dict:
        """Export in the bitsandbytes quant_state dict layout: keys from
        ``valid_qs_keys``, tensors as numpy, the non-tensor fields under
        ``"quant_state"``. ``packed`` (the uint8 payload) is accepted and
        not part of the dict, as in the JAX package: bnb stores it as the
        parameter itself."""
        qs_meta = {
            "quant_type": self.quant_type,
            "blocksize": self.blocksize,
            "dtype": dtype_name(self.dtype),
            "shape": tuple(int(s) for s in self.shape),
        }
        out = {"absmax": _np(self.absmax), "quant_map": _np(self.code)}
        if self.nested:
            st2 = self.state2
            out["nested_absmax"] = _np(st2.absmax)
            out["nested_quant_map"] = _np(st2.code)
            qs_meta["nested_blocksize"] = st2.blocksize
            qs_meta["nested_dtype"] = dtype_name(st2.dtype)
            qs_meta["nested_offset"] = float(_np(self.offset))
        out["quant_state"] = qs_meta
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "QuantState":
        """Reconstruct on the CPU from the bnb dict layout produced by
        :meth:`as_dict` (or read from a bnb checkpoint's
        ``weight.quant_state.*`` keys)."""
        meta = d["quant_state"]
        quant_type = meta["quant_type"]
        common = dict(blocksize=int(meta["blocksize"]), quant_type=quant_type,
                      dtype=dtype_from_name(meta["dtype"]),
                      shape=tuple(meta["shape"]))
        code = _f32(d.get("quant_map", get_4bit_code(quant_type)))
        if "nested_offset" in meta or "nested_absmax" in d:
            state2 = cls(
                absmax=_f32(d["nested_absmax"]),
                code=_f32(d.get("nested_quant_map", create_dynamic_map())),
                blocksize=int(meta.get("nested_blocksize", 256)),
                quant_type="dynamic8bit",
                dtype=dtype_from_name(meta.get("nested_dtype", "float32")),
                shape=(int(np.asarray(d["absmax"]).size),))
            return cls(
                absmax=torch.from_numpy(
                    np.array(d["absmax"], dtype=np.uint8)),
                code=code,
                offset=torch.tensor(np.float32(meta["nested_offset"])),
                state2=state2, **common)
        return cls(absmax=_f32(d["absmax"]), code=code, **common)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))
