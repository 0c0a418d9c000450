"""File-level bitsandbytes checkpoint interop, the HF flat-key format
(counterpart of ``quantizations_tpu/quant/bnb_io.py``).

HF writes these flat tensors beside each quantized ``...weight``:

    <prefix>.weight                                  uint8 [ceil(n/2), 1]
    <prefix>.weight.absmax                           uint8 (nested) / fp32
    <prefix>.weight.quant_map                        fp32 [16]
    <prefix>.weight.nested_absmax                    fp32   (double quant)
    <prefix>.weight.nested_quant_map                 fp32 [256]
    <prefix>.weight.quant_state.bitsandbytes__fp4    uint8 JSON metadata
                                    (or ...__nf4)

The JSON tensor is the UTF-8 encoding of the non-tensor quant-state
fields. Tensors cross as numpy arrays, read through a ``get`` callable,
so no file format package is needed here.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..nn.linear import Linear4bit, Params4bit
from ..ops.gemv import pack_i32_rows
from ..ops.qmatmul import planar_to_pair
from .functional import dequantize_absmax
from .state import QuantState

__all__ = [
    "bnb_flat_tensors",
    "parse_bnb_flat",
    "is_bnb_quantized",
    "qlinear_arrays_from_bnb",
    "load_bnb_linear4bit",
]

_META_KEYS = ("quant_type", "blocksize", "dtype", "shape",
              "nested_blocksize", "nested_dtype", "nested_offset")


def bnb_flat_tensors(prefix: str, packed: Union[np.ndarray, torch.Tensor],
                     state: QuantState) -> Dict[str, np.ndarray]:
    """Export one quantized linear as the HF-bnb flat tensor dict.
    ``prefix`` is the module path (``model.layers.0.self_attn.q_proj``);
    ``packed`` the uint8 payload ``[ceil(n/2), 1]``."""
    if isinstance(packed, torch.Tensor):
        packed = packed.detach().cpu().numpy()
    d = state.as_dict()
    meta = dict(d["quant_state"])
    meta["shape"] = list(meta["shape"])
    out = {
        f"{prefix}.weight": np.asarray(packed, np.uint8),
        f"{prefix}.weight.absmax": np.asarray(d["absmax"]),
        f"{prefix}.weight.quant_map": np.asarray(d["quant_map"], np.float32),
    }
    if "nested_absmax" in d:
        out[f"{prefix}.weight.nested_absmax"] = np.asarray(
            d["nested_absmax"], np.float32)
        out[f"{prefix}.weight.nested_quant_map"] = np.asarray(
            d["nested_quant_map"], np.float32)
    js = json.dumps({k: meta[k] for k in _META_KEYS if k in meta})
    out[f"{prefix}.weight.quant_state.bitsandbytes__{state.quant_type}"] = (
        np.frombuffer(js.encode("utf-8"), dtype=np.uint8).copy())
    return out


def _qs_key(names, prefix: str) -> Optional[str]:
    for qt in ("fp4", "nf4"):
        k = f"{prefix}.weight.quant_state.bitsandbytes__{qt}"
        if k in names:
            return k
    return None


def is_bnb_quantized(names, prefix: str) -> bool:
    """Whether ``prefix`` is stored bnb-4bit-quantized in a tensor set."""
    return _qs_key(names, prefix) is not None


def parse_bnb_flat(get: Callable[[str], np.ndarray], names, prefix: str,
                   ) -> Tuple[np.ndarray, QuantState]:
    """One linear's flat bnb keys -> (packed uint8, QuantState on the
    CPU). ``get`` maps a tensor name to its array; ``names`` is the set
    of available keys."""
    qs_key = _qs_key(names, prefix)
    if qs_key is None:
        raise KeyError(f"{prefix} is not bnb-4bit serialized")
    meta = json.loads(bytes(np.asarray(get(qs_key), np.uint8)).decode("utf-8"))
    d: Dict[str, Any] = {
        "absmax": np.asarray(get(f"{prefix}.weight.absmax")),
        "quant_state": meta,
    }
    qm = f"{prefix}.weight.quant_map"
    if qm in names:
        d["quant_map"] = np.asarray(get(qm))
    na = f"{prefix}.weight.nested_absmax"
    if na in names:
        d["nested_absmax"] = np.asarray(get(na))
        d["nested_quant_map"] = np.asarray(
            get(f"{prefix}.weight.nested_quant_map"))
    state = QuantState.from_dict(d)
    packed = np.asarray(get(f"{prefix}.weight"), np.uint8)
    return packed, state


def qlinear_arrays_from_bnb(packed: np.ndarray, state: QuantState,
                            layout: str = "planar",
                            device: Union[str, torch.device] = "cuda",
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bnb payload -> the runtime tensors ``(wp, scales)`` on ``device``:
    ``wp`` the int32 view of the packed bytes (planar ``[M, K/8]``, or
    the pair layout), ``scales`` the resolved fp32 per-64 absmax (double
    quantization inverted once, here)."""
    dev = resolve_device(device)
    out_f, in_f = state.shape
    # a file's bytes may be a strided or read-only view: copy them
    u8 = torch.from_numpy(np.array(packed, dtype=np.uint8).reshape(-1))
    wp = pack_i32_rows(u8, out_f, in_f)
    scales = dequantize_absmax(state).reshape(out_f, in_f // state.blocksize)
    if state.blocksize != 64:
        scales = scales.repeat_interleave(state.blocksize // 64, dim=1)
    if layout == "pair":
        wp = planar_to_pair(wp)
    return wp.to(dev), scales.to(dev)


def load_bnb_linear4bit(get: Callable[[str], np.ndarray], names,
                        prefix: str, compute_dtype: Any = torch.bfloat16,
                        device: Union[str, torch.device] = "cuda"):
    """Load one bnb-serialized linear into a planar
    :class:`~quantizations_tpu_torch.nn.linear.Linear4bit` on
    ``device``."""
    dev = resolve_device(device)
    packed, state = parse_bnb_flat(get, names, prefix)
    wp, scales = qlinear_arrays_from_bnb(packed, state, device=dev)
    bias = None
    bk = f"{prefix}.bias"
    if bk in names:
        bias = torch.from_numpy(np.array(get(bk), np.float32)).to(dev)
    return Linear4bit(Params4bit(wp=wp, scales=scales,
                                 quant_state=state.to(dev)),
                      bias=bias, compute_dtype=compute_dtype)
