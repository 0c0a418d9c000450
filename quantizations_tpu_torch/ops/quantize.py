"""Blockwise 4-bit quantize kernel K2 and dequantize kernel K7
(counterpart of ``quantizations_tpu/ops/quantize.py``).

``quantize_4bit_kernel(W [M, K]) -> (wp int32 [M, K/8], absmax fp32
[M, K/blocksize])``: per-block absmax, the FP4 ladder or NF4 midpoint
count on ``w * (1/absmax)``, and 8 codes per int32 word in bnb byte
order. Bit-exact with :func:`quantizations_tpu_torch.quant.quantize_4bit`
(without double quantization). The wrapper launches
``csrc/quantize.cu`` for CUDA tensors and runs the plain version for CPU
tensors.

``dequantize_4bit_kernel(wp [M, K/8], scales [M, K/64]) -> [M, K]``: the
true codebook value (fp32) times the fp32 block scale, cast to ``dtype``,
in the original element order. K7 (``csrc/dequantize.cu``) and its plain
version agree bit for bit.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..quant.codebooks import NF4_CODE, code_midpoints, get_4bit_code
from ..quant.functional import _CODES_FN, _block_absmax, _normalize, pack_4bit
from .cuda import DEQUANTIZE_4BIT, QUANTIZE_4BIT, launch
from .gemv import _SHIFTS

__all__ = ["quantize_4bit_kernel", "quantize_4bit_kernel_plain",
           "dequantize_4bit_kernel", "dequantize_4bit_kernel_plain"]


def quantize_4bit_kernel_plain(W: torch.Tensor, blocksize: int = 64,
                               quant_type: str = "fp4"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, same signature and outputs."""
    M, K = W.shape
    _check_shape(M, K, blocksize, quant_type)
    blocked, absmax, _ = _block_absmax(W.reshape(-1).to(torch.float32),
                                       blocksize)
    codes = _CODES_FN[quant_type](_normalize(blocked, absmax))
    wp = pack_4bit(codes).reshape(M, K // 2).view(torch.int32)
    return wp, absmax.reshape(M, K // blocksize)


def _check_shape(M: int, K: int, blocksize: int, quant_type: str) -> None:
    if quant_type not in ("fp4", "nf4"):
        raise ValueError(f"quantize_4bit: quant_type {quant_type!r}")
    if blocksize % 8 or K % blocksize:
        raise ValueError(f"quantize_4bit: K={K} must be a multiple of "
                         f"blocksize={blocksize}, itself a multiple of 8")


@functools.lru_cache(maxsize=None)
def _device_mids(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(code_midpoints(NF4_CODE)).to(device)


def quantize_4bit_kernel(W: torch.Tensor, blocksize: int = 64,
                         quant_type: str = "fp4"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise 4-bit quantization of a ``[M, K]`` fp32 or bf16 weight:
    ``(wp int32 [M, K/8], absmax fp32 [M, K/blocksize])``. Launches K2
    for a CUDA tensor, runs the plain version for a CPU tensor."""
    if W.device.type == "cpu":
        return quantize_4bit_kernel_plain(W, blocksize, quant_type)
    if W.dim() != 2 or W.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_4bit: W must be fp32/bf16 [M, K], got "
                         f"{W.dtype} {tuple(W.shape)}")
    if not W.is_contiguous() or W.data_ptr() % 16:
        raise ValueError("quantize_4bit: W must be contiguous and 16-byte "
                         "aligned")
    M, K = W.shape
    _check_shape(M, K, blocksize, quant_type)
    wp = torch.empty((M, K // 8), dtype=torch.int32, device=W.device)
    absmax = torch.empty((M, K // blocksize), dtype=torch.float32,
                         device=W.device)
    if M == 0:
        return wp, absmax
    launch(QUANTIZE_4BIT, "qt_quantize_4bit", W.device, W.data_ptr(),
           int(W.dtype == torch.bfloat16), _device_mids(W.device).data_ptr(),
           wp.data_ptr(), absmax.data_ptr(), M, K, blocksize,
           int(quant_type == "nf4"))
    return wp, absmax


def dequantize_4bit_kernel_plain(wp: torch.Tensor, scales: torch.Tensor,
                                 quant_type: str = "fp4",
                                 dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """Plain PyTorch version of K7: planar words ``[M, K/8]`` and per-64
    scales ``[M, K/64]`` -> ``[M, K]`` in ``dtype``."""
    M, K8 = wp.shape
    code = torch.from_numpy(get_4bit_code(quant_type).copy()).to(wp.device)
    s = scales.float().repeat_interleave(8, dim=1)            # [M, K8]
    planes = [(code[((wp >> sh) & 15).long()] * s).to(dtype)
              for sh in _SHIFTS]
    return torch.stack(planes, dim=-1).reshape(M, 8 * K8)


# output dtype -> the kernel's out_kind
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=None)
def _device_code(quant_type: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(get_4bit_code(quant_type).copy()).to(device)


def dequantize_4bit_kernel(wp: torch.Tensor, scales: torch.Tensor,
                           quant_type: str = "fp4",
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Dequantize planar words to ``[M, K]`` in the original element
    order: codebook value x fp32 scale, cast to ``dtype``. Launches K7
    for CUDA tensors (``dtype`` fp32, bf16 or fp16; scales fp32 or
    bf16), runs the plain version for CPU tensors."""
    if wp.device.type == "cpu":
        return dequantize_4bit_kernel_plain(wp, scales, quant_type, dtype)
    if wp.dtype != torch.int32 or wp.dim() != 2 or wp.shape[1] % 8:
        raise ValueError(f"dequantize_4bit: wp must be int32 [M, K/8] with "
                         f"K a multiple of 64, got {wp.dtype} "
                         f"{tuple(wp.shape)}")
    M, K8 = wp.shape
    if scales.device != wp.device or scales.dtype not in (
            torch.float32, torch.bfloat16) or tuple(scales.shape) != (
                M, K8 // 8):
        raise ValueError(f"dequantize_4bit: scales must be fp32/bf16 "
                         f"[{M}, {K8 // 8}] on {wp.device}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if dtype not in _OUT_KINDS:
        raise ValueError(f"dequantize_4bit: dtype {dtype} not in "
                         f"{tuple(_OUT_KINDS)}")
    if not (wp.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_4bit: wp and scales must be contiguous")
    out = torch.empty((M, 8 * K8), dtype=dtype, device=wp.device)
    if out.numel() == 0:
        return out
    launch(DEQUANTIZE_4BIT, "qt_dequantize_4bit", wp.device, wp.data_ptr(),
           scales.data_ptr(), int(scales.dtype == torch.bfloat16),
           _device_code(quant_type, wp.device).data_ptr(), out.data_ptr(),
           _OUT_KINDS[dtype], M, K8)
    return out
