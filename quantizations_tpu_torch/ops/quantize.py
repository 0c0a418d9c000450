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

``dequantize_4bit_pair(wp2 [M/2, K/4], scales) -> [M, K]``: the same
values from the pair-layout words (K10, ``csrc/dequantize.cu``), in the
original row and column order, with fp32, bf16 or ``bf16x2`` scales read
as they are; a layer of a stacked ``[L, M/2, K/4]`` is read in place.
Bit-exact with its plain version and with the pair branch of
``nn/linear.py dense_weight``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..quant.codebooks import NF4_CODE, code_midpoints, get_4bit_code
from ..quant.functional import _CODES_FN, _block_absmax, _normalize, pack_4bit
from .cuda import DEQUANTIZE_4BIT, DEQUANTIZE_4BIT_PAIR, QUANTIZE_4BIT, launch
from .gemv import _SHIFTS
from .qmatmul import pair_column, unpack_scale_pairs

__all__ = ["quantize_4bit_kernel", "quantize_4bit_kernel_plain",
           "dequantize_4bit_kernel", "dequantize_4bit_kernel_plain",
           "dequantize_4bit_pair", "dequantize_4bit_pair_plain"]


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
    if W.numel() == 0:
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


# scales dtype -> K10's scale_kind (int32: bf16x2 row-pair words)
_SCALE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def _pair_layer(wp2: torch.Tensor, scales: torch.Tensor,
                layer_idx: Optional[int]):
    """Check K10's operands and return layer ``layer_idx`` of a stack
    (the whole of an unstacked weight when None)."""
    if wp2.dtype != torch.int32 or wp2.dim() != (2 if layer_idx is None
                                                 else 3):
        raise ValueError(f"dequantize_4bit_pair: wp2 must be int32 [M/2, "
                         f"K/4] (or [L, M/2, K/4] with layer_idx), got "
                         f"{wp2.dtype} {tuple(wp2.shape)}")
    if scales.dim() != wp2.dim() or scales.device != wp2.device:
        raise ValueError(f"dequantize_4bit_pair: scales must have wp2's "
                         f"rank and device ({wp2.device}), got "
                         f"{tuple(scales.shape)} on {scales.device}")
    if layer_idx is not None:
        if not 0 <= layer_idx < wp2.shape[0] or scales.shape[0] != \
                wp2.shape[0]:
            raise ValueError(f"dequantize_4bit_pair: layer_idx {layer_idx} "
                             f"not in a stack of {wp2.shape[0]} (scales "
                             f"{scales.shape[0]})")
        wp2, scales = wp2[layer_idx], scales[layer_idx]
    M2, K4 = wp2.shape
    if K4 % 16:
        raise ValueError(f"dequantize_4bit_pair: K = {4 * K4} must be a "
                         "multiple of 64")
    rows = M2 if scales.dtype == torch.int32 else 2 * M2
    if scales.dtype not in _SCALE_KINDS or tuple(scales.shape) != (
            rows, K4 // 16):
        raise ValueError(f"dequantize_4bit_pair: scales must be fp32/bf16 "
                         f"[{2 * M2}, {K4 // 16}] or bf16x2 int32 [{M2}, "
                         f"{K4 // 16}], got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    return wp2, scales


def dequantize_4bit_pair_plain(wp2: torch.Tensor, scales: torch.Tensor,
                               quant_type: str = "fp4",
                               dtype: torch.dtype = torch.bfloat16,
                               layer_idx: Optional[int] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of K10: each nibble placed by
    :func:`~quantizations_tpu_torch.ops.qmatmul.pair_column`, its
    codebook value times the fp32 scale, cast to ``dtype``."""
    wp2, scales = _pair_layer(wp2, scales, layer_idx)
    M2, K4 = wp2.shape
    K = 4 * K4
    s = (unpack_scale_pairs(scales) if scales.dtype == torch.int32
         else scales.float()).reshape(M2, 2, K // 64)
    code = _device_code(quant_type, wp2.device)
    out = torch.empty((M2, 2, K), dtype=dtype, device=wp2.device)
    w = torch.arange(K4, device=wp2.device)
    for half in range(2):
        for p in range(4):
            _, col = pair_column(w, half, p, K)
            codes = ((wp2 >> (16 * half + 4 * p)) & 15).long()
            out[:, half, col] = (code[codes] * s[:, half, col // 64]
                                 ).to(dtype)
    return out.reshape(2 * M2, K)


def dequantize_4bit_pair(wp2: torch.Tensor, scales: torch.Tensor,
                         quant_type: str = "fp4",
                         dtype: torch.dtype = torch.bfloat16,
                         layer_idx: Optional[int] = None) -> torch.Tensor:
    """Dequantize pair words ``[M/2, K/4]`` (or layer ``layer_idx`` of
    ``[L, M/2, K/4]``) to ``[M, K]`` in the original row and column
    order: codebook value x fp32 scale, cast to ``dtype`` (fp32, bf16 or
    fp16). Scales: fp32 or bf16 ``[M, K/64]`` or ``bf16x2`` int32
    ``[M/2, K/64]``, stacked alike. Launches K10 for CUDA tensors, runs
    the plain version for CPU tensors."""
    if dtype not in _OUT_KINDS:
        raise ValueError(f"dequantize_4bit_pair: dtype {dtype} not in "
                         f"{tuple(_OUT_KINDS)}")
    if wp2.device.type == "cpu":
        return dequantize_4bit_pair_plain(wp2, scales, quant_type, dtype,
                                          layer_idx)
    wp2, scales = _pair_layer(wp2, scales, layer_idx)
    if not (wp2.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_4bit_pair: wp2 and scales must be "
                         "contiguous")
    M2, K4 = wp2.shape
    out = torch.empty((2 * M2, 4 * K4), dtype=dtype, device=wp2.device)
    if out.numel() == 0:
        return out
    launch(DEQUANTIZE_4BIT_PAIR, "qt_dequantize_4bit_pair", wp2.device,
           wp2.data_ptr(), scales.data_ptr(), _SCALE_KINDS[scales.dtype],
           _device_code(quant_type, wp2.device).data_ptr(), out.data_ptr(),
           _OUT_KINDS[dtype], M2, K4)
    return out
