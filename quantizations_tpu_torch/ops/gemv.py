"""Planar word layout and the fused 4-bit dequant + GEMV kernel K6
(counterpart of ``quantizations_tpu/ops/gemv.py``).

Word ``c`` of row ``m`` holds elements ``k = 8c .. 8c+7`` in bnb byte
order: element ``j`` sits at bit offset ``_SHIFTS[j]``.

K6 (``csrc/planar_matmul.cu``, entry ``qt_gemv_4bit``) is the TPU GEMV's
fp32 class: each code decodes to its fp32 table value (FP4: the RAW
codebook x 12; NF4: the codebook), is multiplied by the fp32 activation,
64 products are summed per quant block, the sum is multiplied by the
block's fp32 scale, and for FP4 each output is multiplied by 1/12 once.
bf16 scales are widened exactly. The wrappers launch it for CUDA tensors
and run the plain version, which repeats that arithmetic, for CPU
tensors.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..quant.codebooks import get_4bit_code
from .cuda import GEMV_4BIT, launch
from .lut import lut_fp4_bits_raw

__all__ = ["pack_i32_rows", "permute_activation", "planar_table",
           "gemv_4bit", "gemv_4bit_stacked", "gemv_4bit_plain",
           "gemv_4bit_stacked_plain", "check_planar_args", "_SHIFTS"]

# Nibble position of element j within an int32 word under bnb byte order
# (byte = even<<4 | odd, bytes little-endian).
_SHIFTS = tuple(8 * (j // 2) + (4 - 4 * (j % 2)) for j in range(8))

# K6 takes at most this many activation rows (a decode batch).
GEMV_MAX_ROWS = 8


def pack_i32_rows(packed_u8: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """bnb flat packed bytes ``[rows*cols/2(,1)]`` -> int32 words
    ``[rows, cols/8]``, little-endian (a reinterpretation of the same
    memory)."""
    b = packed_u8.reshape(rows, cols // 2).contiguous()
    return b.view(torch.int32)


def permute_activation(x: torch.Tensor) -> torch.Tensor:
    """``[B, K] -> [B, 8, K/8]`` with ``xp[b, j, c] = x[b, 8c + j]``."""
    B, K = x.shape
    return x.reshape(B, K // 8, 8).transpose(-1, -2)


@functools.lru_cache(maxsize=None)
def planar_table(quant_type: str) -> Tuple[torch.Tensor, float]:
    """``(table, out_factor)``: the fp32 16-entry decode of the planar
    kernels K5 and K6 (on the CPU; cached, not to be written). FP4
    decodes to the RAW codebook x 12 (exact) with ``out_factor = 1/12``,
    NF4 to its fp32 codebook with factor 1: what the TPU kernels'
    ``_lut_setup`` decodes give, bit for bit."""
    if quant_type == "fp4":
        return lut_fp4_bits_raw(torch.arange(16, dtype=torch.int32)), 1.0 / 12
    return torch.from_numpy(get_4bit_code(quant_type).copy()), 1.0


@functools.lru_cache(maxsize=None)
def device_planar_table(quant_type: str, device: torch.device) -> torch.Tensor:
    return planar_table(quant_type)[0].to(device)


def gemv_4bit_plain(wp: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
                    quant_type: str = "fp4") -> torch.Tensor:
    """Plain PyTorch version of K6: ``x [B, K] -> y [B, M]`` fp32, all
    arithmetic in fp32 (``x`` is widened to fp32 first)."""
    M, K8 = wp.shape
    table, out_factor = planar_table(quant_type)
    table = table.to(wp.device)
    xp = permute_activation(x.float())                    # [B, 8, K8]
    acc = torch.zeros((x.shape[0], M, K8), dtype=torch.float32,
                      device=wp.device)
    for j, sh in enumerate(_SHIFTS):
        vals = table[((wp >> sh) & 15).long()]            # [M, K8]
        acc += vals[None] * xp[:, j, None, :]
    g = acc.reshape(x.shape[0], M, K8 // 8, 8).sum(-1)    # per-64 sums
    out = (g * scales.float()[None]).sum(-1)
    if out_factor != 1.0:
        out = out * torch.tensor(out_factor, dtype=torch.float32)
    return out


def gemv_4bit_stacked_plain(wp: torch.Tensor, scales: torch.Tensor,
                            x: torch.Tensor, layer_idx: int,
                            quant_type: str = "fp4") -> torch.Tensor:
    """Plain version of the stacked form: layer ``layer_idx`` of
    ``[L, M, K/8]``."""
    return gemv_4bit_plain(wp[layer_idx], scales[layer_idx], x, quant_type)


# The planar kernels put blocks of 16 rows on grid y (at most 65535).
_MAX_ROWS = 16 * 65535


def check_planar_args(name: str, wp: torch.Tensor, scales: torch.Tensor,
                      x: torch.Tensor, x_dtypes) -> None:
    """Raise unless ``wp int32 [M, K/8]``, ``scales`` fp32/bf16
    ``[M, K/64]`` and ``x [T, K]`` of one of ``x_dtypes`` lie contiguous
    on one CUDA device, ``wp`` and ``x`` 16-byte aligned (the kernels
    load them 16 bytes at a time), with K a multiple of 64."""
    if not (x.is_cuda and wp.device == x.device == scales.device):
        raise ValueError(f"{name}: all tensors must be on the same CUDA "
                         "device")
    if wp.dtype != torch.int32 or wp.dim() != 2:
        raise ValueError(f"{name}: wp must be int32 [M, K/8], got "
                         f"{wp.dtype} {tuple(wp.shape)}")
    M, K8 = wp.shape
    if K8 % 8:
        raise ValueError(f"{name}: K = {8 * K8} is not a multiple of 64")
    if M > _MAX_ROWS:
        raise ValueError(f"{name}: M = {M} exceeds the kernel grid "
                         f"({_MAX_ROWS} rows)")
    if x.dtype not in x_dtypes or x.dim() != 2 or x.shape[1] != 8 * K8:
        raise ValueError(f"{name}: x must be {x_dtypes} [T, {8 * K8}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if scales.dtype not in (torch.float32, torch.bfloat16) or tuple(
            scales.shape) != (M, K8 // 8):
        raise ValueError(f"{name}: scales must be fp32/bf16 [{M}, {K8 // 8}],"
                         f" got {scales.dtype} {tuple(scales.shape)}")
    for what, t in (("wp", wp), ("scales", scales), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if wp.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name}: wp and x must be 16-byte aligned")


def _launch_gemv(wp, scales, x, quant_type):
    check_planar_args("gemv_4bit", wp, scales, x,
                      (torch.float32, torch.bfloat16))
    M, K8 = wp.shape
    B = x.shape[0]
    if B > GEMV_MAX_ROWS:
        raise ValueError(f"gemv_4bit: {B} rows, at most {GEMV_MAX_ROWS}")
    y = torch.empty((B, M), dtype=torch.float32, device=x.device)
    if B == 0 or M == 0:
        return y
    _, out_factor = planar_table(quant_type)
    launch(GEMV_4BIT, "qt_gemv_4bit", x.device, wp.data_ptr(),
           scales.data_ptr(), int(scales.dtype == torch.bfloat16),
           device_planar_table(quant_type, x.device).data_ptr(),
           x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(), B, M,
           K8, int(out_factor != 1.0), out_factor)
    return y


def gemv_4bit(wp: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
              quant_type: str = "fp4") -> torch.Tensor:
    """Fused 4-bit dequant + GEMV over planar words, fp32 throughout:
    ``y [B, M] = x [B, K] @ dequant(wp [M, K/8], scales [M, K/64]).T``.
    CUDA tensors launch K6 (``x`` fp32 or bf16, ``B <= 8``); CPU tensors
    run the plain version."""
    if x.device.type == "cpu":
        return gemv_4bit_plain(wp, scales, x, quant_type)
    return _launch_gemv(wp, scales, x, quant_type)


def gemv_4bit_stacked(wp: torch.Tensor, scales: torch.Tensor,
                      x: torch.Tensor, layer_idx: int,
                      quant_type: str = "fp4") -> torch.Tensor:
    """:func:`gemv_4bit` on layer ``layer_idx`` of stacked ``[L, M, K/8]``
    weights, read in place (``wp[layer_idx]`` of a contiguous stack is a
    contiguous view)."""
    if x.device.type == "cpu":
        return gemv_4bit_stacked_plain(wp, scales, x, layer_idx, quant_type)
    if wp.dim() != 3 or scales.dim() != 3:
        raise ValueError("gemv_4bit stacked: wp/scales must be [L, ...]")
    return _launch_gemv(wp[layer_idx], scales[layer_idx], x, quant_type)
