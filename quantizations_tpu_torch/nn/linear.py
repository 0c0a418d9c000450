"""The 4-bit matmul dispatch of the module layer (counterpart of
``quantizations_tpu/nn/linear.py``; ``Params4bit``/``Linear4bit`` are not
ported yet).

Pair-layout weights take kernel K1 (``ops/qmatmul.py``) up to
:func:`pair_max_tokens` token rows and the dense pair matmul above it,
as in the JAX package. Planar weights have no ported kernel: on the CPU
they take the plain dequant + matmul path, on the GPU they raise.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ..ops.gemv import _SHIFTS
from ..ops.lut import lut_fp4_bits, lut_tree
from ..ops.qmatmul import (
    matmul_4bit_pair,
    pair_permute_activation,
    pair_to_planar,
    unpack_scale_pairs,
)
from ..quant.codebooks import get_4bit_code

__all__ = ["apply_4bit", "dense_matmul_pair", "dequantize_permuted",
           "permute_cols", "dense_weight", "kernel_activation",
           "pair_max_tokens", "PAIR_QMATMUL_MAX_TOKENS"]

# Default upper token count of the fused pair kernel band.
PAIR_QMATMUL_MAX_TOKENS = 256


def pair_max_tokens() -> int:
    """The pair kernel's token band: ``QT_PAIR_MAX_TOKENS`` when set (a
    positive integer, else ValueError), otherwise 256."""
    raw = os.environ.get("QT_PAIR_MAX_TOKENS")
    if raw is None:
        return PAIR_QMATMUL_MAX_TOKENS
    try:
        val = int(raw)
    except ValueError:
        val = 0
    if val < 1:
        raise ValueError(
            f"QT_PAIR_MAX_TOKENS={raw!r} must be a positive integer")
    return val


def kernel_activation(x2: torch.Tensor, compute_dtype: Any) -> torch.Tensor:
    """The activation K1 reads: ``x2`` cast to ``compute_dtype`` (as the
    JAX package casts before the call), then to bf16 (as its kernel casts
    inside), contiguous."""
    return x2.to(compute_dtype).to(torch.bfloat16).contiguous()


def _decode(codes: torch.Tensor, quant_type: str) -> torch.Tensor:
    if quant_type == "fp4":
        return lut_fp4_bits(codes)
    return lut_tree(codes, get_4bit_code(quant_type))


def dequantize_permuted(wp: torch.Tensor, scales: torch.Tensor,
                        quant_type: str, dtype: Any = torch.bfloat16
                        ) -> torch.Tensor:
    """Dequantize planar words to a column-permuted ``[M, K]`` where
    column ``j*K/8 + c`` holds original element ``8c + j``: fp32 decode
    times fp32 scale, then cast to ``dtype``."""
    srep8 = scales.to(torch.float32).repeat_interleave(8, dim=1)  # [M, K/8]
    planes = [(_decode((wp >> s) & 15, quant_type) * srep8).to(dtype)
              for s in _SHIFTS]
    return torch.cat(planes, dim=1)


def permute_cols(x: torch.Tensor) -> torch.Tensor:
    """Permute activation columns to match :func:`dequantize_permuted`."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    return x.reshape(*lead, K // 8, 8).transpose(-1, -2).reshape(*lead, K)


def dense_weight(wp: torch.Tensor, scales: torch.Tensor, quant_type: str,
                 layout: str) -> torch.Tensor:
    """Packed weight (pair or planar) + resolved scales -> the dense bf16
    ``[M, K]`` in original column order (the dequantized twin)."""
    if layout == "pair":
        wp = pair_to_planar(wp)
    if scales.dtype == torch.int32:
        scales = unpack_scale_pairs(scales)
    Wp = dequantize_permuted(wp, scales, quant_type, dtype=torch.bfloat16)
    M, K = Wp.shape
    return Wp.reshape(M, 8, K // 8).transpose(1, 2).reshape(M, K)


def dense_matmul_pair(x2: torch.Tensor, wp2: torch.Tensor,
                      scales: torch.Tensor, quant_type: str,
                      compute_dtype: Any = torch.bfloat16) -> torch.Tensor:
    """Matmul straight from the pair layout above the kernel band:
    dequantize the even-row and odd-row halves as two ``[M/2, K]``
    matrices in the pair column order (fp32 decode x fp32 scale, cast to
    ``compute_dtype``), multiply each, and interleave the output columns.
    Returns fp32 ``[T, M]``."""
    if scales.dtype == torch.int32:
        scales = unpack_scale_pairs(scales)
    M2, K4 = wp2.shape[-2:]
    T = x2.shape[0]
    NB = scales.shape[-1]
    xf = pair_permute_activation(x2.to(compute_dtype)).reshape(T, 4 * K4)
    rep = K4 // NB
    ys = []
    for rows, base in ((slice(0, None, 2), 0), (slice(1, None, 2), 16)):
        srep = scales[rows, :].to(torch.float32).repeat(1, rep)
        planes = [(_decode((wp2 >> (base + 4 * p)) & 15, quant_type) * srep
                   ).to(compute_dtype) for p in range(4)]
        Wh = torch.cat(planes, dim=1)                   # [M/2, K] pair cols
        ys.append(xf.float() @ Wh.float().T)
    return torch.stack(ys, dim=-1).reshape(T, 2 * M2)


def apply_4bit(x2: torch.Tensor, wp: torch.Tensor, scales: torch.Tensor,
               quant_type: str, compute_dtype: Any = torch.bfloat16
               ) -> torch.Tensor:
    """``x2 [T, K] @ dequant(wp, scales).T -> [T, M]`` fp32.

    Pair weights: K1 for ``T <= pair_max_tokens()`` token rows (any T;
    the TPU kernels' tiling rule ``pair_tokens_ok`` does not bind K1),
    else :func:`dense_matmul_pair`. Planar weights: plain dequant +
    matmul on the CPU; not ported to the GPU."""
    tokens = x2.shape[0]
    spacked = scales.dtype == torch.int32
    pair = spacked or wp.shape[-2] != scales.shape[-2]
    if pair:
        if tokens <= pair_max_tokens():
            return matmul_4bit_pair(wp, scales,
                                    kernel_activation(x2, compute_dtype),
                                    quant_type)
        return dense_matmul_pair(x2, wp, scales, quant_type,
                                 compute_dtype=compute_dtype)
    if x2.is_cuda:
        raise NotImplementedError(
            "planar-layout 4-bit weights need the planar matmul kernel "
            "(quantizations_tpu/ops/qmatmul.py:93 matmul_4bit_pallas / "
            "ops/gemv.py:296 gemv_4bit_pallas), which is not ported")
    W = dequantize_permuted(wp, scales, quant_type, dtype=compute_dtype)
    xp = permute_cols(x2.to(compute_dtype))
    return xp.float() @ W.float().T
