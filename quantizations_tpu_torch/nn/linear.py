"""The module layer (counterpart of ``quantizations_tpu/nn/linear.py``):
the 4-bit matmul dispatch :func:`apply_4bit`, :class:`Params4bit` and the
bnb-compatible :class:`Linear4bit`.

Pair-layout weights take kernel K1 (``ops/qmatmul.py``) up to
:func:`pair_max_tokens` token rows and the dense pair band above it (on
the card K10 dequantizes, ``ops/quantize.py``, and bf16 tensor-core
products with fp32 output follow, :func:`dense_product`);
with ``pair_pipeline="manual"`` the band's projections that pass the JAX
package's gate (unpacked scales, ``M % 128 == 0``, ``manual_vmem_ok``)
take K9 instead, K1's function bit for bit.
Planar weights follow the JAX package's bands: K5 (``ops/qmatmul.py``)
up to :data:`QMATMUL_MAX_TOKENS` rows when the row count is one the TPU
kernel tiles (``qmm_ok``), else K6 (``ops/gemv.py``) up to
:data:`GEMV_MAX_TOKENS` rows, else K7 (``ops/quantize.py``) dequantizes
the weight and the same bf16 product follows. On CPU tensors each
kernel's plain version runs in its band, and the dense products are fp32
matmuls of the same values.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Union

import numpy as np
import torch

from ..config import FP4_DECODES, PAIR_PIPELINES
from ..device import resolve_device
from ..ops.gemv import _SHIFTS, gemv_4bit, pack_i32_rows
from ..ops.lut import lut_fp4_bits, lut_tree
from ..ops.quantize import dequantize_4bit_kernel, dequantize_4bit_pair
from ..ops.qmatmul import (
    manual_vmem_ok,
    matmul_4bit_pair,
    matmul_4bit_pair_manual,
    matmul_4bit_planar,
    pair_permute_activation,
    pair_to_planar,
    planar_to_pair,
    unpack_scale_pairs,
)
from ..quant.codebooks import get_4bit_code
from ..quant.functional import dequantize_absmax, quantize_4bit
from ..quant.state import QuantState

__all__ = ["apply_4bit", "dense_matmul_pair", "dense_matmul_pair_plain",
           "dense_product", "dequantize_permuted",
           "permute_cols", "dense_weight", "kernel_activation",
           "pair_max_tokens", "qmm_ok", "gemv_activation", "manual_ok",
           "Params4bit", "Linear4bit", "PAIR_QMATMUL_MAX_TOKENS",
           "DENSE_PRODUCT_CHUNK_K",
           "QMATMUL_MAX_TOKENS", "GEMV_MAX_TOKENS"]

# Planar bands: K6 (the fp32 GEMV) takes at most this many token rows...
GEMV_MAX_TOKENS = 8
# ... and K5 (the bf16 dequant-matmul) at most this many.
QMATMUL_MAX_TOKENS = 64

# Default upper token count of the fused pair kernel band.
PAIR_QMATMUL_MAX_TOKENS = 256

# Columns of K per tensor-core product in :func:`dense_product`.
DENSE_PRODUCT_CHUNK_K = 2048


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


def qmm_ok(tokens: int) -> bool:
    """Whether the JAX package's planar matmul kernel tiles ``tokens``
    rows (1, 2, 4 or a multiple of 8). K5 takes any row count; the rule
    is kept because it decides which rounding class a row count gets:
    the others in the GEMV band take K6."""
    return tokens in (1, 2, 4) or tokens % 8 == 0


def manual_ok(M: int, K: int, tokens: int, scales: torch.Tensor) -> bool:
    """The JAX package's gate for its manual-pipeline pair kernel:
    unpacked scales, ``M % 128 == 0`` and :func:`manual_vmem_ok` at the
    scales' itemsize."""
    return (scales.dtype != torch.int32 and M % 128 == 0
            and manual_vmem_ok(M, K, tokens, scales.element_size()))


def gemv_activation(x2: torch.Tensor, compute_dtype: Any) -> torch.Tensor:
    """The activation K6 reads: ``x2`` cast to ``compute_dtype``, widened
    to fp32 unless it is bf16 or fp32 (the kernel widens those itself),
    contiguous."""
    x = x2.to(compute_dtype)
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()
    return x.contiguous()


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


def dense_product(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``x [T, K] @ W[M, K].T -> fp32 [T, M]`` for the dense bands, the
    reference's ``jnp.dot(..., preferred_element_type=jnp.float32)``. On
    the card a bf16 or fp16 ``x`` and ``W`` take one tensor-core product
    with fp32 output per :data:`DENSE_PRODUCT_CHUNK_K` columns of K
    (``torch.mm`` / ``torch.addmm(..., out_dtype=torch.float32)`` into one
    fp32 output): exact products, and fp32 partial sums added in fp32.
    On an H100 one product over the whole K = 14336 came out 1.9e-5 of
    max|y| from the fp32 product of the same values (the tensor cores'
    accumulator over a long K), the chunks within 4.1e-6. Otherwise, and
    on the CPU, an fp32 matmul of the same values."""
    if not x.is_cuda or x.dtype == torch.float32:
        return x.float() @ W.float().T
    c = DENSE_PRODUCT_CHUNK_K
    y = torch.mm(x[:, :c], W[:, :c].T, out_dtype=torch.float32)
    for k0 in range(c, x.shape[1], c):
        torch.addmm(y, x[:, k0:k0 + c], W[:, k0:k0 + c].T,
                    out_dtype=torch.float32, out=y)
    return y


def dense_matmul_pair_plain(x2: torch.Tensor, wp2: torch.Tensor,
                            scales: torch.Tensor, quant_type: str,
                            compute_dtype: Any = torch.bfloat16
                            ) -> torch.Tensor:
    """Plain version of the dense pair band, the JAX package's own steps:
    dequantize the even-row and odd-row halves as two ``[M/2, K]``
    matrices in the pair column order (fp32 decode x fp32 scale, cast to
    ``compute_dtype``), multiply each in fp32, and interleave the output
    columns. Returns fp32 ``[T, M]``."""
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


def dense_matmul_pair(x2: torch.Tensor, wp2: torch.Tensor,
                      scales: torch.Tensor, quant_type: str,
                      compute_dtype: Any = torch.bfloat16) -> torch.Tensor:
    """The dense pair band above the kernel band: ``x2 [T, K]`` times the
    pair words' weight, fp32 ``[T, M]``. On the card K10 dequantizes the
    words to ``compute_dtype`` ``[M, K]`` in the original order (fp32
    decode x fp32 scale, rounded once) and :func:`dense_product`
    multiplies; the weight is not kept. A CPU tensor runs
    :func:`dense_matmul_pair_plain`."""
    if not x2.is_cuda:
        return dense_matmul_pair_plain(x2, wp2, scales, quant_type,
                                       compute_dtype)
    W = dequantize_4bit_pair(wp2, scales, quant_type, dtype=compute_dtype)
    return dense_product(x2.to(compute_dtype), W)


def apply_4bit(x2: torch.Tensor, wp: torch.Tensor, scales: torch.Tensor,
               quant_type: str, compute_dtype: Any = torch.bfloat16,
               pair_pipeline: str = "grid", fp4_decode: str = "arith"
               ) -> torch.Tensor:
    """``x2 [T, K] @ dequant(wp, scales).T -> [T, M]`` fp32.

    Pair weights: for ``T <= pair_max_tokens()`` token rows (any T; the
    TPU kernels' tiling rule ``pair_tokens_ok`` does not bind the port's
    kernels) K9 when ``pair_pipeline == "manual"`` and :func:`manual_ok`,
    else K1; above the band :func:`dense_matmul_pair`. ``fp4_decode``
    names one of the JAX package's decodes; all are the port's table
    decode. Planar weights: K5 for
    ``T <= QMATMUL_MAX_TOKENS`` with :func:`qmm_ok`, else K6 for
    ``T <= GEMV_MAX_TOKENS``, else the dense path: K7 dequantizes to
    ``compute_dtype`` (fp32 decode x fp32 scale, the values of the JAX
    package's XLA dequant) and :func:`dense_product` multiplies."""
    tokens = x2.shape[0]
    spacked = scales.dtype == torch.int32
    pair = spacked or wp.shape[-2] != scales.shape[-2]
    if pair:
        if tokens <= pair_max_tokens():
            M, K = 2 * wp.shape[-2], 4 * wp.shape[-1]
            fn = (matmul_4bit_pair_manual if pair_pipeline == "manual"
                  and manual_ok(M, K, tokens, scales) else matmul_4bit_pair)
            return fn(wp, scales, kernel_activation(x2, compute_dtype),
                      quant_type)
        return dense_matmul_pair(x2, wp, scales, quant_type,
                                 compute_dtype=compute_dtype)
    if tokens <= QMATMUL_MAX_TOKENS and qmm_ok(tokens):
        return matmul_4bit_planar(wp, scales,
                                  kernel_activation(x2, compute_dtype),
                                  quant_type)
    if tokens <= GEMV_MAX_TOKENS:
        return gemv_4bit(wp, scales, gemv_activation(x2, compute_dtype),
                         quant_type)
    W = dequantize_4bit_kernel(wp, scales, quant_type, dtype=compute_dtype)
    return dense_product(x2.to(compute_dtype), W)


@dataclasses.dataclass
class Params4bit:
    """A quantized parameter: packed words, resolved scales and the
    bnb-serializable :class:`~quantizations_tpu_torch.quant.state.QuantState`.

    ``wp`` is the int32 view of bnb's packed bytes (planar ``[out, in/8]``)
    or the pair layout ``[out/2, in/4]``; ``scales`` are the per-64 fp32
    absmax with double quantization already inverted; ``quant_state``
    keeps the bnb form (uint8 nested absmax and so on)."""

    wp: torch.Tensor
    scales: torch.Tensor
    quant_state: QuantState

    @property
    def shape(self) -> tuple:
        return self.quant_state.shape

    @property
    def layout(self) -> str:
        return ("planar" if self.wp.shape[-2] == self.scales.shape[-2]
                else "pair")

    @classmethod
    def quantize(cls, W: torch.Tensor, blocksize: int = 64,
                 quant_type: str = "fp4", compress_statistics: bool = True,
                 layout: str = "planar") -> "Params4bit":
        """Quantize a ``[out, in]`` weight on its device. ``blocksize``
        is a multiple of 64; the scales are expanded to per-64 blocks,
        the granularity the kernels read. ``layout="pair"`` stores K1's
        row-pair words (even ``out`` only)."""
        out_f, in_f = W.shape
        if blocksize % 64 or in_f % blocksize:
            raise ValueError(
                f"blocksize {blocksize} must be a multiple of 64 dividing "
                f"in_features={in_f}")
        if layout not in ("planar", "pair"):
            raise ValueError(f"layout {layout!r} not in ('planar', 'pair')")
        if layout == "pair" and out_f % 2:
            raise ValueError(
                f"pair layout requires even out_features (got {out_f})")
        packed, state = quantize_4bit(W, blocksize=blocksize,
                                      quant_type=quant_type,
                                      compress_statistics=compress_statistics)
        wp = pack_i32_rows(packed, out_f, in_f)
        scales = dequantize_absmax(state).reshape(out_f, in_f // blocksize)
        if blocksize != 64:
            scales = scales.repeat_interleave(blocksize // 64, dim=1)
        if layout == "pair":
            wp = planar_to_pair(wp)
        return cls(wp=wp, scales=scales, quant_state=state)

    def packed_u8(self) -> torch.Tensor:
        """bnb byte-layout view ``[n/2, 1]`` of the packed codes."""
        wp = pair_to_planar(self.wp) if self.layout == "pair" else self.wp
        return wp.contiguous().view(torch.uint8).reshape(-1, 1)


class Linear4bit(torch.nn.Module):
    """bnb-compatible 4-bit linear layer. Build with :meth:`create` (it
    quantizes a full-precision weight) or from loaded parts
    (:func:`~quantizations_tpu_torch.quant.bnb_io.load_bnb_linear4bit`).
    Callable on ``[..., in_features]``. ``pair_pipeline`` (``"grid"`` or
    ``"manual"``) and ``fp4_decode`` are passed to :func:`apply_4bit`."""

    def __init__(self, weight: Params4bit, bias: Optional[torch.Tensor] = None,
                 compute_dtype: Any = torch.bfloat16,
                 pair_pipeline: str = "grid", fp4_decode: str = "arith"):
        super().__init__()
        if pair_pipeline not in PAIR_PIPELINES:
            raise ValueError(f"pair_pipeline {pair_pipeline!r} not in "
                             f"{PAIR_PIPELINES}")
        if fp4_decode not in FP4_DECODES:
            raise ValueError(f"fp4_decode {fp4_decode!r} not in "
                             f"{FP4_DECODES}")
        self.weight = weight
        self.bias = bias
        self.compute_dtype = compute_dtype
        self.pair_pipeline = pair_pipeline
        self.fp4_decode = fp4_decode

    @property
    def in_features(self) -> int:
        return self.weight.shape[1]

    @property
    def out_features(self) -> int:
        return self.weight.shape[0]

    @property
    def quant_state(self) -> QuantState:
        return self.weight.quant_state

    @classmethod
    def create(cls, W: Union[torch.Tensor, np.ndarray],
               bias: Union[torch.Tensor, np.ndarray, None] = None,
               compute_dtype: Any = torch.bfloat16,
               compress_statistics: bool = True, quant_type: str = "fp4",
               blocksize: int = 64, layout: str = "planar",
               device: Union[str, torch.device] = "cuda",
               pair_pipeline: str = "grid", fp4_decode: str = "arith"
               ) -> "Linear4bit":
        """Quantize ``W [out, in]`` on ``device`` into a layer."""
        dev = resolve_device(device)
        params = Params4bit.quantize(
            torch.as_tensor(W, device=dev), blocksize=blocksize,
            quant_type=quant_type, compress_statistics=compress_statistics,
            layout=layout)
        if bias is not None:
            bias = torch.as_tensor(bias, device=dev)
        return cls(params, bias=bias, compute_dtype=compute_dtype,
                   pair_pipeline=pair_pipeline, fp4_decode=fp4_decode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [..., in] -> [..., out]``: cast to ``compute_dtype``, the
        4-bit matmul of :func:`apply_4bit` in fp32, the bias, and back to
        ``x``'s dtype."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        out = apply_4bit(x2, self.weight.wp, self.weight.scales,
                         self.quant_state.quant_type,
                         compute_dtype=self.compute_dtype,
                         pair_pipeline=self.pair_pipeline,
                         fp4_decode=self.fp4_decode)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out.reshape(*lead, self.out_features).to(x.dtype)
