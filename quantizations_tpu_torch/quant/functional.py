"""Functional quantization core in plain PyTorch (counterpart of
``quantizations_tpu/quant/functional.py``).

These reproduce the JAX package's quantization decisions bit for bit:

- FP4 codes come from the literal fp32 thresholds of bnb's
  ``dQuantizeFP4`` ladder; ties resolve toward the smaller-magnitude code.
- NF4 and the 8-bit dynamic map use nearest-entry with fp32 midpoints,
  ties to the lower index.
- Nibble packing: high nibble = even element, low nibble = odd element.
- Double quantization of absmax: subtract the mean ("offset"), then 8-bit
  quantize with blocksize 256 against the dynamic map.
- A zero block quantizes to code 0 and dequantizes to 0 (guarded
  reciprocal).

Normalization multiplies by ``1/absmax``; it never divides.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .codebooks import NF4_CODE, code_midpoints, create_dynamic_map, get_4bit_code
from .state import QuantState

__all__ = [
    "quantize_fp4_codes",
    "quantize_nf4_codes",
    "quantize_codebook_codes",
    "quantize_codebook_codes_stochastic",
    "stochastic_codes_from_uniforms",
    "quantize_blockwise",
    "dequantize_blockwise",
    "quantize_4bit",
    "dequantize_4bit",
    "dequantize_absmax",
    "pack_4bit",
    "unpack_4bit",
    "gemv_4bit",
    "matmul_4bit",
]


def _f32(v: float) -> torch.Tensor:
    """A 0-dim float32 constant: comparisons against it happen in fp32."""
    return torch.tensor(np.float32(v), dtype=torch.float32)


# dQuantizeFP4 thresholds as fp32 constants (comparing against a double
# would flip codes at the thresholds).
_FP4_T = tuple(_f32(v) for v in (
    0.29166667, 0.583333, 0.8333333, 0.4166667,
    0.0859375, 0.20833333, 0.00260417))
_NF4_MIDS = tuple(_f32(v) for v in code_midpoints(NF4_CODE))


def quantize_fp4_codes(x: torch.Tensor) -> torch.Tensor:
    """Normalized fp32 values in [-1, 1] -> FP4 codes (uint8, 0..15):
    the branchless ``dQuantizeFP4`` decision tree."""
    t0, t1, t2, t3, t4, t5, t6 = _FP4_T

    def c(v):
        return torch.tensor(v, dtype=torch.uint8)

    a = x.abs()
    code = torch.where(
        a > t0,
        torch.where(a > t1,
                    torch.where(a > t2, c(3), c(2)),
                    torch.where(a > t3, c(5), c(4))),
        torch.where(a > t4,
                    torch.where(a > t5, c(7), c(6)),
                    torch.where(a > t6, c(1), c(0))),
    )
    return code + torch.where(x < 0, c(8), c(0))


def quantize_nf4_codes(x: torch.Tensor) -> torch.Tensor:
    """Normalized fp32 values -> NF4 codes (uint8): the count of fp32
    midpoints strictly below each value."""
    code = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    for m in _NF4_MIDS:
        code += (x > m).to(torch.uint8)
    return code


def quantize_codebook_codes(x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Normalized values -> codes against a *sorted* codebook: nearest
    entry with fp32 midpoints, ties to the lower index (``searchsorted``
    with ``side="left"`` counts midpoints strictly below x)."""
    mids = (code[:-1] + code[1:]) * _f32(0.5).to(code.device)
    idx = torch.searchsorted(mids, x.reshape(-1).contiguous(), side="left")
    return idx.reshape(x.shape).to(torch.uint8)


def stochastic_codes_from_uniforms(x: torch.Tensor, code: torch.Tensor,
                                   r: torch.Tensor) -> torch.Tensor:
    """The decision of :func:`quantize_codebook_codes_stochastic` given
    its uniforms ``r`` in [0, 1) (one per element of ``x``): between the
    bracketing entries ``lo < x <= hi`` of the sorted codebook, ``hi``
    when ``r < (x - lo) / (hi - lo)`` (clipped to [0, 1]), else ``lo``.
    Outside the codebook's range both are the end entry."""
    flat = x.reshape(-1).contiguous()
    hi = torch.searchsorted(code, flat, side="left").clamp(
        0, code.shape[0] - 1)
    lo = (hi - 1).clamp(min=0)
    cl, ch = code[lo], code[hi]
    denom = ch - cl
    frac = torch.where(denom > 0, (flat - cl) / denom,
                       torch.zeros_like(flat)).clamp(0.0, 1.0)
    idx = torch.where(r.reshape(-1) < frac, hi, lo)
    return idx.reshape(x.shape).to(torch.uint8)


def quantize_codebook_codes_stochastic(x: torch.Tensor, code: torch.Tensor,
                                       generator: torch.Generator
                                       ) -> torch.Tensor:
    """Stochastic rounding against a sorted codebook: the upper
    bracketing entry with probability ``(x - lower) / (upper - lower)``,
    unbiased within the bracket (E[dequant] == x). The uniforms come
    from ``generator`` (the JAX package takes a PRNG key); the decision
    is :func:`stochastic_codes_from_uniforms`."""
    r = torch.rand(x.numel(), generator=generator, device=x.device,
                   dtype=torch.float32)
    return stochastic_codes_from_uniforms(x, code, r)


_CODES_FN = {"fp4": quantize_fp4_codes, "nf4": quantize_nf4_codes}


def pack_4bit(codes: torch.Tensor) -> torch.Tensor:
    """Pack flat uint8 codes (0..15), length 2n, into n bytes:
    ``byte[i] = codes[2i] << 4 | codes[2i+1]``."""
    flat = codes.reshape(-1)
    if flat.shape[0] % 2:
        raise ValueError("pack_4bit needs an even number of codes")
    return (flat[0::2] << 4) | flat[1::2]


def unpack_4bit(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_4bit`: n bytes -> 2n codes."""
    flat = packed.reshape(-1)
    return torch.stack([(flat >> 4) & 0xF, flat & 0xF], dim=-1).reshape(-1)


def _block_absmax(flat: torch.Tensor, blocksize: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Pad flat fp32 values to a blocksize multiple and compute per-block
    absmax. Returns (blocked [nblocks, blocksize], absmax [nblocks], n)."""
    n = flat.shape[0]
    nblocks = -(-n // blocksize)
    pad = nblocks * blocksize - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocked = flat.reshape(nblocks, blocksize)
    return blocked, blocked.abs().amax(dim=1), n


def _normalize(blocked: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    one = _f32(1.0).to(absmax.device)
    inv = torch.where(absmax > 0, one / absmax, torch.zeros_like(absmax))
    return blocked * inv[:, None]


def quantize_blockwise(
    A: torch.Tensor,
    code: Optional[torch.Tensor] = None,
    blocksize: int = 256,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, QuantState]:
    """8-bit blockwise quantization against a 256-entry codebook (the
    statistics path). Returns (uint8 codes with A's shape, QuantState).
    ``stochastic=True`` rounds stochastically (unbiased) with uniforms
    from ``generator``, which it then needs, as the JAX package needs a
    PRNG ``key``."""
    if code is None:
        code = torch.from_numpy(create_dynamic_map()).to(A.device)
    code = code.to(device=A.device, dtype=torch.float32)
    flat = A.reshape(-1).to(torch.float32)
    blocked, absmax, n = _block_absmax(flat, blocksize)
    norm = _normalize(blocked, absmax)
    if stochastic:
        if generator is None:
            raise ValueError("stochastic quantization needs a "
                             "torch.Generator")
        q = quantize_codebook_codes_stochastic(norm, code, generator)
    else:
        q = quantize_codebook_codes(norm, code)
    q = q.reshape(-1)[:n].reshape(A.shape)
    state = QuantState(absmax=absmax, code=code, blocksize=blocksize,
                       quant_type="dynamic8bit", dtype=A.dtype,
                       shape=tuple(A.shape))
    return q, state


def dequantize_blockwise(q: torch.Tensor, state: QuantState) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`: codebook gather x absmax."""
    flat = q.reshape(-1)
    n = flat.shape[0]
    nblocks = state.absmax.shape[0]
    pad = nblocks * state.blocksize - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    vals = state.code[flat.long()]
    vals = vals.reshape(nblocks, state.blocksize) * state.absmax[:, None]
    return vals.reshape(-1)[:n].reshape(state.shape).to(state.dtype)


def quantize_4bit(
    A: torch.Tensor,
    blocksize: int = 64,
    quant_type: str = "fp4",
    compress_statistics: bool = True,
) -> Tuple[torch.Tensor, QuantState]:
    """Blockwise 4-bit quantization of a weight tensor. Returns (packed
    uint8 ``[ceil(n/2), 1]``, the bnb shape convention, and the
    QuantState); ``compress_statistics`` double-quantizes the absmax."""
    if quant_type not in _CODES_FN:
        raise NotImplementedError(f"quant_type {quant_type!r} not supported")
    flat = A.reshape(-1).to(torch.float32)
    blocked, absmax, n = _block_absmax(flat, blocksize)
    codes = _CODES_FN[quant_type](_normalize(blocked, absmax)).reshape(-1)
    if codes.shape[0] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    packed = pack_4bit(codes)[: (n + 1) // 2].reshape(-1, 1)

    code = torch.from_numpy(get_4bit_code(quant_type)).to(A.device)
    meta = dict(blocksize=blocksize, quant_type=quant_type, dtype=A.dtype,
                shape=tuple(A.shape))
    if compress_statistics:
        offset = torch.mean(absmax)
        qabsmax, state2 = quantize_blockwise(absmax - offset, blocksize=256)
        return packed, QuantState(absmax=qabsmax, code=code, offset=offset,
                                  state2=state2, **meta)
    return packed, QuantState(absmax=absmax, code=code, **meta)


def dequantize_absmax(state: QuantState) -> torch.Tensor:
    """Resolve the per-block fp32 scales, inverting double quantization if
    present."""
    if state.nested:
        absmax = dequantize_blockwise(state.absmax, state.state2)
        return (absmax + state.offset).to(torch.float32)
    return state.absmax.to(torch.float32)


def dequantize_4bit(
    packed: torch.Tensor,
    state: QuantState,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Unpack + dequantize a 4-bit tensor to ``state.shape``."""
    absmax = dequantize_absmax(state)
    n = int(np.prod(state.shape))
    codes = unpack_4bit(packed.reshape(-1))[:n]
    nblocks = absmax.shape[0]
    pad = nblocks * state.blocksize - n
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    vals = state.code[codes.long()]
    vals = vals.reshape(nblocks, state.blocksize) * absmax[:, None]
    out = vals.reshape(-1)[:n].reshape(state.shape)
    return out.to(dtype or state.dtype)


# --------------------------------------------------------------------------
# Matmul / GEMV (plain path; the fused kernels live in ops/)
# --------------------------------------------------------------------------

def _dequant_with_scales(packed: torch.Tensor, state: QuantState,
                         absmax_f32: torch.Tensor) -> torch.Tensor:
    """``state.shape`` fp32 values: codebook x resolved fp32 scale."""
    codes = unpack_4bit(packed.reshape(-1))
    n = int(np.prod(state.shape))
    vals = state.code.to(codes.device)[codes[:n].long()]
    nblocks = absmax_f32.shape[0]
    vals = vals.reshape(nblocks, state.blocksize) * absmax_f32[:, None]
    return vals.reshape(state.shape)


def gemv_4bit(x: torch.Tensor, packed: torch.Tensor, state: QuantState,
              absmax_f32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode matvec ``x @ W^T`` with W stored 4-bit: fp32 weights and
    activations, the result cast to ``x.dtype``. ``absmax_f32`` takes
    scales resolved beforehand (double quantization inverted once)."""
    if absmax_f32 is None:
        absmax_f32 = dequantize_absmax(state)
    W = _dequant_with_scales(packed, state, absmax_f32)
    return (x.float() @ W.T).to(x.dtype)


def matmul_4bit(x: torch.Tensor, packed: torch.Tensor, state: QuantState,
                bias: Optional[torch.Tensor] = None,
                absmax_f32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ W^T (+ bias)`` with 4-bit W: weights and activations cast to
    ``state.dtype``, products and sums in fp32, the result cast to
    ``x.dtype``."""
    if absmax_f32 is None:
        absmax_f32 = dequantize_absmax(state)
    W = _dequant_with_scales(packed, state, absmax_f32)
    out = x.to(state.dtype).float() @ W.to(state.dtype).float().T
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)
