"""Quantization codebooks: FP4, NF4, and the bnb "dynamic" 8-bit map.

The port's own copy of ``quantizations_tpu/quant/codebooks.py`` (numpy
only). The FP4 codebook is the 16 raw S1E2M1 values divided by their max
abs (12); NF4 is the bitsandbytes normal-float table; the dynamic map is
bnb's ``create_dynamic_map``. All tables are float32.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "FP4_CODE",
    "NF4_CODE",
    "get_4bit_code",
    "create_dynamic_map",
    "code_midpoints",
]

# FP4 (S1E2M1, bias 3) raw values, index == 4-bit code, normalized by 12.
_FP4_RAW = np.array(
    [0.0, 0.0625, 8.0, 12.0, 4.0, 6.0, 2.0, 3.0,
     -0.0, -0.0625, -8.0, -12.0, -4.0, -6.0, -2.0, -3.0],
    dtype=np.float32,
)
FP4_CODE = (_FP4_RAW / np.float32(12.0)).astype(np.float32)

# NF4 codebook, index == 4-bit code (sorted ascending, code 7 == 0).
NF4_CODE = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)


def get_4bit_code(quant_type: str) -> np.ndarray:
    """Return the 16-entry codebook for ``quant_type`` ("fp4" or "nf4")."""
    if quant_type == "fp4":
        return FP4_CODE
    if quant_type == "nf4":
        return NF4_CODE
    raise NotImplementedError(f"4-bit quant_type {quant_type!r} not supported")


@functools.lru_cache(maxsize=None)
def create_dynamic_map(signed: bool = True, max_exponent_bits: int = 7,
                       total_bits: int = 8) -> np.ndarray:
    """bnb's "dynamic" 8-bit codebook (signed dynamic exponent + linear
    fraction): a sorted float32 array of 256 values in [-1, 1], computed
    in float32 throughout."""
    data: list = []
    non_sign_bits = total_bits - 1
    additional_items = 2 ** (non_sign_bits - max_exponent_bits) - 1
    for i in range(max_exponent_bits):
        fraction_items = int(
            2 ** (i + non_sign_bits - max_exponent_bits) + 1
            if signed
            else 2 ** (i + non_sign_bits - max_exponent_bits + 1) + 1
        )
        boundaries = np.linspace(0.1, 1.0, fraction_items, dtype=np.float32)
        means = (boundaries[:-1] + boundaries[1:]) / np.float32(2.0)
        data += ((10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()

    if additional_items > 0:
        boundaries = np.linspace(0.1, 1.0, additional_items + 1,
                                 dtype=np.float32)
        means = (boundaries[:-1] + boundaries[1:]) / np.float32(2.0)
        i = max_exponent_bits - 1
        data += ((10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()

    data.append(0.0)
    data.append(1.0)
    if len(data) != 2 ** total_bits:
        raise ValueError(f"dynamic map has {len(data)} entries")

    gap = 256 - len(data)
    data += [0.0] * gap

    data.sort()
    return np.array(data, dtype=np.float32)


def code_midpoints(code: np.ndarray) -> np.ndarray:
    """Midpoints between adjacent entries of a *sorted* codebook: a value
    x maps to code ``sum(x > midpoints)`` (ties round to the lower index)."""
    code = np.asarray(code, dtype=np.float32)
    return ((code[:-1] + code[1:]) * np.float32(0.5)).astype(np.float32)
