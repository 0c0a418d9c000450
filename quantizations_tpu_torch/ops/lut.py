"""Exact 16-entry codebook decodes for the plain dequant paths
(counterpart of the plain decodes of ``quantizations_tpu/ops/lut.py``).

The JAX package's SWAR pair decodes are workarounds for the TPU's missing
lane gather; the CUDA kernels decode through a 16-entry table instead
(``ops/qmatmul.py pair_table``), so only these plain decodes are ported.
All take int32 codes in [0, 15] and return float32 values bit-exact to
``table[codes]``.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["lut_tree", "lut_fp4_bits", "lut_fp4_bits_raw"]


def lut_tree(codes: torch.Tensor, table: Sequence[float]) -> torch.Tensor:
    """Balanced 4-level select tree over any 16-entry table. Exact."""
    t = [torch.tensor(float(v), dtype=torch.float32) for v in table]
    b0 = (codes & 1) != 0
    lvl = [torch.where(b0, t[2 * i + 1], t[2 * i]) for i in range(8)]
    for bit in (2, 4, 8):
        sel = (codes & bit) != 0
        lvl = [torch.where(sel, lvl[2 * i + 1], lvl[2 * i])
               for i in range(len(lvl) // 2)]
    return lvl[0]


def lut_fp4_bits_raw(codes: torch.Tensor) -> torch.Tensor:
    """FP4 decode to the RAW values (codebook x 12) by assembling the fp32
    bit pattern: ``e = (code >> 1) & 3``, ``m = code & 1``; e >= 1 gives
    ``+-2^(4-e) * (1 + m/2)``, e == 0 gives ``+-m * 2^-4``."""
    codes = codes.to(torch.int32)
    u = codes << 22
    m22 = u & (1 << 22)
    e23 = u & (3 << 23)
    sgn = (codes & 8) << 28
    bits_ge1 = ((131 << 23) + m22 + sgn) - e23
    bits_e0 = (m22 >> 22) * (123 << 23) + sgn
    bits = torch.where(e23 == 0, bits_e0, bits_ge1)
    return bits.view(torch.float32)


def lut_fp4_bits(codes: torch.Tensor, table: Sequence[float] = ()) -> torch.Tensor:
    """FP4 decode to the normalized codebook values (raw / 12; the product
    is exactly the fp32-rounded codebook)."""
    return lut_fp4_bits_raw(codes) * torch.tensor(1.0 / 12.0,
                                                  dtype=torch.float32)
