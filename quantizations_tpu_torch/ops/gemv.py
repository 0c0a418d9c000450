"""Planar word layout helpers (the part of ``quantizations_tpu/ops/gemv.py``
the model build needs; the planar GEMV kernel is not ported yet).

Word ``c`` of row ``m`` holds elements ``k = 8c .. 8c+7`` in bnb byte
order: element ``j`` sits at bit offset ``_SHIFTS[j]``.
"""

from __future__ import annotations

import torch

__all__ = ["pack_i32_rows", "_SHIFTS"]

# Nibble position of element j within an int32 word under bnb byte order
# (byte = even<<4 | odd, bytes little-endian).
_SHIFTS = tuple(8 * (j // 2) + (4 - 4 * (j % 2)) for j in range(8))


def pack_i32_rows(packed_u8: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """bnb flat packed bytes ``[rows*cols/2(,1)]`` -> int32 words
    ``[rows, cols/8]``, little-endian (a reinterpretation of the same
    memory)."""
    b = packed_u8.reshape(rows, cols // 2).contiguous()
    return b.view(torch.int32)
