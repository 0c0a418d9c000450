"""Blockwise 4-bit quantization in plain torch: the weight a 4-bit model
computes with, written out again from its definition.

- FP4 (bnb's S1E2M1 code, values over 12): each 64-element block is
  scaled by ``1 / absmax`` and takes the code of bnb's ``dQuantizeFP4``
  threshold ladder (fp32 thresholds; ties to the smaller magnitude).
- NF4: the nearest entry of the normal-float table (fp32 midpoints,
  ties to the lower index).
- Double quantization of the absmax: its mean is subtracted, and the
  rest is quantized to bnb's 8-bit "dynamic" map in blocks of 256
  (nearest entry), then dequantized and the mean added back.

The dequantized weight is ``code value * block scale`` in fp32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# FP4 raw values by code, over their largest magnitude (12).
FP4_VALUES = np.array([0.0, 0.0625, 8.0, 12.0, 4.0, 6.0, 2.0, 3.0,
                       -0.0, -0.0625, -8.0, -12.0, -4.0, -6.0, -2.0, -3.0],
                      np.float32) / np.float32(12.0)
# dQuantizeFP4's thresholds on |x|: (t0, t1, t2, t3, t4, t5, t6)
FP4_THRESHOLDS = np.array([0.29166667, 0.583333, 0.8333333, 0.4166667,
                           0.0859375, 0.20833333, 0.00260417], np.float32)
NF4_VALUES = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], np.float32)


def dynamic_map() -> np.ndarray:
    """bnb's signed "dynamic" 8-bit map: 7 exponent decades of linear
    fractions, plus 0 and 1, sorted; fp32 throughout."""
    data = []
    for i in range(7):
        n = 2 ** i + 1
        b = np.linspace(0.1, 1.0, n, dtype=np.float32)
        means = (b[:-1] + b[1:]) / np.float32(2.0)
        data += ((10 ** (-6 + i)) * means).tolist()
        data += (-(10 ** (-6 + i)) * means).tolist()
    data += [0.0, 1.0]
    data += [0.0] * (256 - len(data))
    return np.array(sorted(data), np.float32)


def _blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    flat = x.reshape(-1).float()
    pad = -flat.numel() % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, n)


def _scaled(blocked: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    absmax = blocked.abs().amax(dim=1)
    inv = torch.where(absmax > 0, 1.0 / absmax, torch.zeros_like(absmax))
    return blocked * inv[:, None], absmax


def fp4_codes(x: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(FP4_THRESHOLDS).to(x.device)
    a = x.abs()
    hi = torch.where(a > t[1], torch.where(a > t[2], 3, 2),
                     torch.where(a > t[3], 5, 4))
    lo = torch.where(a > t[4], torch.where(a > t[5], 7, 6),
                     torch.where(a > t[6], 1, 0))
    return torch.where(a > t[0], hi, lo) + torch.where(x < 0, 8, 0)


def nearest_codes(x: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    code = torch.from_numpy(table).to(x.device)
    mids = (code[:-1] + code[1:]) * 0.5
    return torch.searchsorted(mids, x.reshape(-1).contiguous(),
                              side="left").reshape(x.shape)


def double_quantize(absmax: torch.Tensor, blocksize: int = 256
                    ) -> torch.Tensor:
    """The absmax as a double-quantized model stores it, dequantized."""
    offset = absmax.mean()
    norm, a2 = _scaled(_blocks(absmax - offset, blocksize))
    table = dynamic_map()
    q = nearest_codes(norm, table)
    deq = torch.from_numpy(table).to(absmax.device)[q] * a2[:, None]
    return deq.reshape(-1)[:absmax.numel()] + offset


# Elements of a weight dequantized per pass, so that the codes'
# transients stay small beside a 131,072-row lm_head.
CHUNK_ELEMS = 1 << 26


def dequantized_weight(W: torch.Tensor, quant_type: str = "fp4",
                       blocksize: int = 64,
                       compress_statistics: bool = True) -> torch.Tensor:
    """``W [out, in]`` quantized to 4 bits and dequantized: fp32. The
    absmax of every block comes first (the double quantization takes
    their mean), then the codes, in row chunks."""
    out_f, in_f = W.shape
    rows = max(1, CHUNK_ELEMS // in_f)
    absmax = torch.cat([_blocks(W[r:r + rows], blocksize).abs().amax(dim=1)
                        for r in range(0, out_f, rows)])
    scale = double_quantize(absmax) if compress_statistics else absmax
    nb = in_f // blocksize
    out = torch.empty((out_f, in_f), dtype=torch.float32, device=W.device)
    for r in range(0, out_f, rows):
        blocked = _blocks(W[r:r + rows], blocksize)
        a = absmax[r * nb:(r + blocked.shape[0] // nb) * nb]
        inv = torch.where(a > 0, 1.0 / a, torch.zeros_like(a))
        norm = blocked * inv[:, None]
        if quant_type == "fp4":
            vals = torch.from_numpy(FP4_VALUES).to(W.device)[fp4_codes(norm)]
        elif quant_type == "nf4":
            vals = torch.from_numpy(NF4_VALUES).to(W.device)[
                nearest_codes(norm, NF4_VALUES)]
        else:
            raise ValueError(f"quant_type {quant_type!r}")
        s = scale[r * nb:(r + blocked.shape[0] // nb) * nb]
        out[r:r + rows] = (vals * s[:, None]).reshape(-1, in_f)
    return out
