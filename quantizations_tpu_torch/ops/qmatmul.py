"""The fused 4-bit dequant + matmul kernels: K1 over pair-layout ("SWAR
row-pair") weights and K5 over planar words (counterpart of
``quantizations_tpu/ops/qmatmul.py``).

K5 (``csrc/planar_matmul.cu``, entry ``qt_planar_matmul``) is the TPU
planar kernel's bf16 class, the class K1 reproduces too: the block scale
rounded to bf16 (times bf16(1/12) in bf16 for FP4), each weight
``bf16(decoded * scale)``, bf16 activations, fp32 products and sums. Its
decode is the fp32 table of :func:`~quantizations_tpu_torch.ops.gemv.planar_table`:
for NF4 the fp32 codebook, where K1's pair decode takes the bf16
codebook, as the two TPU kernels do.

Layout of ``wp2 [M/2, K/4]`` (same bytes as planar ``[M, K/8]``): the
word axis is block-major, ``w = r*NB + b`` with ``b`` the 64-element quant
block (``NB = K/64``) and ``r`` in [0, 16) the word's place in the block:

  r < 8  : word (i, w) covers columns 64b + 8r + p        (p in 0..3)
  r >= 8 : word (i, w) covers columns 64b + 8(r-8) + 4 + p

with row 2i's code at bits [4p, 4p+4) and row 2i+1's at [16+4p, 16+4p+4).

K1 (``csrc/pair_matmul.cu``) serves both the stacked form (a layer of
``[L, M/2, K/4]``: the view ``wp2[idx]`` is a pointer offset, no copy)
and the unstacked one (the lm_head). The wrappers launch it for CUDA
tensors and run the plain version, which repeats its arithmetic, for
CPU tensors.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..quant.codebooks import FP4_CODE, get_4bit_code
from .cuda import PAIR_MATMUL, PLANAR_MATMUL, launch
from .gemv import _SHIFTS, check_planar_args, device_planar_table, planar_table

__all__ = [
    "pair_tokens_ok",
    "nibble_swap",
    "planar_to_pair",
    "pair_to_planar",
    "pack_scale_pairs",
    "unpack_scale_pairs",
    "pair_permute_activation",
    "pair_table",
    "matmul_4bit_pair",
    "matmul_4bit_pair_stacked",
    "matmul_4bit_pair_plain",
    "matmul_4bit_pair_stacked_plain",
    "matmul_4bit_planar",
    "matmul_4bit_planar_stacked",
    "matmul_4bit_planar_plain",
    "matmul_4bit_planar_stacked_plain",
]


def pair_tokens_ok(tokens: int, tile_t: int = 256) -> bool:
    """Whether the JAX package's pair kernels tile ``tokens`` rows: the
    token tile must equal the row count or be a multiple of 8 (a Mosaic
    block rule). K1 takes any row count, so the port's dispatch does not
    use it."""
    while tokens % tile_t:
        tile_t //= 2
    return tile_t == tokens or tile_t % 8 == 0


def nibble_swap(x: torch.Tensor) -> torch.Tensor:
    """Swap the two nibbles of every byte of an int32 tensor."""
    m = 0x0F0F0F0F
    return ((x >> 4) & m) | ((x & m) << 4)


def _blockmajor(h: torch.Tensor) -> torch.Tensor:
    """[..., K/8] u-ordered half -> [..., K/8] (r, b)-ordered half."""
    nb = h.shape[-1] // 8
    return h.reshape(*h.shape[:-1], nb, 8).transpose(-1, -2).reshape(
        *h.shape[:-1], 8 * nb)


def _unblockmajor(h: torch.Tensor) -> torch.Tensor:
    nb = h.shape[-1] // 8
    return h.reshape(*h.shape[:-1], 8, nb).transpose(-1, -2).reshape(
        *h.shape[:-1], 8 * nb)


_HI16 = -65536  # ~0xFFFF as int32


def planar_to_pair(wp: torch.Tensor) -> torch.Tensor:
    """Planar packed words ``[..., M, K/8]`` -> pair layout
    ``[..., M/2, K/4]``."""
    nse = nibble_swap(wp[..., 0::2, :])   # even rows
    nso = nibble_swap(wp[..., 1::2, :])   # odd rows
    E = (nse & 0xFFFF) | ((nso & 0xFFFF) << 16)
    O = ((nse >> 16) & 0xFFFF) | (nso & _HI16)
    return torch.cat([_blockmajor(E), _blockmajor(O)], dim=-1)


def pair_to_planar(wp2: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`planar_to_pair`."""
    k8 = wp2.shape[-1] // 2
    E = _unblockmajor(wp2[..., :k8])
    O = _unblockmajor(wp2[..., k8:])
    nse = (E & 0xFFFF) | ((O & 0xFFFF) << 16)
    nso = ((E >> 16) & 0xFFFF) | (O & _HI16)
    inter = torch.stack([nibble_swap(nse), nibble_swap(nso)], dim=-2)
    return inter.reshape(*wp2.shape[:-2], 2 * wp2.shape[-2], k8)


def pack_scale_pairs(scales: torch.Tensor) -> torch.Tensor:
    """fp32/bf16 scales ``[..., M, NB]`` -> merged bf16 row-pair words
    ``int32 [..., M/2, NB]`` with row 2i in the low half (the
    ``scales_dtype="bf16x2"`` storage)."""
    sb = scales.to(torch.bfloat16)
    M, NB = sb.shape[-2], sb.shape[-1]
    pairs = sb.reshape(*sb.shape[:-2], M // 2, 2, NB).transpose(-1, -2)
    return pairs.contiguous().view(torch.int32).squeeze(-1)


def unpack_scale_pairs(packed: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_scale_pairs`:
    ``int32 [..., M/2, NB] -> [..., M, NB]`` (bf16 values widened)."""
    M2, NB = packed.shape[-2], packed.shape[-1]
    pairs = packed.contiguous().unsqueeze(-1).view(torch.bfloat16)
    return pairs.transpose(-1, -2).reshape(
        *packed.shape[:-2], 2 * M2, NB).to(dtype)


def pair_permute_activation(x: torch.Tensor) -> torch.Tensor:
    """``[T, K] -> [T, 4, K/4]`` matching the pair column map:
    ``xp[t, p, r*NB+b] = x[t, 64b + 8r + p]`` for ``r < 8``, and the
    ``+4+p`` columns in the second half."""
    T, K = x.shape
    xa = x.reshape(T, K // 8, 8).transpose(1, 2)    # [T, 8, K/8]
    return torch.cat([_blockmajor(xa[:, :4, :]), _blockmajor(xa[:, 4:, :])],
                     dim=2)


def pair_table(quant_type: str) -> Tuple[torch.Tensor, float]:
    """``(table, out_factor)``: the kernel's 16-entry bf16 decode table and
    the factor folded into the bf16 scale. FP4 decodes to the raw
    codebook x 12 (exact in bf16) with ``out_factor = 1/12``; NF4 to
    ``bf16(codebook)`` with factor 1. This is what the TPU kernel's SWAR
    decodes produce, bit for bit."""
    if quant_type == "fp4":
        raw = torch.from_numpy(FP4_CODE.copy()) * 12.0
        return raw.to(torch.bfloat16), 1.0 / 12.0
    return torch.from_numpy(get_4bit_code(quant_type).copy()).to(
        torch.bfloat16), 1.0


@functools.lru_cache(maxsize=None)
def _device_table(quant_type: str, device: torch.device) -> torch.Tensor:
    return pair_table(quant_type)[0].to(device)


def _bf16_scales(scales: torch.Tensor, out_factor: float) -> torch.Tensor:
    """Per-row bf16 block scales ``[M, NB]`` with the kernel's rounding:
    ``bf16(scale)``, then ``bf16(s * bf16(out_factor))``."""
    s = (unpack_scale_pairs(scales, torch.bfloat16)
         if scales.dtype == torch.int32 else scales.to(torch.bfloat16))
    if out_factor != 1.0:
        fac = torch.tensor(out_factor, dtype=torch.float64).to(torch.bfloat16)
        s = (s.float() * fac.float()).to(torch.bfloat16)
    return s


def matmul_4bit_pair_plain(wp2: torch.Tensor, scales: torch.Tensor,
                           x: torch.Tensor, quant_type: str = "fp4"
                           ) -> torch.Tensor:
    """Plain PyTorch version of K1: ``x [T, K] -> y [T, M]`` fp32, with
    the kernel's arithmetic (table decode, bf16 scale and weight
    rounding, fp32 products and sums)."""
    M2, K4 = wp2.shape
    NB = K4 // 16
    table, out_factor = pair_table(quant_type)
    table = table.to(wp2.device).float()
    s = _bf16_scales(scales, out_factor).float()          # [M, NB]
    srep = s.repeat(1, 16).reshape(M2, 2, K4)             # word w: block w % NB
    halves = []
    for h in range(2):
        planes = [table[((wp2 >> (16 * h + 4 * p)) & 15).long()]
                  for p in range(4)]                      # 4 x [M2, K4]
        W = torch.stack(planes, dim=1) * srep[:, h, None, :]
        halves.append(W.to(torch.bfloat16).float())       # [M2, 4, K4]
    W = torch.stack(halves, dim=1).reshape(2 * M2, 4 * K4)
    xp = pair_permute_activation(x.to(torch.bfloat16)).reshape(
        x.shape[0], 4 * K4).float()
    return xp @ W.T


def matmul_4bit_pair_stacked_plain(wp2: torch.Tensor, scales: torch.Tensor,
                                   x: torch.Tensor, layer_idx: int,
                                   quant_type: str = "fp4") -> torch.Tensor:
    """Plain version of the stacked form: layer ``layer_idx`` of
    ``[L, M/2, K/4]``."""
    return matmul_4bit_pair_plain(wp2[layer_idx], scales[layer_idx], x,
                                  quant_type)


# The kernel puts blocks of 8 row pairs on grid y (at most 65535 blocks).
_MAX_ROW_PAIRS = 8 * 65535


def _check_pair_args(wp2, scales, x):
    if not (x.is_cuda and wp2.device == x.device == scales.device):
        raise ValueError("pair_matmul: all tensors must be on the same CUDA "
                         "device")
    if wp2.dtype != torch.int32 or wp2.dim() != 2:
        raise ValueError(f"pair_matmul: wp2 must be int32 [M/2, K/4], got "
                         f"{wp2.dtype} {tuple(wp2.shape)}")
    M2, K4 = wp2.shape
    if K4 % 16:
        raise ValueError(f"pair_matmul: K = {4 * K4} is not a multiple of 64")
    if M2 > _MAX_ROW_PAIRS:
        raise ValueError(f"pair_matmul: M = {2 * M2} exceeds the kernel "
                         f"grid ({2 * _MAX_ROW_PAIRS} rows)")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != 4 * K4:
        raise ValueError(f"pair_matmul: x must be bf16 [T, {4 * K4}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    kinds = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
    if scales.dtype not in kinds:
        raise ValueError(f"pair_matmul: scales dtype {scales.dtype}")
    kind = kinds[scales.dtype]
    want = (M2, K4 // 16) if kind == 2 else (2 * M2, K4 // 16)
    if tuple(scales.shape) != want:
        raise ValueError(f"pair_matmul: scales shape {tuple(scales.shape)}, "
                         f"expected {want}")
    for name, t in (("wp2", wp2), ("scales", scales), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"pair_matmul: {name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("pair_matmul: x must be 16-byte aligned")
    return kind


def _launch_pair(wp2, scales, x, quant_type):
    kind = _check_pair_args(wp2, scales, x)
    M2, K4 = wp2.shape
    T = x.shape[0]
    y = torch.empty((T, 2 * M2), dtype=torch.float32, device=x.device)
    if T == 0:
        return y
    _, out_factor = pair_table(quant_type)
    table = _device_table(quant_type, x.device)
    launch(PAIR_MATMUL, "qt_pair_matmul", x.device, wp2.data_ptr(),
           scales.data_ptr(),
           kind, table.data_ptr(), x.data_ptr(), y.data_ptr(), T, M2, K4,
           int(out_factor != 1.0), out_factor)
    return y


def matmul_4bit_pair(wp2: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
                     quant_type: str = "fp4") -> torch.Tensor:
    """Fused 4-bit dequant + matmul over pair words: ``y [T, M] = x [T, K]
    @ dequant(wp2 [M/2, K/4], scales).T`` in fp32. ``scales`` are fp32 or
    bf16 ``[M, K/64]``, or ``bf16x2`` int32 ``[M/2, K/64]``. CUDA tensors
    launch K1 (``x`` must be bf16); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_plain(wp2, scales, x, quant_type)
    return _launch_pair(wp2, scales, x, quant_type)


def matmul_4bit_pair_stacked(wp2: torch.Tensor, scales: torch.Tensor,
                             x: torch.Tensor, layer_idx: int,
                             quant_type: str = "fp4") -> torch.Tensor:
    """:func:`matmul_4bit_pair` on layer ``layer_idx`` of stacked
    ``[L, M/2, K/4]`` weights. ``wp2[layer_idx]`` of a contiguous stack
    is a contiguous view, so the kernel reads the layer in place."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_stacked_plain(wp2, scales, x, layer_idx,
                                              quant_type)
    if wp2.dim() != 3 or scales.dim() != 3:
        raise ValueError("pair_matmul stacked: wp2/scales must be [L, ...]")
    return _launch_pair(wp2[layer_idx], scales[layer_idx], x, quant_type)


# --------------------------------------------------------------------------
# Planar words: K5
# --------------------------------------------------------------------------

def matmul_4bit_planar_plain(wp: torch.Tensor, scales: torch.Tensor,
                             x: torch.Tensor, quant_type: str = "fp4"
                             ) -> torch.Tensor:
    """Plain PyTorch version of K5: ``x [T, K] -> y [T, M]`` fp32 over
    planar words ``wp [M, K/8]`` and fp32/bf16 ``scales [M, K/64]``, with
    the kernel's arithmetic."""
    M, K8 = wp.shape
    table, out_factor = planar_table(quant_type)
    table = table.to(wp.device)
    s = _bf16_scales(scales, out_factor).float().repeat_interleave(8, dim=1)
    planes = [(table[((wp >> sh) & 15).long()] * s).to(torch.bfloat16)
              for sh in _SHIFTS]                          # 8 x [M, K8]
    W = torch.stack(planes, dim=-1).reshape(M, 8 * K8).float()
    return x.to(torch.bfloat16).float() @ W.T


def matmul_4bit_planar_stacked_plain(wp: torch.Tensor, scales: torch.Tensor,
                                     x: torch.Tensor, layer_idx: int,
                                     quant_type: str = "fp4") -> torch.Tensor:
    """Plain version of the stacked form: layer ``layer_idx`` of
    ``[L, M, K/8]``."""
    return matmul_4bit_planar_plain(wp[layer_idx], scales[layer_idx], x,
                                    quant_type)


def _launch_planar(wp, scales, x, quant_type):
    check_planar_args("planar_matmul", wp, scales, x, (torch.bfloat16,))
    M, K8 = wp.shape
    T = x.shape[0]
    y = torch.empty((T, M), dtype=torch.float32, device=x.device)
    if T == 0 or M == 0:
        return y
    _, out_factor = planar_table(quant_type)
    launch(PLANAR_MATMUL, "qt_planar_matmul", x.device, wp.data_ptr(),
           scales.data_ptr(), int(scales.dtype == torch.bfloat16),
           device_planar_table(quant_type, x.device).data_ptr(),
           x.data_ptr(), y.data_ptr(), T, M, K8, int(out_factor != 1.0),
           out_factor)
    return y


def matmul_4bit_planar(wp: torch.Tensor, scales: torch.Tensor,
                       x: torch.Tensor, quant_type: str = "fp4"
                       ) -> torch.Tensor:
    """Fused 4-bit dequant + matmul over planar words: ``y [T, M] =
    x [T, K] @ dequant(wp [M, K/8], scales [M, K/64]).T`` in fp32, any
    ``M`` and ``T``. CUDA tensors launch K5 (``x`` must be bf16); CPU
    tensors run the plain version."""
    if x.device.type == "cpu":
        return matmul_4bit_planar_plain(wp, scales, x, quant_type)
    return _launch_planar(wp, scales, x, quant_type)


def matmul_4bit_planar_stacked(wp: torch.Tensor, scales: torch.Tensor,
                               x: torch.Tensor, layer_idx: int,
                               quant_type: str = "fp4") -> torch.Tensor:
    """:func:`matmul_4bit_planar` on layer ``layer_idx`` of stacked
    ``[L, M, K/8]`` weights, read in place."""
    if x.device.type == "cpu":
        return matmul_4bit_planar_stacked_plain(wp, scales, x, layer_idx,
                                                quant_type)
    if wp.dim() != 3 or scales.dim() != 3:
        raise ValueError("planar_matmul stacked: wp/scales must be [L, ...]")
    return _launch_planar(wp[layer_idx], scales[layer_idx], x, quant_type)
