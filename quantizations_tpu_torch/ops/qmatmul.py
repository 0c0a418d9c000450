"""The fused 4-bit dequant + matmul kernels: K1 over pair-layout ("SWAR
row-pair") weights and K5 over planar words (counterpart of
``quantizations_tpu/ops/qmatmul.py``).

K5 (``csrc/planar_matmul.cu``) is the TPU planar kernel's bf16 class,
the class K1 reproduces too: the block scale rounded to bf16 (times
bf16(1/12) in bf16 for FP4), each weight ``bf16(decoded * scale)``, bf16
activations, fp32 products and sums. Its decode is the fp32 table of
:func:`~quantizations_tpu_torch.ops.gemv.planar_table`: for NF4 the fp32
codebook, where K1's pair decode takes the bf16 codebook, as the two TPU
kernels do. It has two bodies, chosen by the token count alone
(:func:`planar_body`): below ``PLANAR_MMA_MIN_TOKENS`` rows the CUDA-core
body it shares with K6 (entry ``qt_planar_matmul``), from there on the
tensor-core body (entry ``qt_planar_mma``: ``mma.sync`` bf16 with fp32
sums, K split over the warps of a block). ``PLANAR_MATMUL`` counts every
K5 launch, ``PLANAR_MATMUL_MMA`` those of the tensor-core body.

Layout of ``wp2 [M/2, K/4]`` (same bytes as planar ``[M, K/8]``): the
word axis is block-major, ``w = r*NB + b`` with ``b`` the 64-element quant
block (``NB = K/64``) and ``r`` in [0, 16) the word's place in the block:

  r < 8  : word (i, w) covers columns 64b + 8r + p        (p in 0..3)
  r >= 8 : word (i, w) covers columns 64b + 8(r-8) + 4 + p

with row 2i's code at bits [4p, 4p+4) and row 2i+1's at [16+4p, 16+4p+4).

K1 serves both the stacked form (a layer of ``[L, M/2, K/4]``: the view
``wp2[idx]`` is a pointer offset, no copy) and the unstacked one (the
lm_head). It has three bodies, chosen by the token count alone
(:func:`pair_body`): below ``PAIR_SPLITK_MIN_TOKENS`` rows the CUDA-core
body (``csrc/pair_matmul.cu``, entry ``qt_pair_matmul``), from there up
to 128 rows the split-K tensor-core body (``csrc/pair_splitk.cu``, entry
``qt_pair_splitk``: ``mma.sync`` bf16 with fp32 sums, K split over the
warps of a block), from ``PAIR_MMA_MIN_TOKENS`` = 129 rows on the
tensor-core body (``csrc/pair_prefill.cu``, entry ``qt_pair_mma``, tiles
from :func:`pair_mma_tiles`). ``PAIR_MATMUL`` counts every K1 launch,
``PAIR_MATMUL_SPLITK`` and ``PAIR_MATMUL_MMA`` those of their bodies.
The wrappers launch for CUDA tensors and run the plain version, which
repeats K1's arithmetic, for CPU tensors.

Two more kernels compute K1's function over the same words, in K1's
rounding class:

- K9 (``csrc/pair_matmul.cu``, entry ``qt_pair_manual``), the
  manual-pipeline pair kernel: its weight words stream through a
  ``cp.async`` ring in shared memory, as K1's CUDA-core body's do, so
  the two entry points launch one body. K9 picks its body by K1's rule,
  so from ``PAIR_SPLITK_MIN_TOKENS`` rows on it launches K1's other
  bodies, and its output is K1's bit for bit at every row count.
- K8 (``csrc/pair_prefill.cu``, entry ``qt_pair_mma``), the prefill pair
  kernel: the tensor-core body (``mma.sync`` bf16 -> fp32, weights
  decoded in registers once per token tile), within 1e-5 * max|y| of its
  plain version.

Which projections take them is the JAX package's rule, copied here as
pure integer functions: :func:`manual_vmem_ok` and
:func:`prefill_pair_ok` are TPU VMEM budgets, kept so that the same
projections take the same kernel as on the reference.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..quant.codebooks import FP4_CODE, get_4bit_code
from .cuda import (PAIR_MANUAL, PAIR_MATMUL, PAIR_MATMUL_MMA,
                   PAIR_MATMUL_SPLITK, PAIR_PREFILL, PLANAR_MATMUL,
                   PLANAR_MATMUL_MMA, launch)
from .gemv import (_SHIFTS, check_planar_args, device_planar_table,
                   pack_i32_rows, planar_table)

__all__ = [
    "PAIR_SPLITK_MIN_TOKENS",
    "PAIR_MMA_MIN_TOKENS",
    "pair_body",
    "pair_mma_tiles",
    "matmul_4bit_pair_cuda_core",
    "matmul_4bit_pair_splitk",
    "matmul_4bit_pair_mma",
    "PREFILL_PAIR_CHUNK_T",
    "prefill_pair_ok",
    "manual_vmem_ok",
    "matmul_4bit_pair_prefill",
    "matmul_4bit_pair_prefill_stacked",
    "matmul_4bit_pair_prefill_plain",
    "matmul_4bit_pair_prefill_stacked_plain",
    "pair_prefill_matmul",
    "matmul_4bit_pair_manual",
    "matmul_4bit_pair_manual_stacked",
    "matmul_4bit_pair_manual_plain",
    "matmul_4bit_pair_manual_stacked_plain",
    "pair_tokens_ok",
    "nibble_swap",
    "pair_column",
    "planar_to_pair",
    "pair_to_planar",
    "pack_pair_rows",
    "pack_scale_pairs",
    "unpack_scale_pairs",
    "pair_permute_activation",
    "pair_table",
    "matmul_4bit_pair",
    "matmul_4bit_pair_stacked",
    "matmul_4bit_pair_plain",
    "matmul_4bit_pair_stacked_plain",
    "PLANAR_MMA_MIN_TOKENS",
    "planar_body",
    "matmul_4bit_planar_cuda_core",
    "matmul_4bit_planar_mma",
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


def pair_column(w, half, p, K: int):
    """The pair layout's map: nibble ``p`` (0-3) of 16-bit half ``half``
    of word ``w`` of a row pair ``[K/4]`` holds the code of row
    ``half`` of the pair (0 even, 1 odd) at original column
    ``64b + 8(q % 8) + 4(q // 8) + p``, where ``w = q*NB + b``,
    ``NB = K/64``. Returns ``(row, column)``; ``w`` and ``p`` may be
    integer tensors. K10 (``csrc/dequantize.cu``) mirrors it."""
    NB = K // 64
    q, b = w // NB, w % NB
    return half, 64 * b + 8 * (q % 8) + 4 * (q // 8) + p


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


def pack_pair_rows(packed_u8: torch.Tensor, rows: int,
                   cols: int) -> torch.Tensor:
    """bnb flat packed bytes -> pair layout ``[rows/2, cols/4]``."""
    return planar_to_pair(pack_i32_rows(packed_u8, rows, cols))


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
def _device_table(quant_type: str, device: torch.device
                  ) -> Tuple[torch.Tensor, float]:
    """:func:`pair_table` with the table on ``device``, built once (the
    launch path calls this for every K1/K8/K9 launch)."""
    table, out_factor = pair_table(quant_type)
    return table.to(device), out_factor


def _bf16_scales(scales: torch.Tensor, out_factor: float) -> torch.Tensor:
    """Per-row bf16 block scales ``[M, NB]`` with the kernel's rounding:
    ``bf16(scale)``, then ``bf16(s * bf16(out_factor))``."""
    s = (unpack_scale_pairs(scales, torch.bfloat16)
         if scales.dtype == torch.int32 else scales.to(torch.bfloat16))
    if out_factor != 1.0:
        fac = torch.tensor(out_factor, dtype=torch.float64).to(torch.bfloat16)
        s = (s.float() * fac.float()).to(torch.bfloat16)
    return s


def _pair_weight(wp2: torch.Tensor, scales: torch.Tensor,
                 quant_type: str) -> torch.Tensor:
    """The kernels' bf16 weights ``[M, K]`` in pair column order (that of
    :func:`pair_permute_activation`): table decode times the bf16 scale,
    rounded to bf16."""
    M2, K4 = wp2.shape
    table, out_factor = pair_table(quant_type)
    table = table.to(wp2.device).float()
    s = _bf16_scales(scales, out_factor).float()          # [M, NB]
    srep = s.repeat(1, 16).reshape(M2, 2, K4)             # word w: block w % NB
    halves = []
    for h in range(2):
        planes = [table[((wp2 >> (16 * h + 4 * p)) & 15).long()]
                  for p in range(4)]                      # 4 x [M2, K4]
        W = torch.stack(planes, dim=1) * srep[:, h, None, :]
        halves.append(W.to(torch.bfloat16))               # [M2, 4, K4]
    return torch.stack(halves, dim=1).reshape(2 * M2, 4 * K4)


def matmul_4bit_pair_plain(wp2: torch.Tensor, scales: torch.Tensor,
                           x: torch.Tensor, quant_type: str = "fp4"
                           ) -> torch.Tensor:
    """Plain PyTorch version of K1: ``x [T, K] -> y [T, M]`` fp32, with
    the kernel's arithmetic (table decode, bf16 scale and weight
    rounding, fp32 products and sums)."""
    W = _pair_weight(wp2, scales, quant_type).float()
    xp = pair_permute_activation(x.to(torch.bfloat16)).reshape(
        x.shape[0], W.shape[1]).float()
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


def _check_pair_args(wp2, scales, x, name="pair_matmul"):
    if not (x.is_cuda and wp2.device == x.device == scales.device):
        raise ValueError(f"{name}: all tensors must be on the same CUDA "
                         "device")
    if wp2.dtype != torch.int32 or wp2.dim() != 2:
        raise ValueError(f"{name}: wp2 must be int32 [M/2, K/4], got "
                         f"{wp2.dtype} {tuple(wp2.shape)}")
    M2, K4 = wp2.shape
    if K4 % 16:
        raise ValueError(f"{name}: K = {4 * K4} is not a multiple of 64")
    if M2 > _MAX_ROW_PAIRS:
        raise ValueError(f"{name}: M = {2 * M2} exceeds the kernel "
                         f"grid ({2 * _MAX_ROW_PAIRS} rows)")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != 4 * K4:
        raise ValueError(f"{name}: x must be bf16 [T, {4 * K4}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    kinds = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
    if scales.dtype not in kinds:
        raise ValueError(f"{name}: scales dtype {scales.dtype}")
    kind = kinds[scales.dtype]
    want = (M2, K4 // 16) if kind == 2 else (2 * M2, K4 // 16)
    if tuple(scales.shape) != want:
        raise ValueError(f"{name}: scales shape {tuple(scales.shape)}, "
                         f"expected {want}")
    for tname, t in (("wp2", wp2), ("scales", scales), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    return kind


def _launch_pair(wp2, scales, x, quant_type, kernel=PAIR_MATMUL,
                 entry="qt_pair_matmul", tiles=()):
    """Launch K1's CUDA-core body or K9 through ``entry``, K1's split-K
    body (``qt_pair_splitk``), or the tensor-core body (``qt_pair_mma``,
    K8 and K1 above 128 rows) with its ``tiles`` (bm, bn)."""
    kind = _check_pair_args(wp2, scales, x, kernel.name)
    M2, K4 = wp2.shape
    T = x.shape[0]
    y = torch.empty((T, 2 * M2), dtype=torch.float32, device=x.device)
    if T == 0 or M2 == 0:
        return y
    table, out_factor = _device_table(quant_type, x.device)
    launch(kernel, entry, x.device, wp2.data_ptr(),
           scales.data_ptr(),
           kind, table.data_ptr(), x.data_ptr(), y.data_ptr(), T, M2, K4,
           int(out_factor != 1.0), out_factor, *tiles)
    return y


# K1 runs its CUDA-core body (``qt_pair_matmul``) below
# PAIR_SPLITK_MIN_TOKENS rows, its split-K tensor-core body
# (``qt_pair_splitk``) from there up to 128 rows and the tensor-core body
# it shares with K8 (``qt_pair_mma``) from PAIR_MMA_MIN_TOKENS on; K9
# follows the same rule. The split-K body is the faster per Llama3-8B
# forward on an H100 from 3 rows on, not at 1 or 2 (``chip_smoke.py
# phase_body_time``'s crossover).
PAIR_SPLITK_MIN_TOKENS = 3
PAIR_MMA_MIN_TOKENS = 129


def pair_body(tokens: int) -> str:
    """Which body K1 (and K9) runs for ``tokens`` rows: ``"cuda_core"``,
    ``"splitk"`` or ``"mma"``."""
    if tokens >= PAIR_MMA_MIN_TOKENS:
        return "mma"
    return "splitk" if tokens >= PAIR_SPLITK_MIN_TOKENS else "cuda_core"


def pair_mma_tiles(T: int) -> Tuple[int, int]:
    """(bm, bn): the tensor-core body's block of bm weight rows x bn
    tokens. bn is 128 from 128 tokens on (a weight is decoded T / 128
    times), else 64. bm is 64: of the body's row tiles (32, 64, 128) the
    fastest, or within 4% of it, at T = 128, 256 and 512 on every
    Llama3-8B layer shape (``chip_smoke.py``'s tile sweep). At T = 256 on
    o (M = 4096): 128 blocks of 8 warps."""
    return 64, (128 if T >= 128 else 64)


def _launch_mma(wp2, scales, x, quant_type, kernel):
    tiles = pair_mma_tiles(x.shape[0])
    return _launch_pair(wp2, scales, x, quant_type, kernel, "qt_pair_mma",
                        tiles)


def matmul_4bit_pair_cuda_core(wp2: torch.Tensor, scales: torch.Tensor,
                               x: torch.Tensor, quant_type: str = "fp4"
                               ) -> torch.Tensor:
    """K1's CUDA-core body at any ``T``: what :func:`matmul_4bit_pair`
    launches below ``PAIR_SPLITK_MIN_TOKENS`` rows, counted in
    ``PAIR_MATMUL``. CPU tensors run its plain version."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_plain(wp2, scales, x, quant_type)
    return _launch_pair(wp2, scales, x, quant_type)


def matmul_4bit_pair_splitk(wp2: torch.Tensor, scales: torch.Tensor,
                            x: torch.Tensor, quant_type: str = "fp4"
                            ) -> torch.Tensor:
    """K1's split-K tensor-core body at any ``T``: what
    :func:`matmul_4bit_pair` launches from ``PAIR_SPLITK_MIN_TOKENS`` up
    to 128 rows, counted in ``PAIR_MATMUL_SPLITK`` only. CPU tensors run
    its plain version, which sums in original column order as the body's
    B fragments do (K8's)."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_prefill_plain(wp2, scales, x, quant_type)
    return _launch_pair(wp2, scales, x, quant_type, PAIR_MATMUL_SPLITK,
                        "qt_pair_splitk")


def matmul_4bit_pair_mma(wp2: torch.Tensor, scales: torch.Tensor,
                         x: torch.Tensor, quant_type: str = "fp4"
                         ) -> torch.Tensor:
    """K1's tensor-core body at any ``T``: what :func:`matmul_4bit_pair`
    launches from ``PAIR_MMA_MIN_TOKENS`` rows on, counted in
    ``PAIR_MATMUL_MMA`` only. CPU tensors run its plain version, which
    sums in original column order as the body does (K8's)."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_prefill_plain(wp2, scales, x, quant_type)
    return _launch_mma(wp2, scales, x, quant_type, PAIR_MATMUL_MMA)


def _launch_k1(wp2, scales, x, quant_type, kernel=PAIR_MATMUL,
               entry="qt_pair_matmul"):
    """K1's dispatch, and K9's: launch the body :func:`pair_body` names
    for ``x``'s rows, counted also in ``kernel``, K1's ``PAIR_MATMUL`` or
    K9's ``PAIR_MANUAL`` (whose ``entry`` is the CUDA-core body's other
    name)."""
    body = pair_body(x.shape[0])
    if body == "cuda_core":
        return _launch_pair(wp2, scales, x, quant_type, kernel, entry)
    y = (matmul_4bit_pair_splitk if body == "splitk"
         else matmul_4bit_pair_mma)(wp2, scales, x, quant_type)
    kernel.launches += 1       # K1's (K9's) count holds every body
    return y


def matmul_4bit_pair(wp2: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
                     quant_type: str = "fp4") -> torch.Tensor:
    """Fused 4-bit dequant + matmul over pair words: ``y [T, M] = x [T, K]
    @ dequant(wp2 [M/2, K/4], scales).T`` in fp32. ``scales`` are fp32 or
    bf16 ``[M, K/64]``, or ``bf16x2`` int32 ``[M/2, K/64]``. CUDA tensors
    launch K1 (``x`` must be bf16) through the body :func:`pair_body`
    names for its rows; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_plain(wp2, scales, x, quant_type)
    return _launch_k1(wp2, scales, x, quant_type)


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
    return _launch_k1(wp2[layer_idx], scales[layer_idx], x, quant_type)


# --------------------------------------------------------------------------
# Routing rules of the JAX package (TPU VMEM budgets), copied as they are
# --------------------------------------------------------------------------

# The JAX package's scoped-VMEM budget for the pair kernels (16 MB limit).
_PAIR_VMEM_BUDGET = 11_500_000
# x-residency cap per prefill-kernel call; larger T chunks through it.
PREFILL_PAIR_CHUNK_T = 512


def _prefill_vmem_est(T, tile_t, tile_m, kc4, nb_total, x_itemsize,
                      s_itemsize) -> int:
    nb_lanes = -(-nb_total // 128) * 128
    tm2 = tile_m // 2
    blocks = 2 * (tm2 * kc4 * 4                      # wp2
                  + T * 4 * kc4 * x_itemsize         # full-T activation
                  + tile_m * nb_lanes * s_itemsize   # scales
                  + T * tile_m * 4)                  # out
    live = (4 * tm2 * kc4 * 4                        # decoded planes
            + 4 * tile_m * kc4 * 2                   # 4 live Wj planes
            + tile_m * kc4 * 2                       # srep
            + tile_t * tile_m * 4)                   # partial
    return blocks + live


def _pick_tiles_pair_prefill(M, K4, T, x_itemsize, s_itemsize=4):
    """(tile_m, kc4, tile_t) of the TPU prefill pair kernel, or None when
    no tiling fits its VMEM budget."""
    nb = K4 // 16
    tile_t = min(T, 256)
    while T % tile_t:
        tile_t //= 2
    for kc4 in [d for d in range(min(K4, 896), 0, -nb)
                if K4 % d == 0 and d % nb == 0] or [K4]:
        for tile_m in (512, 256, 128):
            if M % tile_m:
                continue
            if _prefill_vmem_est(T, tile_t, tile_m, kc4, K4 // 16,
                                 x_itemsize, s_itemsize) < _PAIR_VMEM_BUDGET:
                return tile_m, kc4, tile_t
    return None


def prefill_pair_ok(M: int, K4: int, T: int, s_itemsize: int = 4) -> bool:
    """Whether the JAX package's prefill pair kernel tiles these shapes
    (even M, ``T % 8 == 0``, a tiling within its VMEM budget). K8 takes
    any shape; the rule decides which projections take it."""
    return (M % 2 == 0 and T % 8 == 0
            and _pick_tiles_pair_prefill(M, K4, T, 2, s_itemsize)
            is not None)


def _pick_tile_manual(M: int, K4: int) -> int:
    """M-chunk rows of the TPU manual pipeline: the largest of 512/256/128
    that divides M and keeps two weight slots within ~2 MB; 0 if none."""
    for tm in (512, 256, 128):
        if M % tm == 0 and tm * K4 * 4 <= 2 * 2**20:
            return tm
    return 0


def manual_vmem_ok(M: int, K: int, tokens: int,
                   scales_itemsize: int = 4) -> bool:
    """Whether the TPU manual-pipeline kernel's whole-operand VMEM
    residency (scales, activation, output, two weight slots) fits 10 MiB.
    K9 takes any shape; the rule decides which projections take it."""
    tm = _pick_tile_manual(M, K // 4)
    if not tm:
        return False
    lanes = -(-(K // 64) // 128) * 128          # VMEM lane padding
    fixed = (M * lanes * scales_itemsize        # scales (lane-padded)
             + tokens * M * 4                   # output
             + tokens * K * 4                   # permuted activation
             + tm * K)                          # two weight slots
    return fixed <= 10 * 2**20


# --------------------------------------------------------------------------
# K8: the decode-once prefill pair kernel
# --------------------------------------------------------------------------

def matmul_4bit_pair_prefill_plain(wp2: torch.Tensor, scales: torch.Tensor,
                                   x: torch.Tensor, quant_type: str = "fp4"
                                   ) -> torch.Tensor:
    """Plain PyTorch version of K8: ``bf16(x) @ W.T`` in fp32, with K1's
    bf16 weights ``W`` put back in original column order, as the kernel
    decodes them (K1's arithmetic; only the summation order differs)."""
    Wp = _pair_weight(wp2, scales, quant_type)            # pair column order
    K = Wp.shape[1]
    cols = pair_permute_activation(
        torch.arange(K, device=wp2.device)[None]).reshape(K)
    W = torch.empty_like(Wp)
    W[:, cols] = Wp
    return x.to(torch.bfloat16).float() @ W.float().T


def matmul_4bit_pair_prefill_stacked_plain(wp2: torch.Tensor,
                                           scales: torch.Tensor,
                                           x: torch.Tensor, layer_idx: int,
                                           quant_type: str = "fp4"
                                           ) -> torch.Tensor:
    """Plain version of K8's stacked form: layer ``layer_idx`` of
    ``[L, M/2, K/4]``."""
    return matmul_4bit_pair_prefill_plain(wp2[layer_idx], scales[layer_idx],
                                          x, quant_type)


def matmul_4bit_pair_prefill(wp2: torch.Tensor, scales: torch.Tensor,
                             x: torch.Tensor, quant_type: str = "fp4"
                             ) -> torch.Tensor:
    """:func:`matmul_4bit_pair`'s function through the decode-once
    prefill kernel: CUDA tensors launch K8 (``x`` bf16, any T and even
    M); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_prefill_plain(wp2, scales, x, quant_type)
    return _launch_mma(wp2, scales, x, quant_type, PAIR_PREFILL)


def matmul_4bit_pair_prefill_stacked(wp2: torch.Tensor, scales: torch.Tensor,
                                     x: torch.Tensor, layer_idx: int,
                                     quant_type: str = "fp4"
                                     ) -> torch.Tensor:
    """:func:`matmul_4bit_pair_prefill` on layer ``layer_idx`` of stacked
    ``[L, M/2, K/4]`` weights, read in place."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_prefill_stacked_plain(wp2, scales, x,
                                                      layer_idx, quant_type)
    if wp2.dim() != 3 or scales.dim() != 3:
        raise ValueError("pair_prefill stacked: wp2/scales must be [L, ...]")
    return _launch_mma(wp2[layer_idx], scales[layer_idx], x, quant_type,
                       PAIR_PREFILL)


def pair_prefill_matmul(wp2: torch.Tensor, scales: torch.Tensor,
                        x: torch.Tensor, quant_type: str,
                        layer_idx: Optional[int] = None) -> torch.Tensor:
    """The prefill product through K8 in chunks of at most
    :data:`PREFILL_PAIR_CHUNK_T` token rows (the reference's residency
    cap), one launch each; ``layer_idx`` selects the stacked form."""
    step = PREFILL_PAIR_CHUNK_T
    outs = []
    for t0 in range(0, x.shape[0], step):
        xc = x[t0:t0 + step]
        if layer_idx is None:
            outs.append(matmul_4bit_pair_prefill(wp2, scales, xc,
                                                 quant_type))
        else:
            outs.append(matmul_4bit_pair_prefill_stacked(
                wp2, scales, xc, layer_idx, quant_type))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


# --------------------------------------------------------------------------
# K9: the manual-pipeline pair kernel
# --------------------------------------------------------------------------

def matmul_4bit_pair_manual_plain(wp2: torch.Tensor, scales: torch.Tensor,
                                  x: torch.Tensor, quant_type: str = "fp4"
                                  ) -> torch.Tensor:
    """Plain version of K9: K9 computes K1's function bit for bit, so
    this is :func:`matmul_4bit_pair_plain`."""
    return matmul_4bit_pair_plain(wp2, scales, x, quant_type)


def matmul_4bit_pair_manual_stacked_plain(wp2: torch.Tensor,
                                          scales: torch.Tensor,
                                          x: torch.Tensor, layer_idx: int,
                                          quant_type: str = "fp4"
                                          ) -> torch.Tensor:
    """Plain version of K9's stacked form."""
    return matmul_4bit_pair_plain(wp2[layer_idx], scales[layer_idx], x,
                                  quant_type)


def matmul_4bit_pair_manual(wp2: torch.Tensor, scales: torch.Tensor,
                            x: torch.Tensor, quant_type: str = "fp4"
                            ) -> torch.Tensor:
    """:func:`matmul_4bit_pair` with the weight words streamed through
    shared memory: CUDA tensors launch K9 (``x`` bf16) through the body
    :func:`pair_body` names, as K1 does, so its output is K1's bit for
    bit; CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_manual_plain(wp2, scales, x, quant_type)
    return _launch_k1(wp2, scales, x, quant_type, PAIR_MANUAL,
                      "qt_pair_manual")


def matmul_4bit_pair_manual_stacked(wp2: torch.Tensor, scales: torch.Tensor,
                                    x: torch.Tensor, layer_idx: int,
                                    quant_type: str = "fp4") -> torch.Tensor:
    """:func:`matmul_4bit_pair_manual` on layer ``layer_idx`` of stacked
    ``[L, M/2, K/4]`` weights, read in place."""
    if x.device.type == "cpu":
        return matmul_4bit_pair_manual_stacked_plain(wp2, scales, x,
                                                     layer_idx, quant_type)
    if wp2.dim() != 3 or scales.dim() != 3:
        raise ValueError("pair_manual stacked: wp2/scales must be [L, ...]")
    return _launch_k1(wp2[layer_idx], scales[layer_idx], x, quant_type,
                      PAIR_MANUAL, "qt_pair_manual")


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


def _launch_planar(wp, scales, x, quant_type, kernel=PLANAR_MATMUL,
                   entry="qt_planar_matmul"):
    """Launch K5's CUDA-core body, or its tensor-core body through
    ``entry="qt_planar_mma"``, counted in ``kernel``."""
    check_planar_args(kernel.name, wp, scales, x, (torch.bfloat16,))
    M, K8 = wp.shape
    T = x.shape[0]
    y = torch.empty((T, M), dtype=torch.float32, device=x.device)
    if T == 0 or M == 0:
        return y
    _, out_factor = planar_table(quant_type)
    launch(kernel, entry, x.device, wp.data_ptr(),
           scales.data_ptr(), int(scales.dtype == torch.bfloat16),
           device_planar_table(quant_type, x.device).data_ptr(),
           x.data_ptr(), y.data_ptr(), T, M, K8, int(out_factor != 1.0),
           out_factor)
    return y


# K5 runs its CUDA-core body (``qt_planar_matmul``) below this many token
# rows and its tensor-core body (``qt_planar_mma``) from here on: on an
# H100 the tensor-core body is the faster per Llama3-8B forward from 4
# rows on, not at 1 or 2 (``chip_smoke.py phase_planar_time``'s crossover).
PLANAR_MMA_MIN_TOKENS = 4


def planar_body(tokens: int) -> str:
    """Which body K5 runs for ``tokens`` rows: ``"cuda_core"`` or
    ``"mma"``."""
    return "mma" if tokens >= PLANAR_MMA_MIN_TOKENS else "cuda_core"


def matmul_4bit_planar_cuda_core(wp: torch.Tensor, scales: torch.Tensor,
                                 x: torch.Tensor, quant_type: str = "fp4"
                                 ) -> torch.Tensor:
    """K5's CUDA-core body at any ``T``: what :func:`matmul_4bit_planar`
    launches below ``PLANAR_MMA_MIN_TOKENS`` rows, counted in
    ``PLANAR_MATMUL``. CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return matmul_4bit_planar_plain(wp, scales, x, quant_type)
    return _launch_planar(wp, scales, x, quant_type)


def matmul_4bit_planar_mma(wp: torch.Tensor, scales: torch.Tensor,
                           x: torch.Tensor, quant_type: str = "fp4"
                           ) -> torch.Tensor:
    """K5's tensor-core body at any ``T``: what :func:`matmul_4bit_planar`
    launches from ``PLANAR_MMA_MIN_TOKENS`` rows on, counted in
    ``PLANAR_MATMUL_MMA`` only. CPU tensors run the plain version (the
    same function; the body sums in another fp32 order)."""
    if x.device.type == "cpu":
        return matmul_4bit_planar_plain(wp, scales, x, quant_type)
    return _launch_planar(wp, scales, x, quant_type, PLANAR_MATMUL_MMA,
                          "qt_planar_mma")


def _launch_k5(wp, scales, x, quant_type):
    if planar_body(x.shape[0]) == "cuda_core":
        return matmul_4bit_planar_cuda_core(wp, scales, x, quant_type)
    y = matmul_4bit_planar_mma(wp, scales, x, quant_type)
    PLANAR_MATMUL.launches += 1      # K5's count holds both bodies
    return y


def matmul_4bit_planar(wp: torch.Tensor, scales: torch.Tensor,
                       x: torch.Tensor, quant_type: str = "fp4"
                       ) -> torch.Tensor:
    """Fused 4-bit dequant + matmul over planar words: ``y [T, M] =
    x [T, K] @ dequant(wp [M, K/8], scales [M, K/64]).T`` in fp32, any
    ``M`` and ``T``. CUDA tensors launch K5 (``x`` must be bf16): its
    CUDA-core body below ``PLANAR_MMA_MIN_TOKENS`` rows, its tensor-core
    body from there on (:func:`planar_body`); CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return matmul_4bit_planar_plain(wp, scales, x, quant_type)
    return _launch_k5(wp, scales, x, quant_type)


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
    return _launch_k5(wp[layer_idx], scales[layer_idx], x, quant_type)
