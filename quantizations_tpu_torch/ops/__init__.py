"""Kernels (CUDA C++ under ``csrc/``) with their plain PyTorch versions,
and the layout helpers around them."""

from .cuda import KERNELS, PAIR_MATMUL, QUANTIZE_4BIT
from .gemv import pack_i32_rows
from .qmatmul import (
    matmul_4bit_pair,
    matmul_4bit_pair_plain,
    matmul_4bit_pair_stacked,
    matmul_4bit_pair_stacked_plain,
    pack_scale_pairs,
    pair_permute_activation,
    pair_to_planar,
    planar_to_pair,
    unpack_scale_pairs,
)
from .quantize import quantize_4bit_kernel, quantize_4bit_kernel_plain

__all__ = [
    "KERNELS", "PAIR_MATMUL", "QUANTIZE_4BIT", "pack_i32_rows",
    "matmul_4bit_pair", "matmul_4bit_pair_plain", "matmul_4bit_pair_stacked",
    "matmul_4bit_pair_stacked_plain", "pack_scale_pairs",
    "pair_permute_activation", "pair_to_planar", "planar_to_pair",
    "unpack_scale_pairs", "quantize_4bit_kernel",
    "quantize_4bit_kernel_plain",
]
