"""Kernels (CUDA C++ under ``csrc/``) with their plain PyTorch versions,
and the layout helpers around them: K1 pair dequant-matmul, K2 quantize,
K3/K4 flash-decode attention (bf16 / int8 cache, slot and paged)."""

from .attention import (
    flash_decode_attention,
    flash_decode_attention_plain,
    flash_decode_attention_stacked,
    flash_decode_attention_stacked_i8,
    flash_decode_attention_stacked_i8_plain,
    flash_decode_attention_stacked_plain,
)
from .cuda import (
    FLASH_DECODE,
    FLASH_DECODE_I8,
    KERNELS,
    PAIR_MATMUL,
    QUANTIZE_4BIT,
)
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
from .paged_attention import (
    paged_flash_decode_attention,
    paged_flash_decode_attention_i8,
    paged_flash_decode_attention_i8_plain,
    paged_flash_decode_attention_plain,
)
from .quantize import quantize_4bit_kernel, quantize_4bit_kernel_plain

__all__ = [
    "KERNELS", "PAIR_MATMUL", "QUANTIZE_4BIT", "FLASH_DECODE",
    "FLASH_DECODE_I8", "pack_i32_rows",
    "matmul_4bit_pair", "matmul_4bit_pair_plain", "matmul_4bit_pair_stacked",
    "matmul_4bit_pair_stacked_plain", "pack_scale_pairs",
    "pair_permute_activation", "pair_to_planar", "planar_to_pair",
    "unpack_scale_pairs", "quantize_4bit_kernel",
    "quantize_4bit_kernel_plain", "flash_decode_attention",
    "flash_decode_attention_plain", "flash_decode_attention_stacked",
    "flash_decode_attention_stacked_plain",
    "flash_decode_attention_stacked_i8",
    "flash_decode_attention_stacked_i8_plain",
    "paged_flash_decode_attention", "paged_flash_decode_attention_plain",
    "paged_flash_decode_attention_i8",
    "paged_flash_decode_attention_i8_plain",
]
