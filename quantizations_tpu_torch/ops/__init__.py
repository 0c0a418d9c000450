"""Kernels (CUDA C++ under ``csrc/``) with their plain PyTorch versions,
and the layout helpers around them: K1 pair dequant-matmul, K2 quantize,
K3/K4 flash-decode attention (bf16 / int8 cache, slot and paged), K5
planar dequant-matmul, K6 planar fp32 GEMV, K7 dequantize."""

from .attention import (
    flash_decode_attention,
    flash_decode_attention_plain,
    flash_decode_attention_stacked,
    flash_decode_attention_stacked_i8,
    flash_decode_attention_stacked_i8_plain,
    flash_decode_attention_stacked_plain,
)
from .cuda import (
    DEQUANTIZE_4BIT,
    FLASH_DECODE,
    FLASH_DECODE_I8,
    GEMV_4BIT,
    KERNELS,
    PAIR_MATMUL,
    PLANAR_MATMUL,
    QUANTIZE_4BIT,
)
from .gemv import (
    gemv_4bit,
    gemv_4bit_plain,
    gemv_4bit_stacked,
    gemv_4bit_stacked_plain,
    pack_i32_rows,
    permute_activation,
)
from .qmatmul import (
    matmul_4bit_pair,
    matmul_4bit_pair_plain,
    matmul_4bit_pair_stacked,
    matmul_4bit_pair_stacked_plain,
    matmul_4bit_planar,
    matmul_4bit_planar_plain,
    matmul_4bit_planar_stacked,
    matmul_4bit_planar_stacked_plain,
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
from .quantize import (
    dequantize_4bit_kernel,
    dequantize_4bit_kernel_plain,
    quantize_4bit_kernel,
    quantize_4bit_kernel_plain,
)

__all__ = [
    "KERNELS", "PAIR_MATMUL", "QUANTIZE_4BIT", "FLASH_DECODE",
    "FLASH_DECODE_I8", "PLANAR_MATMUL", "GEMV_4BIT", "DEQUANTIZE_4BIT",
    "pack_i32_rows", "permute_activation", "gemv_4bit", "gemv_4bit_plain",
    "gemv_4bit_stacked", "gemv_4bit_stacked_plain", "matmul_4bit_planar",
    "matmul_4bit_planar_plain", "matmul_4bit_planar_stacked",
    "matmul_4bit_planar_stacked_plain", "dequantize_4bit_kernel",
    "dequantize_4bit_kernel_plain",
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
