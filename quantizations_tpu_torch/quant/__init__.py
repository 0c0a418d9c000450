"""Quantization core: codebooks, QuantState and the functional quantizers."""

from .codebooks import (
    FP4_CODE,
    NF4_CODE,
    code_midpoints,
    create_dynamic_map,
    get_4bit_code,
)
from .functional import (
    dequantize_4bit,
    dequantize_absmax,
    dequantize_blockwise,
    gemv_4bit,
    matmul_4bit,
    pack_4bit,
    quantize_4bit,
    quantize_blockwise,
    quantize_codebook_codes,
    quantize_fp4_codes,
    quantize_nf4_codes,
    unpack_4bit,
)
from .state import QuantState, valid_qs_keys

__all__ = [
    "FP4_CODE", "NF4_CODE", "code_midpoints", "create_dynamic_map",
    "get_4bit_code", "dequantize_4bit", "dequantize_absmax",
    "dequantize_blockwise", "gemv_4bit", "matmul_4bit", "pack_4bit",
    "quantize_4bit",
    "quantize_blockwise", "quantize_codebook_codes", "quantize_fp4_codes",
    "quantize_nf4_codes", "unpack_4bit", "QuantState", "valid_qs_keys",
]
