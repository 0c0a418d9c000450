"""Module layer: the 4-bit matmul dispatch."""

from .linear import (
    apply_4bit,
    dense_matmul_pair,
    dense_weight,
    dequantize_permuted,
    pair_max_tokens,
    permute_cols,
)

__all__ = ["apply_4bit", "dense_matmul_pair", "dense_weight",
           "dequantize_permuted", "pair_max_tokens", "permute_cols"]
