"""Module layer: the 4-bit matmul dispatch, ``Params4bit`` and the
bnb-compatible ``Linear4bit``."""

from .linear import (
    Linear4bit,
    Params4bit,
    apply_4bit,
    dense_matmul_pair,
    dense_matmul_pair_plain,
    dense_product,
    dense_weight,
    dequantize_permuted,
    pair_max_tokens,
    permute_cols,
)

__all__ = ["Linear4bit", "Params4bit", "apply_4bit", "dense_matmul_pair",
           "dense_matmul_pair_plain", "dense_product", "dense_weight",
           "dequantize_permuted", "pair_max_tokens", "permute_cols"]
