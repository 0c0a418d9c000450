"""Model families of the port (counterpart of ``quantizations_tpu/models``;
only Llama3-8B and the tiny test config are ported so far)."""

from .llama import (
    KVCache,
    LLAMA3_8B,
    LlamaConfig,
    LlamaParams,
    QLinear,
    TINY_LLAMA,
    decode_step,
    init_llama_params,
    prefill,
)

__all__ = [
    "LlamaConfig",
    "LlamaParams",
    "QLinear",
    "KVCache",
    "init_llama_params",
    "prefill",
    "decode_step",
    "LLAMA3_8B",
    "TINY_LLAMA",
]
