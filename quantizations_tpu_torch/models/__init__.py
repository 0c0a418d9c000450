"""Model families of the port (counterpart of ``quantizations_tpu/models``):
the Llama-family model with the Llama3-8B, Llama3-70B, Gemma2-9B and tiny
test presets."""

from .llama import (
    GEMMA2_9B,
    KVCache,
    LLAMA3_70B,
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
    "LLAMA3_70B",
    "GEMMA2_9B",
    "TINY_LLAMA",
]
