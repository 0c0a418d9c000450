"""PyTorch/CUDA port of ``quantizations_tpu``: bnb-compatible FP4/NF4
blockwise 4-bit weights and Llama-family greedy generation on an NVIDIA
Hopper GPU.

The module tree follows the JAX package (``config``, ``quant``, ``ops``,
``nn``, ``models``, ``serve``) so each function's counterpart sits where
a reader of the JAX package would look for it. The storage formats are
the JAX package's own (pair words ``int32 [M/2, K/4]``, fp32/bf16 or
``bf16x2`` scales), so tensors cross between the two through numpy with
no repacking (:mod:`quantizations_tpu_torch.bridge`).

Every kernel is CUDA C++ for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use. A wrapper launches its kernel for CUDA tensors and
runs the kernel's plain PyTorch version for CPU tensors only.
"""

from .config import QuantConfig, ServeConfig

__all__ = ["QuantConfig", "ServeConfig"]
