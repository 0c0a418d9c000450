"""Configuration dataclasses (counterpart of ``quantizations_tpu/config.py``).

Every knob the JAX package validates is accepted and validated the same
way. Dtype fields hold torch dtypes; ``"bf16x2"`` (merged bf16 row-pair
scale words, ``int32 [out/2, in/64]``) stays a string.

The JAX package's pair-kernel decode strategies (``fp4_decode``,
``nf4_decode``) are bit-identical to each other on the TPU. The port has
one decode (a 16-entry table lookup inside the CUDA kernel), so every
valid value maps onto it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

__all__ = ["QuantConfig", "ServeConfig", "VALID_BLOCKSIZES",
           "PAIR_PIPELINES", "FP4_DECODES", "NF4_DECODES"]

# Blocksizes the blockwise quantizers accept.
VALID_BLOCKSIZES = (64, 128, 256, 512, 1024, 2048, 4096)
# The pair kernels' weight streams (K1, K9) and the JAX package's decode
# strategies (all one table decode here).
PAIR_PIPELINES = ("grid", "manual")
FP4_DECODES = ("arith", "arith_sr", "mixg0", "mixg02")
NF4_DECODES = ("mix", "mix_bt", "mix_g3")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How weights are quantized and which kernels apply them.

    - ``quant_type``: ``"fp4"`` or ``"nf4"`` codebook.
    - ``blocksize``: elements per absmax block of the weights.
    - ``compress_statistics``: double-quantize the absmax statistics
      (8-bit against the dynamic map, blocksize ``stats_blocksize``).
    - ``compute_dtype``: activation dtype fed to the 4-bit matmuls.
    - ``quantize_lm_head`` / ``quantize_embedding``: 4-bit those tables.
    - ``scales_dtype``: storage of the resolved scales: ``torch.float32``,
      ``torch.bfloat16`` or ``"bf16x2"``.
    - ``pair_pipeline``: ``"grid"`` (K1) or ``"manual"`` (K9, the weight
      words streamed through shared memory; K1's output bit for bit) for
      the pair kernel band's projections that pass the JAX package's gate.
    - ``fp4_decode`` / ``nf4_decode``: accepted for compatibility; all map
      onto the port's table decode.
    - ``dense_twin``: dense bf16 twin projections (each weight
      dequantized, then ``torch.matmul``).
    """

    quant_type: str = "fp4"
    blocksize: int = 64
    compress_statistics: bool = True
    stats_blocksize: int = 256
    compute_dtype: Any = torch.bfloat16
    quantize_lm_head: bool = True
    quantize_embedding: bool = False
    scales_dtype: Any = torch.float32
    pair_pipeline: str = "grid"
    fp4_decode: str = "arith"
    nf4_decode: str = "mix"
    dense_twin: bool = False

    @property
    def pair_decode(self) -> str:
        """The decode strategy name for this quant type."""
        return self.fp4_decode if self.quant_type == "fp4" else self.nf4_decode

    def __post_init__(self):
        if self.quant_type not in ("fp4", "nf4"):
            raise ValueError(f"quant_type {self.quant_type!r} not supported")
        if self.pair_pipeline not in PAIR_PIPELINES:
            raise ValueError(
                f"pair_pipeline {self.pair_pipeline!r} not in "
                f"{PAIR_PIPELINES}")
        if self.fp4_decode not in FP4_DECODES:
            raise ValueError(
                f"fp4_decode {self.fp4_decode!r} not in {FP4_DECODES}")
        if self.nf4_decode not in NF4_DECODES:
            raise ValueError(
                f"nf4_decode {self.nf4_decode!r} not in {NF4_DECODES}")
        if self.scales_dtype != "bf16x2" and self.scales_dtype not in (
                torch.float32, torch.bfloat16):
            raise ValueError(
                f"scales_dtype {self.scales_dtype!r} not in "
                f"(torch.float32, torch.bfloat16, 'bf16x2')")
        if self.blocksize not in VALID_BLOCKSIZES:
            raise ValueError(
                f"blocksize {self.blocksize} not in {VALID_BLOCKSIZES}")
        if self.stats_blocksize not in VALID_BLOCKSIZES:
            raise ValueError(
                f"stats_blocksize {self.stats_blocksize} not in "
                f"{VALID_BLOCKSIZES}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving/runtime knobs: mesh shape, batching, generation limits."""

    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("tp",)
    batch_size: int = 1
    max_seq_len: int = 2048
    max_new_tokens: int = 60
    temperature: float = 0.0                 # 0 => greedy
    top_k: int = 0                           # 0 => no top-k mask
    top_p: float = 1.0                       # 1.0 => no nucleus mask
    eos_id: Optional[int] = None             # freeze a row once it emits eos
    seed: int = 0
    donate_cache: bool = True                # the port updates in place

    @property
    def tp(self) -> int:
        return (self.mesh_shape[self.mesh_axes.index("tp")]
                if "tp" in self.mesh_axes else 1)
