"""Accuracy evaluation (counterpart of ``quantizations_tpu/evals``):
quantization-parity metrics and the IFEval harnesses. The accuracy bar
of a 4-bit scheme is IFEval score parity with the bf16 model."""

from .parity import logit_parity, perplexity

__all__ = ["logit_parity", "perplexity"]
