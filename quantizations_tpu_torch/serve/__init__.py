"""Generation on the port's model."""

from .generate import GenerateResult, generate, make_generate_fn, sample_logits

__all__ = ["GenerateResult", "generate", "make_generate_fn", "sample_logits"]
