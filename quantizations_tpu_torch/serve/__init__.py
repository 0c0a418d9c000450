"""Serving on the port's model: the generate loop, sampling, speculative
decoding and the two engines."""

from .engine import Engine, Request
from .generate import GenerateResult, generate, make_generate_fn, sample_logits
from .paged import PagedEngine, PagedKVCache
from .speculative import make_speculative_generate_fn

__all__ = ["GenerateResult", "generate", "make_generate_fn", "sample_logits",
           "Engine", "Request", "PagedEngine", "PagedKVCache",
           "make_speculative_generate_fn"]
