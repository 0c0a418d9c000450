"""Serving on the port's model: the generate loop, sampling, speculative
decoding, the two engines and the watchdog over them."""

from .engine import Engine, Request
from .generate import GenerateResult, generate, make_generate_fn, sample_logits
from .paged import PagedEngine, PagedKVCache
from .speculative import make_speculative_generate_fn
from .watchdog import Watchdog

__all__ = ["GenerateResult", "generate", "make_generate_fn", "sample_logits",
           "Engine", "Request", "PagedEngine", "PagedKVCache",
           "make_speculative_generate_fn", "Watchdog"]
