"""Autoregressive generation (counterpart of
``quantizations_tpu/serve/generate.py``).

Prefill, then a Python loop of decode steps over the KV cache, which the
model updates in place. Sampling stays on the device: the next token is
fed back as a tensor, so the loop never waits for the device until the
caller reads the tokens.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional, Tuple

import torch

from ..config import ServeConfig
from ..models.llama import (
    KVCache,
    LlamaConfig,
    LlamaParams,
    check_cache_room,
    decode_step,
    prefill,
)

__all__ = ["sample_logits", "make_generate_fn", "generate", "GenerateResult"]


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Greedy (temperature 0) or temperature/top-k/top-p categorical
    sampling of ``logits [B, vocab]`` -> int32 ``[B]``. Top-p keeps the
    smallest prefix of probability-sorted tokens whose mass reaches
    ``top_p``. Categorical draws come from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p                  # mass BEFORE token
        thr = torch.where(keep, srt, torch.tensor(
            float("inf"), device=logits.device)).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thr, neg_inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _generate_impl(params: LlamaParams, prompt_ids: torch.Tensor,
                   cache: KVCache, generator: Optional[torch.Generator],
                   cfg: LlamaConfig, max_new_tokens: int, temperature: float,
                   top_k: int, top_p: float = 1.0,
                   eos_id: Optional[int] = None,
                   axis_name: Optional[str] = None
                   ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill + decode loop. Returns (tokens int32 ``[B,
    max_new_tokens]``, cache). ``eos_id`` freezes a row to eos once it
    emits eos (the loop still runs ``max_new_tokens`` steps). Raises
    ``ValueError`` before any launch when the last decode step's
    position, ``P + max_new_tokens - 2``, lies past the cache."""
    B, P = prompt_ids.shape
    check_cache_room(0, P + max_new_tokens - 1, cache)
    with torch.inference_mode():
        logits, cache = prefill(params, prompt_ids, cache, cfg,
                                axis_name=axis_name, last_token_only=True)
        tok = sample_logits(logits[:, -1, :], generator, temperature, top_k,
                            top_p)
        done = (torch.zeros(B, dtype=torch.bool, device=tok.device)
                if eos_id is None else tok == eos_id)
        toks = [tok]
        for step in range(max_new_tokens - 1):
            logits, cache = decode_step(params, tok[:, None], cache, P + step,
                                        cfg, axis_name=axis_name)
            nxt = sample_logits(logits, generator, temperature, top_k, top_p)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            toks.append(nxt)
            tok = nxt
    return torch.stack(toks, dim=1), cache


def make_generate_fn(cfg: LlamaConfig, serve: ServeConfig,
                     axis_name: Optional[str] = None) -> Callable:
    """``(params, prompt_ids, cache, generator) -> (tokens, cache)`` for
    the sampling knobs of ``serve``. The cache is updated in place (the
    JAX package donates it)."""
    return functools.partial(
        _generate_impl, cfg=cfg, max_new_tokens=serve.max_new_tokens,
        temperature=serve.temperature, top_k=serve.top_k, top_p=serve.top_p,
        eos_id=serve.eos_id, axis_name=axis_name)


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor         # [B, max_new_tokens] int32
    prefill_s: float
    decode_s: float              # the whole generate call, prefill included
    tokens_per_s: float          # new tokens, batch-summed, per second
    per_seq_tps: float


def generate(params: LlamaParams, prompt_ids: torch.Tensor, cfg: LlamaConfig,
             serve: ServeConfig, warmup: bool = True) -> GenerateResult:
    """Build a cache, run generation and time it: new tokens over the
    time of the whole call, as the JAX package reports it. On CUDA the
    time comes from CUDA events around the call; on the CPU from the host
    clock."""
    B, _ = prompt_ids.shape
    dev = prompt_ids.device
    gen = make_generate_fn(cfg, serve)

    def run():
        cache = KVCache.create(cfg, B, serve.max_seq_len, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(serve.seed)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            toks, _ = gen(params, prompt_ids, cache, g)
            end.record()
            end.synchronize()
            return toks, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        toks, _ = gen(params, prompt_ids, cache, g)
        return toks, time.perf_counter() - t0

    if warmup:
        run()
    toks, total_s = run()
    n_new = serve.max_new_tokens
    return GenerateResult(tokens=toks, prefill_s=0.0, decode_s=total_s,
                          tokens_per_s=n_new * B / total_s,
                          per_seq_tps=n_new / total_s)
