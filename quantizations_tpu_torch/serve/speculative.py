"""Prompt-lookup speculative decoding (counterpart of
``quantizations_tpu/serve/speculative.py``).

The drafter is model-free: it proposes the ``k`` tokens that followed the
most recent earlier occurrence of the current bigram in the token history
(:func:`draft_prompt_lookup`). One verify forward of the pending token and
``k - 1`` drafts at ``T = k`` checks them all:

- temperature 0: a draft is accepted where it equals the argmax, so the
  emitted stream is the greedy stream of the verify forward's numerics,
  whatever the drafts are;
- temperature > 0: exact speculative sampling against the deterministic
  draft (:func:`spec_accept_sample`): accept draft ``d`` with probability
  ``p(d)``, else draw from ``p`` with ``d`` removed; with the bonus-slot
  rule of :func:`spec_window_tokens` the emitted stream is distributed as
  ordinary temperature sampling.

The uniforms and the correction draws come from an explicit
``torch.Generator``; :func:`spec_accept_from` takes the uniforms as an
argument and :func:`spec_correction_logits` returns the logits the
correction is drawn from, so both can be held against the JAX package.

A ``T = k`` verify forward and ``T = 1`` decode steps round differently,
so a near-tied argmax may flip between them (on random weights often,
on trained ones rarely).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from ..config import ServeConfig
from ..models.llama import KVCache, LlamaConfig, LlamaParams, prefill
from .generate import sample_logits

__all__ = ["make_speculative_generate_fn", "draft_prompt_lookup",
           "spec_accept_sample", "spec_accept_sample_vec",
           "spec_accept_from", "spec_correction_logits",
           "spec_window_tokens"]


def spec_correction_logits(logits: torch.Tensor, draft: torch.Tensor,
                           temps: torch.Tensor) -> torch.Tensor:
    """The logits a rejected position's correction is drawn from:
    ``logits [B, K, V]`` over the per-row temperature ``temps [B]``
    (clamped at 1e-6), with each position's draft token set to ``-inf``."""
    t = torch.clamp(torch.as_tensor(temps, dtype=torch.float32).to(
        logits.device), min=1e-6)
    lt = logits.float() / t[:, None, None]
    return lt.scatter(-1, draft.long()[..., None], float("-inf"))


def _categorical(lt: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of ``lt [..., V]`` from ``softmax(lt)``."""
    V = lt.shape[-1]
    probs = torch.softmax(lt.reshape(-1, V), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].reshape(
        lt.shape[:-1]).to(torch.int32)


def spec_accept_from(logits: torch.Tensor, draft: torch.Tensor,
                     temps: torch.Tensor, u: torch.Tensor,
                     corr_t: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The accept rule on given draws: ``u [B, K]`` uniforms and
    ``corr_t [B, K]`` correction tokens. Greedy rows (``temps == 0``)
    accept where the draft is the argmax and correct to the argmax; the
    others accept where ``u < p(draft)`` under ``softmax(logits / temp)``.
    Returns (ok [B, K] bool, corr [B, K] int32)."""
    g = torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.as_tensor(temps, dtype=torch.float32).to(logits.device)
    lt = logits.float() / torch.clamp(t, min=1e-6)[:, None, None]
    pd = torch.softmax(lt, dim=-1).gather(-1, draft.long()[..., None])[..., 0]
    greedy = (t == 0.0)[:, None]
    ok = torch.where(greedy, draft == g, u.to(pd.device) < pd)
    corr = torch.where(greedy, g, corr_t.to(g.device, torch.int32))
    return ok, corr


def spec_accept_sample_vec(logits: torch.Tensor, draft: torch.Tensor,
                           generator: Optional[torch.Generator],
                           temps: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact speculative sampling with a temperature per row (``temps
    [B]``, a host tensor; 0 is greedy for that row). ``logits [B, K, V]``,
    ``draft [B, K]`` -> (ok [B, K], corr [B, K]). When every row is
    greedy no draw is made."""
    temps = torch.as_tensor(temps, dtype=torch.float32)
    B, K, _ = logits.shape
    if not bool((temps != 0.0).any()):
        g = torch.argmax(logits, dim=-1).to(torch.int32)
        return draft == g, g
    u = torch.rand((B, K), generator=generator, device=logits.device)
    corr_t = _categorical(spec_correction_logits(logits, draft, temps),
                          generator)
    return spec_accept_from(logits, draft, temps, u, corr_t)


def spec_accept_sample(logits: torch.Tensor, draft: torch.Tensor,
                       generator: Optional[torch.Generator],
                       temperature: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact speculative sampling against a deterministic draft, one
    temperature for every row: accept ``draft`` with probability
    ``p(draft)``, else draw from ``p`` without it. Temperature 0 accepts
    by argmax equality. ``logits [B, K, V]``, ``draft [B, K]`` -> (ok
    [B, K], corr [B, K])."""
    return spec_accept_sample_vec(
        logits, draft, generator,
        torch.full((logits.shape[0],), float(temperature)))


def spec_window_tokens(okk: torch.Tensor, corr: torch.Tensor,
                       draft: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve one verify window. Only drafts ``[:, :K-1]`` were fed, so
    the window emits ``a`` leading accepted drafts and one decision token,
    ``g[:, :a+1]``. The decision token is ``corr[:, a]``, except at
    ``a == K-1`` (every fed draft accepted), where position ``K-1`` is the
    bonus slot and its own ``okk[:, K-1]`` decides draft against
    correction. Returns (g [B, K], a [B] int64)."""
    B, K = draft.shape
    ok = okk[:, :K - 1].to(torch.int64)
    a = torch.cumprod(ok, dim=1).sum(dim=1)
    idx = torch.arange(K, device=draft.device)[None, :]
    bonus_ok = (a == K - 1) & okk[:, K - 1]
    draft = draft.to(torch.int32)
    g = torch.where(idx < a[:, None], draft, corr.to(torch.int32))
    g = torch.where((idx == a[:, None]) & bonus_ok[:, None], draft, g)
    return g, a


def draft_prompt_lookup(hist: torch.Tensor, hcnt: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Propose ``k`` tokens per row from the most recent strictly earlier
    match of the current bigram in ``hist[:, :hcnt]`` (``hist [B, S]``,
    ``hcnt [B]`` >= 2). Rows with no match read from their last token on.
    The read wraps around the row's end, as the JAX package's does."""
    B, S = hist.shape
    dev = hist.device
    hcnt = hcnt.to(dev, torch.int64)
    j = torch.arange(S, device=dev)[None, :]
    last1 = hist.gather(1, (hcnt - 1)[:, None])
    last2 = hist.gather(1, (hcnt - 2)[:, None])
    nxt = torch.cat([hist[:, 1:], hist[:, :1]], dim=1)      # hist[j + 1]
    match = (hist == last2) & (nxt == last1) & (j + 1 < (hcnt - 1)[:, None])
    jm = torch.where(match, j, torch.full_like(j, -1)).amax(dim=1)
    start = torch.where(jm >= 0, jm + 2, hcnt - 1).clamp(max=S - 1)
    ext = torch.cat([hist, hist[:, :k]], dim=1)             # wrap-safe
    return ext.gather(1, start[:, None] + torch.arange(k, device=dev)[None])


def append_window(buf: torch.Tensor, base: torch.Tensor, vals: torch.Tensor,
                  n: torch.Tensor) -> torch.Tensor:
    """Write ``vals[b, :n[b]]`` into ``buf [B, W]`` at ``base[b]`` (in
    place; positions past ``W - 1`` are clamped there and keep their
    value). Returns ``buf``."""
    K = vals.shape[1]
    idx = torch.arange(K, device=buf.device)[None, :]
    at = (base.to(torch.int64)[:, None] + idx).clamp(max=buf.shape[1] - 1)
    keep = buf.gather(1, at)
    buf.scatter_(1, at, torch.where(idx < n[:, None], vals.to(buf.dtype),
                                    keep))
    return buf


def _spec_impl(params: LlamaParams, prompt_ids: torch.Tensor, cache: KVCache,
               generator: Optional[torch.Generator], cfg: LlamaConfig,
               max_new_tokens: int, draft_k: int, temperature: float = 0.0
               ) -> Tuple[torch.Tensor, int, KVCache]:
    """Prefill, then verify windows over the slot cache until every row
    has ``max_new_tokens`` tokens. Returns (tokens [B, max_new_tokens]
    int32, verify windows run, cache); plain decoding would run
    ``max_new_tokens - 1`` forwards after the prefill.

    Each window reads back one number, the least row count, which decides
    whether the loop ends. A row that is done stays frozen: it emits
    nothing and its position does not move, and its window is written at
    ``min(pos, max_seq - draft_k)``, so no write leaves the cache. Raises
    ``ValueError`` before any launch when the cache is shorter than
    ``P + max_new_tokens + draft_k``."""
    B, P = prompt_ids.shape
    N, K = max_new_tokens, draft_k
    S = cache.max_seq
    if S < P + N + K:
        raise ValueError(
            f"cache max_seq {S} < prompt {P} + max_new_tokens {N} + draft_k "
            f"{K} (the verify forward writes up to K positions past the "
            "final token)")
    dev = prompt_ids.device
    with torch.inference_mode():
        logits, cache = prefill(params, prompt_ids, cache, cfg,
                                last_token_only=True)
        t0 = sample_logits(logits[:, -1], generator, temperature)
        hist = torch.zeros((B, P + N + K + 2), dtype=torch.int32, device=dev)
        hist[:, :P] = prompt_ids
        hist[:, P] = t0
        hcnt = torch.full((B,), P + 1, dtype=torch.int64, device=dev)
        out = torch.zeros((B, N + K), dtype=torch.int32, device=dev)
        out[:, 0] = t0
        pending = t0
        pos = torch.full((B,), P, dtype=torch.int64, device=dev)
        cnt = torch.ones((B,), dtype=torch.int64, device=dev)
        steps = 0
        while int(cnt.min()) < N:
            draft = draft_prompt_lookup(hist, hcnt, K)
            feed = torch.cat([pending[:, None], draft[:, :K - 1]], dim=1)
            logits, cache = prefill(params, feed, cache, cfg,
                                    pos=pos.clamp(max=S - K))
            okk, corr = spec_accept_sample(logits, draft, generator,
                                           temperature)
            g, a = spec_window_tokens(okk, corr, draft)
            emit_n = torch.where(cnt < N, a + 1, torch.zeros_like(a))
            append_window(out, cnt, g, emit_n)
            append_window(hist, hcnt, g, emit_n)
            pending = g.gather(1, a[:, None])[:, 0]
            pos = pos + emit_n
            cnt = cnt + emit_n
            hcnt = hcnt + emit_n
            steps += 1
    return out[:, :N], steps, cache


def make_speculative_generate_fn(cfg: LlamaConfig, serve: ServeConfig,
                                 draft_k: int = 8) -> Callable:
    """``(params, prompt_ids, cache, generator) -> (tokens [B,
    max_new_tokens], verify_steps, cache)``: greedy at temperature 0
    (the greedy stream of the verify forward), exact speculative
    sampling above. The cache is updated in place."""
    return functools.partial(
        _spec_impl, cfg=cfg, max_new_tokens=serve.max_new_tokens,
        draft_k=draft_k, temperature=serve.temperature)
