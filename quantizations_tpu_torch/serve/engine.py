"""Helpers shared by the serving engines (counterpart of the shared part of
``quantizations_tpu/serve/engine.py``): the request record, the host
prompt-lookup drafter, per-row sampling and the prefill chunking that
both engines use. The slot ``Engine`` class is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import numpy as np
import torch

__all__ = ["Request", "draft_lookup_host", "truncate_rows", "sample_rows",
           "sample_rows_samp", "iter_prefill_chunks", "clamp_buckets",
           "run_chunk_rounds"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt_ids: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: Optional[float] = None   # None = engine default
    top_k: Optional[int] = None           # None = engine default
    top_p: Optional[float] = None         # None = engine default
    # filled by the engine:
    output_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def draft_lookup_host(hist: List[int], k: int) -> List[int]:
    """Host-side prompt-lookup drafter: the ``k`` tokens following the
    most recent strictly-earlier occurrence of the current trigram,
    falling back to the bigram; pads with the last token."""
    n = len(hist)
    if n >= 3:
        t3, t2, t1 = hist[-3], hist[-2], hist[-1]
        for j in range(n - 4, -1, -1):
            if hist[j] == t3 and hist[j + 1] == t2 and hist[j + 2] == t1:
                src = hist[j + 3:j + 3 + k]
                return (src + [t1] * k)[:k]
    if n >= 2:
        b2, b1 = hist[-2], hist[-1]
        for j in range(n - 3, -1, -1):
            if hist[j] == b2 and hist[j + 1] == b1:
                src = hist[j + 2:j + 2 + k]
                return (src + [b1] * k)[:k]
    return [hist[-1] if hist else 0] * k


Scalar = Union[int, float, torch.Tensor]


def truncate_rows(lt: torch.Tensor, top_k: Scalar = 0,
                  top_p: Scalar = 1.0) -> torch.Tensor:
    """Top-k then top-p truncation of temperature-scaled logits
    ``lt [rows, V]``: masked entries become ``-inf``. ``top_k`` and
    ``top_p`` are scalars or per-row host tensors; ``top_k == 0`` and
    ``top_p >= 1`` mean "none" for a row.

    One descending sort serves both truncations (its top-k-masked copy
    is the sorted masked array). It runs only when some row truncates,
    as the JAX package's ``lax.cond`` does (with every row at the
    defaults, fp32 rounding of the cumulative sum could otherwise mask a
    far tail); the test reads host tensors, so it never waits for the
    device."""
    V, rows = lt.shape[-1], lt.shape[0]
    ks = torch.as_tensor(top_k).to(torch.int64).reshape(-1)
    ps = torch.as_tensor(top_p).to(torch.float32).reshape(-1)
    if not (bool((ks > 0).any()) or bool((ps < 1.0).any())):
        return lt
    ks = torch.broadcast_to(ks, (rows,)).to(lt.device)
    ps = torch.broadcast_to(ps, (rows,)).to(lt.device)
    srt = torch.sort(lt, dim=-1, descending=True).values
    kk = torch.where(ks <= 0, torch.full_like(ks, V), ks)
    kth = torch.gather(srt, 1, (kk - 1).clamp(0, V - 1)[:, None])
    ninf = torch.full_like(lt, float("-inf"))
    x = torch.where(lt < kth, ninf, lt)
    probs = torch.softmax(torch.where(srt < kth, ninf, srt), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < ps[:, None]
    thr = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                      ).amin(dim=-1, keepdim=True)
    return torch.where(x < thr, ninf, x)


def sample_rows(logits: torch.Tensor, temps: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                top_k: Scalar = 0, top_p: Scalar = 1.0) -> torch.Tensor:
    """Per-row temperature sampling: rows with ``temps == 0`` take the
    greedy argmax, others a categorical draw (from ``generator``) over the
    temperature-scaled, :func:`truncate_rows`-truncated logits. ``temps``
    is a host tensor: when every row is greedy no draw is made. Returns
    int32 ``[rows]``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = torch.as_tensor(temps, dtype=torch.float32)
    if not bool((temps != 0.0).any()):
        return greedy
    t = temps.to(logits.device)
    lt = logits.float() / torch.clamp(t, min=1e-6)[:, None]
    lt = truncate_rows(lt, top_k, top_p)
    sampled = torch.multinomial(torch.softmax(lt, dim=-1), 1,
                                generator=generator)[:, 0].to(torch.int32)
    return torch.where(t == 0.0, greedy, sampled)


def sample_rows_samp(logits: torch.Tensor, samp: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """:func:`sample_rows` over a host sampling matrix ``samp [rows, 3]``
    = (temperature, top_k, top_p), one row per request."""
    samp = torch.as_tensor(samp, dtype=torch.float32)
    return sample_rows(logits, samp[:, 0], generator,
                       top_k=samp[:, 1].to(torch.int32), top_p=samp[:, 2])


def iter_prefill_chunks(plen: int, buckets, max_len: int = 0,
                        base: int = 0) -> list:
    """(start, take, bucket_len) triples covering a prompt of ``plen``
    tokens with bucket-shaped prefill chunks. With ``max_len`` set, a
    final padded chunk that would run past the cache end is shifted back
    so that it ends exactly at ``max_len``, re-feeding already-prefilled
    tokens (they recompute identical K/V) and growing ``take`` so that
    the last real token stays at offset ``take - 1``."""
    buckets = tuple(sorted(buckets))
    out = []
    start = 0
    while start < plen:
        take = min(plen - start, buckets[-1])
        blen = next(b for b in buckets if take <= b)
        out.append((start, take, blen))
        start += take
    if max_len and out:
        start, take, blen = out[-1]
        if base + start + blen > max_len:
            if blen > max_len or base + plen > max_len:
                raise ValueError(
                    f"prefill bucket {blen} cannot fit: base {base} + "
                    f"plen {plen} vs cache length {max_len}")
            start = max_len - blen - base   # may reach below ``base``
            out[-1] = (start, plen - start, blen)
    return out


def clamp_buckets(buckets, max_seq: int) -> tuple:
    """Drop prefill buckets wider than the cache."""
    return (tuple(b for b in sorted(buckets) if b <= max_seq)
            or (max_seq,))


def run_chunk_rounds(entries, n_rows: int, default_starts,
                     dispatch: Callable) -> dict:
    """Drive batched chunk-round prefills.

    ``entries``: (row, prompt_ids, cov, chunks) per admission, chunks from
    :func:`iter_prefill_chunks` over ``len(prompt_ids) - cov``. Rows that
    run out of chunks write garbage at ``len(prompt_ids)`` of their own
    row (past their valid prefix: never attended, never scattered).
    ``dispatch(ids, starts, plens) -> out[row]`` runs one round (the
    paged engine's returns each row's logits). Returns {row: ``out[row]``
    of its final real round}."""
    rounds = max(len(c) for _, _, _, c in entries)
    out: dict = {}
    for j in range(rounds):
        blen = max(c[j][2] for _, _, _, c in entries if j < len(c))
        ids = np.zeros((n_rows, blen), np.int32)
        starts = np.asarray(default_starts, np.int32).copy()
        plens = np.ones(n_rows, np.int32)
        for row, prompt, cov, c in entries:
            if j >= len(c):
                starts[row] = len(prompt)   # garbage round
                continue
            start, take, _ = c[j]
            ids[row, :take] = prompt[cov + start:cov + start + take]
            starts[row] = cov + start
            plens[row] = take
        tok = dispatch(ids, starts, plens)
        for row, _, _, c in entries:
            if j == len(c) - 1:
                out[row] = tok[row]
    return out
