"""The slot-based continuous-batching engine and the helpers both engines
share (counterpart of ``quantizations_tpu/serve/engine.py``): the request
record, the host prompt-lookup drafter, per-row sampling and the prefill
chunking.

:class:`Engine` keeps ``slots`` requests in one slot KV cache, each at its
own position. Decode steps run every slot through one batched forward;
finished slots are refilled from the queue without stopping the others.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import ServeConfig
from ..models.llama import (
    KVCache,
    LlamaConfig,
    LlamaParams,
    decode_step,
    named_tensors,
    prefill,
)
from ..utils.profiling import count, span
from .speculative import spec_accept_sample_vec, spec_window_tokens

__all__ = ["Request", "Engine", "draft_lookup_host", "truncate_rows",
           "sample_rows", "sample_rows_samp", "iter_prefill_chunks",
           "clamp_buckets", "prefill_round", "run_chunk_rounds"]


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


@span("prefill.round")
def prefill_round(params: LlamaParams, cfg: LlamaConfig, cache: KVCache,
                  ids: np.ndarray, starts: np.ndarray, plens: np.ndarray,
                  max_seq: int, axis_name: Any = None) -> torch.Tensor:
    """One admission chunk ``ids [rows, blen]`` written into ``cache``'s
    rows, each at its own start (on the cache's device); returns the logits
    ``[rows, vocab]`` of each row's last valid position (only those are
    computed). Attention reads the cache up to the furthest written
    position. ``axis_name``: the tensor-parallel axis of a sharded
    engine."""
    dev = cache.k.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    attend = min(max_seq, int(starts.max()) + ids.shape[1])
    with torch.inference_mode():
        logits, _ = prefill(params, put(ids), cache, cfg,
                            pos=put(starts.astype(np.int64)),
                            axis_name=axis_name, attend_len=attend,
                            logits_at=put(plens.astype(np.int64) - 1))
    return logits[:, 0]


def run_chunk_rounds(entries, n_rows: int, default_starts,
                     dispatch: Callable) -> dict:
    """Drive batched chunk-round prefills.

    ``entries``: (row, prompt_ids, cov, chunks) per admission, chunks from
    :func:`iter_prefill_chunks` over ``len(prompt_ids) - cov``. Rows that
    run out of chunks write garbage at ``len(prompt_ids)`` of their own
    row (past their valid prefix: never attended, never scattered).
    ``dispatch(ids, starts, plens) -> out[row]`` runs one round (the
    paged engine's returns each row's logits). Returns {row: ``out[row]``
    of its final real round}. Counts each round's rows x bucket length
    (``prefill.rows``) and the prompt tokens its rows with a chunk feed
    (``prefill.tokens``)."""
    rounds = max(len(c) for _, _, _, c in entries)
    out: dict = {}
    for j in range(rounds):
        blen = max(c[j][2] for _, _, _, c in entries if j < len(c))
        ids = np.zeros((n_rows, blen), np.int32)
        starts = np.asarray(default_starts, np.int32).copy()
        plens = np.ones(n_rows, np.int32)
        fed = 0
        for row, prompt, cov, c in entries:
            if j >= len(c):
                starts[row] = len(prompt)   # garbage round
                continue
            start, take, _ = c[j]
            ids[row, :take] = prompt[cov + start:cov + start + take]
            starts[row] = cov + start
            plens[row] = take
            fed += take
        count("prefill.rows", n_rows * blen)
        count("prefill.tokens", fed)
        tok = dispatch(ids, starts, plens)
        for row, _, _, c in entries:
            if j == len(c) - 1:
                out[row] = tok[row]
    return out


class Engine:
    """Slot-based continuous batching over one slot KV cache ``[L, slots,
    KVH, max_seq, D]``.

    Prompts are prefilled in ``prefill_buckets``-shaped chunks. Admission
    is batched: one prefill per chunk round writes every admitted request
    straight into its slot of the batch cache (:func:`run_chunk_rounds`);
    rows that are not being admitted carry zero tokens at their own
    position, whose garbage K/V later steps overwrite before any query
    reads it. When a live slot or a prompt sits too close to ``max_seq``
    for that, each request is prefilled into a scratch cache and copied
    into its slot. Each admitted request samples its first token once,
    after its last chunk, from that chunk's logits at its last real token
    (the only logits the admission forward computes).

    Sampling is per request through a ``[slots, 3]`` (temperature, top_k,
    top_p) host matrix; the engine's values are the defaults of requests
    that leave theirs unset. Draws come from one ``torch.Generator``
    seeded with ``seed``. Decode attends only the smallest power of two
    (at least 128) of cache positions that covers every live row; with
    ``use_flash_attention`` a decode step runs K3 (K4 over an int8 cache),
    and verify windows the einsum path. The engine runs on its
    parameters' device.

    ``mesh`` (a :class:`~quantizations_tpu_torch.parallel.Mesh` with a
    ``"tp"`` axis): ``params`` are this rank's tensor-parallel shard
    (``parallel.shard_llama_params``), the caches hold its kv heads, and
    every forward runs with the axis's collectives. Every rank runs this
    same engine loop on the same gathered logits with an identically
    seeded generator, so every rank makes the same admissions, samples
    and retirements and holds the same ``finished``."""

    def __init__(self, params: LlamaParams, cfg: LlamaConfig,
                 serve: ServeConfig, slots: int = 4,
                 prefill_buckets: tuple = (16, 64, 256),
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0, mesh=None):
        # the caches are shaped by the shard's config under a mesh
        self._axis, self._cache_cfg = None, cfg
        if mesh is not None:
            from ..parallel.shard import AXIS, check_mesh, shard_config

            self._cache_cfg = shard_config(cfg, check_mesh(mesh).shape[AXIS])
            self._axis = mesh.axis(AXIS)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_seq = serve.max_seq_len
        self.buckets = clamp_buckets(prefill_buckets, self.max_seq)
        self.device = params.final_norm.device
        self._temp = temperature
        self._top_k, self._top_p = top_k, top_p
        self.on_token = None   # optional callable(Request, token_id)
        # speculative drafter: (history tokens, k) -> k draft ids; a
        # replay or oracle drafter, or a draft model, can take its place
        self.draft_fn = draft_lookup_host
        self.pos = np.zeros(slots, np.int32)         # next write offset
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        self._uid = 0
        self._cur_tok = np.zeros(slots, np.int32)
        self._steps = 0
        self._spec_windows = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.cache = KVCache.create(self._cache_cfg, slots, self.max_seq,
                                    self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _attend_bucket(self, extra: int = 0) -> int:
        """Smallest power of two >= the live maximum position + 1 +
        ``extra`` (at least 128), at most ``max_seq``. ``extra`` is a
        window's headroom: ``n - 1`` more steps or ``k - 1`` positions."""
        need = int(self.pos.max()) + 1 + extra
        b = 128
        while b < need:
            b *= 2
        return min(b, self.max_seq)

    # -- public API --------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> int:
        # refused here: a refusal inside _admit would strand the requests
        # popped in the same round
        if len(prompt_ids) >= self.max_seq:
            raise ValueError(f"prompt length {len(prompt_ids)} >= max_seq "
                             f"{self.max_seq}")
        self._uid += 1
        self.queue.append(Request(
            uid=self._uid, prompt_ids=list(map(int, prompt_ids)),
            max_new_tokens=max_new_tokens, eos_id=eos_id,
            temperature=temperature, top_k=top_k, top_p=top_p))
        return self._uid

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    def _commit(self, i: int, toks) -> bool:
        """Append ``toks`` to slot ``i``'s request one at a time, retiring
        it at its length, its eos or the cache end (a retired slot's
        position goes back to 0, so that it does not hold the attention
        bucket up). Returns True when it retired."""
        r = self.active[i]
        for t in toks:
            r.output_ids.append(t)
            if self.on_token is not None:
                self.on_token(r, t)
            self.pos[i] += 1
            full = len(r.output_ids) >= r.max_new_tokens
            hit_eos = r.eos_id is not None and t == r.eos_id
            if full or hit_eos or self.pos[i] >= self.max_seq - 1:
                r.done = True
                self.finished[r.uid] = r
                self.active[i] = None
                self.pos[i] = 0
                return True
        return False

    def step(self) -> int:
        """Admit queued requests into free slots, run one batched decode
        step and retire finished requests. Returns the slots stepped."""
        self._admit()
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        with torch.inference_mode():
            logits, self.cache = decode_step(
                self.params, self._dev(self._cur_tok)[:, None], self.cache,
                self._dev(self.pos), self.cfg, axis_name=self._axis,
                attend_len=self._attend_bucket())
            nxt = sample_rows_samp(logits, self._slot_samp(),
                                   self._gen).cpu().numpy()
        self._steps += 1
        for i in act:
            if not self._commit(i, [int(self._cur_tok[i])]):
                self._cur_tok[i] = nxt[i]
        return len(act)

    def step_window(self, n: int) -> int:
        """``n`` decode steps with no host read in between: each step's
        sampled tokens feed the next as device tensors. Admission and
        retirement happen at window boundaries, so a slot that finishes
        inside the window wastes at most ``n - 1`` steps of throwaway
        tokens. A row's writes stay inside the cache: a step past its last
        position writes there (the JAX package's clamped write), and its
        tokens are never committed."""
        self._admit()
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        samp = self._slot_samp()
        attend = self._attend_bucket(extra=n)
        tok = self._dev(self._cur_tok)
        pos_v = self._dev(self.pos).to(torch.int64)
        emitted = []
        with torch.inference_mode():
            for _ in range(n):
                logits, self.cache = decode_step(
                    self.params, tok[:, None], self.cache,
                    pos_v.clamp(max=self.max_seq - 1), self.cfg,
                    axis_name=self._axis, attend_len=attend)
                emitted.append(tok)
                tok = sample_rows_samp(logits, samp, self._gen)
                pos_v = pos_v + 1
        nxt = tok.cpu().numpy()
        emitted = torch.stack(emitted, dim=1).cpu().numpy()   # [slots, n]
        self._steps += n
        for i in act:
            if not self._commit(i, [int(t) for t in emitted[i]]):
                self._cur_tok[i] = nxt[i]
        return len(act)

    def step_spec(self, k: int = 8) -> int:
        """One speculative verify window across the active slots: each
        slot's pending token and ``k - 1`` drafts from ``draft_fn`` go
        through one ``T = k`` prefill-shaped forward at the slots' own
        positions, and each slot commits 1 to ``k`` tokens. Greedy slots
        stream the plain engine's tokens; temperature > 0 is exact
        speculative sampling per row. Keys of rejected drafts above the
        committed position are overwritten by the next window before any
        query reads them. Near the cache end it falls back to a plain
        step."""
        self._admit()
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        if any(self.pos[i] + k > self.max_seq - 1 for i in act):
            return self.step()
        feed = np.zeros((self.slots, k), np.int32)
        draft = np.zeros((self.slots, k), np.int32)
        for i in act:
            r = self.active[i]
            d = self.draft_fn(
                r.prompt_ids + r.output_ids + [int(self._cur_tok[i])], k)
            draft[i] = d
            feed[i, 0] = self._cur_tok[i]
            feed[i, 1:] = d[:k - 1]
        samp = self._slot_samp()
        with torch.inference_mode():
            logits, self.cache = prefill(
                self.params, self._dev(feed), self.cache, self.cfg,
                pos=self._dev(self.pos).to(torch.int64),
                axis_name=self._axis,
                attend_len=self._attend_bucket(extra=k))
            draft_d = self._dev(draft)
            okk, corr = spec_accept_sample_vec(logits, draft_d, self._gen,
                                               samp[:, 0])
            g, a = spec_window_tokens(okk, corr, draft_d)
        g = g.cpu().numpy()
        a = a.cpu().numpy()
        self._steps += 1
        self._spec_windows += 1
        self._spec_drafted += (k - 1) * len(act)
        self._spec_accepted += int(sum(min(int(a[i]), k - 1) for i in act))
        for i in act:
            # the pending token and a[i] accepted drafts commit; the
            # decision token g[i, a[i]] is the next pending token
            toks = [int(self._cur_tok[i])] + [int(t) for t in
                                              g[i, :int(a[i])]]
            if not self._commit(i, toks):
                self._cur_tok[i] = int(g[i, int(a[i])])
        return len(act)

    def run(self, max_steps: int = 100000, steps_per_dispatch: int = 1,
            spec_k: int = 0) -> Dict[int, Request]:
        """Drive to completion (or ``max_steps`` counted forwards):
        ``spec_k > 0`` runs :meth:`step_spec`, else ``steps_per_dispatch >
        1`` runs :meth:`step_window`."""
        while self.has_work() and self._steps < max_steps:
            if spec_k > 0:
                self.step_spec(spec_k)
            elif steps_per_dispatch > 1:
                self.step_window(steps_per_dispatch)
            else:
                self.step()
        return self.finished

    def stats(self) -> Dict[str, Any]:
        """Engine counters (the keys of the JAX package's
        ``Engine.stats``)."""
        live = sum(1 for r in self.active if r is not None)
        return {
            "steps": self._steps,
            "spec_windows": self._spec_windows,
            "spec_drafted": self._spec_drafted,
            "spec_accepted": self._spec_accepted,
            "spec_accept_rate": (self._spec_accepted / self._spec_drafted
                                 if self._spec_drafted else 0.0),
            "active_slots": live,
            "queued": len(self.queue),
            "finished": len(self.finished),
            "emitted_tokens": sum(len(r.output_ids)
                                  for r in self.finished.values())
            + sum(len(r.output_ids) for r in self.active if r is not None),
        }

    def recover(self) -> int:
        """Requeue every in-flight request with its prompt extended by the
        tokens already generated, and zero the cache (a device error
        leaves its contents untrusted). Greedy re-admission reproduces the
        exact continuation. Returns the number of requests requeued."""
        n = 0
        for i, r in enumerate(self.active):
            if r is None:
                continue
            r.prompt_ids = r.prompt_ids + r.output_ids
            self.queue.appendleft(r)
            self.active[i] = None
            n += 1
        self.pos[:] = 0
        self._cur_tok[:] = 0
        for _, t in named_tensors(self.cache):
            t.zero_()
        return n

    # -- internals ----------------------------------------------------------

    def _resolved_temp(self, r: Optional[Request]) -> float:
        if r is None or r.temperature is None:
            return self._temp
        return r.temperature

    def _resolved_samp(self, r: Optional[Request]):
        """(temperature, top_k, top_p) with the engine's defaults filled
        in."""
        if r is None:
            return (self._temp, float(self._top_k), self._top_p)
        return (self._resolved_temp(r),
                float(self._top_k if r.top_k is None else r.top_k),
                self._top_p if r.top_p is None else r.top_p)

    def _slot_samp(self) -> torch.Tensor:
        """[slots, 3] resolved sampling rows (greedy, no truncation, for
        empty slots)."""
        out = torch.zeros((self.slots, 3), dtype=torch.float32)
        out[:, 2] = 1.0
        for i, r in enumerate(self.active):
            if r is not None:
                out[i] = torch.tensor(self._resolved_samp(r))
        return out

    def _prefill_round(self, ids: np.ndarray, cache: KVCache,
                       starts: np.ndarray, plens: np.ndarray
                       ) -> torch.Tensor:
        """:func:`prefill_round` over ``cache``'s rows (the batch cache or
        a scratch)."""
        return prefill_round(self.params, self.cfg, cache, ids, starts,
                             plens, self.max_seq, self._axis)

    def _sample_first(self, logits: torch.Tensor,
                      samp: torch.Tensor) -> List[int]:
        """Admitted rows' first tokens: one sampling call, after the last
        chunk."""
        with torch.inference_mode():
            return sample_rows_samp(logits, samp, self._gen).cpu().tolist()

    def _admit(self) -> None:
        """Admit queued requests into every free slot: one batched prefill
        per chunk round straight into the batch cache, or, when a live
        slot or a prompt sits within the largest chunk of ``max_seq``,
        :meth:`_admit_scratch`."""
        free = [i for i in range(self.slots) if self.active[i] is None]
        if not free or not self.queue:
            return
        admits = []                       # (slot, request, chunks)
        for slot in free:
            if not self.queue:
                break
            r = self.queue.popleft()      # length checked at submit
            admits.append((slot, r, iter_prefill_chunks(
                len(r.prompt_ids), self.buckets, max_len=self.max_seq)))
        max_blen = max(bl for _, _, c in admits for _, _, bl in c)
        live = [i for i in range(self.slots) if self.active[i] is not None]
        tight = (any(self.pos[i] + max_blen > self.max_seq for i in live)
                 or any(len(r.prompt_ids) + max_blen > self.max_seq
                        for _, r, _ in admits))
        if tight:
            self._admit_scratch(admits)
            return
        final = run_chunk_rounds(
            [(slot, r.prompt_ids, 0, chunks) for slot, r, chunks in admits],
            self.slots, self.pos,
            lambda ids, starts, plens: self._prefill_round(
                ids, self.cache, starts, plens))
        rows = [slot for slot, _, _ in admits]
        samp = torch.stack([torch.tensor(self._resolved_samp(r))
                            for _, r, _ in admits])
        toks = self._sample_first(torch.stack([final[s] for s in rows]),
                                  samp)
        for (slot, r, _), tok in zip(admits, toks):
            self.active[slot] = r
            self.pos[slot] = len(r.prompt_ids)
            self._cur_tok[slot] = tok

    def _admit_scratch(self, admits) -> None:
        """Per-request admission through a one-row scratch cache, copied
        into the slot's row of the batch cache."""
        for slot, r, chunks in admits:
            scratch = KVCache.create(self._cache_cfg, 1, self.max_seq,
                                     self.device)
            logits = None
            for start, take, blen in chunks:
                ids = np.zeros((1, blen), np.int32)
                ids[0, :take] = r.prompt_ids[start:start + take]
                logits = self._prefill_round(ids, scratch,
                                             np.asarray([start]),
                                             np.asarray([take]))
            tok = self._sample_first(
                logits, torch.tensor([self._resolved_samp(r)]))[0]
            for (_, dst), (_, src) in zip(named_tensors(self.cache),
                                          named_tensors(scratch)):
                dst[:, slot] = src[:, 0]
            self.active[slot] = r
            self.pos[slot] = len(r.prompt_ids)
            self._cur_tok[slot] = tok
