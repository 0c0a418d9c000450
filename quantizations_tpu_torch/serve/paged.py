"""Paged KV serving: page pool, block tables and the paged forward
(counterpart of ``quantizations_tpu/serve/paged.py``).

- :class:`PagedKVCache`: the device pool ``[L, P, KVH, page, D]`` (bf16,
  or int8 codes with bf16 steps ``[L, P, KVH, page]``), updated in place.
- :class:`PageAllocator`: the host's refcounted free list; page 0 is the
  junk page that unused block-table entries and empty slots point at.
- :func:`paged_decode_step` (``T = 1``) and :func:`paged_verify_step`
  (a speculative verify window of ``T <= page_size`` tokens): one indexed
  write per layer of every row's new K/V rows, then K3 (K4 for an int8
  pool) through the block table with ``q_span = T``.
- :func:`insert_prefill`: scatter a slot-layout scratch prefill into
  pages (prefill itself is the dense path of ``models/llama.py``).
- :class:`PagedEngine`: continuous batching over the pool with batched
  admission, a prefix cache, OOM rollback, multi-step windows and
  speculative decoding (``step_spec``, ``step_spec_multi``).

``mesh=`` is not ported; it raises.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import (
    KVCache,
    LlamaConfig,
    LlamaParams,
    _kv_rows,
    _layer_forward,
    embed_tokens,
    layer_params,
    layer_window,
    lm_head_logits,
    rope_cos_sin,
)
from ..ops.paged_attention import (
    paged_flash_decode_attention,
    paged_flash_decode_attention_i8,
)
from .engine import (
    Request,
    clamp_buckets,
    draft_lookup_host,
    iter_prefill_chunks,
    prefill_round,
    run_chunk_rounds,
    sample_rows_samp,
)
from .speculative import (
    append_window,
    draft_prompt_lookup,
    spec_accept_sample_vec,
    spec_window_tokens,
)

__all__ = ["PagedKVCache", "PageAllocator", "PagedEngine",
           "paged_decode_step", "paged_verify_step", "insert_prefill"]


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (quantizations_tpu/serve/{where}) is not ported")


@dataclasses.dataclass
class PagedKVCache:
    """Device page pool. Page ``p`` of layer ``l`` holds ``page_size``
    consecutive positions of whichever sequence owns it. An int8 pool
    (``kv_cache_dtype="int8"``) carries bf16 dequant-step pages beside the
    code pages. Updated in place."""

    pages_k: torch.Tensor   # [L, P, KVH, page, D]
    pages_v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None   # [L, P, KVH, page] bf16
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: LlamaConfig, num_pages: int, page_size: int = 128,
               device: Union[str, torch.device] = "cuda") -> "PagedKVCache":
        dev = resolve_device(device)
        shape = (cfg.num_hidden_layers, num_pages, cfg.num_key_value_heads,
                 page_size, cfg.head_dim)
        if cfg.kv_cache_dtype == "int8":
            return cls(pages_k=torch.zeros(shape, dtype=torch.int8,
                                           device=dev),
                       pages_v=torch.zeros(shape, dtype=torch.int8,
                                           device=dev),
                       k_scale=torch.zeros(shape[:4], dtype=torch.bfloat16,
                                           device=dev),
                       v_scale=torch.zeros(shape[:4], dtype=torch.bfloat16,
                                           device=dev))
        return cls(pages_k=torch.zeros(shape, dtype=torch.bfloat16,
                                       device=dev),
                   pages_v=torch.zeros(shape, dtype=torch.bfloat16,
                                       device=dev))

    @property
    def page_size(self) -> int:
        return self.pages_k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.pages_k.shape[1]

    def tensors(self) -> List[torch.Tensor]:
        return [t for t in (self.pages_k, self.pages_v, self.k_scale,
                            self.v_scale) if t is not None]


class _AdmitOOM(Exception):
    """Pool exhausted while finishing a batched admission; ``row`` is the
    first group row that could not be completed (rows before it were
    fully admitted)."""

    def __init__(self, row: int):
        super().__init__(f"pool exhausted at admission row {row}")
        self.row = row


class PageAllocator:
    """Host-side refcounted page free list. Page 0 is reserved as the junk
    page. A page shared by several sequences (or pinned by the prefix
    cache) returns to the free list only when its last holder frees
    it."""

    def __init__(self, num_pages: int):
        self.num_usable = num_pages - 1   # page 0 is the junk page
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: dict = {}

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV pool exhausted: need {n}, free {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def retain(self, page: int) -> None:
        """Add a holder to an allocated page (prefix-cache sharing)."""
        self._refs[page] += 1

    def refs(self, page: int) -> int:
        return self._refs.get(page, 0)

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == 0:
                continue
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)

    @property
    def available(self) -> int:
        return len(self._free)


def write_window(pages: PagedKVCache, idx: int, page_of: torch.Tensor,
                 off: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write layer ``idx``'s new K/V rows ``k, v [B, T, KVH, D]`` into the
    pool at (``page_of[b, t]``, ``off[b, t]``) with one indexed assignment
    per plane; an int8 pool quantizes all ``T`` rows on write. A window of
    ``T <= page_size`` rows lies in at most two pages (the JAX package
    writes it as two slabs, ``paged.py:151 _write_row_window``: the same
    values land at the same places). Rows of empty slots write to the
    junk page 0; duplicate writes there are harmless, since no live row
    attends page 0."""
    int8 = pages.k_scale is not None
    kn, vn, ks, vs = _kv_rows(k, v, int8, pages.pages_k.dtype)
    pages.pages_k[idx][page_of, :, off] = kn
    pages.pages_v[idx][page_of, :, off] = vn
    if int8:
        pages.k_scale[idx][page_of, :, off] = ks
        pages.v_scale[idx][page_of, :, off] = vs


def _paged_attend(pages: PagedKVCache, idx: int, table: torch.Tensor,
                  page_of: torch.Tensor, off: torch.Tensor,
                  lengths: torch.Tensor, cfg: LlamaConfig):
    """Attention of layer ``idx`` over the pool: :func:`write_window`,
    then K3/K4 through ``table [B, max_pages]`` with the ``T`` query
    positions packed position-major (row ``t*G + g`` is position
    ``pos + t``, grouped head ``g``) and masked causally inside the
    window."""
    int8 = pages.k_scale is not None
    _, win_eff = layer_window(cfg, idx)

    def attend(q, k, v):
        B, T, n_q, D = q.shape
        n_kv = k.shape[2]
        G = n_q // n_kv
        write_window(pages, idx, page_of, off, k, v)
        qs = q.reshape(B, T, n_kv, G, D).transpose(1, 2).reshape(
            B, n_kv, T * G, D)
        common = dict(scale=(cfg.query_scale or D) ** -0.5,
                      softcap=cfg.attn_logit_softcap, window=win_eff,
                      q_span=T, pages_per_step=cfg.paged_pages_per_step)
        if int8:
            attn = paged_flash_decode_attention_i8(
                qs, pages.pages_k, pages.pages_v, pages.k_scale,
                pages.v_scale, table, idx, lengths, **common)
        else:
            attn = paged_flash_decode_attention(
                qs, pages.pages_k, pages.pages_v, table, idx, lengths,
                **common)
        return attn.reshape(B, n_kv, T, G, D).transpose(1, 2).reshape(
            B * T, n_q * D)

    return attend


# K3/K4 take at most this many query rows (q_span x G) per kv head
MAX_QUERY_ROWS = 32


def check_window(cfg: LlamaConfig, T: int, page_size: int,
                 device: torch.device) -> None:
    """Raise ``ValueError`` for a window the paged forward cannot take:
    longer than a page (the JAX package refuses it too), or, on the card,
    more than :data:`MAX_QUERY_ROWS` query rows per kv head for K3/K4
    (``T * G``; at Llama3-8B's G = 4, ``T <= 8``)."""
    if T > page_size:
        raise ValueError(f"verify window {T} exceeds page_size {page_size}")
    G = cfg.num_attention_heads // cfg.num_key_value_heads
    if device.type == "cuda" and T * G > MAX_QUERY_ROWS:
        raise ValueError(
            f"verify window {T} x {G} query heads per kv head is "
            f"{T * G} query rows; K3/K4 take at most {MAX_QUERY_ROWS}")


def _paged_forward(params: LlamaParams, token_ids: torch.Tensor,
                   pages: PagedKVCache, block_table: torch.Tensor,
                   pos: torch.Tensor, cfg: LlamaConfig, max_pages: int
                   ) -> Tuple[torch.Tensor, PagedKVCache]:
    """The paged forward of ``T`` tokens per row (decode at ``T = 1``, a
    verify window above): row ``b``'s token ``t`` sits at position
    ``pos[b] + t``, written at (page ``block_table[b, (pos + t) // page]``,
    offset ``(pos + t) % page``); attention covers the first ``max_pages``
    table entries with ``lengths = pos + 1`` and ``q_span = T``. A
    position past the table (an empty slot's stale position) reads its
    last entry. Raises ``ValueError`` before any launch for a window
    :func:`check_window` refuses. Returns (logits [B, T, vocab], pages),
    the pool updated in place."""
    B, T = token_ids.shape
    dev = token_ids.device
    psz = pages.page_size
    check_window(cfg, T, psz, dev)
    pos = pos.to(dev, torch.int64).reshape(B)
    positions = pos[:, None] + torch.arange(T, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    table = block_table.to(dev, torch.int32)
    page_of = table.long().gather(
        1, (positions // psz).clamp(max=table.shape[1] - 1))
    off = positions % psz
    lengths = (pos + 1).to(torch.int32)
    attn_table = table[:, :max_pages].contiguous()
    x = embed_tokens(params, token_ids, cfg)
    for i in range(cfg.num_hidden_layers):
        attend = _paged_attend(pages, i, attn_table, page_of, off, lengths,
                               cfg)
        x = _layer_forward(x, layer_params(params.layers, i), cos, sin, cfg,
                           i, attend)
    return lm_head_logits(params, x, cfg), pages


def paged_decode_step(params: LlamaParams, token_ids: torch.Tensor,
                      pages: PagedKVCache, block_table: torch.Tensor,
                      pos: torch.Tensor, cfg: LlamaConfig, max_pages: int
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One ``T = 1`` decode step over the paged pool (see
    :func:`_paged_forward`). Returns (logits [B, vocab], pages)."""
    with torch.inference_mode():
        logits, pages = _paged_forward(params, token_ids, pages, block_table,
                                       pos, cfg, max_pages)
    return logits[:, 0], pages


def paged_verify_step(params: LlamaParams, token_ids: torch.Tensor,
                      pages: PagedKVCache, block_table: torch.Tensor,
                      pos: torch.Tensor, cfg: LlamaConfig, max_pages: int
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """A speculative verify window over the pool: ``token_ids [B, K]``
    (the pending token and ``K - 1`` drafts) written at ``pos .. pos +
    K - 1`` and attended in one forward. Keys of rejected drafts above the
    committed position are overwritten by the next window before any
    query attends them. Returns (logits [B, K, vocab], pages)."""
    with torch.inference_mode():
        return _paged_forward(params, token_ids, pages, block_table, pos,
                              cfg, max_pages)


def _paged_spec(params: LlamaParams, feed: torch.Tensor, pages: PagedKVCache,
                block_table: torch.Tensor, pos: torch.Tensor,
                draft: torch.Tensor, samp: torch.Tensor,
                generator: Optional[torch.Generator], cfg: LlamaConfig,
                max_pages: int):
    """A verify window and its accept step: (g [B, K] window tokens, a [B]
    accepted drafts, pages). ``samp [B, 3]`` is the host sampling matrix;
    acceptance reads its temperatures only (exact speculative sampling is
    defined against the untruncated distribution)."""
    with torch.inference_mode():
        logits, pages = _paged_forward(params, feed, pages, block_table, pos,
                                       cfg, max_pages)
        okk, corr = spec_accept_sample_vec(logits, draft, generator,
                                           samp[:, 0])
        g, a = spec_window_tokens(okk, corr, draft)
    return g, a, pages


def _paged_spec_multi(params: LlamaParams, pending: torch.Tensor,
                      pages: PagedKVCache, block_table: torch.Tensor,
                      pos: torch.Tensor, hist: torch.Tensor,
                      hcnt: torch.Tensor, samp: torch.Tensor,
                      generator: Optional[torch.Generator], cfg: LlamaConfig,
                      max_pages: int, n: int, k: int):
    """``n`` verify windows with no host read in between: each window's
    drafts come from :func:`draft_prompt_lookup` over the per-slot history
    ``hist [B, H]`` (prompt, outputs and the pending token; ``hcnt [B]``
    its valid length), which takes each window's accepted tokens and new
    pending token. Returns (g [n, B, k], a [n, B], pages); the host walks
    the windows in order. Rows that finish inside the dispatch overshoot
    into their own pages."""
    pending = pending.to(torch.int32)
    pos_v = pos.to(pending.device, torch.int64)
    hist = hist.clone()
    hcnt = hcnt.to(pending.device, torch.int64)
    gs, accs = [], []
    with torch.inference_mode():
        for _ in range(n):
            draft = draft_prompt_lookup(hist, hcnt, k)
            feed = torch.cat([pending[:, None], draft[:, :k - 1]], dim=1)
            g, a, pages = _paged_spec(params, feed, pages, block_table,
                                      pos_v, draft, samp, generator, cfg,
                                      max_pages)
            append_window(hist, hcnt, g, a + 1)
            pending = g.gather(1, a[:, None])[:, 0]
            pos_v = pos_v + a + 1
            hcnt = hcnt + a + 1
            gs.append(g)
            accs.append(a)
    return torch.stack(gs), torch.stack(accs), pages


def _paged_multi(params: LlamaParams, tokens: torch.Tensor,
                 pages: PagedKVCache, block_table: torch.Tensor,
                 pos: torch.Tensor, samp: torch.Tensor,
                 generator: Optional[torch.Generator], cfg: LlamaConfig,
                 max_pages: int, n: int):
    """``n`` decode steps over the pool with no host read in between:
    each step's sampled tokens feed the next as device tensors. Emitted
    column ``j`` is the token fed INTO step ``j``; the final tokens are
    the next pending token per slot. Pages for positions
    ``pos .. pos + n - 1`` must be in ``block_table``. Returns
    (next [B], emitted [B, n], pages)."""
    tok = tokens
    pos_v = pos.to(tokens.device, torch.int64)
    emitted = []
    with torch.inference_mode():
        for _ in range(n):
            logits, pages = _paged_forward(params, tok[:, None], pages,
                                           block_table, pos_v, cfg,
                                           max_pages)
            nxt = sample_rows_samp(logits[:, 0], samp, generator)
            emitted.append(tok)
            tok = nxt
            pos_v = pos_v + 1
    return tok, torch.stack(emitted, dim=1), pages


def _scatter_page(pages: PagedKVCache, scratch: KVCache, src_start: int,
                  page_id: int, row: int = 0) -> PagedKVCache:
    """Copy scratch positions ``[src_start, src_start + page)`` of slot
    ``row`` into pool page ``page_id`` (a whole page; positions past the
    prompt are garbage that ``lengths`` masks). The scratch ``max_seq``
    is a multiple of the page size."""
    psz = pages.page_size
    sl = slice(src_start, src_start + psz)
    pages.pages_k[:, page_id] = scratch.k[:, row, :, sl]
    pages.pages_v[:, page_id] = scratch.v[:, row, :, sl]
    if pages.k_scale is not None:
        pages.k_scale[:, page_id] = scratch.k_scale[:, row, :, sl]
        pages.v_scale[:, page_id] = scratch.v_scale[:, row, :, sl]
    return pages


def insert_prefill(pages: PagedKVCache, scratch: KVCache,
                   page_ids: List[int], plen: int, start_page: int = 0,
                   row: int = 0) -> PagedKVCache:
    """Scatter a slot-layout scratch prefill (slot ``row``, positions
    ``[0, plen)``) into ``page_ids``, skipping the first ``start_page``
    pages (prefix-cache hits already in the pool)."""
    psz = pages.page_size
    need = -(-plen // psz)
    if len(page_ids) < need:
        raise ValueError(f"{len(page_ids)} pages for {plen} positions "
                         f"(need {need})")
    for j in range(start_page, need):
        pages = _scatter_page(pages, scratch, j * psz, page_ids[j], row)
    return pages


def _gather_page(scratch: KVCache, pages: PagedKVCache, dst_start: int,
                 page_id: int, row: int = 0) -> KVCache:
    """Copy pool page ``page_id`` into scratch positions ``[dst_start,
    dst_start + page)`` of slot ``row``: the inverse of
    :func:`_scatter_page`, seeding a prefill scratch with prefix-cache
    hits."""
    psz = pages.page_size
    sl = slice(dst_start, dst_start + psz)
    scratch.k[:, row, :, sl] = pages.pages_k[:, page_id].to(scratch.k.dtype)
    scratch.v[:, row, :, sl] = pages.pages_v[:, page_id].to(scratch.v.dtype)
    if pages.k_scale is not None:
        scratch.k_scale[:, row, :, sl] = pages.k_scale[:, page_id]
        scratch.v_scale[:, row, :, sl] = pages.v_scale[:, page_id]
    return scratch


class PagedEngine:
    """Continuous batching over the paged pool: slots hold sequence state
    (block-table rows); KV memory is allocated page by page as sequences
    grow and freed when they finish. Sampling is per request through a
    ``[slots, 3]`` (temperature, top_k, top_p) host matrix; the engine's
    ``temperature``/``top_k``/``top_p`` are defaults for requests that
    leave theirs unset.

    Admission prefills through the dense chunked path into a scratch slot
    cache (groups of up to ``admit_width`` requests share one prefill per
    chunk round), scatters it into freshly allocated pages, then decode
    runs :func:`paged_decode_step` (or verify windows: :meth:`step_spec`,
    :meth:`step_spec_multi`) over the batched block table. The engine
    runs on its parameters' device."""

    def __init__(self, params: LlamaParams, cfg: LlamaConfig, *,
                 num_pages: int, page_size: Optional[int] = None,
                 slots: int = 4, max_seq: int = 2048,
                 prefill_buckets=(64, 256), temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 prefix_cache: bool = False, admit_width: int = 4,
                 mesh=None):
        if mesh is not None:
            raise _not_ported("PagedEngine(mesh=...)",
                              "paged.py:735 the tensor-parallel pool")
        if page_size is None:
            page_size = next((p for p in (384, 256, 128, 64, 32, 16, 8)
                              if max_seq % p == 0), 0)
        if not page_size or max_seq % page_size:
            raise ValueError("max_seq must be a multiple of page_size")
        self.params = params
        self.cfg = cfg
        self.device = params.final_norm.device
        self.page_size = page_size
        self.max_seq = max_seq
        self.slots = slots
        self.max_pages = max_seq // page_size
        self.pages = PagedKVCache.create(cfg, num_pages, page_size,
                                         device=self.device)
        self.alloc = PageAllocator(num_pages)
        self.table = np.zeros((slots, self.max_pages), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(slots)]
        self.pos = np.zeros(slots, np.int32)
        self._cur = np.zeros(slots, np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue = deque()
        self.finished = {}
        self.on_token = None   # optional callable(Request, token_id)
        # speculative drafter: (history tokens, k) -> k draft ids; the
        # on-device drafting of step_spec_multi does not use it
        self.draft_fn = draft_lookup_host
        self._uid = 0
        self._buckets = clamp_buckets(prefill_buckets, max_seq)
        self._temp = temperature
        # prefix cache: token prefix ending at each full page boundary ->
        # pool page id, LRU-ordered; each entry pins its page with one
        # allocator ref and is evicted (oldest first, only when no live
        # sequence shares it) when the pool runs dry
        self._prefix = OrderedDict() if prefix_cache else None
        self._admit_width = max(1, admit_width)
        self._top_k, self._top_p = top_k, top_p
        self._steps = 0
        self._spec_windows = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    # -- requests and sampling rows ------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> int:
        if len(prompt_ids) + max_new_tokens >= self.max_seq:
            raise ValueError(
                f"request needs {len(prompt_ids)} + {max_new_tokens} "
                f"positions but max_seq is {self.max_seq}")
        # an impossible request is rejected here: admitted, it would
        # block the head of the queue forever (the OOM rollback requeues
        # it at the front every step)
        need = -(-(len(prompt_ids) + max_new_tokens) // self.page_size)
        usable = self.alloc.num_usable
        if need > usable:
            raise ValueError(
                f"request needs {need} pages to complete but the pool "
                f"only has {usable} usable pages")
        self._uid += 1
        self.queue.append(Request(
            uid=self._uid, prompt_ids=list(map(int, prompt_ids)),
            max_new_tokens=max_new_tokens, eos_id=eos_id,
            temperature=temperature, top_k=top_k, top_p=top_p))
        return self._uid

    def _rtemp(self, r) -> float:
        if r is None:
            return 0.0
        return self._temp if r.temperature is None else r.temperature

    def _rsamp(self, r):
        """Resolved (temperature, top_k, top_p) of a request."""
        if r is None:
            return (0.0, 0.0, 1.0)
        return (self._rtemp(r),
                float(self._top_k if r.top_k is None else r.top_k),
                self._top_p if r.top_p is None else r.top_p)

    def _slot_samp(self) -> torch.Tensor:
        """[slots, 3] resolved sampling rows (greedy for empty slots)."""
        return torch.tensor([self._rsamp(r) for r in self.active],
                            dtype=torch.float32)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- pages ---------------------------------------------------------

    def _mk_scratch(self, rows: int) -> KVCache:
        return KVCache.create(self.cfg, rows, self.max_seq, self.device)

    def _alloc_pages(self, n: int) -> List[int]:
        """Allocate, evicting prefix-cache pages (LRU, unshared only) when
        the pool is dry."""
        while True:
            try:
                return self.alloc.alloc(n)
            except MemoryError:
                if not self._evict_one():
                    raise

    def _evict_one(self) -> bool:
        if not self._prefix:
            return False
        for k, pg in self._prefix.items():    # oldest first
            if self.alloc.refs(pg) == 1:      # only the cache holds it
                del self._prefix[k]
                self.alloc.free([pg])
                return True
        return False

    def _ensure_pages(self, slot: int, upto: int) -> None:
        """Grow the slot's page list to cover positions [0, upto)."""
        need = -(-upto // self.page_size)
        while len(self.owned[slot]) < need:
            pg = self._alloc_pages(1)[0]
            self.table[slot, len(self.owned[slot])] = pg
            self.owned[slot].append(pg)

    def _prefix_lookup(self, r):
        """(cov, shared pages): the longest run of full prompt pages
        already in the pool, capped at plen - 1 so that at least one
        suffix token is prefilled (its logits give the first token)."""
        psz = self.page_size
        plen = len(r.prompt_ids)
        cov, shared = 0, []
        if self._prefix is not None:
            for j in range((plen - 1) // psz):
                k = tuple(r.prompt_ids[:(j + 1) * psz])
                pg = self._prefix.get(k)
                if pg is None:
                    break
                self._prefix.move_to_end(k)   # LRU touch
                shared.append(pg)
                cov = (j + 1) * psz
        return cov, shared

    def _attach_shared(self, slot, shared, scratch, row=0):
        """Point the slot at the shared pages and seed scratch row ``row``
        with their K/V so that the suffix prefill attends them."""
        psz = self.page_size
        for j, pg in enumerate(shared):
            self.alloc.retain(pg)
            self.table[slot, j] = pg
            self.owned[slot].append(pg)
            scratch = _gather_page(scratch, self.pages, j * psz, pg, row)
        return scratch

    def _finish_admit(self, slot, r, tok, n_shared, scratch, row=0):
        """Scatter the suffix pages, register prefix pages, activate."""
        plen = len(r.prompt_ids)
        psz = self.page_size
        self._ensure_pages(slot, plen + 1)
        self.pages = insert_prefill(self.pages, scratch, self.owned[slot],
                                    plen, start_page=n_shared, row=row)
        if self._prefix is not None:
            for j in range(plen // psz):
                k = tuple(r.prompt_ids[:(j + 1) * psz])
                if k not in self._prefix:
                    pg = int(self.table[slot, j])
                    self.alloc.retain(pg)   # cache pin
                    self._prefix[k] = pg
        self.active[slot] = r
        self.pos[slot] = plen
        self._cur[slot] = tok

    # -- admission -----------------------------------------------------

    def _admit(self) -> None:
        """Admit queued requests into free slots, in groups of up to
        ``admit_width`` prefilled together (one prefill per chunk round).
        A group falls back to one request at a time when a row's garbage
        round would run past the scratch end, or when the pool cannot
        cover it.

        If the pool runs dry mid-admission, the failed request and any
        not yet attempted go back to the queue front with their pages
        released; they retry as live sequences retire. MemoryError only
        when nothing is active (no request could ever be satisfied)."""
        pairs = []
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            pairs.append((slot, self.queue.popleft()))
        if not pairs:
            return
        W = self._admit_width
        failed = []   # (slot, request) rolled back, queue order
        for g in range(0, len(pairs), W):
            group = pairs[g:g + W]
            if failed:                  # pool already dry: don't try
                failed.extend(group)
                continue
            max_blen = self._buckets[-1]
            tight = any(len(r.prompt_ids) + max_blen > self.max_seq
                        for _, r in group)
            short = any(self._pages_short(r, self._prefix_lookup(r)[1])
                        for _, r in group)
            if len(group) == 1 or tight or short:
                for slot, r in group:
                    if failed:
                        failed.append((slot, r))
                        continue
                    try:
                        self._admit_one(slot, r)
                    except MemoryError:
                        self._rollback(slot)
                        failed.append((slot, r))
            else:
                try:
                    self._admit_group(group)
                except _AdmitOOM as e:
                    for slot, r in group[e.row:]:
                        self._rollback(slot)
                        failed.append((slot, r))
        if failed:
            self.queue.extendleft(r for _, r in reversed(failed))
            if not any(r is not None for r in self.active):
                raise MemoryError(
                    "paged KV pool too small for any queued request "
                    f"(free pages {self.alloc.available})")

    def _pages_short(self, r, shared) -> bool:
        """True when the pool cannot cover this admission now (fresh pages
        beyond the free and evictable ones), checked before any prefill."""
        need = (-(-(len(r.prompt_ids) + 1) // self.page_size)
                - len(shared))
        evictable = 0
        if self._prefix:
            sh = set(shared)
            evictable = sum(1 for pg in self._prefix.values()
                            if self.alloc.refs(pg) == 1 and pg not in sh)
        return need > self.alloc.available + evictable

    def _rollback(self, slot: int) -> None:
        """Undo a partial admission: release every page the slot holds
        (shared-page retains and fresh pages alike: one ``free`` per
        ``owned`` entry) and clear its block-table row."""
        self.alloc.free(self.owned[slot])
        self.owned[slot] = []
        self.table[slot, :] = 0

    def _prefill_round(self, ids: np.ndarray, scratch: KVCache,
                       starts: np.ndarray, plens: np.ndarray
                       ) -> torch.Tensor:
        """:func:`prefill_round` over the scratch rows."""
        return prefill_round(self.params, self.cfg, scratch, ids, starts,
                             plens, self.max_seq)

    def _sample_first(self, logits: torch.Tensor,
                      samp: torch.Tensor) -> np.ndarray:
        """Each admitted row's first token from its final chunk's logits:
        one sampling call per admission, after its last chunk (as the
        reference samples), tokens on the host."""
        with torch.inference_mode():
            return sample_rows_samp(logits, samp, self._gen).cpu().numpy()

    def _admit_one(self, slot, r) -> None:
        plen = len(r.prompt_ids)
        cov, shared = self._prefix_lookup(r)
        if self._pages_short(r, shared):
            raise MemoryError(f"pool cannot cover admission of uid {r.uid}")
        scratch = self._mk_scratch(1)
        scratch = self._attach_shared(slot, shared, scratch)
        logits = None
        for start, take, blen in iter_prefill_chunks(
                plen - cov, self._buckets, max_len=self.max_seq, base=cov):
            ids = np.zeros((1, blen), np.int32)
            ids[0, :take] = r.prompt_ids[cov + start:cov + start + take]
            logits = self._prefill_round(ids, scratch,
                                         np.asarray([cov + start]),
                                         np.asarray([take]))
        samp = torch.tensor([self._rsamp(r)], dtype=torch.float32)
        tok = self._sample_first(logits, samp)
        self._finish_admit(slot, r, int(tok[0]), len(shared), scratch)

    def _admit_group(self, group) -> None:
        """Batched admission: one prefill per chunk round across the
        group's scratch rows (:func:`run_chunk_rounds`); rows out of
        chunks write garbage at ``[plen, plen + blen)`` of their own
        scratch row, which is never scattered or attended."""
        W = self._admit_width
        scratch = self._mk_scratch(W)
        n_shared, entries = [], []
        for row, (slot, r) in enumerate(group):
            cov, shared = self._prefix_lookup(r)
            scratch = self._attach_shared(slot, shared, scratch, row=row)
            n_shared.append(len(shared))
            entries.append((row, r.prompt_ids, cov, iter_prefill_chunks(
                len(r.prompt_ids) - cov, self._buckets,
                max_len=self.max_seq, base=cov)))
        samp = torch.zeros((W, 3), dtype=torch.float32)
        samp[:, 2] = 1.0
        for row, (slot, r) in enumerate(group):
            samp[row] = torch.tensor(self._rsamp(r))
        def dispatch(ids, starts, plens):
            return self._prefill_round(ids, scratch, starts, plens)

        # each row's logits from its final real round, sampled once after
        # the last round (the rounds themselves sample nothing)
        final = run_chunk_rounds(entries, W, np.zeros(W, np.int32), dispatch)
        rows = sorted(final)
        toks = dict(zip(rows, self._sample_first(
            torch.stack([final[row] for row in rows]), samp[rows]).tolist()))
        for row, (slot, r) in enumerate(group):
            try:
                self._finish_admit(slot, r, toks[row], n_shared[row],
                                   scratch, row=row)
            except MemoryError:
                raise _AdmitOOM(row) from None

    # -- decode --------------------------------------------------------

    def _attend_pages(self, act, ahead: int) -> int:
        """Pages the attention covers: the live maximum rounded up to a
        power of two, at most ``max_pages``."""
        live = int(np.max(((self.pos[act] + ahead - 1) // self.page_size)
                          + 1))
        mp = 1
        while mp < live:
            mp *= 2
        return min(mp, self.max_pages)

    def _retire(self, i: int, r: Request) -> None:
        r.done = True
        self.finished[r.uid] = r
        self.active[i] = None
        self.alloc.free(self.owned[i])
        self.owned[i] = []
        self.table[i, :] = 0

    def step(self) -> int:
        self._admit()
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        for i in act:
            self._ensure_pages(i, int(self.pos[i]) + 1)
        mp = self._attend_pages(act, 1)
        logits, self.pages = paged_decode_step(
            self.params, self._dev(self._cur)[:, None], self.pages,
            self._dev(self.table), self._dev(self.pos), self.cfg, mp)
        nxt = sample_rows_samp(logits, self._slot_samp(),
                               self._gen).cpu().numpy()
        self._steps += 1
        for i in act:
            if not self._commit(i, [int(self._cur[i])]):
                self._cur[i] = nxt[i]
        return len(act)

    def step_window(self, n: int) -> int:
        """``n`` decode steps with no host read in between: admission and
        retirement happen at window boundaries, so a slot that finishes
        inside the window wastes at most ``n - 1`` steps of throwaway
        tokens, written into its own pages and freed at retirement. Near
        the sequence end it falls back to a plain step."""
        self._admit()
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        if any(self.pos[i] + n > self.max_seq - 1 for i in act):
            return self.step()
        for i in act:
            self._ensure_pages(i, int(self.pos[i]) + n)
        mp = self._attend_pages(act, n)
        nxt, emitted, self.pages = _paged_multi(
            self.params, self._dev(self._cur), self.pages,
            self._dev(self.table), self._dev(self.pos), self._slot_samp(),
            self._gen, self.cfg, mp, n)
        nxt = nxt.cpu().numpy()
        emitted = emitted.cpu().numpy()    # [slots, n]
        self._steps += n
        for i in act:
            if not self._commit(i, [int(t) for t in emitted[i]]):
                self._cur[i] = int(nxt[i])
        return len(act)

    def _commit(self, i: int, toks) -> bool:
        """Append ``toks`` to slot ``i``'s request one at a time, retiring
        it at its length, its eos or the cache end. Returns True when it
        retired."""
        r = self.active[i]
        for t in toks:
            r.output_ids.append(t)
            if self.on_token is not None:
                self.on_token(r, t)
            self.pos[i] += 1
            full = len(r.output_ids) >= r.max_new_tokens
            hit_eos = r.eos_id is not None and t == r.eos_id
            if full or hit_eos or self.pos[i] >= self.max_seq - 1:
                self._retire(i, r)
                return True
        return False

    def step_spec(self, k: int = 8) -> int:
        """One speculative verify window across the pool: each slot's
        pending token and ``k - 1`` drafts from ``draft_fn`` go through
        one :func:`paged_verify_step`-shaped forward, and each slot
        commits 1 to ``k`` tokens. Greedy slots stream the tokens of the
        plain step. Near the sequence end it falls back to a plain step."""
        check_window(self.cfg, k, self.page_size, self.device)
        self._admit()
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        if any(self.pos[i] + k > self.max_seq - 1 for i in act):
            return self.step()
        for i in act:
            self._ensure_pages(i, int(self.pos[i]) + k)
        feed = np.zeros((self.slots, k), np.int32)
        draft = np.zeros((self.slots, k), np.int32)
        for i in act:
            r = self.active[i]
            d = self.draft_fn(r.prompt_ids + r.output_ids + [int(self._cur[i])],
                              k)
            draft[i] = d
            feed[i, 0] = self._cur[i]
            feed[i, 1:] = d[:k - 1]
        mp = self._attend_pages(act, k)
        g, a, self.pages = _paged_spec(
            self.params, self._dev(feed), self.pages, self._dev(self.table),
            self._dev(self.pos), self._dev(draft), self._slot_samp(),
            self._gen, self.cfg, mp)
        g = g.cpu().numpy()
        a = a.cpu().numpy()
        self._steps += 1
        self._spec_windows += 1
        self._spec_drafted += (k - 1) * len(act)
        self._spec_accepted += int(sum(min(int(a[i]), k - 1) for i in act))
        for i in act:
            toks = [int(self._cur[i])] + [int(t) for t in g[i, :int(a[i])]]
            if not self._commit(i, toks):
                self._cur[i] = int(g[i, int(a[i])])
        return len(act)

    def step_spec_multi(self, k: int, n: int) -> int:
        """``n`` speculative verify windows with no host read in between
        (``spec_k`` x ``steps_per_dispatch``): the drafts come from the
        device's bigram rule over each slot's history, so window ``j + 1``
        drafts from window ``j``'s tokens; the host walks the windows
        afterwards. Near the sequence end it falls back to
        :meth:`step_spec` (and that to a plain step)."""
        check_window(self.cfg, k, self.page_size, self.device)
        self._admit()
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        if any(self.pos[i] + n * k > self.max_seq - 1 for i in act):
            return self.step_spec(k)
        for i in act:
            self._ensure_pages(i, int(self.pos[i]) + n * k)
        H = self.max_seq + k + 2
        hist = np.zeros((self.slots, H), np.int32)
        hcnt = np.full(self.slots, 2, np.int32)
        pending = np.zeros(self.slots, np.int32)
        for i in act:
            r = self.active[i]
            h = r.prompt_ids + r.output_ids + [int(self._cur[i])]
            hist[i, :len(h)] = h
            hcnt[i] = len(h)
            pending[i] = self._cur[i]
        mp = self._attend_pages(act, n * k)
        gs, accs, self.pages = _paged_spec_multi(
            self.params, self._dev(pending), self.pages,
            self._dev(self.table), self._dev(self.pos), self._dev(hist),
            self._dev(hcnt), self._slot_samp(), self._gen, self.cfg, mp, n, k)
        gs = gs.cpu().numpy()            # [n, slots, k]
        accs = accs.cpu().numpy()        # [n, slots]
        self._steps += n
        self._spec_windows += n
        for i in act:
            cur = int(self._cur[i])
            for j in range(n):
                # drafted and accepted count the windows a slot walks: a
                # slot that finishes mid-dispatch drafts no more
                self._spec_drafted += k - 1
                a = int(accs[j, i])
                self._spec_accepted += min(a, k - 1)
                if self._commit(i, [cur] + [int(t) for t in gs[j, i, :a]]):
                    break
                cur = int(gs[j, i, a])
            else:
                self._cur[i] = cur
        return len(act)

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    def stats(self) -> dict:
        """Engine counters and page-pool occupancy (the keys of the JAX
        package's ``PagedEngine.stats``)."""
        live = [i for i, r in enumerate(self.active) if r is not None]
        return {
            "steps": self._steps,
            "spec_windows": self._spec_windows,
            "spec_drafted": self._spec_drafted,
            "spec_accepted": self._spec_accepted,
            "spec_accept_rate": (self._spec_accepted / self._spec_drafted
                                 if self._spec_drafted else 0.0),
            "active_slots": len(live),
            "queued": len(self.queue),
            "finished": len(self.finished),
            "emitted_tokens": sum(len(r.output_ids)
                                  for r in self.finished.values())
            + sum(len(r.output_ids) for r in self.active if r is not None),
            "pages_total": self.pages.num_pages,
            "pages_free": self.alloc.available,
            "prefix_cache_pages": (0 if self._prefix is None
                                   else len(self._prefix)),
            "live_tokens": int(self.pos[live].sum()) if live else 0,
        }

    def recover(self) -> int:
        """Requeue every in-flight request with its prompt extended by the
        tokens already generated, release all pages, reset the allocator,
        tables and prefix cache, and zero the pool (a device error leaves
        its contents untrusted). Greedy re-admission reproduces the exact
        continuation. Returns the number of requests requeued."""
        n = 0
        for i, r in enumerate(self.active):
            if r is None:
                continue
            r.prompt_ids = r.prompt_ids + r.output_ids
            self.queue.appendleft(r)
            self.active[i] = None
            n += 1
        for i in range(self.slots):
            self.owned[i] = []
        self.table[:, :] = 0
        self.pos[:] = 0
        self._cur[:] = 0
        self.alloc = PageAllocator(self.pages.num_pages)
        if self._prefix is not None:
            self._prefix.clear()
        for t in self.pages.tensors():
            t.zero_()
        return n

    def run(self, max_steps: int = 100000, spec_k: int = 0,
            steps_per_dispatch: int = 1):
        """Drive to completion. ``spec_k`` and ``steps_per_dispatch``
        compose: ``spec_k=8, steps_per_dispatch=4`` runs 4 verify windows
        per dispatch (:meth:`step_spec_multi`); ``spec_k`` alone runs
        :meth:`step_spec`, ``steps_per_dispatch`` alone
        :meth:`step_window`."""
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            if spec_k > 0 and steps_per_dispatch > 1:
                self.step_spec_multi(spec_k, steps_per_dispatch)
            elif spec_k > 0:
                self.step_spec(spec_k)
            elif steps_per_dispatch > 1:
                self.step_window(steps_per_dispatch)
            else:
                self.step()
            steps += 1
        return self.finished
