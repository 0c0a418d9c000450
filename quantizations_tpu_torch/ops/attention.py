"""GQA flash-decode attention over the slot KV cache (counterpart of
``quantizations_tpu/ops/attention.py``).

Shapes (one query token per sequence):

  q        [B, KVH, G, D]       bf16 or fp32 (G query heads per kv head)
  cache    [B, KVH, S, D]       or the stacked [L, B, KVH, S, D]
  lengths  [B] int32            row b attends positions s < lengths[b]
  out      [B, KVH, G, D]       fp32

CUDA tensors launch K3 (bf16 cache) or K4 (int8 codes with a bf16 step
per cached row) from ``csrc/flash_decode.cu``; CPU tensors run the plain
version, a masked softmax in fp32 over the visible positions. The kernel
splits the attended positions across blocks (:func:`decode_split`) and
the query rows into groups of at most 8 (:func:`row_groups`), and folds
the splits' partials in a second launch of the same C call. The
stacked forms hand the kernel layer ``li`` of the full cache as a pointer
offset (``cache[li]`` of a contiguous stack is a view), and it reads only
the first ``attend_len`` positions: nothing is sliced or copied.

Both sides agree with the TPU kernel wherever a query row sees at least
one position. A row that sees none writes zeros here; the TPU kernel's
finite mask gives it the mean of the attended V rows there. Such rows
are junk on every caller's path (an empty engine slot attends its own
position at least).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda import FLASH_DECODE, FLASH_DECODE_I8, launch

__all__ = [
    "flash_decode_attention",
    "flash_decode_attention_stacked",
    "flash_decode_attention_stacked_i8",
    "flash_decode_attention_plain",
    "flash_decode_attention_stacked_plain",
    "flash_decode_attention_stacked_i8_plain",
    "decode_attention_plain",
    "decode_split",
    "row_groups",
]

_NEG = -1e30

# How K3/K4 cut their work (csrc/flash_decode.cu): a block of 4 warps (8
# for K4 at up to 4 rows) takes a chunk of positions in 16-position warp
# tiles, for a group of at most GROUP_ROWS query rows; the grid is
# (B * KVH, n_split, row groups). The constants come from a sweep of
# forced splits on an H100 (PERF.md, PR 7).
SPLIT_TILE = 16             # positions of one warp tile
SPLIT_ALIGN = 64            # four warp tiles
SPLIT_MIN_CHUNK = 128       # keeps the partials a few % of the K/V bytes
SPLIT_TARGET_BLOCKS = 264   # at most two blocks per SM of an H100's 132
GROUP_ROWS = 8


def row_groups(qg: int) -> Tuple[int, int]:
    """``(n_groups, group_rows)``: ``qg`` query rows in the fewest
    groups of at most :data:`GROUP_ROWS`, as even as whole rows allow
    (the last group may be shorter)."""
    n = -(-qg // GROUP_ROWS)
    return n, -(-qg // n)


def decode_split(n_pos: int, blocks: int) -> Tuple[int, int]:
    """``(n_split, chunk)`` for ``n_pos`` attended positions and
    ``blocks`` = B * KVH * row groups blocks per split: split ``s`` takes
    positions ``[s * chunk, (s + 1) * chunk)``. As many splits as keep
    the grid within :data:`SPLIT_TARGET_BLOCKS` (a partial second wave
    costs as much as a whole one), with chunks a multiple of
    :data:`SPLIT_ALIGN` and at least :data:`SPLIT_MIN_CHUNK` positions,
    so ``n_split`` is 1 up to that many positions. Reads nothing from the
    card: ``n_pos`` is what the host knows (``attend_len``, or
    ``max_pages * page`` for the pool)."""
    if n_pos < 1 or blocks < 1:
        raise ValueError(f"decode_split: n_pos {n_pos}, blocks {blocks}")
    want = max(1, SPLIT_TARGET_BLOCKS // blocks)
    chunk = -(-n_pos // want)
    chunk = max(SPLIT_MIN_CHUNK, -(-chunk // SPLIT_ALIGN) * SPLIT_ALIGN)
    return -(-n_pos // chunk), chunk


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, scale: float,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None, q_span: int = 1,
                           k_step: Optional[torch.Tensor] = None,
                           v_step: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The recurrence of K3/K4 as one masked softmax, in fp32.

    ``q [B, KVH, q_span*G, D]`` against ``k, v [B, KVH, N, D]``, the
    positions ``0..N-1`` of each row (gathered through a block table for
    a paged pool). Row ``r`` is query position ``r // G``; it sees
    position ``s`` iff ``s < len + r // G`` and, with a window,
    ``s > len - 1 + r // G - window``. int8 codes take their steps
    ``[B, KVH, N]`` as column scalings: the scores by ``k_step``, the
    probabilities by ``v_step``."""
    B, KVH, QG, D = q.shape
    G = QG // q_span
    N = k.shape[2]
    dev = q.device
    s = torch.einsum("bhrd,bhnd->bhrn", q.float() * scale, k.float())
    if k_step is not None:
        s = s * k_step.float()[:, :, None, :]
    if softcap is not None:
        s = softcap * torch.tanh(s * (1.0 / softcap))
    span = torch.arange(N, device=dev)[None, None, None, :]
    qpos = (torch.arange(QG, device=dev) // G)[None, None, :, None]
    ln = lengths.to(dev, torch.int64)[:, None, None, None]
    vis = span < ln + qpos
    if window is not None:
        vis = vis & (span > ln - 1 + qpos - int(window))
    s = torch.where(vis, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if v_step is not None:
        p = p * v_step.float()[:, :, None, :]
    acc = torch.einsum("bhrn,bhnd->bhrd", p, v.float())
    return torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), acc)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else q.shape[-1] ** -0.5


def _window(window) -> Optional[int]:
    return None if window is None else int(window)


def launch_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, *, page: int, n_pos: int,
                  scale: float, softcap: Optional[float],
                  window: Optional[int], q_span: int = 1,
                  table: Optional[torch.Tensor] = None,
                  k_step: Optional[torch.Tensor] = None,
                  v_step: Optional[torch.Tensor] = None,
                  split: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Check the operands and launch K3 (bf16 ``k``/``v``) or K4 (int8
    codes with ``k_step``/``v_step``). ``k``/``v`` are one layer: the
    slot cache ``[B, KVH, page = S, D]`` with ``table`` None, or the pool
    ``[P, KVH, page, D]`` read through ``table [B, max_pages]``.
    ``split`` = ``(n_split, chunk)`` overrides :func:`decode_split` (for
    timing other splits; the result does not depend on it beyond the
    fp32 summation order)."""
    int8 = k_step is not None
    name = "flash_decode_i8" if int8 else "flash_decode"
    dev = q.device
    ops = [("q", q), ("k", k), ("v", v), ("lengths", lengths)]
    if table is not None:
        ops.append(("block_table", table))
    if int8:
        ops += [("k_step", k_step), ("v_step", v_step)]
    for nm, t in ops:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: {nm} must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    if q.dim() != 4 or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: q must be bf16 or fp32 [B, KVH, QG, D], "
                         f"got {q.dtype} {tuple(q.shape)}")
    B, KVH, QG, D = q.shape
    if D not in (64, 128):
        raise ValueError(f"{name}: head_dim {D} is not 64 or 128")
    if q_span < 1 or QG % q_span or QG > 32:
        raise ValueError(f"{name}: {QG} query rows must be q_span ({q_span}) "
                         "x G and at most 32")
    want = torch.int8 if int8 else torch.bfloat16
    for nm, t in (("k", k), ("v", v)):
        if t.dtype != want or t.dim() != 4 or tuple(t.shape[1:]) != (
                KVH, page, D):
            raise ValueError(f"{name}: {nm} must be {want} [*, {KVH}, {page}, "
                             f"{D}], got {t.dtype} {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must be 16-byte aligned")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} != v {tuple(v.shape)}")
    if int8:
        for nm, t in (("k_step", k_step), ("v_step", v_step)):
            if t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(
                    k.shape[:3]):
                raise ValueError(f"{name}: {nm} must be bf16 "
                                 f"{tuple(k.shape[:3])}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: lengths must be int32 [{B}]")
    max_pages = 1
    if table is None:
        if k.shape[0] != B or not 0 < n_pos <= page:
            raise ValueError(f"{name}: slot cache of {k.shape[0]} rows and "
                             f"{page} positions for B={B}, n_pos={n_pos}")
    else:
        if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != B:
            raise ValueError(f"{name}: block_table must be int32 [{B}, pages]")
        max_pages = table.shape[1]
        n_pos = max_pages * page
    out = torch.empty((B, KVH, QG, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    n_groups, group_rows = row_groups(QG)
    n_split, chunk = split or decode_split(n_pos, B * KVH * n_groups)
    if not (1 <= n_split <= 1024 and chunk >= 1
            and n_split * chunk >= n_pos):
        raise ValueError(f"{name}: split ({n_split}, {chunk}) does not "
                         f"cover {n_pos} positions")
    part = ml = None
    if n_split > 1:   # the partials' scratch, folded by the second launch
        part = torch.empty((n_split, B * KVH * QG, D), dtype=torch.float32,
                           device=dev)
        ml = torch.empty((n_split, B * KVH * QG, 2), dtype=torch.float32,
                         device=dev)
    has_cap = softcap is not None
    cap = float(softcap) if has_cap else 1.0
    inv_cap = float(torch.tensor(1.0 / cap, dtype=torch.float32))
    tail = [None if table is None else table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, KVH, QG, QG // q_span, D, page, max_pages,
            n_pos, int(window is not None), 0 if window is None else window,
            float(scale), int(has_cap), cap, inv_cap, n_split, chunk,
            group_rows, None if part is None else part.data_ptr(),
            None if ml is None else ml.data_ptr()]
    head = [q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(),
            v.data_ptr()]
    if int8:
        launch(FLASH_DECODE_I8, "qt_flash_decode_i8", dev, *head,
               k_step.data_ptr(), v_step.data_ptr(), *tail)
    else:
        launch(FLASH_DECODE, "qt_flash_decode_bf16", dev, *head, *tail)
    (FLASH_DECODE_I8 if int8 else FLASH_DECODE).last_grid = (
        n_split, chunk, B * KVH * n_groups * n_split)
    return out


# -- slot cache, unstacked ------------------------------------------------------

def flash_decode_attention_plain(q, cache_k, cache_v, lengths, scale=None,
                                 softcap=None, window=None) -> torch.Tensor:
    """Plain version of :func:`flash_decode_attention`."""
    return decode_attention_plain(q, cache_k, cache_v, lengths,
                                  _scale(q, scale), softcap, _window(window))


def flash_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, lengths: torch.Tensor,
                           scale: Optional[float] = None,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Online-softmax decode attention over a per-layer bf16 cache
    ``[B, KVH, S, D]``; returns fp32 ``[B, KVH, G, D]``. ``scale``
    defaults to ``D ** -0.5``; ``softcap`` is the Gemma-2 logit cap,
    ``window`` a sliding window."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, cache_k, cache_v, lengths,
                                            scale, softcap, window)
    S = cache_k.shape[2]
    return launch_decode(q, cache_k, cache_v, lengths, page=S, n_pos=S,
                         scale=_scale(q, scale), softcap=softcap,
                         window=_window(window))


# -- slot cache, stacked ----------------------------------------------------------

def _attend_len(cache_k: torch.Tensor, attend_len: Optional[int]) -> int:
    S = cache_k.shape[3]
    n = attend_len or S
    if not 0 < n <= S:
        raise ValueError(f"attend_len {attend_len} outside (0, {S}]")
    return n


def flash_decode_attention_stacked_plain(q, cache_k, cache_v, layer_idx,
                                         lengths, attend_len=None, scale=None,
                                         softcap=None, window=None
                                         ) -> torch.Tensor:
    """Plain version of :func:`flash_decode_attention_stacked`."""
    n = _attend_len(cache_k, attend_len)
    li = int(layer_idx)
    return decode_attention_plain(q, cache_k[li, :, :, :n],
                                  cache_v[li, :, :, :n], lengths,
                                  _scale(q, scale), softcap, _window(window))


def flash_decode_attention_stacked(q: torch.Tensor, cache_k: torch.Tensor,
                                   cache_v: torch.Tensor, layer_idx: int,
                                   lengths: torch.Tensor,
                                   attend_len: Optional[int] = None,
                                   scale: Optional[float] = None,
                                   softcap: Optional[float] = None,
                                   window: Optional[int] = None
                                   ) -> torch.Tensor:
    """:func:`flash_decode_attention` over layer ``layer_idx`` of the
    stacked ``[L, B, KVH, S, D]`` cache, attending only the first
    ``attend_len`` positions. ``window`` may differ per layer (``2**30``
    is global: the Gemma-2 alternation)."""
    if q.device.type == "cpu":
        return flash_decode_attention_stacked_plain(
            q, cache_k, cache_v, layer_idx, lengths, attend_len, scale,
            softcap, window)
    li = int(layer_idx)
    return launch_decode(q, cache_k[li], cache_v[li], lengths,
                         page=cache_k.shape[3],
                         n_pos=_attend_len(cache_k, attend_len),
                         scale=_scale(q, scale), softcap=softcap,
                         window=_window(window))


def flash_decode_attention_stacked_i8_plain(q, cache_k, cache_v, k_scale,
                                            v_scale, layer_idx, lengths,
                                            attend_len=None, scale=None,
                                            softcap=None, window=None
                                            ) -> torch.Tensor:
    """Plain version of :func:`flash_decode_attention_stacked_i8`."""
    n = _attend_len(cache_k, attend_len)
    li = int(layer_idx)
    return decode_attention_plain(
        q, cache_k[li, :, :, :n], cache_v[li, :, :, :n], lengths,
        _scale(q, scale), softcap, _window(window),
        k_step=k_scale[li, :, :, :n], v_step=v_scale[li, :, :, :n])


def flash_decode_attention_stacked_i8(q: torch.Tensor, cache_k: torch.Tensor,
                                      cache_v: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor, layer_idx: int,
                                      lengths: torch.Tensor,
                                      attend_len: Optional[int] = None,
                                      scale: Optional[float] = None,
                                      softcap: Optional[float] = None,
                                      window: Optional[int] = None
                                      ) -> torch.Tensor:
    """:func:`flash_decode_attention_stacked` over the int8 cache: codes
    ``[L, B, KVH, S, D]`` with bf16 steps ``[L, B, KVH, S]`` (K4)."""
    if q.device.type == "cpu":
        return flash_decode_attention_stacked_i8_plain(
            q, cache_k, cache_v, k_scale, v_scale, layer_idx, lengths,
            attend_len, scale, softcap, window)
    li = int(layer_idx)
    return launch_decode(q, cache_k[li], cache_v[li], lengths,
                         page=cache_k.shape[3],
                         n_pos=_attend_len(cache_k, attend_len),
                         scale=_scale(q, scale), softcap=softcap,
                         window=_window(window), k_step=k_scale[li],
                         v_step=v_scale[li])
