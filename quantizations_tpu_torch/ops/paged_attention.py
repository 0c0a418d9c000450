"""Paged flash-decode attention through block tables (counterpart of
``quantizations_tpu/ops/paged_attention.py``).

Pool layout ``pages_k/v [L, P, KVH, page, D]`` with one block table
``[B, max_pages]`` shared by every layer: page ``j`` of row ``b`` is pool
page ``block_table[b, j]`` and covers positions ``[j*page, (j+1)*page)``.
Unused entries may hold any valid page id (the engine uses the junk page
0); ``lengths`` masks them. An int8 pool keeps its bf16 steps in their
natural ``[L, P, KVH, page]`` layout.

CUDA tensors launch K3/K4 (``csrc/flash_decode.cu``), which follow the
table for each position they read; CPU tensors run the plain version over
the gathered pages. ``pages_per_step`` is accepted and validated: on the
TPU it only groups the page DMAs of a grid step, and the result does not
depend on it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import _scale, _window, decode_attention_plain, launch_decode

__all__ = ["paged_flash_decode_attention", "paged_flash_decode_attention_i8",
           "paged_flash_decode_attention_plain",
           "paged_flash_decode_attention_i8_plain"]


def _clamp_pps(max_pages: int, pages_per_step: int) -> int:
    """The pages per grid step the TPU kernel would use: halved until it
    divides ``max_pages``."""
    if int(pages_per_step) < 1:
        raise ValueError(f"pages_per_step must be >= 1, got {pages_per_step}")
    pps = int(pages_per_step)
    while max_pages % pps:
        pps //= 2
    return max(pps, 1)


def _gather(pool: torch.Tensor, block_table: torch.Tensor,
            layer_idx: int) -> torch.Tensor:
    """Layer ``layer_idx`` of a pool ``[L, P, KVH, page, ...]`` gathered
    along each row's table -> ``[B, KVH, max_pages * page, ...]``."""
    g = pool[int(layer_idx)][block_table.long()]     # [B, mp, KVH, page, ...]
    B, mp, KVH, page = g.shape[:4]
    g = g.transpose(1, 2)
    return g.reshape(B, KVH, mp * page, *g.shape[4:])


def paged_flash_decode_attention_plain(q, pages_k, pages_v, block_table,
                                       layer_idx, lengths, scale=None,
                                       softcap=None, window=None, q_span=1,
                                       pages_per_step=1) -> torch.Tensor:
    """Plain version of :func:`paged_flash_decode_attention`."""
    _clamp_pps(block_table.shape[1], pages_per_step)
    return decode_attention_plain(
        q, _gather(pages_k, block_table, layer_idx),
        _gather(pages_v, block_table, layer_idx), lengths, _scale(q, scale),
        softcap, _window(window), q_span=q_span)


def paged_flash_decode_attention(q: torch.Tensor, pages_k: torch.Tensor,
                                 pages_v: torch.Tensor,
                                 block_table: torch.Tensor, layer_idx: int,
                                 lengths: torch.Tensor,
                                 scale: Optional[float] = None,
                                 softcap: Optional[float] = None,
                                 window: Optional[int] = None,
                                 q_span: int = 1,
                                 pages_per_step: int = 1) -> torch.Tensor:
    """Online-softmax decode attention over the bf16 pool through
    ``block_table [B, max_pages]`` (K3). ``q [B, KVH, q_span*G, D]``: row
    ``t*G + g`` is position ``lengths[b] - 1 + t``, masked causally inside
    the window. Returns fp32 ``[B, KVH, q_span*G, D]``."""
    if q.device.type == "cpu":
        return paged_flash_decode_attention_plain(
            q, pages_k, pages_v, block_table, layer_idx, lengths, scale,
            softcap, window, q_span, pages_per_step)
    _clamp_pps(block_table.shape[1], pages_per_step)
    li = int(layer_idx)
    return launch_decode(q, pages_k[li], pages_v[li], lengths,
                         page=pages_k.shape[3], n_pos=0,
                         scale=_scale(q, scale), softcap=softcap,
                         window=_window(window), q_span=q_span,
                         table=block_table)


def paged_flash_decode_attention_i8_plain(q, pages_k, pages_v, scales_k,
                                          scales_v, block_table, layer_idx,
                                          lengths, scale=None, softcap=None,
                                          window=None, q_span=1,
                                          pages_per_step=1) -> torch.Tensor:
    """Plain version of :func:`paged_flash_decode_attention_i8`."""
    _clamp_pps(block_table.shape[1], pages_per_step)
    return decode_attention_plain(
        q, _gather(pages_k, block_table, layer_idx),
        _gather(pages_v, block_table, layer_idx), lengths, _scale(q, scale),
        softcap, _window(window), q_span=q_span,
        k_step=_gather(scales_k, block_table, layer_idx),
        v_step=_gather(scales_v, block_table, layer_idx))


def paged_flash_decode_attention_i8(q: torch.Tensor, pages_k: torch.Tensor,
                                    pages_v: torch.Tensor,
                                    scales_k: torch.Tensor,
                                    scales_v: torch.Tensor,
                                    block_table: torch.Tensor,
                                    layer_idx: int, lengths: torch.Tensor,
                                    scale: Optional[float] = None,
                                    softcap: Optional[float] = None,
                                    window: Optional[int] = None,
                                    q_span: int = 1,
                                    pages_per_step: int = 1) -> torch.Tensor:
    """:func:`paged_flash_decode_attention` over the int8 pool: codes
    ``[L, P, KVH, page, D]`` with bf16 steps ``[L, P, KVH, page]`` (K4)."""
    if q.device.type == "cpu":
        return paged_flash_decode_attention_i8_plain(
            q, pages_k, pages_v, scales_k, scales_v, block_table, layer_idx,
            lengths, scale, softcap, window, q_span, pages_per_step)
    _clamp_pps(block_table.shape[1], pages_per_step)
    li = int(layer_idx)
    return launch_decode(q, pages_k[li], pages_v[li], lengths,
                         page=pages_k.shape[3], n_pos=0,
                         scale=_scale(q, scale), softcap=softcap,
                         window=_window(window), q_span=q_span,
                         table=block_table, k_step=scales_k[li],
                         v_step=scales_v[li])
