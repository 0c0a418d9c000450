"""Operations and bytes of the work a run does, from shapes alone, and
the card's peaks. The count is the same whatever kernel does the work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16 and 3.35 TB/s of HBM. A share of a roofline
is the least time, the larger of operations over the peak rate and bytes
over the bandwidth, over the time measured; each input byte is counted
once and each output byte once.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from .weights import Dims

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def linear(rows: int, out_f: int, in_f: int, weight_bytes: int,
           in_item: int, out_item: int):
    """(ops, bytes) of ``y [rows, out] = x [rows, in] @ W.T`` with the
    stored weight of ``weight_bytes`` (codes and scales)."""
    return (2 * rows * out_f * in_f,
            weight_bytes + rows * in_f * in_item + rows * out_f * out_item)


def decode_attention(lengths: Sequence[int], n_q: int, n_kv: int, D: int,
                     kv_item: int, act_item: int):
    """(ops, bytes) of one layer's decode attention: a query position a
    row attending ``lengths`` cached positions, each row's K and V read
    once, q read and the output written."""
    total = int(sum(lengths))
    rows = len(lengths)
    ops = 4 * n_q * D * total
    nbytes = 2 * total * n_kv * D * kv_item + 2 * rows * n_q * D * act_item
    return ops, nbytes


def weight_bytes(out_f: int, in_f: int, blocksize: int,
                 scale_item: int) -> int:
    """Stored bytes of a 4-bit ``[out, in]`` weight: the codes and one
    scale a block."""
    return out_f * in_f // 2 + out_f * in_f // blocksize * scale_item


def projections(d: Dims, fused: bool):
    """(out, in) of the projections a layer runs: q|k|v and gate|up as
    one each when ``fused``."""
    p = d.part_shapes()
    if not fused:
        return list(p.values())
    return [(p["q"][0] + p["k"][0] + p["v"][0], d.hidden), p["o"],
            (2 * d.inter, d.hidden), p["down"]]


def decode_step_linear_least(d: Dims, rows: int, fused: bool,
                             blocksize: int, scale_item: int,
                             head_4bit: bool, act_item: int = 2) -> float:
    """Least seconds of a decode step's 4-bit projections at ``rows``
    rows: every layer's, and the lm_head's when it is 4-bit."""
    shapes = projections(d, fused) * d.layers
    if head_4bit:
        shapes = shapes + [(d.vocab, d.hidden)]
    return sum(least_seconds(*linear(rows, o, i,
                                     weight_bytes(o, i, blocksize,
                                                  scale_item),
                                     act_item, act_item))
               for o, i in shapes)


def decode_step_attention_least(d: Dims, lengths: Sequence[int],
                                kv_item: int = 2,
                                act_item: int = 2) -> float:
    """Least seconds of a decode step's attention over every layer."""
    if not lengths:
        return 0.0
    return d.layers * least_seconds(*decode_attention(
        lengths, d.n_q, d.n_kv, d.head_dim, kv_item, act_item))


def causal_prefill_attention(starts: Iterable[int], takes: Iterable[int],
                             n_q: int, n_kv: int, D: int, kv_item: int,
                             act_item: int):
    """(ops, bytes) of prefill chunks: row ``r``'s ``takes[r]`` queries at
    positions ``starts[r] ..`` each attending every position up to its
    own (causal); its K and V up to the chunk's end read once."""
    s = np.asarray(list(starts), np.float64)
    t = np.asarray(list(takes), np.float64)
    keys = float(np.sum(t * s + t * (t + 1) / 2))
    ops = 4 * n_q * D * keys
    nbytes = (2 * float(np.sum(s + t)) * n_kv * D * kv_item
              + 2 * float(np.sum(t)) * n_q * D * act_item)
    return ops, nbytes


def _attn_per_key(d: Dims) -> int:
    return 4 * d.layers * d.n_q * d.head_dim


def decode_token_ops(d: Dims, length: int) -> float:
    """Model operations of one decode row attending ``length``
    positions: every projection, the lm_head and attention."""
    return (2 * (d.layers * d.layer_params() + d.head_params())
            + _attn_per_key(d) * length)


def prefill_ops(d: Dims, plen: int) -> float:
    """Model operations of a ``plen``-token prompt: every projection of
    every token, the lm_head of the last, causal attention."""
    return (2 * d.layers * d.layer_params() * plen + 2 * d.head_params()
            + _attn_per_key(d) * plen * (plen + 1) / 2)
