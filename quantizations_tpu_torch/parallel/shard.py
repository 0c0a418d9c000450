"""Tensor-parallel shards of the Llama model (counterpart of
``quantizations_tpu/parallel/shard.py``), Megatron style over a mesh's
``"tp"`` axis:

- q/k/v/gate/up: column-parallel, the output rows split (pair words
  ``[L, M/2, K/4]`` on their word-row axis, which is row-pair local;
  planar ``[L, M, K/8]`` and every scale layout on the row axis).
  Attention heads land whole on a shard.
- o/down: row-parallel, the K axis split, in the planar layout (the pair
  layout's word axis does not slice congruently with K): ``K / tp`` is a
  multiple of the 64-element quant block, so no block straddles shards.
- the KV cache and the paged pool: kv heads split, the int8 step planes
  on the same axis.
- embedding and norms replicated; the lm_head column-parallel on vocab.

The JAX package places one global array over the mesh; here each rank
holds its own shard (:func:`shard_for_rank`, a pure function) and the
forward runs on the shard shapes, summing o and down over the axis and
gathering the vocab-sharded logits. Every shard is its own contiguous
copy, as the kernels' wrappers require.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..config import ServeConfig
from ..models.llama import (
    KVCache,
    LlamaConfig,
    LlamaParams,
    QLinear,
    fuse_projections,
    map_tensors,
)
from ..ops.qmatmul import pair_to_planar, unpack_scale_pairs
from .mesh import Mesh

__all__ = ["AXIS", "validate_tp", "check_mesh", "shard_for_rank",
           "shard_column", "shard_row", "split_rows", "shard_llama_params",
           "fuse_projections_tp", "shard_config", "sharded_cache",
           "make_sharded_generate_fn", "ensure_planar"]

AXIS = "tp"

# the column-parallel (output rows) and row-parallel (K) projections
COLUMN = ("q", "k", "v", "gate", "up")
ROW = ("o", "down")
BIASES = ("q_bias", "k_bias", "v_bias")


def validate_tp(cfg: LlamaConfig, tp: int) -> None:
    """Check the model divides over ``tp`` shards without splitting
    attention heads or 64-element quant blocks."""
    bs = max(cfg.quant.blocksize, 64)
    checks = [
        (cfg.num_key_value_heads % tp == 0,
         f"kv_heads {cfg.num_key_value_heads} % tp {tp}"),
        (cfg.num_attention_heads % tp == 0,
         f"q_heads {cfg.num_attention_heads} % tp {tp}"),
        ((cfg.q_size // tp) % bs == 0, "o_proj K shard vs quant block"),
        ((cfg.intermediate_size // tp) % bs == 0,
         "down_proj K shard vs quant block"),
        (cfg.intermediate_size % tp == 0, "intermediate % tp"),
        (cfg.vocab_size % tp == 0, "vocab % tp"),
    ]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        raise ValueError(f"config does not shard over tp={tp}: {bad}")


def check_mesh(mesh, axes=(AXIS,)) -> Mesh:
    """``mesh`` if it is a port :class:`~.mesh.Mesh` with ``axes``, else
    a clear error."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            "mesh must be a quantizations_tpu_torch.parallel.Mesh "
            f"(parallel.make_mesh), got {type(mesh).__name__}")
    for a in axes:
        mesh.axis(a)
    return mesh


def split_rows(t: torch.Tensor, tp: int, rank: int,
               dim: int = -1) -> torch.Tensor:
    """Rank ``rank``'s slice of ``tp`` along ``dim``, as its own
    contiguous copy."""
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).clone(
        memory_format=torch.contiguous_format)


def ensure_planar(ql: QLinear) -> QLinear:
    """Row-parallel (K-sharded) weights in the planar layout: pair words
    are repacked (``pair_to_planar``, on their device) and packed bf16x2
    scales widened to fp32 rows; planar weights pass unchanged."""
    if ql.layout != "pair":
        return ql
    scales = unpack_scale_pairs(ql.scales) if ql.scales_packed else ql.scales
    return QLinear(wp=pair_to_planar(ql.wp), scales=scales)


def shard_column(ql: QLinear, tp: int, rank: int) -> QLinear:
    """A column-parallel shard: the output rows (the second-to-last axis
    of the words and the scales, stacked or not)."""
    return QLinear(wp=split_rows(ql.wp, tp, rank, -2),
                   scales=split_rows(ql.scales, tp, rank, -2))


def shard_row(ql: QLinear, tp: int, rank: int) -> QLinear:
    """A row-parallel shard: planar (:func:`ensure_planar`), the K axis
    (the last axis of the words and the scales) split."""
    ql = ensure_planar(ql)
    return QLinear(wp=split_rows(ql.wp, tp, rank),
                   scales=split_rows(ql.scales, tp, rank))


def _check_unfused(params: LlamaParams) -> None:
    if params.layers.qkv is not None:
        raise ValueError(
            "fused params: TP shards the UNFUSED per-projection form — "
            "shard first, or skip fuse_projections for parallel serving")


def shard_for_rank(params: LlamaParams, cfg: LlamaConfig, tp: int,
                   rank: int) -> LlamaParams:
    """The shard of ``params`` that tensor-parallel rank ``rank`` of
    ``tp`` holds, on the params' device (see the module docstring).
    Raises ``ValueError`` for fused params or a config that
    :func:`validate_tp` refuses."""
    validate_tp(cfg, tp)
    _check_unfused(params)
    st = params.layers
    rep = {n: shard_column(getattr(st, n), tp, rank) for n in COLUMN}
    rep.update({n: shard_row(getattr(st, n), tp, rank) for n in ROW})
    rep.update({n: split_rows(getattr(st, n), tp, rank) for n in BIASES
                if getattr(st, n) is not None})
    head = params.lm_head
    head = (shard_column(head, tp, rank) if isinstance(head, QLinear)
            else split_rows(head, tp, rank, dim=0))
    return dataclasses.replace(params, layers=dataclasses.replace(st, **rep),
                               lm_head=head)


def shard_llama_params(params: LlamaParams, mesh: Mesh,
                       cfg: LlamaConfig) -> LlamaParams:
    """This rank's tensor-parallel shard of whole ``params``
    (:func:`shard_for_rank` at the mesh's ``"tp"`` coordinate), on the
    mesh's device."""
    ax = check_mesh(mesh).axis(AXIS)
    local = shard_for_rank(params, cfg, ax.size, ax.rank)
    return map_tensors(lambda t: t.to(mesh.device), local)


def fuse_projections_tp(params: LlamaParams, mesh: Mesh,
                        cfg: LlamaConfig) -> LlamaParams:
    """Projection fusion of a tensor-parallel shard: each rank
    concatenates its own q|k|v and gate|up rows (the single-device
    :func:`~quantizations_tpu_torch.models.llama.fuse_projections`), so
    the global row order is the JAX package's shard-blocked
    ``[q_0|k_0|v_0 | q_1|k_1|v_1 | ...]``, which the forward slices back
    apart from the fused rows and the shard-invariant q:kv ratio."""
    check_mesh(mesh)
    return fuse_projections(params)


def shard_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The config that shapes a tensor-parallel shard's caches: its
    ``num_key_value_heads / tp`` kv heads (the int8 step planes follow
    them). The forward takes the whole model's config."""
    validate_tp(cfg, tp)
    return dataclasses.replace(cfg,
                               num_key_value_heads=cfg.num_key_value_heads
                               // tp)


def sharded_cache(cfg: LlamaConfig, batch: int, max_seq: int,
                  mesh: Mesh) -> KVCache:
    """This rank's slot cache ``[L, B, KV/tp, S, D]`` (int8 steps ``[L,
    B, KV/tp, S]``) on the mesh's device."""
    return KVCache.create(shard_config(cfg, check_mesh(mesh).shape[AXIS]),
                          batch, max_seq, device=mesh.device)



def make_sharded_generate_fn(cfg: LlamaConfig, serve: ServeConfig,
                             mesh: Mesh, fused: bool = False) -> Callable:
    """The generate loop over the mesh's ``"tp"`` axis: ``(params,
    prompt_ids, cache, generator) -> (tokens, cache)`` with this rank's
    shard of the params (:func:`shard_llama_params`, or
    :func:`fuse_projections_tp` of it: ``fused`` is accepted for the JAX
    package's signature and the forward reads the form from the params)
    and of the cache (:func:`sharded_cache`), the prompt and the
    generator the same on every rank; every rank returns the same
    tokens."""
    from ..serve.generate import make_generate_fn

    check_mesh(mesh)
    validate_tp(cfg, mesh.shape[AXIS])
    return make_generate_fn(cfg, serve, axis_name=mesh.axis(AXIS))

