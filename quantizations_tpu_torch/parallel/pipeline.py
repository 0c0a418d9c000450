"""Pipeline parallelism for inference, GPipe-style microbatching
(counterpart of ``quantizations_tpu/parallel/pipeline.py``).

- Stage ``s`` of the ``"pp"`` axis holds layers ``[s L/n, (s+1) L/n)``
  and the matching cache slice; embedding, final norm and lm_head are on
  every stage. With a ``tp_axis`` each stage's slice is also
  Megatron-sharded (:mod:`.shard`): the pp x tp layout.
- A forward splits the batch into ``n`` microbatches and runs the
  ``2 n - 1`` tick schedule: at tick ``t`` stage ``s`` works on
  microbatch ``t - s`` and hands its activation to stage ``s + 1``
  (:func:`~.collectives.send_recv`). The JAX package runs every stage at
  every tick (SPMD) and sends inactive ticks' K/V writes to a reserved
  last cache position; here a stage skips its inactive ticks, which
  write nothing. The reserved position stays reserved (the effective
  ``max_seq`` is ``max_seq - 1``), so both packages accept the same
  requests.
- The last stage's logits reach every stage by a broadcast over the
  ``"pp"`` axis (the JAX package's ``psum`` with zeros elsewhere).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from ..config import ServeConfig
from ..models.llama import (
    KVCache,
    LlamaConfig,
    LlamaParams,
    add_residual,
    embed_tokens,
    lm_head_logits,
    map_tensors,
    rope_cos_sin,
    slot_layers,
)
from ..serve.generate import sample_logits
from .collectives import broadcast, send_recv
from .mesh import Axis, Mesh
from .shard import check_mesh, shard_config, shard_for_rank, validate_tp

__all__ = ["PP_AXIS", "shard_llama_params_pp", "pp_cache",
           "make_pp_generate_fn"]

PP_AXIS = "pp"


def _stage_slice(params: LlamaParams, stage: int, n: int) -> LlamaParams:
    """Stage ``stage``'s layers of the ``[L, ...]`` stacks, as copies."""
    L = params.layers.attn_norm.shape[0]
    per = L // n
    layers = map_tensors(
        lambda t: t[stage * per:(stage + 1) * per].clone(
            memory_format=torch.contiguous_format), params.layers)
    return dataclasses.replace(params, layers=layers)


def shard_llama_params_pp(params: LlamaParams, mesh: Mesh, cfg: LlamaConfig,
                          tp_axis: Optional[str] = None) -> LlamaParams:
    """This rank's stage of whole ``params`` (and with ``tp_axis`` its
    tensor-parallel shard of it, o and down planar), on the mesh's
    device. Raises ``ValueError`` when the layers do not divide over the
    stages, for fused params and for a config :func:`validate_tp`
    refuses."""
    check_mesh(mesh, (PP_AXIS,) + ((tp_axis,) if tp_axis else ()))
    n = mesh.shape[PP_AXIS]
    if cfg.num_hidden_layers % n:
        raise ValueError(f"layers {cfg.num_hidden_layers} % pp {n} != 0")
    if params.layers.qkv is not None:
        raise ValueError(
            "fused params: PP slices the UNFUSED per-projection form")
    local = _stage_slice(params, mesh.axis(PP_AXIS).rank, n)
    if tp_axis is not None:
        tp = mesh.axis(tp_axis)
        validate_tp(cfg, tp.size)
        local = shard_for_rank(local, cfg, tp.size, tp.rank)
    return map_tensors(lambda t: t.to(mesh.device), local)


def pp_cache(cfg: LlamaConfig, batch: int, max_seq: int, mesh: Mesh,
             tp_axis: Optional[str] = None) -> KVCache:
    """This rank's cache: its stage's layers, and with ``tp_axis`` its kv
    heads (int8 step planes alike)."""
    check_mesh(mesh, (PP_AXIS,))
    if tp_axis is not None:
        cfg = shard_config(cfg, mesh.shape[tp_axis])
    return KVCache.create(dataclasses.replace(
        cfg, num_hidden_layers=cfg.num_hidden_layers // mesh.shape[PP_AXIS]),
        batch, max_seq, device=mesh.device)


def _stage_forward(params: LlamaParams, x: torch.Tensor, cache: KVCache,
                   positions: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, mask: torch.Tensor,
                   mask_full: torch.Tensor, cfg: LlamaConfig, stage: int,
                   tp_axis: Optional[Axis] = None) -> torch.Tensor:
    """This stage's layers on ``x``; each layer's window follows its
    GLOBAL index ``stage * L_local + i`` (the Gemma-2 alternation crosses
    stage boundaries)."""
    per = params.layers.attn_norm.shape[0]
    return add_residual(*slot_layers(params, x, cache, positions, cos, sin,
                                     mask, mask_full, cfg, axis_name=tp_axis,
                                     first_layer=stage * per))


def _microbatch_cache(cache: KVCache, rows: slice, contiguous: bool
                      ) -> KVCache:
    """The cache rows of one microbatch: views, or contiguous copies for
    the flash kernels (written back by :func:`_write_back`)."""
    def take(t):
        v = t[:, rows]
        return v.contiguous() if contiguous else v
    return map_tensors(take, cache)


def _write_back(cache: KVCache, part: KVCache, rows: slice) -> None:
    for name in ("k", "v", "k_scale", "v_scale"):
        dst, src = getattr(cache, name), getattr(part, name)
        if dst is not None and src.data_ptr() != dst[:, rows].data_ptr():
            dst[:, rows] = src


def _pp_forward(params: LlamaParams, token_ids: torch.Tensor, cache: KVCache,
                pos: Union[int, torch.Tensor], cfg: LlamaConfig, pp: Axis,
                tp_axis: Optional[Axis] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """Microbatched pipeline forward of ``token_ids [B, T]`` (the same on
    every rank, ``B % n == 0``) at positions ``pos .. pos + T``; returns
    the last token's logits ``[B, vocab]`` on every rank and the cache,
    updated in place."""
    n, stage = pp.size, pp.rank
    B, T = token_ids.shape
    if B % n:
        raise ValueError(f"batch {B} % pp {n} != 0")
    mb = B // n
    dev = token_ids.device
    pos = torch.broadcast_to(
        torch.as_tensor(pos, dtype=torch.int64, device=dev).reshape(-1), (B,))
    positions = pos[:, None] + torch.arange(T, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    key_pos = torch.arange(cache.max_seq, device=dev)
    mask_full = key_pos[None, None, :] <= positions[:, :, None]
    mask = mask_full
    if cfg.sliding_window is not None:
        mask = mask & (key_pos[None, None, :]
                       > positions[:, :, None] - cfg.sliding_window)
    copies = cfg.use_flash_attention and n > 1
    logits = torch.zeros((B, cfg.vocab_size), dtype=torch.float32,
                         device=dev)
    buf = None
    shape = (mb, T, cfg.hidden_size)
    for t in range(2 * n - 1):
        m = t - stage
        x = None
        if 0 <= m < n:
            rows = slice(m * mb, (m + 1) * mb)
            x = (embed_tokens(params, token_ids[rows], cfg) if stage == 0
                 else buf)
            part = _microbatch_cache(cache, rows, copies)
            x = _stage_forward(params, x, part, positions[rows], cos[rows],
                               sin[rows], mask[rows], mask_full[rows], cfg,
                               stage, tp_axis)
            _write_back(cache, part, rows)
            if stage == n - 1:
                logits[rows] = lm_head_logits(params, x[:, -1:], cfg,
                                              tp_axis)[:, 0]
        # the hand-off: stage s sends microbatch t - s to stage s + 1,
        # which works on it at tick t + 1
        send = (x.to(torch.bfloat16), stage + 1) if (
            x is not None and stage < n - 1) else None
        recv = None
        if stage > 0 and 0 <= t - (stage - 1) < n:
            recv = (torch.empty(shape, dtype=torch.bfloat16, device=dev),
                    stage - 1)
        if send is not None or recv is not None:
            got = send_recv(send, recv, pp)
            if recv is not None:
                buf = got
    return broadcast(logits, pp, n - 1), cache


def make_pp_generate_fn(cfg: LlamaConfig, serve: ServeConfig, mesh: Mesh,
                        tp_axis: Optional[str] = None) -> Callable:
    """Pipeline-parallel generate: ``(params, prompt_ids, cache,
    generator) -> (tokens, cache)`` with this rank's stage
    (:func:`shard_llama_params_pp`) and cache (:func:`pp_cache`), the
    prompt and the generator the same on every rank. ``B % n_pp == 0``;
    the effective ``max_seq`` is the cache's less one (``ValueError``
    before any launch otherwise). ``tp_axis`` composes with tensor
    parallelism on a 2D (pp, tp) mesh. Sampling is the JAX package's:
    temperature and top-k, no top-p."""
    check_mesh(mesh, (PP_AXIS,) + ((tp_axis,) if tp_axis else ()))
    pp = mesh.axis(PP_AXIS)
    tp = mesh.axis(tp_axis) if tp_axis else None

    def run(params, prompt_ids, cache, generator=None):
        B, P = prompt_ids.shape
        last = P + serve.max_new_tokens - 2       # the last written position
        if last > cache.max_seq - 2:
            raise ValueError(
                f"positions up to {last} run past the pipeline's "
                f"{cache.max_seq - 1} usable cache positions (one is kept "
                "in reserve)")
        with torch.inference_mode():
            logits, cache = _pp_forward(params, prompt_ids, cache, 0, cfg,
                                        pp, tp)
            tok = sample_logits(logits, generator, serve.temperature,
                                serve.top_k)
            toks = [tok]
            for step in range(serve.max_new_tokens - 1):
                logits, cache = _pp_forward(params, tok[:, None], cache,
                                            P + step, cfg, pp, tp)
                tok = sample_logits(logits, generator, serve.temperature,
                                    serve.top_k)
                toks.append(tok)
        return torch.stack(toks, dim=1), cache

    return run
