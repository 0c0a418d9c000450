"""Ring attention: sequence-parallel causal attention and the long-prompt
prefill built on it (counterpart of ``quantizations_tpu/parallel/ring.py``).

The sequence axis is split over a mesh axis: rank ``d`` holds positions
``[d C, (d + 1) C)`` of Q, K and V. The K/V chunks go round the ring
(:func:`~.collectives.ring_shift`) while each rank folds every visiting
chunk into its queries' attention with an online softmax in fp32. The
mask is a function of the global position difference, which covers the
causal, own-chunk and sliding-window cases alike; a chunk wholly in the
future contributes nothing (every score masked), and the ring still
passes it on, so every rank does the same steps.

The einsums here are plain torch: the JAX package has no Pallas kernel
on this path. The prefill's projections run the model's kernels on each
rank's token chunk.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.llama import (
    LlamaConfig,
    LlamaParams,
    _ql,
    _ql_psum,
    apply_rope,
    embed_tokens,
    layer_params,
    layer_window,
    lm_head_logits,
    quantize_kv_i8,
    rms_norm,
    rope_cos_sin,
)
from ..ops.glue import activation, add_rms_norm_plain
from .collectives import all_gather_cat, broadcast, ring_shift
from .mesh import Axis, Mesh
from .shard import AXIS, check_mesh, validate_tp

__all__ = ["ring_attention", "make_ring_attention_fn", "make_sp_prefill_fn"]

_NEG = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: Axis, sliding_window: Optional[int] = None,
                   use_window: Optional[bool] = None,
                   scale: Optional[float] = None,
                   logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Causal attention of this rank's chunk ``q [B, C, KVH, G, D]`` over
    the whole sequence, whose chunks ``k, v [B, C, KVH, D]`` are spread
    over ``axis_name`` (coordinate ``d`` holds positions ``[d C, (d + 1)
    C)``). ``sliding_window`` attends iff ``0 <= q_pos - k_pos <
    window``; ``use_window`` False turns it off for a layer (the Gemma-2
    alternation). ``scale`` overrides ``D ** -0.5``; ``logit_softcap`` is
    Gemma-2's ``cap * tanh(s / cap)``. Returns fp32 ``[B, C, KVH, G,
    D]``."""
    B, C, KVH, G, D = q.shape
    n, d = axis_name.size, axis_name.rank
    scale = D ** -0.5 if scale is None else scale
    dev = q.device
    qf = q.float() * scale
    qpos = d * C + torch.arange(C, device=dev)[:, None]
    kloc = torch.arange(C, device=dev)[None, :]
    m = torch.full((B, C, KVH, G), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, C, KVH, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, C, KVH, G, D), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])                  # one message a ring step
    for s in range(n):
        kc, vc = kv[0], kv[1]
        src = (d - s) % n
        sc = torch.einsum("bqkgd,bskd->bqkgs", qf, kc.float())
        if logit_softcap is not None:
            sc = logit_softcap * torch.tanh(sc / logit_softcap)
        diff = qpos - (src * C + kloc)
        vis = diff >= 0
        if sliding_window is not None and use_window is not False:
            vis = vis & (diff < sliding_window)
        sc = torch.where(vis[None, :, None, None, :], sc,
                         torch.tensor(_NEG, device=dev))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        # a fully masked row (a future chunk) gives exp(_NEG - m) = 0
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgs,bskd->bqkgd", p, vc.float())
        m = m_new
        if s + 1 < n:
            kv = ring_shift(kv, axis_name)
    return acc / l[..., None]


def make_ring_attention_fn(mesh: Mesh, axis_name: str = "sp") -> Callable:
    """Sequence-parallel attention over the whole of ``q [B, T, KVH, G,
    D]`` and ``k, v [B, T, KVH, D]`` (the same on every rank, ``T``
    divisible by the axis): each rank attends its chunk and the output is
    gathered back, ``[B, T, KVH, G, D]`` on every rank. A standalone
    entry for tests and for callers that split the sequence
    themselves."""
    ax = check_mesh(mesh, (axis_name,)).axis(axis_name)

    def f(q, k, v):
        T = q.shape[1]
        if T % ax.size:
            raise ValueError(f"sequence {T} % {axis_name} {ax.size} != 0")
        C = T // ax.size
        sl = slice(ax.rank * C, (ax.rank + 1) * C)
        out = ring_attention(q[:, sl], k[:, sl], v[:, sl], ax)
        return all_gather_cat(out, ax, dim=1)

    return f


def _check_planar(params: LlamaParams) -> None:
    st = params.layers
    if st.o.layout == "pair" or st.down.layout == "pair":
        raise ValueError(
            "row-parallel o/down must be planar under tp (the pair layout's "
            "word axis does not slice congruently with K) — place params "
            "with parallel.shard_llama_params")


def make_sp_prefill_fn(mesh: Mesh, cfg: LlamaConfig, axis_name: str = "sp",
                       tp_axis: Optional[str] = None) -> Callable:
    """Sequence-parallel prefill of a long prompt: ``f(params, token_ids
    [B, T], cache) -> (last-token logits [B, vocab], cache)``.

    Each rank of ``axis_name`` embeds and projects its ``T / n`` tokens
    (the projections are token-parallel), attention is
    :func:`ring_attention`, and every layer's K/V chunks are gathered
    into ``cache`` positions ``[0, T)`` in the standard layout on every
    rank, so decode proceeds on the filled cache as after a single-device
    prefill. An int8 cache quantizes on write, and the ring attends the
    dequantized values, as the single-device prefill reads them back.

    ``tp_axis`` (the mesh axis named ``"tp"``) composes with tensor
    parallelism on a 2D (sp, tp) mesh: ``params`` are the rank's tp shard
    (:func:`~.shard.shard_llama_params`), o and down are summed over tp
    inside each chunk, and ``cache`` holds the rank's kv heads. The
    prompt and ``token_ids`` are the same on every rank; ``T`` must
    divide by the axis size."""
    int8_kv = cfg.kv_cache_dtype == "int8"
    if tp_axis is not None:
        if tp_axis != AXIS:
            raise ValueError("tp_axis must be the mesh axis named 'tp'")
        check_mesh(mesh, (axis_name, tp_axis))
        validate_tp(cfg, mesh.shape[tp_axis])
    sp = check_mesh(mesh, (axis_name,)).axis(axis_name)
    tp = mesh.axis(tp_axis) if tp_axis is not None else None
    qcfg = cfg.quant
    D = cfg.head_dim

    def trunk(params, tokens):
        B, C = tokens.shape
        dev = tokens.device
        positions = (sp.rank * C + torch.arange(C, device=dev))[None, :]
        positions = positions.expand(B, C)
        cos, sin = rope_cos_sin(positions, D, cfg.rope_theta,
                                cfg.rope_scaling)
        x = embed_tokens(params, tokens, cfg)
        chunks = []
        eps, plus_one = cfg.rms_norm_eps, cfg.norm_plus_one
        for i in range(params.layers.attn_norm.shape[0]):
            lay = layer_params(params.layers, i)
            xa = add_rms_norm_plain(x, None, lay.attn_norm, eps, plus_one)[1]
            x2 = xa.to(qcfg.compute_dtype).reshape(B * C, -1)
            q = _ql(x2, lay.q, qcfg, i)
            k = _ql(x2, lay.k, qcfg, i)
            v = _ql(x2, lay.v, qcfg, i)
            if lay.q_bias is not None:
                q = q + lay.q_bias.to(q.dtype)
                k = k + lay.k_bias.to(k.dtype)
                v = v + lay.v_bias.to(v.dtype)
            n_q, n_kv = q.shape[-1] // D, k.shape[-1] // D   # per tp shard
            q = q.reshape(B, C, n_q, D)
            k = k.reshape(B, C, n_kv, D)
            if lay.q_norm is not None:
                q = rms_norm(q, lay.q_norm, cfg.rms_norm_eps)
                k = rms_norm(k, lay.k_norm, cfg.rms_norm_eps)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            v = v.reshape(B, C, n_kv, D)
            if int8_kv:
                # quantize-on-write as the single-device path does, then
                # attend the dequantized values it reads back
                kq, kst = quantize_kv_i8(k.transpose(1, 2))
                vq, vst = quantize_kv_i8(v.transpose(1, 2))
                k = (kq.float() * kst[..., None].float()).transpose(1, 2)
                v = (vq.float() * vst[..., None].float()).transpose(1, 2)
                chunks.append((kq, vq, kst, vst))
            else:
                chunks.append((k.transpose(1, 2).to(torch.bfloat16),
                               v.transpose(1, 2).to(torch.bfloat16)))
            use_win, _ = layer_window(cfg, i)
            attn = ring_attention(
                q.reshape(B, C, n_kv, n_q // n_kv, D), k, v, sp,
                sliding_window=cfg.sliding_window, use_window=use_win,
                scale=(None if cfg.query_scale is None
                       else cfg.query_scale ** -0.5),
                logit_softcap=cfg.attn_logit_softcap)
            o = _ql_psum(attn.reshape(B * C, n_q * D).to(qcfg.compute_dtype),
                         lay.o, qcfg, i, tp, cfg.tp_overlap_chunks)
            ob = o.reshape(B, C, -1)
            if lay.post_attn_norm is not None:
                ob = add_rms_norm_plain(ob, None, lay.post_attn_norm, eps,
                                        plus_one)[1]
            x, xm = add_rms_norm_plain(x, ob, lay.mlp_norm, eps, plus_one)
            x2 = xm.to(qcfg.compute_dtype).reshape(B * C, -1)
            g = _ql(x2, lay.gate, qcfg, i)
            u = _ql(x2, lay.up, qcfg, i)
            act = activation(g, cfg.hidden_activation) * u
            dn = _ql_psum(act.to(qcfg.compute_dtype),
                          lay.down, qcfg, i, tp, cfg.tp_overlap_chunks)
            db = dn.reshape(B, C, -1)
            if lay.post_mlp_norm is not None:
                db = add_rms_norm_plain(db, None, lay.post_mlp_norm, eps,
                                        plus_one)[1]
            x = x + db.to(x.dtype)
        # the global last token lives on the axis's last coordinate
        xl = broadcast(x[:, -1:, :].contiguous(), sp, sp.size - 1)
        logits = lm_head_logits(params, xl, cfg, tp)[:, 0]
        return logits, chunks

    def f(params, token_ids, cache):
        if tp is not None:
            _check_planar(params)
        B, T = token_ids.shape
        if T % sp.size:
            raise ValueError(f"prompt {T} % {axis_name} {sp.size} != 0")
        if T > cache.max_seq:
            raise ValueError(f"prompt {T} runs past the cache's "
                             f"{cache.max_seq} positions")
        C = T // sp.size
        with torch.inference_mode():
            logits, chunks = trunk(
                params, token_ids[:, sp.rank * C:(sp.rank + 1) * C])
            # every layer's chunks at once: [L, B, KV, C, D] per plane,
            # gathered along the sequence into positions [0, T)
            planes = [torch.stack(p) for p in zip(*chunks)]
            names = ("k", "v", "k_scale", "v_scale")
            for name, plane in zip(names, planes):
                dst = getattr(cache, name)
                dst[:, :, :, :T] = all_gather_cat(plane, sp, dim=3).to(
                    dst.dtype)
        return logits, cache

    return f
