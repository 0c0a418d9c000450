"""Quantization parity metrics (counterpart of
``quantizations_tpu/evals/parity.py``).

The 4-bit model is compared with the same model whose weights are
dequantized to bf16 (what the quantization did) on any token stream:
top-1 agreement, KL divergence and the perplexity delta.

The dense twin's weights come from the route of ``QuantConfig.dense_twin``
(:func:`~quantizations_tpu_torch.models.llama.dense_twin_weight`): K10
for pair words, K7 for planar, their plain versions on the CPU. Its
projections are :func:`~quantizations_tpu_torch.nn.linear.dense_product`
(bf16 values, fp32 sums); its attention is an fp32 einsum with the
family's sliding-window and softcap rules. Above 4 GiB of dense-twin
bytes (Llama3-8B: 16 GB) the twin is dequantized layer by layer
(``lazy``), with logits bit-identical to the materialized twin's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from ..models.llama import (
    KVCache,
    LlamaConfig,
    LlamaLayer,
    LlamaParams,
    QLinear,
    apply_rope,
    dense_twin_weight,
    embed_lookup,
    prefill,
    rms_norm,
    rope_cos_sin,
)
from ..nn.linear import dense_product
from ..ops.glue import activation, add_rms_norm_plain

__all__ = ["dequantized_params", "logit_parity", "parity_report",
           "perplexity", "ParityReport"]

# above this many bytes of dense bf16 weights the twin runs lazily
LAZY_TWIN_BYTES = 4 * 2 ** 30


def _dense_from_qlinear(ql: QLinear, quant_type: str) -> torch.Tensor:
    """QLinear -> dense bf16 [out, in] in the original column order; a
    layer stack ``[L, ...]`` -> ``[L, out, in]``, filled one layer at a
    time so that only one layer's transient is live."""
    if ql.wp.dim() == 2:
        return dense_twin_weight(ql, quant_type)
    L = ql.wp.shape[0]
    out = torch.empty((L, ql.out_features, ql.in_features),
                      dtype=torch.bfloat16, device=ql.wp.device)
    for i in range(L):
        out[i] = dense_twin_weight(
            QLinear(wp=ql.wp[i], scales=ql.scales[i]), quant_type)
    return out


def _check_unfused(layers: LlamaLayer) -> None:
    if layers.qkv is not None or layers.gate_up is not None:
        raise ValueError("parity runs on unfused params (q/k/v, gate/up); "
                         "fuse_projections after it")


def dequantized_params(params: LlamaParams,
                       cfg: LlamaConfig) -> LlamaParams:
    """Replace every QLinear with its dequantized dense bf16 matrix: the
    bf16 reference model whose outputs define parity. Biases, norms and
    a dense embedding or lm_head pass through."""
    qt = cfg.quant.quant_type
    lay = params.layers
    _check_unfused(lay)
    layers = dataclasses.replace(lay, **{
        name: _dense_from_qlinear(getattr(lay, name), qt)
        for name in ("q", "k", "v", "o", "gate", "up", "down")})

    def conv(leaf):
        return (_dense_from_qlinear(leaf, qt).to(torch.bfloat16)
                if isinstance(leaf, QLinear) else leaf)

    return LlamaParams(embed=conv(params.embed), layers=layers,
                       final_norm=params.final_norm,
                       lm_head=conv(params.lm_head))


def _layer(st: LlamaLayer, i: int, qt: str, lazy: bool) -> LlamaLayer:
    """Layer ``i`` of the stacks; with ``lazy`` each QLinear becomes its
    dense bf16 weight here (same math as :func:`dequantized_params`)."""
    def take(v):
        if v is None:
            return None
        if isinstance(v, QLinear):
            v = QLinear(wp=v.wp[i], scales=v.scales[i])
            return dense_twin_weight(v, qt) if lazy else v
        return v[i]

    return dataclasses.replace(st, **{
        f.name: take(getattr(st, f.name)) for f in dataclasses.fields(st)})


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Causal attention of ``q [B, T, n_q, D]`` over ``k, v [B, T, n_kv,
    D]`` under ``mask [1, T, T]``, with the family's softcap: fp32
    operands, products, sums and softmax. Returns ``[B*T, n_q*D]``."""
    B, T, n_q, D = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, T, n_kv, n_q // n_kv, D).float()
    scores = torch.einsum("btkgd,bskd->btkgs", qg, k.float()) * (
        (cfg.query_scale or D) ** -0.5)
    if cfg.attn_logit_softcap is not None:
        cap = cfg.attn_logit_softcap
        scores = cap * torch.tanh(scores / cap)
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    w = torch.softmax(scores, dim=-1)
    attn = torch.einsum("btkgs,bskd->btkgd", w, v.float())
    return attn.reshape(B * T, n_q * D)


def _dense_forward(dense: LlamaParams, token_ids: torch.Tensor,
                   cfg: LlamaConfig, lazy: bool = False) -> torch.Tensor:
    """Causal forward of the dequantized-dense model: logits ``[B, T,
    vocab]`` fp32. With ``lazy=True``, ``dense`` is the quantized params
    and each layer is dequantized as it is reached (bit-identical logits
    to the materialized twin)."""
    B, T = token_ids.shape
    dev = token_ids.device
    qt = cfg.quant.quant_type
    _check_unfused(dense.layers)
    if lazy and isinstance(dense.embed, QLinear):
        x = embed_lookup(dense.embed, token_ids, qt).to(torch.bfloat16)
    else:
        x = dense.embed[token_ids.long()].to(torch.bfloat16)
    if cfg.embed_normalizer:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    qp = torch.arange(T, device=dev)[:, None]
    kp = torch.arange(T, device=dev)[None, :]
    mask_full = (kp <= qp)[None]
    mask_win = mask_full
    if cfg.sliding_window is not None:
        mask_win = mask_full & (kp > qp - cfg.sliding_window)[None]

    def proj(x2, W):
        return dense_product(x2.to(torch.bfloat16), W)

    D = cfg.head_dim
    eps, plus_one = cfg.rms_norm_eps, cfg.norm_plus_one
    for i in range(cfg.num_hidden_layers):
        lay = _layer(dense.layers, i, qt, lazy)
        if cfg.sliding_window is None or cfg.sliding_layers == "all":
            mask = mask_win
        else:
            use_win = (i % 2 == 0 if cfg.sliding_layers == "even"
                       else i % 2 == 1)
            mask = mask_win if use_win else mask_full
        n_q = lay.q.shape[0] // D
        n_kv = lay.k.shape[0] // D
        xa = add_rms_norm_plain(x, None, lay.attn_norm, eps, plus_one)[1]
        x2 = xa.reshape(B * T, -1)
        q = proj(x2, lay.q)
        k = proj(x2, lay.k)
        v = proj(x2, lay.v)
        if lay.q_bias is not None:
            q = q + lay.q_bias.to(q.dtype)
            k = k + lay.k_bias.to(k.dtype)
            v = v + lay.v_bias.to(v.dtype)
        q = q.reshape(B, T, n_q, D)
        k = k.reshape(B, T, n_kv, D)
        v = v.reshape(B, T, n_kv, D)
        if lay.q_norm is not None:
            q = rms_norm(q, lay.q_norm, cfg.rms_norm_eps)
            k = rms_norm(k, lay.k_norm, cfg.rms_norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = _attention(q, k, v, mask, cfg)
        o = proj(attn, lay.o)
        ob = o.reshape(B, T, -1)
        if lay.post_attn_norm is not None:
            ob = add_rms_norm_plain(ob, None, lay.post_attn_norm, eps,
                                    plus_one)[1]
        x, xm = add_rms_norm_plain(x, ob, lay.mlp_norm, eps, plus_one)
        x2 = xm.reshape(B * T, -1)
        act = (activation(proj(x2, lay.gate), cfg.hidden_activation)
               * proj(x2, lay.up))
        d = proj(act, lay.down)
        db = d.reshape(B, T, -1)
        if lay.post_mlp_norm is not None:
            db = add_rms_norm_plain(db, None, lay.post_mlp_norm, eps,
                                    plus_one)[1]
        x = x + db.to(x.dtype)

    x = add_rms_norm_plain(x, None, dense.final_norm, eps, plus_one)[1]
    head = dense.lm_head
    if lazy and isinstance(head, QLinear):
        head = dense_twin_weight(head, qt)
    logits = proj(x.reshape(B * T, -1), head.to(torch.bfloat16)).reshape(
        B, T, -1)
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


@dataclasses.dataclass
class ParityReport:
    top1_agreement: float     # fraction of positions with the same argmax
    mean_kl: float            # KL(dense || quantized), nats/token
    max_abs_logit_delta: float
    ppl_quant: float
    ppl_dense: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _qlinears(params: LlamaParams) -> Iterator[QLinear]:
    for f in dataclasses.fields(params.layers):
        v = getattr(params.layers, f.name)
        if isinstance(v, QLinear):
            yield v
    for v in (params.embed, params.lm_head):
        if isinstance(v, QLinear):
            yield v


def dense_twin_bytes(params: LlamaParams) -> int:
    """Bytes of the materialized dense bf16 twin's 4-bit weights."""
    return sum(2 * ql.out_features * ql.in_features
               * (ql.wp.shape[0] if ql.wp.dim() == 3 else 1)
               for ql in _qlinears(params))


def _next_token_ppl(lp: torch.Tensor, token_ids: torch.Tensor) -> float:
    tgt = token_ids[:, 1:].long()
    nll = -torch.gather(lp[:, :-1], -1, tgt[..., None])[..., 0].mean()
    return float(torch.exp(nll))


def logit_parity(params: LlamaParams, cfg: LlamaConfig,
                 token_ids: torch.Tensor) -> ParityReport:
    """Run the quantized model (``prefill`` into a fresh cache of the
    config's KV dtype) and its dense twin over ``token_ids [B, T]`` (on
    the params' device) and report the deltas. For a weight-only 4-bit
    scheme this is the quantization error, plus the KV cache's with an
    int8 cache, plus the rounding of the attention paths."""
    B, T = token_ids.shape
    lazy = dense_twin_bytes(params) > LAZY_TWIN_BYTES
    with torch.inference_mode():
        cache = KVCache.create(cfg, B, T, device=token_ids.device)
        ql, _ = prefill(params, token_ids, cache, cfg)
        del cache
        dense = params if lazy else dequantized_params(params, cfg)
        dl = _dense_forward(dense, token_ids, cfg, lazy=lazy)
        del dense
        return parity_report(ql, dl, token_ids)


def parity_report(ql: torch.Tensor, dl: torch.Tensor,
                  token_ids: torch.Tensor) -> ParityReport:
    """The deltas of the quantized model's logits ``ql`` against the
    dense twin's ``dl`` (both ``[B, T, vocab]``) over ``token_ids [B,
    T]``: the share of positions with the same argmax, the mean over
    positions of KL(dense || quantized) summed over the vocabulary, the
    largest logit difference, and each model's next-token perplexity on
    the stream."""
    qlp = torch.log_softmax(ql.float(), dim=-1)
    dlp = torch.log_softmax(dl.float(), dim=-1)
    top1 = float((ql.argmax(-1) == dl.argmax(-1)).float().mean())
    kl = float((torch.exp(dlp) * (dlp - qlp)).sum(-1).mean())
    mad = float((ql - dl).abs().max())
    return ParityReport(top1_agreement=top1, mean_kl=kl,
                        max_abs_logit_delta=mad,
                        ppl_quant=_next_token_ppl(qlp, token_ids),
                        ppl_dense=_next_token_ppl(dlp, token_ids))


def perplexity(params: LlamaParams, cfg: LlamaConfig,
               token_ids: torch.Tensor) -> float:
    """Next-token perplexity of the quantized model on a token stream."""
    B, T = token_ids.shape
    with torch.inference_mode():
        cache = KVCache.create(cfg, B, T, device=token_ids.device)
        logits, _ = prefill(params, token_ids, cache, cfg)
        lp = torch.log_softmax(logits.float(), dim=-1)
        return _next_token_ppl(lp, token_ids)
