"""HuggingFace checkpoints: safetensors -> quantized ``LlamaParams``, and
back out (counterpart of ``quantizations_tpu/models/hf_loader.py``).

HF is only a format here: ``config.json`` and the safetensors file or
shards are read one tensor at a time (peak host memory is one dense
tensor, :mod:`~quantizations_tpu_torch.models.safetensors_io`), each
weight is moved to the device and quantized there (K2 on the card,
through :func:`~quantizations_tpu_torch.models.llama.quantize_linear`),
and the layers are copied into preallocated ``[L, ...]`` stacks.

A checkpoint that holds bnb 4-bit flat keys is taken as it is: its codes
and statistics become the runtime words and fp32 scales without
re-quantization. :func:`save_bnb_checkpoint` writes that format, with the
embedding and the lm_head dense (K10 or K7 dequantizes a 4-bit table on
the card), and :func:`save_quantized` / :func:`load_quantized` keep the
runtime words and resolved scales in one file, under the JAX package's
keys and dtypes, so each package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..config import QuantConfig
from ..device import resolve_device
from ..ops.qmatmul import pack_scale_pairs, pair_to_planar, unpack_scale_pairs
from ..ops.quantize import dequantize_4bit_kernel, dequantize_4bit_pair
from ..quant.bnb_io import (bnb_flat_tensors, is_bnb_quantized, parse_bnb_flat,
                            qlinear_arrays_from_bnb)
from ..quant.codebooks import get_4bit_code
from ..quant.functional import quantize_blockwise
from ..quant.state import QuantState
from .llama import (
    LlamaConfig,
    LlamaLayer,
    LlamaParams,
    QLinear,
    quantize_linear,
    stack_layers,
)
from .safetensors_io import load_file, read_tensors, save_file

__all__ = [
    "config_from_hf",
    "config_to_hf",
    "load_hf_llama",
    "save_quantized",
    "load_quantized",
    "save_bnb_checkpoint",
]


def _is(archs, family: str) -> bool:
    return any(a.startswith(family) for a in archs)


def config_from_hf(model_dir: str,
                   quant: Optional[QuantConfig] = None) -> LlamaConfig:
    """Build :class:`LlamaConfig` from an HF ``config.json``.

    A genuine bnb 4-bit stanza (``quant_method == "bitsandbytes"`` and
    ``load_in_4bit``) dictates ``quant_type``: the stored codes are FP4
    or NF4 bytes. A stale or 8-bit stanza does not override the request.
    Family rules: llama3 ``rope_scaling``; Qwen2 implies a qkv bias and
    gates ``sliding_window`` behind ``use_sliding_window``; Mistral's
    ``sliding_window``; Gemma-2's softcaps, ``query_pre_attn_scalar``,
    sandwich norms and sliding layers from ``layer_types`` (even layers
    by default); Qwen3's ``qk_norm``."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    qc = hf.get("quantization_config") or {}
    stored_qt = qc.get("bnb_4bit_quant_type")
    if (stored_qt and qc.get("quant_method") == "bitsandbytes"
            and qc.get("load_in_4bit", False)):
        quant = dataclasses.replace(quant or QuantConfig(),
                                    quant_type=stored_qt)
    rs = hf.get("rope_scaling") or None
    rope_scaling = None
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        rope_scaling = (
            float(rs["factor"]),
            float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]),
            int(rs["original_max_position_embeddings"]),
        )
    head_dim = hf.get("head_dim") or (
        hf["hidden_size"] // hf["num_attention_heads"])
    archs = hf.get("architectures", [])
    gemma_kw = {}
    if _is(archs, "Gemma2"):
        lt = hf.get("layer_types")
        sliding = ("even" if not lt or lt[0] == "sliding_attention"
                   else "odd")
        gemma_kw = dict(
            hidden_activation="gelu_tanh",
            post_norms=True,
            norm_plus_one=True,
            embed_normalizer=True,
            attn_logit_softcap=hf.get("attn_logit_softcapping"),
            final_logit_softcap=hf.get("final_logit_softcapping"),
            query_scale=hf.get("query_pre_attn_scalar"),
            sliding_layers=sliding,
        )
    qwen2 = _is(archs, "Qwen2")
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get(
            "num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        rope_theta=float(hf.get("rope_theta", 500000.0)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
        rope_scaling=rope_scaling,
        attention_bias=bool(hf.get("attention_bias", qwen2)),
        sliding_window=(hf.get("sliding_window")
                        if hf.get("use_sliding_window", not qwen2) else None),
        quant=quant or QuantConfig(),
        qk_norm=_is(archs, "Qwen3"),
        **gemma_kw,
    )


def load_hf_llama(
    model_dir: str,
    quant: Optional[QuantConfig] = None,
    mesh=None,
    dtype: Any = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[LlamaConfig, LlamaParams]:
    """Load and quantize an HF Llama-family checkpoint onto ``device``.

    Each weight is read on the host, moved to ``device`` and quantized
    there (K2 on the card, its plain version on the CPU); bnb 4-bit flat
    keys are taken verbatim, and their quant type must be one across the
    checkpoint (``ValueError`` otherwise). ``dtype`` is accepted and
    unused, as in the JAX package.

    ``mesh`` (a :class:`~quantizations_tpu_torch.parallel.Mesh` with a
    ``"tp"`` axis) loads this rank's tensor-parallel shard onto the
    mesh's device: o and down are planar, each weight is quantized whole
    as in the single-device load and the rank keeps its slice
    (``parallel.shard``), so double quantization never sees a partial
    tensor."""
    shard = None
    if mesh is not None:
        from ..parallel.shard import AXIS, check_mesh

        ax = check_mesh(mesh).axis(AXIS)
        shard = (ax.size, ax.rank)
        device = mesh.device
    dev = resolve_device(device)
    read = read_tensors(model_dir)
    # pre-quantized bnb tensors dictate the quant type even when
    # config.json has no quantization_config: the flat key embeds it
    stored = {"nf4" if n.endswith("bitsandbytes__nf4") else "fp4"
              for n in read.names
              if ".weight.quant_state.bitsandbytes__" in n}
    if len(stored) > 1:
        raise ValueError(f"mixed bnb quant types in checkpoint: {stored}")
    if stored:
        quant = dataclasses.replace(quant or QuantConfig(),
                                    quant_type=stored.pop())
    cfg = config_from_hf(model_dir, quant)
    q = cfg.quant
    if shard is not None:
        from ..parallel.shard import (shard_column, shard_row, split_rows,
                                      validate_tp)

        validate_tp(cfg, shard[0])

    def weight(name: str) -> torch.Tensor:
        """A dense weight on the device, fp32 or bf16 as stored (another
        float type widened to fp32, exactly)."""
        w = read(name).to(dev)
        return w if w.dtype in (torch.float32, torch.bfloat16) else w.float()

    def quantize(W: torch.Tensor, scales_dtype: Any,
                 layout: str = "auto") -> QLinear:
        return quantize_linear(W, blocksize=q.blocksize,
                               quant_type=q.quant_type,
                               compress_statistics=q.compress_statistics,
                               scales_dtype=scales_dtype, layout=layout)

    def qlin(name: str, part: Optional[str] = None) -> QLinear:
        """The QLinear of ``name``; under a mesh this rank's ``part``
        ("col" or "row") of it, row-parallel weights planar."""
        ql = _qlin(name, planar=shard is not None and part == "row")
        if shard is None or part is None:
            return ql
        return (shard_column if part == "col" else shard_row)(ql, *shard)

    def _qlin(name: str, planar: bool) -> QLinear:
        prefix = name[: -len(".weight")]
        if not is_bnb_quantized(read.names, prefix):
            return quantize(weight(name), q.scales_dtype,
                            "planar" if planar else "auto")
        # the stored codes and statistics, verbatim
        packed, state = parse_bnb_flat(lambda n: read(n).numpy(), read.names,
                                       prefix)
        if state.quant_type != q.quant_type:
            raise ValueError(
                f"{prefix}: stored bnb codes are {state.quant_type} "
                f"but the model is configured {q.quant_type}")
        lay = ("pair" if state.shape[0] % 2 == 0 and not planar
               else "planar")
        wp, scales = qlinear_arrays_from_bnb(packed, state, layout=lay,
                                             device=dev)
        if q.scales_dtype == "bf16x2":
            # planar weights keep fp32 scales
            return QLinear(wp=wp, scales=(pack_scale_pairs(scales)
                                          if lay == "pair" else scales))
        return QLinear(wp=wp, scales=scales.to(q.scales_dtype))

    def vec(name: str) -> torch.Tensor:
        return read(name).to(dev).to(torch.bfloat16)

    def bias(name: str) -> torch.Tensor:
        """A column-parallel projection's bias (this rank's rows of it)."""
        b = vec(name)
        return b if shard is None else split_rows(b, *shard)

    def make_layer(i: int) -> LlamaLayer:
        p = f"model.layers.{i}."
        if cfg.post_norms:
            # Gemma sandwich norms: post_attention_layernorm is the
            # post-attention norm, pre_feedforward the pre-MLP one
            mlp_norm = vec(p + "pre_feedforward_layernorm.weight")
            post_attn = vec(p + "post_attention_layernorm.weight")
            post_mlp = vec(p + "post_feedforward_layernorm.weight")
        else:
            mlp_norm = vec(p + "post_attention_layernorm.weight")
            post_attn = post_mlp = None
        a = p + "self_attn."
        has_bias = cfg.attention_bias
        return LlamaLayer(
            attn_norm=vec(p + "input_layernorm.weight"),
            q=qlin(a + "q_proj.weight", "col"),
            k=qlin(a + "k_proj.weight", "col"),
            v=qlin(a + "v_proj.weight", "col"),
            q_bias=bias(a + "q_proj.bias") if has_bias else None,
            k_bias=bias(a + "k_proj.bias") if has_bias else None,
            v_bias=bias(a + "v_proj.bias") if has_bias else None,
            o=qlin(a + "o_proj.weight", "row"),
            mlp_norm=mlp_norm,
            gate=qlin(p + "mlp.gate_proj.weight", "col"),
            up=qlin(p + "mlp.up_proj.weight", "col"),
            down=qlin(p + "mlp.down_proj.weight", "row"),
            post_attn_norm=post_attn, post_mlp_norm=post_mlp,
            q_norm=vec(a + "q_norm.weight") if cfg.qk_norm else None,
            k_norm=vec(a + "k_norm.weight") if cfg.qk_norm else None)

    layers = stack_layers(make_layer, cfg.num_hidden_layers, dev)

    embed_w = weight("model.embed_tokens.weight")
    if q.quantize_embedding:
        # a row gather: bf16 scales in place of bf16x2
        embed = quantize(embed_w, torch.bfloat16 if q.scales_dtype == "bf16x2"
                         else q.scales_dtype)
    else:
        embed = embed_w.to(torch.bfloat16)
    # the reference widens the head to fp32 first: exact for fp32/bf16
    head_w = (embed_w if cfg.tie_word_embeddings
              or "lm_head.weight" not in read.names
              else weight("lm_head.weight"))
    del embed_w
    lm_head = (quantize(head_w, q.scales_dtype) if q.quantize_lm_head
               else head_w.to(torch.bfloat16))
    del head_w
    if shard is not None:
        lm_head = (shard_column(lm_head, *shard)
                   if isinstance(lm_head, QLinear)
                   else split_rows(lm_head, *shard, dim=0))
    params = LlamaParams(embed=embed, layers=layers,
                         final_norm=vec("model.norm.weight"),
                         lm_head=lm_head)
    return cfg, params


# --------------------------------------------------------------------------
# Pre-quantized checkpoints in the runtime layout
# --------------------------------------------------------------------------

def _check_unfused(params: LlamaParams, what: str) -> None:
    if params.layers.qkv is not None or params.layers.gate_up is not None:
        raise ValueError(
            f"{what} takes unfused params (q/k/v and gate/up); these are "
            "fused (qkv/gate_up): save them before fuse_projections")


def _iter_qlinears(params: LlamaParams
                   ) -> Iterator[Tuple[str, Union[torch.Tensor, QLinear]]]:
    _check_unfused(params, "save_quantized")
    lay = params.layers
    yield "embed", params.embed
    yield "final_norm", params.final_norm
    yield "layers.attn_norm", lay.attn_norm
    yield "layers.mlp_norm", lay.mlp_norm
    for attr in ("q", "k", "v", "o", "gate", "up", "down"):
        yield f"layers.{attr}", getattr(lay, attr)
    # the optional family leaves: qkv biases (Qwen2), sandwich norms
    # (Gemma-2), per-head qk norms (Qwen3)
    for attr in ("q_bias", "k_bias", "v_bias", "post_attn_norm",
                 "post_mlp_norm", "q_norm", "k_norm"):
        leaf = getattr(lay, attr)
        if leaf is not None:
            yield f"layers.{attr}", leaf
    yield "lm_head", params.lm_head


def save_quantized(params: LlamaParams, path: str) -> None:
    """Save quantized params to one safetensors file: a QLinear as
    ``<name>.weight.packed`` (its int32 words) and ``<name>.weight.absmax``
    (its resolved scales: fp32, bf16, or ``bf16x2`` int32 words), every
    other tensor as fp32 when it is bf16 — the JAX package's keys and
    dtypes. Fused params raise ``ValueError`` (the JAX package fails on
    them with an ``AttributeError``)."""
    tensors: Dict[str, torch.Tensor] = {}
    for name, leaf in _iter_qlinears(params):
        if isinstance(leaf, QLinear):
            tensors[name + ".weight.packed"] = leaf.wp
            tensors[name + ".weight.absmax"] = leaf.scales
        else:
            tensors[name] = (leaf.float() if leaf.dtype == torch.bfloat16
                             else leaf)
    save_file(tensors, path)


def load_quantized(path: str, cfg: LlamaConfig,
                   device: Union[str, torch.device] = "cuda"
                   ) -> LlamaParams:
    """Inverse of :func:`save_quantized` onto ``device`` (also reads the
    JAX package's files)."""
    dev = resolve_device(device)
    t = load_file(path)

    def get(name):
        if name + ".weight.packed" in t:
            return QLinear(wp=t[name + ".weight.packed"].to(dev),
                           scales=t[name + ".weight.absmax"].to(dev))
        return t[name].to(dev).to(torch.bfloat16)

    def get_opt(name):
        return get(name) if name in t else None

    layers = LlamaLayer(
        attn_norm=get("layers.attn_norm"),
        q=get("layers.q"), k=get("layers.k"), v=get("layers.v"),
        o=get("layers.o"),
        mlp_norm=get("layers.mlp_norm"),
        gate=get("layers.gate"), up=get("layers.up"), down=get("layers.down"),
        q_bias=get_opt("layers.q_bias"),
        k_bias=get_opt("layers.k_bias"),
        v_bias=get_opt("layers.v_bias"),
        post_attn_norm=get_opt("layers.post_attn_norm"),
        post_mlp_norm=get_opt("layers.post_mlp_norm"),
        q_norm=get_opt("layers.q_norm"),
        k_norm=get_opt("layers.k_norm"),
    )
    return LlamaParams(embed=get("embed"), layers=layers,
                       final_norm=get("final_norm"), lm_head=get("lm_head"))


# --------------------------------------------------------------------------
# bnb-format export: an HF directory whose quantized linears use the bnb
# flat keys, which load_hf_llama reloads without re-quantizing
# --------------------------------------------------------------------------

def config_to_hf(cfg: LlamaConfig, compress_statistics: bool = True,
                 ) -> Dict[str, Any]:
    """Inverse of :func:`config_from_hf`: an HF ``config.json`` dict whose
    architecture name makes the loader's family rules fire."""
    if cfg.qk_norm:
        arch, mt = "Qwen3ForCausalLM", "qwen3"
    elif cfg.post_norms:
        arch, mt = "Gemma2ForCausalLM", "gemma2"
    elif cfg.attention_bias:
        arch, mt = "Qwen2ForCausalLM", "qwen2"
    elif cfg.sliding_window is not None:
        arch, mt = "MistralForCausalLM", "mistral"
    else:
        arch, mt = "LlamaForCausalLM", "llama"
    hf: Dict[str, Any] = {
        "architectures": [arch],
        "model_type": mt,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "attention_bias": cfg.attention_bias,
        "torch_dtype": "bfloat16",
        "quantization_config": {
            "quant_method": "bitsandbytes",
            "load_in_4bit": True,
            "bnb_4bit_quant_type": cfg.quant.quant_type,
            "bnb_4bit_use_double_quant": compress_statistics,
            "bnb_4bit_compute_dtype": "bfloat16",
        },
    }
    if cfg.sliding_window is not None:
        hf["sliding_window"] = cfg.sliding_window
        hf["use_sliding_window"] = True
    if cfg.rope_scaling is not None:
        f, lo, hi, om = cfg.rope_scaling
        hf["rope_scaling"] = {
            "rope_type": "llama3", "factor": f, "low_freq_factor": lo,
            "high_freq_factor": hi,
            "original_max_position_embeddings": om,
        }
    if cfg.post_norms:   # the Gemma-2 block
        hf["attn_logit_softcapping"] = cfg.attn_logit_softcap
        hf["final_logit_softcapping"] = cfg.final_logit_softcap
        hf["query_pre_attn_scalar"] = cfg.query_scale
        first = ("sliding_attention" if cfg.sliding_layers == "even"
                 else "full_attention")
        other = ("full_attention" if first == "sliding_attention"
                 else "sliding_attention")
        hf["layer_types"] = [first if i % 2 == 0 else other
                             for i in range(cfg.num_hidden_layers)]
    return hf


def _bnb_payload(ql: QLinear, quant_type: str, compress: bool
                 ) -> Tuple[np.ndarray, QuantState]:
    """Runtime QLinear (pair or planar words, resolved scales) -> (bnb
    packed uint8 ``[n/2, 1]``, QuantState on the CPU): the inverse of
    :func:`~quantizations_tpu_torch.quant.bnb_io.qlinear_arrays_from_bnb`,
    with the double quantization encoded here, once. ``bf16x2`` scales
    are widened to the bf16 values the kernels compute with."""
    wp = pair_to_planar(ql.wp) if ql.layout == "pair" else ql.wp
    M, K8 = wp.shape
    K = K8 * 8
    # the little-endian bytes of the planar words are the bnb byte stream
    packed = wp.contiguous().cpu().view(torch.uint8).numpy().reshape(
        M * K // 2, 1)
    scales = unpack_scale_pairs(ql.scales) if ql.scales_packed else ql.scales
    absmax = scales.float().reshape(-1).cpu()
    code = torch.from_numpy(get_4bit_code(quant_type).copy())
    meta = dict(code=code, blocksize=64, quant_type=quant_type,
                dtype=torch.bfloat16, shape=(M, K))
    if not compress:
        return packed, QuantState(absmax=absmax, **meta)
    offset = absmax.mean()
    qabsmax, state2 = quantize_blockwise(absmax - offset, blocksize=256)
    return packed, QuantState(absmax=qabsmax, offset=offset, state2=state2,
                              **meta)


def _dense(x: Union[torch.Tensor, QLinear], quant_type: str) -> torch.Tensor:
    """A leaf as fp32 for the export: a 4-bit table dequantized to bf16
    (K10 for pair words, K7 for planar ones, on the card) and widened."""
    if isinstance(x, QLinear):
        dq = (dequantize_4bit_pair if x.layout == "pair"
              else dequantize_4bit_kernel)
        x = dq(x.wp, x.scales, quant_type, dtype=torch.bfloat16)
    return x.float()


def save_bnb_checkpoint(params: LlamaParams, cfg: LlamaConfig,
                        out_dir: str,
                        compress_statistics: bool = True) -> None:
    """Export quantized params as an HF directory in the bnb flat-key
    format: quantized linears keep their packed codes verbatim, their
    statistics double-quantized again when ``compress_statistics`` (bnb's
    default, slightly lossy on the scales) or written as fp32 absmax
    (exact). The embedding, lm_head and norms are written dense in fp32
    (HF + bnb keep them unquantized). ``load_hf_llama(out_dir)`` reloads
    the packed bytes as they are. ``bf16x2`` models export their bf16
    runtime scales. Fused params raise ``ValueError``."""
    _check_unfused(params, "save_bnb_checkpoint")
    qt = cfg.quant.quant_type
    tensors: Dict[str, torch.Tensor] = {}

    def put_q(prefix: str, lin: QLinear, i: int) -> None:
        packed, state = _bnb_payload(
            QLinear(wp=lin.wp[i], scales=lin.scales[i]), qt,
            compress_statistics)
        tensors.update(bnb_flat_tensors(prefix, packed, state))

    def put(name: str, leaf: torch.Tensor) -> None:
        tensors[name] = _dense(leaf, qt).cpu()

    lay = params.layers
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        for attr, hf in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                         ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                         ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                         ("down", "mlp.down_proj")):
            put_q(p + hf, getattr(lay, attr), i)
        put(p + "input_layernorm.weight", lay.attn_norm[i])
        if cfg.post_norms:
            put(p + "post_attention_layernorm.weight", lay.post_attn_norm[i])
            put(p + "pre_feedforward_layernorm.weight", lay.mlp_norm[i])
            put(p + "post_feedforward_layernorm.weight", lay.post_mlp_norm[i])
        else:
            put(p + "post_attention_layernorm.weight", lay.mlp_norm[i])
        if cfg.attention_bias:
            for attr in ("q", "k", "v"):
                put(p + f"self_attn.{attr}_proj.bias",
                    getattr(lay, f"{attr}_bias")[i])
        if cfg.qk_norm:
            put(p + "self_attn.q_norm.weight", lay.q_norm[i])
            put(p + "self_attn.k_norm.weight", lay.k_norm[i])

    put("model.embed_tokens.weight", params.embed)
    put("model.norm.weight", params.final_norm)
    if not cfg.tie_word_embeddings:
        put("lm_head.weight", params.lm_head)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg, compress_statistics), f, indent=1)
    save_file(tensors, os.path.join(out_dir, "model.safetensors"))
