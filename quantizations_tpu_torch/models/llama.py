"""Llama3 in PyTorch with 4-bit quantized projections (counterpart of
``quantizations_tpu/models/llama.py``).

Architecture: RMSNorm, rotary embeddings (HF non-interleaved
convention), grouped-query attention, SwiGLU MLP, with the family knobs
the JAX package carries on this path: q/k/v bias, sliding window and its
Gemma-2 per-layer alternation, attention and final softcaps,
``query_scale``, sandwich post-norms, ``qk_norm`` and GeGLU.

Layer parameters are stacked ``[L, ...]`` as in the JAX package. The
scan over layers is a Python loop: the layer index is a Python int, so
``wp2[idx]`` is a view into the contiguous stack and the pair kernel
reads the layer in place, as scalar prefetch does on the TPU.

Attention is the einsum path, or at ``T == 1`` with
``use_flash_attention`` the flash-decode kernels (K3, or K4 over an
int8 cache). ``kv_cache_dtype="int8"`` stores codes with a bf16 step per
cached row (:func:`quantize_kv_i8`).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Iterator, Optional, Tuple, Union

import torch

from ..config import QuantConfig
from ..device import resolve_device
from ..nn.linear import (
    GEMV_MAX_TOKENS,
    QMATMUL_MAX_TOKENS,
    apply_4bit,
    dense_product,
    gemv_activation,
    kernel_activation,
    manual_ok,
    pair_max_tokens,
    qmm_ok,
)
from ..ops.attention import (
    flash_decode_attention_stacked,
    flash_decode_attention_stacked_i8,
)
from ..ops.gemv import _SHIFTS, gemv_4bit_stacked, pack_i32_rows
from ..ops.qmatmul import (
    PREFILL_PAIR_CHUNK_T,
    _unblockmajor,
    matmul_4bit_pair_manual_stacked,
    matmul_4bit_pair_stacked,
    matmul_4bit_planar_stacked,
    pack_scale_pairs,
    pair_prefill_matmul,
    planar_to_pair,
    prefill_pair_ok,
)
from ..ops.quantize import (
    dequantize_4bit_kernel,
    dequantize_4bit_pair,
    quantize_4bit_kernel,
)
from ..quant.codebooks import get_4bit_code
from ..quant.functional import (
    dequantize_absmax,
    dequantize_blockwise,
    quantize_4bit,
    quantize_blockwise,
)

__all__ = [
    "LlamaConfig",
    "QLinear",
    "LlamaLayer",
    "LlamaParams",
    "KVCache",
    "quantize_linear",
    "init_llama_params",
    "fuse_projections",
    "stack_layers",
    "rms_norm",
    "rope_cos_sin",
    "apply_rope",
    "embed_lookup",
    "layer_window",
    "layer_params",
    "embed_tokens",
    "lm_head_logits",
    "quantize_kv_i8",
    "check_cache_room",
    "prefill",
    "decode_step",
    "named_tensors",
    "map_tensors",
    "prefill_pair_enabled",
    "LLAMA3_8B",
    "TINY_LLAMA",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Static model hyperparameters (HF ``config.json`` field names).
    Field meanings are those of the JAX package's ``LlamaConfig``."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    # HF "llama3" rope scaling: (factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings); None = off
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    attention_bias: bool = False
    sliding_window: Optional[int] = None
    use_flash_attention: bool = False
    tp_overlap_chunks: int = 1
    hidden_activation: str = "silu"          # or "gelu_tanh"
    post_norms: bool = False
    norm_plus_one: bool = False
    embed_normalizer: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    sliding_layers: str = "all"              # "all" | "even" | "odd"
    qk_norm: bool = False
    kv_cache_dtype: str = "bf16"
    paged_pages_per_step: int = 2
    quant: QuantConfig = QuantConfig()

    @property
    def q_size(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_key_value_heads * self.head_dim


LLAMA3_8B = LlamaConfig()

# Tiny config for tests.
TINY_LLAMA = LlamaConfig(
    vocab_size=1024,
    hidden_size=512,
    intermediate_size=1024,
    num_hidden_layers=2,
    num_attention_heads=8,
    num_key_value_heads=8,
    head_dim=64,
    rope_theta=10000.0,
    max_position_embeddings=256,
)


@dataclasses.dataclass
class QLinear:
    """A 4-bit linear weight: packed int32 words + resolved scales.

    - ``planar``: ``wp [out, in/8]``.
    - ``pair``: ``wp [out/2, in/4]`` (``ops/qmatmul.py`` layout).

    ``scales`` are fp32/bf16 ``[out, in/64]`` or the ``bf16x2`` storage
    ``int32 [out/2, in/64]`` (pair only). A leading ``[L]`` axis on both
    marks a layer stack."""

    wp: torch.Tensor
    scales: torch.Tensor

    @property
    def scales_packed(self) -> bool:
        return self.scales.dtype == torch.int32

    @property
    def layout(self) -> str:
        if self.scales_packed:
            return "pair"
        return ("planar" if self.wp.shape[-2] == self.scales.shape[-2]
                else "pair")

    @property
    def out_features(self) -> int:
        rows = self.scales.shape[-2]
        return 2 * rows if self.scales_packed else rows

    @property
    def in_features(self) -> int:
        return self.scales.shape[-1] * 64


@dataclasses.dataclass
class LlamaLayer:
    """One decoder layer's parameters; in :class:`LlamaParams` every
    tensor carries a leading ``[num_layers]`` axis. After
    :func:`fuse_projections`, ``qkv``/``gate_up`` replace q/k/v and
    gate/up."""

    attn_norm: torch.Tensor
    q: Optional[QLinear]
    k: Optional[QLinear]
    v: Optional[QLinear]
    o: QLinear
    mlp_norm: torch.Tensor
    gate: Optional[QLinear]
    up: Optional[QLinear]
    down: QLinear
    q_bias: Optional[torch.Tensor] = None
    k_bias: Optional[torch.Tensor] = None
    v_bias: Optional[torch.Tensor] = None
    post_attn_norm: Optional[torch.Tensor] = None
    post_mlp_norm: Optional[torch.Tensor] = None
    q_norm: Optional[torch.Tensor] = None
    k_norm: Optional[torch.Tensor] = None
    qkv: Optional[QLinear] = None
    gate_up: Optional[QLinear] = None
    qkv_bias: Optional[torch.Tensor] = None


@dataclasses.dataclass
class LlamaParams:
    embed: Union[torch.Tensor, QLinear]     # bf16 [vocab, hidden] or 4-bit
    layers: LlamaLayer                      # stacked [L, ...]
    final_norm: torch.Tensor                # [hidden]
    lm_head: Union[torch.Tensor, QLinear]   # 4-bit or bf16 [vocab, hidden]


@dataclasses.dataclass
class KVCache:
    """Preallocated KV cache ``[L, B, kv_heads, max_seq, head_dim]``: bf16
    (any ``kv_cache_dtype`` but ``"int8"``, as in the JAX package), or
    int8 codes with a bf16 dequant step
    per cached row in ``k_scale``/``v_scale`` ``[L, B, kv_heads,
    max_seq]``.

    Updated IN PLACE: each layer writes its new rows with one indexed
    assignment into the stacked tensors (the JAX package threads a
    donated scan carry through ``dynamic_update_slice`` instead).
    ``prefill``/``decode_step`` return the same object they were given."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, max_seq: int,
               device: Union[str, torch.device] = "cuda") -> "KVCache":
        dev = resolve_device(device)
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
                 max_seq, cfg.head_dim)
        if cfg.kv_cache_dtype == "int8":
            return cls(k=torch.zeros(shape, dtype=torch.int8, device=dev),
                       v=torch.zeros(shape, dtype=torch.int8, device=dev),
                       k_scale=torch.zeros(shape[:4], dtype=torch.bfloat16,
                                           device=dev),
                       v_scale=torch.zeros(shape[:4], dtype=torch.bfloat16,
                                           device=dev))
        return cls(k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                   v=torch.zeros(shape, dtype=torch.bfloat16, device=dev))

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


# --------------------------------------------------------------------------
# Tensor trees
# --------------------------------------------------------------------------

def named_tensors(obj: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """Every tensor of a params/cache dataclass tree with its dotted path
    (``"layers.q.wp"``), in field order; None fields are skipped."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            if val is not None:
                yield from named_tensors(
                    val, f"{prefix}.{f.name}" if prefix else f.name)


def map_tensors(fn, obj: Any) -> Any:
    """Apply ``fn`` to every tensor of a dataclass tree."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None})
    return obj


# --------------------------------------------------------------------------
# Parameter construction
# --------------------------------------------------------------------------

def quantize_linear(W: torch.Tensor, blocksize: int = 64,
                    quant_type: str = "fp4", compress_statistics: bool = True,
                    scales_dtype: Any = torch.float32,
                    layout: str = "auto") -> QLinear:
    """Quantize a ``[out, in]`` weight into a :class:`QLinear`.

    On CUDA the weight quantization is kernel K2 and the absmax double
    quantization (1/64th of the data) stays plain torch; on the CPU the
    functional path runs. Both give the same words and scales.
    ``layout="auto"`` picks the pair layout for an even row count."""
    out_f, in_f = W.shape
    if W.is_cuda:
        wp, absmax2d = quantize_4bit_kernel(W, blocksize, quant_type)
        absmax = absmax2d.reshape(-1)
        if compress_statistics:
            offset = absmax.mean()
            q8, st2 = quantize_blockwise(absmax - offset, blocksize=256)
            absmax = dequantize_blockwise(q8, st2) + offset
        scales = absmax.reshape(out_f, in_f // blocksize)
    else:
        packed, state = quantize_4bit(
            W, blocksize=blocksize, quant_type=quant_type,
            compress_statistics=compress_statistics)
        wp = pack_i32_rows(packed, out_f, in_f)
        scales = dequantize_absmax(state).reshape(out_f, in_f // blocksize)
    if blocksize != 64:
        scales = scales.repeat_interleave(blocksize // 64, dim=1)
    if layout == "auto":
        layout = "pair" if out_f % 2 == 0 else "planar"
    if layout == "pair":
        wp = planar_to_pair(wp)
    if scales_dtype == "bf16x2":
        if layout != "pair":
            return QLinear(wp=wp, scales=scales.to(torch.float32))
        return QLinear(wp=wp, scales=pack_scale_pairs(scales))
    return QLinear(wp=wp, scales=scales.to(scales_dtype))


def stack_layers(make_layer: Callable[[int], LlamaLayer], L: int,
                 device: torch.device) -> LlamaLayer:
    """The ``[L, ...]`` stacks of layers ``make_layer(0)`` to
    ``make_layer(L - 1)``: layer 0 is built first and gives the stacks'
    shapes, then each layer is copied in as it is built, so peak memory is
    the stacks plus one layer."""
    layer0 = make_layer(0)
    layers = map_tensors(
        lambda t: torch.empty((L,) + tuple(t.shape), dtype=t.dtype,
                              device=device), layer0)
    for i in range(L):
        layer = layer0 if i == 0 else make_layer(i)
        for (_, dst), (_, src) in zip(named_tensors(layers),
                                      named_tensors(layer)):
            dst[i].copy_(src)
        del layer
    return layers


def init_llama_params(cfg: LlamaConfig, seed: int = 0, scale: float = 0.02,
                      dist: str = "normal",
                      device: Union[str, torch.device] = "cuda"
                      ) -> LlamaParams:
    """Random-initialized quantized model, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.

    Layers are drawn and quantized one at a time and copied into
    preallocated stacks, so peak memory is the model plus one dense
    layer. Only ``dist="normal"`` is ported."""
    if dist != "normal":
        raise NotImplementedError(f"init_llama_params dist={dist!r} is not "
                                  "ported (only 'normal')")
    dev = resolve_device(device)
    q = cfg.quant
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, qs, kvs, inter = (cfg.hidden_size, cfg.q_size, cfg.kv_size,
                         cfg.intermediate_size)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    def qlin(out_f, in_f, scales_dtype=None):
        return quantize_linear(
            randn(out_f, in_f) * scale, blocksize=q.blocksize,
            quant_type=q.quant_type,
            compress_statistics=q.compress_statistics,
            scales_dtype=q.scales_dtype if scales_dtype is None
            else scales_dtype)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    def bias(n):
        if not cfg.attention_bias:
            return None
        return (randn(n) * scale).to(torch.bfloat16)

    def make_layer() -> LlamaLayer:
        return LlamaLayer(
            attn_norm=ones(h), q=qlin(qs, h), k=qlin(kvs, h), v=qlin(kvs, h),
            o=qlin(h, qs), mlp_norm=ones(h), gate=qlin(inter, h),
            up=qlin(inter, h), down=qlin(h, inter),
            q_bias=bias(qs), k_bias=bias(kvs), v_bias=bias(kvs),
            post_attn_norm=ones(h) if cfg.post_norms else None,
            post_mlp_norm=ones(h) if cfg.post_norms else None,
            q_norm=ones(cfg.head_dim) if cfg.qk_norm else None,
            k_norm=ones(cfg.head_dim) if cfg.qk_norm else None)

    layers = stack_layers(lambda i: make_layer(), cfg.num_hidden_layers, dev)

    if q.quantize_embedding:
        # the embedding is a row gather: bf16 scales instead of bf16x2
        embed = qlin(cfg.vocab_size, h,
                     scales_dtype=(torch.bfloat16 if q.scales_dtype == "bf16x2"
                                   else None))
    else:
        embed = (randn(cfg.vocab_size, h) * scale).to(torch.bfloat16)
    if q.quantize_lm_head:
        lm_head = qlin(cfg.vocab_size, h)
    else:
        lm_head = (randn(cfg.vocab_size, h) * scale).to(torch.bfloat16)
    return LlamaParams(embed=embed, layers=layers, final_norm=ones(h),
                       lm_head=lm_head)


def fuse_projections(params: LlamaParams) -> LlamaParams:
    """Concatenate q|k|v and gate|up along output rows into one stacked
    QLinear each (4 weight kernels per layer instead of 7). The pair
    layout is row-pair local, so concatenating the pieces is the fused
    pair array; logits are the unfused ones (row results do not depend
    on the row split)."""
    st = params.layers
    if st.qkv is not None:
        return params

    def cat(lins):
        if len({l.layout for l in lins}) != 1:
            raise ValueError("cannot fuse mixed layouts")
        if len({l.scales.dtype for l in lins}) != 1:
            raise ValueError("cannot fuse mixed scale dtypes")
        return QLinear(wp=torch.cat([l.wp for l in lins], dim=-2),
                       scales=torch.cat([l.scales for l in lins], dim=-2))

    qkv_bias = None
    if st.q_bias is not None:
        qkv_bias = torch.cat([st.q_bias, st.k_bias, st.v_bias], dim=-1)
    layers = dataclasses.replace(
        st, qkv=cat([st.q, st.k, st.v]), gate_up=cat([st.gate, st.up]),
        qkv_bias=qkv_bias, q=None, k=None, v=None, gate=None, up=None,
        q_bias=None, k_bias=None, v_bias=None)
    return dataclasses.replace(params, layers=layers)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 (HF Llama numerics); returns fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)) * w.float()


def _norm(x: torch.Tensor, w: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """RMSNorm with the family's gain: ``w`` (Llama) or ``1 + w`` (Gemma)."""
    wf = w.float()
    if cfg.norm_plus_one:
        wf = wf + 1.0
    return rms_norm(x, wf, cfg.rms_norm_eps)


def _act(g: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """SwiGLU silu (Llama) or GeGLU tanh-gelu (Gemma)."""
    if cfg.hidden_activation == "gelu_tanh":
        return torch.nn.functional.gelu(g, approximate="tanh")
    return torch.nn.functional.silu(g)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 rope_scaling: Optional[Tuple[float, float, float, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[..., head_dim]`` (the half table tiled twice),
    with the HF "llama3" frequency rescaling when ``rope_scaling`` is set."""
    dev = positions.device
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=dev) / head_dim))
    if rope_scaling is not None:
        factor, low_f, high_f, orig_max = rope_scaling
        wavelen = 2.0 * math.pi / inv
        low_wl = orig_max / low_f
        high_wl = orig_max / high_f
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        smoothed = (1 - smooth) * inv / factor + smooth * inv
        inv = torch.where(wavelen > low_wl, inv / factor,
                          torch.where(wavelen < high_wl, inv, smoothed))
    ang = positions.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``x [B, T, H, D]`` with cos/sin ``[B, T, D]`` (HF ``rotate_half``)."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rot * s


def embed_lookup(embed: Union[torch.Tensor, QLinear], token_ids: torch.Tensor,
                 quant_type: str = "fp4") -> torch.Tensor:
    """Embedding gather; a 4-bit table gathers the packed rows and scales
    and dequantizes just those rows (fp32 decode x fp32 scale -> bf16)."""
    if not isinstance(embed, QLinear):
        return embed[token_ids].to(torch.bfloat16)
    code = torch.from_numpy(get_4bit_code(quant_type)).to(token_ids.device)
    s = embed.scales[token_ids].float()              # [..., H/64]
    srep = s.repeat_interleave(8, dim=-1)            # [..., H/8]
    if embed.layout == "pair":
        # token row r lives in word row r // 2, 16-bit half r % 2
        g2 = embed.wp[token_ids // 2]                # [..., H/4]
        h = (g2 >> (16 * (token_ids % 2))[..., None].to(g2.dtype)) & 0xFFFF
        k8 = h.shape[-1] // 2
        gE = _unblockmajor(h[..., :k8])
        gO = _unblockmajor(h[..., k8:])
        planes = [code[((g >> (4 * p)) & 15).long()] * srep
                  for g in (gE, gO) for p in range(4)]
        g = gE
    else:
        g = embed.wp[token_ids]                      # [..., H/8]
        planes = [code[((g >> sh) & 15).long()] * srep for sh in _SHIFTS]
    out = torch.stack(planes, dim=-1)
    return out.reshape(*g.shape[:-1], g.shape[-1] * 8).to(torch.bfloat16)


def prefill_pair_enabled() -> bool:
    """Whether ``QT_PREFILL_PAIR`` routes prefill-sized pair projections
    through K8, read at each call (the JAX package reads it once, at
    import). Unset or ``"0"``: no; another integer: yes; anything else
    raises ValueError."""
    raw = os.environ.get("QT_PREFILL_PAIR", "0")
    try:
        return int(raw) != 0
    except ValueError:
        raise ValueError(
            f"QT_PREFILL_PAIR={raw!r} must be an integer") from None


def _ql(x2: torch.Tensor, lin: QLinear, qcfg: QuantConfig,
        idx: Optional[int] = None) -> torch.Tensor:
    """Apply a (possibly layer-stacked) QLinear, in the JAX package's
    order (``models/llama.py:725-799``):

    - ``dense_twin``: the dense bf16 weight of layer ``idx`` (K10 for
      pair words, K7 for planar; their plain versions on the CPU, bit for
      bit ``dense_weight``), then
      :func:`~quantizations_tpu_torch.nn.linear.dense_product` (fp32 sums
      of bf16 values);
    - stacked pair words in the kernel band: K9 (``pair_pipeline ==
      "manual"`` and :func:`~quantizations_tpu_torch.nn.linear.manual_ok`)
      or K1, on layer ``idx`` in place;
    - stacked pair words above the band with ``QT_PREFILL_PAIR`` set, a
      row count divisible by 8 and ``prefill_pair_ok``: K8 in chunks of
      512 rows;
    - stacked planar words: K5, then K6 (the planar bands);
    - otherwise :func:`~quantizations_tpu_torch.nn.linear.apply_4bit` on
      the layer's weights."""
    cd, qt = qcfg.compute_dtype, qcfg.quant_type
    if qcfg.dense_twin:
        if lin.wp.dim() == 3:
            lin = QLinear(wp=lin.wp[idx], scales=lin.scales[idx])
        dq = (dequantize_4bit_pair if lin.layout == "pair"
              else dequantize_4bit_kernel)
        W = dq(lin.wp, lin.scales, qt, dtype=torch.bfloat16)
        return dense_product(x2.to(torch.bfloat16), W)
    if lin.wp.dim() == 3:
        tokens = x2.shape[0]
        if lin.layout == "pair":
            M, K4 = 2 * lin.wp.shape[-2], lin.wp.shape[-1]
            if tokens <= pair_max_tokens():
                fn = (matmul_4bit_pair_manual_stacked
                      if qcfg.pair_pipeline == "manual"
                      and manual_ok(M, 4 * K4, tokens, lin.scales)
                      else matmul_4bit_pair_stacked)
                return fn(lin.wp, lin.scales, kernel_activation(x2, cd), idx,
                          quant_type=qt)
            # bf16x2 words hold two rows: 2 bytes of scale per row
            s_item = 2 if lin.scales_packed else lin.scales.element_size()
            if (tokens % 8 == 0 and prefill_pair_enabled()
                    and prefill_pair_ok(M, K4,
                                        min(tokens, PREFILL_PAIR_CHUNK_T),
                                        s_item)):
                return pair_prefill_matmul(lin.wp, lin.scales,
                                           kernel_activation(x2, cd), qt,
                                           layer_idx=idx)
        elif tokens <= QMATMUL_MAX_TOKENS and qmm_ok(tokens):
            return matmul_4bit_planar_stacked(
                lin.wp, lin.scales, kernel_activation(x2, cd), idx,
                quant_type=qt)
        elif tokens <= GEMV_MAX_TOKENS:
            return gemv_4bit_stacked(lin.wp, lin.scales,
                                     gemv_activation(x2, cd), idx,
                                     quant_type=qt)
        lin = QLinear(wp=lin.wp[idx], scales=lin.scales[idx])
    return apply_4bit(x2, lin.wp, lin.scales, qt, compute_dtype=cd,
                      pair_pipeline=qcfg.pair_pipeline,
                      fp4_decode=qcfg.pair_decode)


def layer_window(cfg: LlamaConfig, i: int) -> Tuple[Optional[bool], Optional[int]]:
    """(use_win, win_eff) for layer ``i``: ``use_win`` is None when no
    per-layer toggle applies, else whether layer ``i`` slides
    (``"even"`` slides layers 0, 2, ...); ``win_eff`` is the effective
    window (``2**30`` = global) or None without a window."""
    if cfg.sliding_window is None:
        return None, None
    if cfg.sliding_layers == "all":
        return None, cfg.sliding_window
    use_win = (i % 2 == 0) if cfg.sliding_layers == "even" else (i % 2 == 1)
    return use_win, (cfg.sliding_window if use_win else 2 ** 30)


def quantize_kv_i8(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 quantize-on-write of KV rows: one absmax step per row over the
    trailing ``D`` axis, rounded to its bf16 storage before the codes are
    computed (so write and read use the same step), codes rounded half to
    even and clipped to +-127. Returns (int8 codes, bf16 steps ``[...]``),
    bit-exact with the JAX package."""
    tf = t.float()
    step = (tf.abs().amax(dim=-1) * (1.0 / 127.0)).to(torch.bfloat16)
    codes = torch.round(tf / torch.clamp(step.float(), min=1e-12)[..., None])
    return codes.clamp(-127, 127).to(torch.int8), step


def _check_ported(cfg: LlamaConfig, axis_name: Optional[str]) -> None:
    """Raise for configuration values whose path is not ported."""
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name (tensor-parallel shards under shard_map) is not "
            "ported")


# attend(q [B, T, n_q, D], k, v [B, T, n_kv, D]) -> attention [B*T, n_q*D]:
# writes this layer's new K/V rows to its cache, then attends over it.
Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _layer_forward(x: torch.Tensor, layer: LlamaLayer, cos: torch.Tensor,
                   sin: torch.Tensor, cfg: LlamaConfig, idx: int,
                   attend: Attend) -> torch.Tensor:
    """One decoder layer on ``x [B, T, hidden]`` (bf16): projections,
    q/k norms and rope, then ``attend`` (which owns the cache: slot or
    paged), the o projection and the MLP."""
    B, T, h = x.shape
    D = cfg.head_dim
    if layer.qkv is not None:
        r = cfg.num_attention_heads // cfg.num_key_value_heads
        n_kv = (layer.qkv.out_features // D) // (r + 2)
        n_q = r * n_kv
    else:
        n_q = layer.q.out_features // D
        n_kv = layer.k.out_features // D
    qcfg = cfg.quant

    # -- attention --
    xa = _norm(x, layer.attn_norm, cfg)
    x2 = xa.to(qcfg.compute_dtype).reshape(B * T, h)
    if layer.qkv is not None:
        qkv = _ql(x2, layer.qkv, qcfg, idx)
        if layer.qkv_bias is not None:
            qkv = qkv + layer.qkv_bias.to(qkv.dtype)
        qd, kd = n_q * D, n_kv * D
        q, k, v = qkv[:, :qd], qkv[:, qd:qd + kd], qkv[:, qd + kd:]
    else:
        q = _ql(x2, layer.q, qcfg, idx)
        k = _ql(x2, layer.k, qcfg, idx)
        v = _ql(x2, layer.v, qcfg, idx)
        if layer.q_bias is not None:
            q = q + layer.q_bias.to(q.dtype)
            k = k + layer.k_bias.to(k.dtype)
            v = v + layer.v_bias.to(v.dtype)
    q = q.reshape(B, T, n_q, D)
    k = k.reshape(B, T, n_kv, D)
    v = v.reshape(B, T, n_kv, D)
    if layer.q_norm is not None:
        q = rms_norm(q, layer.q_norm, cfg.rms_norm_eps)
        k = rms_norm(k, layer.k_norm, cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, k, v)

    o = _ql(attn, layer.o, qcfg, idx)
    ob = o.reshape(B, T, h)
    if layer.post_attn_norm is not None:
        ob = _norm(ob, layer.post_attn_norm, cfg)
    x = x + ob.to(x.dtype)

    # -- MLP (SwiGLU / GeGLU) --
    xm = _norm(x, layer.mlp_norm, cfg)
    x2 = xm.to(qcfg.compute_dtype).reshape(B * T, h)
    if layer.gate_up is not None:
        gu = _ql(x2, layer.gate_up, qcfg, idx)
        inter = gu.shape[-1] // 2
        g, u = gu[:, :inter], gu[:, inter:]
    else:
        g = _ql(x2, layer.gate, qcfg, idx)
        u = _ql(x2, layer.up, qcfg, idx)
    act = _act(g, cfg) * u
    d = _ql(act.to(qcfg.compute_dtype), layer.down, qcfg, idx)
    db = d.reshape(B, T, h)
    if layer.post_mlp_norm is not None:
        db = _norm(db, layer.post_mlp_norm, cfg)
    return x + db.to(x.dtype)


def _kv_rows(k: torch.Tensor, v: torch.Tensor, int8: bool, dtype):
    """New K/V rows in the cache's storage: (k, v, k_step, v_step), the
    steps None for a bf16 cache."""
    if int8:
        kq, ks = quantize_kv_i8(k)
        vq, vs = quantize_kv_i8(v)
        return kq, vq, ks, vs
    return k.to(dtype), v.to(dtype), None, None


def _slot_attend(cache: KVCache, idx: int, positions: torch.Tensor,
                 mask: torch.Tensor, cfg: LlamaConfig,
                 attend_len: Optional[int], win_eff: Optional[int]) -> Attend:
    """Attention over layer ``idx`` of the slot cache: write the new rows
    at ``positions [B, T]``, then the flash-decode kernel (``T == 1`` with
    ``use_flash_attention``, gated as in the JAX package) or the einsum
    path over ``cache[idx][:, :, :attend_len]`` under ``mask``.

    Einsum operands are fp32 on the CPU and the cache dtype (bf16; bf16
    ``code * step`` for int8) on the GPU, with fp32 products, sums and
    softmax on both."""
    int8 = cache.k_scale is not None

    def attend(q, k, v):
        B, T, n_q, D = q.shape
        n_kv = k.shape[2]
        G = n_q // n_kv
        kn, vn, ks, vs = _kv_rows(k, v, int8, cache.k.dtype)
        bi = torch.arange(B, device=q.device)[:, None].expand(B, T)
        cache.k[idx][bi, :, positions] = kn
        cache.v[idx][bi, :, positions] = vn
        if int8:
            cache.k_scale[idx][bi, :, positions] = ks
            cache.v_scale[idx][bi, :, positions] = vs

        S_att = attend_len or cache.max_seq
        scale = (cfg.query_scale or D) ** -0.5
        if (cfg.use_flash_attention and T == 1
                and (cfg.sliding_window is None or win_eff is not None)):
            qg = q[:, 0].reshape(B, n_kv, G, D)
            lengths = (positions[:, 0] + 1).to(torch.int32)
            common = dict(attend_len=S_att, scale=scale,
                          softcap=cfg.attn_logit_softcap, window=win_eff)
            if int8:
                attn = flash_decode_attention_stacked_i8(
                    qg, cache.k, cache.v, cache.k_scale, cache.v_scale, idx,
                    lengths, **common)
            else:
                attn = flash_decode_attention_stacked(
                    qg, cache.k, cache.v, idx, lengths, **common)
            return attn.reshape(B * T, n_q * D)

        adt = torch.bfloat16 if q.is_cuda else torch.float32
        kf = cache.k[idx][:, :, :S_att].to(adt)
        vf = cache.v[idx][:, :, :S_att].to(adt)
        if int8:
            kf = kf * cache.k_scale[idx][:, :, :S_att, None].to(adt)
            vf = vf * cache.v_scale[idx][:, :, :S_att, None].to(adt)
        qg = q.reshape(B, T, n_kv, G, D).to(adt).float()
        scores = torch.einsum("btkgd,bksd->btkgs", qg, kf.float()) * scale
        if cfg.attn_logit_softcap is not None:
            cap = cfg.attn_logit_softcap
            scores = cap * torch.tanh(scores / cap)
        scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
        w = torch.softmax(scores, dim=-1)
        attn = torch.einsum("btkgs,bksd->btkgd", w.to(adt).float(),
                            vf.float())
        return attn.reshape(B * T, n_q * D)

    return attend


_PER_LAYER = ("attn_norm", "mlp_norm", "q_bias", "k_bias", "v_bias",
              "post_attn_norm", "post_mlp_norm", "q_norm", "k_norm",
              "qkv_bias")


def layer_params(st: LlamaLayer, i: int) -> LlamaLayer:
    """Layer ``i``'s view of the stacked parameters: the weights stay
    stacked (the kernel reads layer ``i`` in place); only the small
    per-layer vectors are sliced."""
    return dataclasses.replace(st, **{
        n: getattr(st, n)[i] for n in _PER_LAYER
        if getattr(st, n) is not None})


def embed_tokens(params: LlamaParams, token_ids: torch.Tensor,
                 cfg: LlamaConfig) -> torch.Tensor:
    """The embedding rows of ``token_ids``, times sqrt(hidden) when the
    config has the Gemma normalizer."""
    x = embed_lookup(params.embed, token_ids, cfg.quant.quant_type)
    if cfg.embed_normalizer:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype)
    return x


def lm_head_logits(params: LlamaParams, x: torch.Tensor,
                   cfg: LlamaConfig) -> torch.Tensor:
    """Final norm, lm_head and final softcap: ``x [B, T, hidden]`` ->
    fp32 logits ``[B, T, vocab]``."""
    B, T, _ = x.shape
    x = _norm(x, params.final_norm, cfg)
    if isinstance(params.lm_head, QLinear):
        logits = _ql(x.to(cfg.quant.compute_dtype).reshape(B * T, -1),
                     params.lm_head, cfg.quant).reshape(B, T, -1)
    else:
        logits = torch.einsum("bth,vh->btv", x.to(torch.bfloat16).float(),
                              params.lm_head.float())
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def _forward(params: LlamaParams, token_ids: torch.Tensor, cache: KVCache,
             pos: Union[int, torch.Tensor], cfg: LlamaConfig,
             axis_name: Optional[str] = None, last_token_only: bool = False,
             attend_len: Optional[int] = None,
             logits_at: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, KVCache]:
    """Shared prefill/decode forward: embeds ``T`` tokens written at cache
    positions ``pos .. pos+T`` (``pos`` an int or per-row ``[B]``) and
    returns logits ``[B, T, vocab]`` and the cache, updated in place.
    ``last_token_only`` computes the logits of the last token only, and
    ``logits_at [B]`` those of token ``logits_at[b]`` of each row (both
    ``T = 1``): the others are never computed."""
    _check_ported(cfg, axis_name)
    B, T = token_ids.shape
    dev = token_ids.device
    x = embed_tokens(params, token_ids, cfg)

    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    pos = torch.broadcast_to(pos.reshape(-1), (B,))
    positions = pos[:, None] + torch.arange(T, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    key_pos = torch.arange(attend_len or cache.max_seq, device=dev)
    mask_full = key_pos[None, None, :] <= positions[:, :, None]
    mask = mask_full
    if cfg.sliding_window is not None:
        mask = mask & (key_pos[None, None, :]
                       > positions[:, :, None] - cfg.sliding_window)

    for i in range(cfg.num_hidden_layers):
        use_win, win_eff = layer_window(cfg, i)
        mask_i = mask if use_win is None or use_win else mask_full
        attend = _slot_attend(cache, i, positions, mask_i, cfg, attend_len,
                              win_eff)
        x = _layer_forward(x, layer_params(params.layers, i), cos, sin, cfg,
                           i, attend)

    if logits_at is not None:
        x = x[torch.arange(B, device=dev), logits_at.to(dev).long()][:, None]
    elif last_token_only:
        x = x[:, -1:, :]
    return lm_head_logits(params, x, cfg), cache


def check_cache_room(pos: Union[int, torch.Tensor], T: int,
                     cache: KVCache) -> None:
    """Raise ``ValueError`` when ``T`` tokens written from position
    ``pos`` would run past the cache's ``max_seq`` positions. (The JAX
    package's ``dynamic_update_slice`` clamps the write instead, to the
    wrong positions.) A position tensor on the card is not read back:
    its caller (the paged engine) validates its requests itself."""
    if isinstance(pos, torch.Tensor):
        if pos.device.type != "cpu" or pos.numel() == 0:
            return
        pos = int(pos.max())
    if pos + T > cache.max_seq:
        raise ValueError(f"positions {pos}..{pos + T - 1} run past the "
                         f"cache's {cache.max_seq} positions")


def prefill(params: LlamaParams, token_ids: torch.Tensor, cache: KVCache,
            cfg: LlamaConfig, pos: Union[int, torch.Tensor, None] = None,
            axis_name: Optional[str] = None, last_token_only: bool = False,
            attend_len: Optional[int] = None,
            logits_at: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Process a prompt chunk; returns (logits [B, T, vocab], cache), or
    the logits of one token per row with ``last_token_only`` or
    ``logits_at``. Raises ``ValueError`` before any launch when the chunk
    would run past the cache."""
    pos = 0 if pos is None else pos
    check_cache_room(pos, token_ids.shape[1], cache)
    return _forward(params, token_ids, cache, pos, cfg,
                    axis_name=axis_name, last_token_only=last_token_only,
                    attend_len=attend_len, logits_at=logits_at)


def decode_step(params: LlamaParams, token_ids: torch.Tensor, cache: KVCache,
                pos: Union[int, torch.Tensor], cfg: LlamaConfig,
                axis_name: Optional[str] = None,
                attend_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: ``token_ids [B, 1]`` at position ``pos``.
    Returns (logits [B, vocab], cache). Raises ``ValueError`` before any
    launch when ``pos`` lies past the cache."""
    check_cache_room(pos, token_ids.shape[1], cache)
    logits, cache = _forward(params, token_ids, cache, pos, cfg,
                             axis_name=axis_name, attend_len=attend_len)
    return logits[:, -1, :], cache
