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
from ..ops.glue import (
    GLUE_DTYPES,
    add_rms_norm,
    add_rms_norm_plain,
    apply_rope,
    glu_act,
    glu_act_plain,
    rms_norm,
    rope_qk,
    rope_qk_plain,
)
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
from ..utils.profiling import span

__all__ = [
    "LlamaConfig",
    "QLinear",
    "LlamaLayer",
    "LlamaParams",
    "KVCache",
    "quantize_linear",
    "init_llama_params",
    "fuse_projections",
    "dense_twin_weight",
    "stack_layers",
    "rms_norm",
    "rope_cos_sin",
    "apply_rope",
    "embed_lookup",
    "layer_window",
    "layer_params",
    "slot_layers",
    "add_residual",
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
    "LLAMA3_70B",
    "GEMMA2_9B",
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

# Llama3-70B: ~35 GB of packed 4-bit weights.
LLAMA3_70B = LlamaConfig(
    hidden_size=8192,
    intermediate_size=28672,
    num_hidden_layers=80,
    num_attention_heads=64,
    num_key_value_heads=8,
)

# Gemma2-9B (HF google/gemma-2-9b): sandwich norms, GeGLU, softcaps,
# alternating 4k sliding window.
GEMMA2_9B = LlamaConfig(
    vocab_size=256000,
    hidden_size=3584,
    intermediate_size=14336,
    num_hidden_layers=42,
    num_attention_heads=16,
    num_key_value_heads=8,
    head_dim=256,
    rope_theta=10000.0,
    rms_norm_eps=1e-6,
    max_position_embeddings=8192,
    tie_word_embeddings=True,
    hidden_activation="gelu_tanh",
    post_norms=True,
    norm_plus_one=True,
    embed_normalizer=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=256.0,
    sliding_window=4096,
    sliding_layers="even",
)

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
        """A zeroed cache shaped by ``cfg`` alone (a shard's cache by its
        shard's config: ``parallel.shard.shard_config``)."""
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


# Proxy matrices of at least this many elements are drawn in 16 row
# slabs, so that the sampler's transients stay one slab's.
_PROXY_SLAB_ELEMS = 1 << 28
_PROXY_SLABS = 16


def _proxy_student_t(gen: torch.Generator, rows: int, cols: int,
                     device: torch.device) -> torch.Tensor:
    """Student-t draws with 5 degrees of freedom, fp32 ``[rows, cols]``:
    ``Z / sqrt(chi2_5 / 5)`` with the chi-square the sum of five squared
    normals, every normal from ``gen`` (torch's ``StudentT`` and
    ``Gamma`` samplers take no generator)."""
    def randn():
        return torch.randn((rows, cols), generator=gen, device=device,
                           dtype=torch.float32)

    z = randn()
    chi = torch.zeros_like(z)
    for _ in range(5):
        n = randn()
        chi.addcmul_(n, n)
    return z.div_(chi.div_(5.0).sqrt_())


def _proxy_parts(gen: torch.Generator, out_f: int, in_f: int,
                 device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three factors of :func:`_proxy_weight`: Student-t (df 5)
    draws ``[out_f, in_f]`` (in ``_PROXY_SLABS`` row slabs from
    ``_PROXY_SLAB_ELEMS`` elements on, as in the JAX package), the row
    scales ``exp(0.4 N)`` ``[out_f, 1]`` and the outlier columns ``[1,
    in_f]``: 8 with probability 0.005, else 1."""
    if out_f * in_f >= _PROXY_SLAB_ELEMS and out_f % _PROXY_SLABS == 0:
        rows = out_f // _PROXY_SLABS
        t = torch.empty((out_f, in_f), dtype=torch.float32, device=device)
        for i in range(_PROXY_SLABS):
            t[i * rows:(i + 1) * rows] = _proxy_student_t(gen, rows, in_f,
                                                          device)
    else:
        t = _proxy_student_t(gen, out_f, in_f, device)
    row = torch.exp(0.4 * torch.randn((out_f, 1), generator=gen,
                                      device=device, dtype=torch.float32))
    hit = torch.rand((1, in_f), generator=gen, device=device,
                     dtype=torch.float32) < 0.005
    outlier = torch.where(hit, 8.0, 1.0).to(torch.float32)
    return t, row, outlier


def _proxy_weight(gen: torch.Generator, out_f: int, in_f: int, scale: float,
                  device: torch.device) -> torch.Tensor:
    """Trained-distribution weight proxy (counterpart of the JAX
    package's ``_proxy_weight``): the statistics that make 4-bit
    quantization hard on trained LLM weights and that an i.i.d. Gaussian
    lacks:

    - heavy tails (Student-t, df 5: excess kurtosis 6),
    - per-output-row scale spread (log-normal row norms, sigma 0.4),
    - rare outlier input columns (0.5% of columns at 8x), which inflate
      a block's absmax and crush its small values.

    The draws come from ``gen``: they cannot equal JAX's stream, only
    its distribution."""
    t, row, outlier = _proxy_parts(gen, out_f, in_f, device)
    return t.mul_(row).mul_(outlier).mul_(scale)


def _proxy_norm_gain(gen: torch.Generator, n: int,
                     device: torch.device) -> torch.Tensor:
    """Trained RMSNorm gains cluster near 1 with real spread:
    ``|1 + 0.3 N|`` in bf16."""
    return torch.abs(1.0 + 0.3 * torch.randn(
        (n,), generator=gen, device=device, dtype=torch.float32)
                     ).to(torch.bfloat16)


def init_llama_params(cfg: LlamaConfig, seed: int = 0, scale: float = 0.02,
                      dist: str = "normal",
                      device: Union[str, torch.device] = "cuda"
                      ) -> LlamaParams:
    """Random-initialized quantized model, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.

    ``dist="normal"``: i.i.d. normal weights times ``scale``, unit norm
    gains. ``dist="trained_proxy"``: weights from :func:`_proxy_weight`
    and norm gains from :func:`_proxy_norm_gain` (biases stay normal),
    the accuracy stand-in for a trained checkpoint.

    Layers are drawn and quantized one at a time and copied into
    preallocated stacks, so peak memory is the model plus one dense
    layer."""
    if dist not in ("normal", "trained_proxy"):
        raise ValueError(f"init_llama_params: dist {dist!r} not in "
                         "('normal', 'trained_proxy')")
    proxy = dist == "trained_proxy"
    dev = resolve_device(device)
    q = cfg.quant
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, qs, kvs, inter = (cfg.hidden_size, cfg.q_size, cfg.kv_size,
                         cfg.intermediate_size)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    def dense(out_f, in_f):
        if proxy:
            return _proxy_weight(gen, out_f, in_f, scale, dev)
        return randn(out_f, in_f) * scale

    def qlin(out_f, in_f, scales_dtype=None):
        return quantize_linear(
            dense(out_f, in_f), blocksize=q.blocksize,
            quant_type=q.quant_type,
            compress_statistics=q.compress_statistics,
            scales_dtype=q.scales_dtype if scales_dtype is None
            else scales_dtype)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    def gain(n):
        return _proxy_norm_gain(gen, n, dev) if proxy else ones(n)

    def bias(n):
        if not cfg.attention_bias:
            return None
        return (randn(n) * scale).to(torch.bfloat16)

    def make_layer() -> LlamaLayer:
        return LlamaLayer(
            attn_norm=gain(h), q=qlin(qs, h), k=qlin(kvs, h), v=qlin(kvs, h),
            o=qlin(h, qs), mlp_norm=gain(h), gate=qlin(inter, h),
            up=qlin(inter, h), down=qlin(h, inter),
            q_bias=bias(qs), k_bias=bias(kvs), v_bias=bias(kvs),
            post_attn_norm=gain(h) if cfg.post_norms else None,
            post_mlp_norm=gain(h) if cfg.post_norms else None,
            q_norm=ones(cfg.head_dim) if cfg.qk_norm else None,
            k_norm=ones(cfg.head_dim) if cfg.qk_norm else None)

    layers = stack_layers(lambda i: make_layer(), cfg.num_hidden_layers, dev)

    if q.quantize_embedding:
        # the embedding is a row gather: bf16 scales instead of bf16x2
        embed = qlin(cfg.vocab_size, h,
                     scales_dtype=(torch.bfloat16 if q.scales_dtype == "bf16x2"
                                   else None))
    else:
        embed = dense(cfg.vocab_size, h).to(torch.bfloat16)
    if q.quantize_lm_head:
        lm_head = qlin(cfg.vocab_size, h)
    else:
        lm_head = dense(cfg.vocab_size, h).to(torch.bfloat16)
    return LlamaParams(embed=embed, layers=layers, final_norm=gain(h),
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

def _glue(compute_dtype: Any):
    """The layer's glue, ``(norm, rope, act)``: K11-K13
    (:mod:`~quantizations_tpu_torch.ops.glue`; their plain versions on the
    CPU) where the compute dtype is one they write, else the plain
    versions."""
    if compute_dtype in GLUE_DTYPES:
        return add_rms_norm, rope_qk, glu_act
    return add_rms_norm_plain, rope_qk_plain, glu_act_plain


def add_residual(x: torch.Tensor,
                 delta: Optional[torch.Tensor]) -> torch.Tensor:
    """The residual stream with a layer's pending output ``delta`` added
    in ``x``'s dtype (``x`` itself for None): what the next norm's K11
    would add, for a caller that needs the stream itself."""
    return x if delta is None else x + delta.to(x.dtype)


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


def dense_twin_weight(lin: QLinear, quant_type: str) -> torch.Tensor:
    """The dense bf16 ``[M, K]`` of an unstacked QLinear in the original
    row and column order, the dequantized twin's weight: K10 for pair
    words, K7 for planar (their plain versions on the CPU, bit for bit
    ``nn/linear.py dense_weight``)."""
    dq = (dequantize_4bit_pair if lin.layout == "pair"
          else dequantize_4bit_kernel)
    return dq(lin.wp, lin.scales, quant_type, dtype=torch.bfloat16)


@span("linear.4bit")
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
        return dense_product(x2.to(torch.bfloat16),
                             dense_twin_weight(lin, qt))
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


def _check_axis(axis_name: Any) -> None:
    """``axis_name`` is None or a mesh axis (``parallel.mesh.Axis``), the
    port's counterpart of the JAX package's axis name."""
    if axis_name is not None and not hasattr(axis_name, "group"):
        raise TypeError(
            f"axis_name must be a mesh axis (Mesh.axis('tp') of "
            f"quantizations_tpu_torch.parallel.make_mesh), got "
            f"{type(axis_name).__name__}")


def _ql_psum(x2: torch.Tensor, lin: QLinear, qcfg: QuantConfig,
             idx: Optional[int], axis_name: Any, chunks: int) -> torch.Tensor:
    """A row-parallel projection and its sum over the tensor-parallel
    axis (the JAX package's ``_ql_psum``, ``models/llama.py:802``).

    ``chunks > 1`` (``tp_overlap_chunks``) splits the output rows into
    ``chunks`` slices: slice ``c + 1`` is computed while slice ``c``'s
    gather is in flight. Each slice is layer ``idx``'s rows, a contiguous
    view; per-row results do not depend on the row split, and the sum is
    the coordinate-ordered one of
    :func:`~quantizations_tpu_torch.parallel.collectives.all_reduce_sum`,
    so the result is the unchunked one bit for bit. Pair words, and row
    counts that ``chunks`` does not divide, take the single sum."""
    if axis_name is None:
        return _ql(x2, lin, qcfg, idx)
    from ..parallel.collectives import (all_reduce_sum, ordered_sum,
                                        start_all_gather)

    M = lin.wp.shape[-2]          # row-parallel shards are planar
    if chunks <= 1 or axis_name.size == 1 or lin.layout == "pair" \
            or M % chunks:
        return all_reduce_sum(_ql(x2, lin, qcfg, idx), axis_name)
    if lin.wp.dim() == 3:
        lin = QLinear(wp=lin.wp[idx], scales=lin.scales[idx])
    mc = M // chunks
    pending = []
    for c in range(chunks):
        sl = QLinear(wp=lin.wp[c * mc:(c + 1) * mc],
                     scales=lin.scales[c * mc:(c + 1) * mc])
        pending.append(start_all_gather(_ql(x2, sl, qcfg), axis_name))
    return torch.cat([ordered_sum(p.wait()) for p in pending], dim=-1)


# attend(q [B, T, n_q, D], k, v [B, T, n_kv, D]) -> attention [B*T, n_q*D]:
# writes this layer's new K/V rows to its cache, then attends over it.
Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _layer_forward(x: torch.Tensor, layer: LlamaLayer, cos: torch.Tensor,
                   sin: torch.Tensor, cfg: LlamaConfig, idx: int,
                   attend: Attend, axis_name: Any = None,
                   delta: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer on the residual stream ``x [B, T, hidden]``
    (bf16) with ``delta``, the previous layer's MLP output not yet added
    (None before the first layer): projections, q/k norms and rope, then
    ``attend`` (which owns the cache: slot or paged), the o projection
    and the MLP. Returns ``(x, delta)``: the stream after the attention
    block and this layer's MLP output, which the next layer's first norm
    (or :func:`lm_head_logits`' final norm) adds in the same launch
    (:func:`add_residual` adds it alone). Each norm with its residual
    add, the rope of q and k, and the activation are one kernel each
    (K11-K13, :func:`_glue`). Under a tensor-parallel ``axis_name`` the
    layer holds one shard: its head counts come from its own q/k/v rows,
    and o and down are summed over the axis (:func:`_ql_psum`)."""
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
    cd = qcfg.compute_dtype
    norm, rope, act = _glue(cd)
    eps, plus_one = cfg.rms_norm_eps, cfg.norm_plus_one

    # -- attention --
    x, xa = norm(x, delta, layer.attn_norm, eps, plus_one, cd)
    x2 = xa.reshape(B * T, h)
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
        q = rms_norm(q, layer.q_norm, eps)
        k = rms_norm(k, layer.k_norm, eps)
    q, k = rope(q, k, cos, sin)
    attn = attend(q, k, v)

    o = _ql_psum(attn, layer.o, qcfg, idx, axis_name, cfg.tp_overlap_chunks)
    ob = o.reshape(B, T, h)
    if layer.post_attn_norm is not None:
        ob = norm(ob, None, layer.post_attn_norm, eps, plus_one,
                  torch.float32)[1]

    # -- MLP (SwiGLU / GeGLU) --
    x, xm = norm(x, ob, layer.mlp_norm, eps, plus_one, cd)
    x2 = xm.reshape(B * T, h)
    if layer.gate_up is not None:
        gu = _ql(x2, layer.gate_up, qcfg, idx)
        inter = gu.shape[-1] // 2
        g, u = gu[:, :inter], gu[:, inter:]
    else:
        g = _ql(x2, layer.gate, qcfg, idx)
        u = _ql(x2, layer.up, qcfg, idx)
    d = _ql_psum(act(g, u, cfg.hidden_activation, cd), layer.down, qcfg, idx,
                 axis_name, cfg.tp_overlap_chunks)
    db = d.reshape(B, T, h)
    if layer.post_mlp_norm is not None:
        db = norm(db, None, layer.post_mlp_norm, eps, plus_one,
                  torch.float32)[1]
    return x, db


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
    softmax on both. The callable runs in span ``attn.prefill`` (it
    serves the admissions' prefill and the slot engine's decode)."""
    int8 = cache.k_scale is not None

    @span("attn.prefill")
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
                   cfg: LlamaConfig, axis_name: Any = None,
                   delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final norm, lm_head and final softcap: ``x [B, T, hidden]`` (with
    the last layer's pending output ``delta`` added by the norm's K11) ->
    fp32 logits ``[B, T, vocab]``. Under a tensor-parallel ``axis_name``
    the lm_head is a vocab shard and the logits are gathered over the
    axis."""
    B, T, _ = x.shape
    cd = cfg.quant.compute_dtype
    quantized = isinstance(params.lm_head, QLinear)
    _, x = _glue(cd)[0](x, delta, params.final_norm, cfg.rms_norm_eps,
                        cfg.norm_plus_one,
                        cd if quantized else torch.bfloat16)
    if quantized:
        logits = _ql(x.reshape(B * T, -1), params.lm_head,
                     cfg.quant).reshape(B, T, -1)
    else:
        logits = torch.einsum("bth,vh->btv", x.float(),
                              params.lm_head.float())
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    if axis_name is not None:
        from ..parallel.collectives import all_gather_cat

        logits = all_gather_cat(logits, axis_name, dim=-1)
    return logits


def slot_layers(params: LlamaParams, x: torch.Tensor, cache: KVCache,
                positions: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                mask: torch.Tensor, mask_full: torch.Tensor,
                cfg: LlamaConfig, attend_len: Optional[int] = None,
                axis_name: Any = None, first_layer: int = 0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Every layer of ``params`` over the slot cache (layer ``i`` of the
    stacks and of ``cache``), the layer's global index ``first_layer +
    i`` choosing its window (a pipeline stage holds a slice of the
    layers). Returns ``(x, delta)`` as :func:`_layer_forward` does (delta
    None without layers)."""
    delta = None
    for i in range(params.layers.attn_norm.shape[0]):
        use_win, win_eff = layer_window(cfg, first_layer + i)
        mask_i = mask if use_win is None or use_win else mask_full
        attend = _slot_attend(cache, i, positions, mask_i, cfg, attend_len,
                              win_eff)
        x, delta = _layer_forward(x, layer_params(params.layers, i), cos,
                                  sin, cfg, i, attend, axis_name, delta)
    return x, delta


def _forward(params: LlamaParams, token_ids: torch.Tensor, cache: KVCache,
             pos: Union[int, torch.Tensor], cfg: LlamaConfig,
             axis_name: Any = None, last_token_only: bool = False,
             attend_len: Optional[int] = None,
             logits_at: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, KVCache]:
    """Shared prefill/decode forward: embeds ``T`` tokens written at cache
    positions ``pos .. pos+T`` (``pos`` an int or per-row ``[B]``) and
    returns logits ``[B, T, vocab]`` and the cache, updated in place.
    ``last_token_only`` computes the logits of the last token only, and
    ``logits_at [B]`` those of token ``logits_at[b]`` of each row (both
    ``T = 1``): the others are never computed. ``axis_name``, a mesh's
    tensor-parallel axis, runs the rank's shard of ``params`` and
    ``cache`` with the axis's collectives; the logits are the whole
    vocabulary's on every rank."""
    _check_axis(axis_name)
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

    x, delta = slot_layers(params, x, cache, positions, cos, sin, mask,
                           mask_full, cfg, attend_len, axis_name)

    if logits_at is not None:
        rows = (torch.arange(B, device=dev), logits_at.to(dev).long())
        x = x[rows][:, None]
        delta = None if delta is None else delta[rows][:, None]
    elif last_token_only:
        x = x[:, -1:, :]
        delta = None if delta is None else delta[:, -1:, :]
    return lm_head_logits(params, x, cfg, axis_name, delta), cache


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
            axis_name: Any = None, last_token_only: bool = False,
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
                axis_name: Any = None,
                attend_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: ``token_ids [B, 1]`` at position ``pos``.
    Returns (logits [B, vocab], cache). Raises ``ValueError`` before any
    launch when ``pos`` lies past the cache."""
    check_cache_room(pos, token_ids.shape[1], cache)
    logits, cache = _forward(params, token_ids, cache, pos, cfg,
                             axis_name=axis_name, attend_len=attend_len)
    return logits[:, -1, :], cache
