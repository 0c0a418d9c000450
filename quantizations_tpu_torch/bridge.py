"""Move parameters and KV caches between the JAX package and the port
through numpy, with no repacking.

The JAX side is a flat dict of numpy arrays keyed by pytree path, dotted
(``"layers.q.wp"``, ``"embed.scales"``, ``"final_norm"``): what
``jax.tree_util.tree_flatten_with_path`` gives for a ``LlamaParams`` or
``KVCache``, with each path's attribute names joined by dots and each
leaf passed through ``np.asarray``. Fields that are None have no leaves
and no keys. The storage is the same on both sides: pair words
``int32 [L, M/2, K/4]``, scales fp32, bf16 or ``int32 [L, M/2, K/64]``,
norms and biases bf16, the cache bf16 ``[L, B, KV, S, D]`` or int8 with
bf16 steps ``[L, B, KV, S]``, the paged pool ``[L, P, KV, page, D]``
(steps ``[L, P, KV, page]``). Planar weights (``wp [L, M, K/8]``, fp32
or bf16 scales ``[L, M, K/64]``) cross the same way. bf16 arrays
arrive as numpy's ``bfloat16`` extension dtype and are moved by bits.

A ``Linear4bit`` crosses as its leaves (``weight.wp``, ``weight.scales``,
``weight.quant_state.absmax`` and ``.code``, and for double
quantization ``.offset``, ``.state2.absmax`` and ``.state2.code``, then
``bias``) plus the bnb metadata dict of ``QuantState.as_dict()``
(``quant_type``, ``blocksize``, ``dtype``, ``shape``, and
``nested_blocksize`` / ``nested_dtype`` when nested). Its static fields
``compute_dtype``, ``pair_pipeline`` and ``fp4_decode`` are no leaves:
they are passed as keywords and read back from the layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .models.llama import (
    KVCache,
    LlamaConfig,
    LlamaLayer,
    LlamaParams,
    QLinear,
    named_tensors,
)
from .nn.linear import Linear4bit, Params4bit
from .quant.state import QuantState, dtype_from_name
from .serve.paged import PagedKVCache

__all__ = ["params_from_numpy", "params_to_numpy", "cache_from_numpy",
           "cache_to_numpy", "paged_from_numpy", "paged_to_numpy",
           "linear4bit_from_numpy", "linear4bit_to_numpy"]

Tree = Dict[str, np.ndarray]
_CACHE_KEYS = ("k", "v", "k_scale", "v_scale")
_PAGED_KEYS = ("pages_k", "pages_v", "k_scale", "v_scale")


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _node(tree: Tree, key: str, device: torch.device):
    """The tensor at ``key``, a QLinear when ``key`` has ``.wp`` and
    ``.scales`` children, or None when the field is absent."""
    if key in tree:
        return _tensor(tree[key], device)
    if f"{key}.wp" in tree:
        return QLinear(wp=_tensor(tree[f"{key}.wp"], device),
                       scales=_tensor(tree[f"{key}.scales"], device))
    return None


def params_from_numpy(tree: Tree, cfg: LlamaConfig,
                      device: Union[str, torch.device] = "cuda"
                      ) -> LlamaParams:
    """The JAX package's ``LlamaParams`` (as a dotted-path numpy dict) ->
    the port's :class:`LlamaParams` on ``device``."""
    dev = resolve_device(device)
    known = {"embed", "final_norm", "lm_head"}
    layer_fields = {f.name for f in dataclasses.fields(LlamaLayer)}
    for key in tree:
        head, _, rest = key.partition(".")
        if head == "layers":
            ok = rest.partition(".")[0] in layer_fields
        else:
            ok = head in known
        if not ok:
            raise KeyError(f"unknown parameter path {key!r}")
    layers = LlamaLayer(**{name: _node(tree, f"layers.{name}", dev)
                           for name in layer_fields})
    L = cfg.num_hidden_layers
    for name, t in named_tensors(layers):
        if t.shape[0] != L:
            raise ValueError(f"layers.{name} has {t.shape[0]} layers, "
                             f"config says {L}")
    return LlamaParams(embed=_node(tree, "embed", dev), layers=layers,
                       final_norm=_node(tree, "final_norm", dev),
                       lm_head=_node(tree, "lm_head", dev))


def params_to_numpy(params: LlamaParams) -> Tree:
    """Inverse of :func:`params_from_numpy`."""
    return {k: _array(t) for k, t in named_tensors(params)}


def cache_from_numpy(tree: Tree,
                     device: Union[str, torch.device] = "cuda") -> KVCache:
    """The JAX package's ``KVCache`` (``{"k", "v"}``, plus ``"k_scale"``
    and ``"v_scale"`` for an int8 cache) -> the port's
    :class:`KVCache`."""
    dev = resolve_device(device)
    return KVCache(**{k: _tensor(tree[k], dev) for k in _CACHE_KEYS
                      if k in tree})


def cache_to_numpy(cache: KVCache) -> Tree:
    """Inverse of :func:`cache_from_numpy`."""
    return {k: _array(t) for k, t in named_tensors(cache)}


def paged_from_numpy(tree: Tree, device: Union[str, torch.device] = "cuda"
                     ) -> PagedKVCache:
    """The JAX package's ``PagedKVCache`` (``{"pages_k", "pages_v"}``,
    plus ``"k_scale"``/``"v_scale"`` for an int8 pool) -> the port's
    :class:`~quantizations_tpu_torch.serve.paged.PagedKVCache`."""
    dev = resolve_device(device)
    return PagedKVCache(**{k: _tensor(tree[k], dev) for k in _PAGED_KEYS
                           if k in tree})


def paged_to_numpy(pages: PagedKVCache) -> Tree:
    """Inverse of :func:`paged_from_numpy`."""
    return {k: _array(t) for k, t in named_tensors(pages)}


_QS = "weight.quant_state"


def linear4bit_from_numpy(tree: Tree, meta: Dict[str, Any],
                          compute_dtype: Any = torch.bfloat16,
                          pair_pipeline: str = "grid",
                          fp4_decode: str = "arith",
                          device: Union[str, torch.device] = "cuda"
                          ) -> Linear4bit:
    """The JAX package's ``Linear4bit`` (its leaves as a dotted-path numpy
    dict, and ``meta`` = ``quant_state.as_dict()["quant_state"]``) ->
    the port's :class:`~quantizations_tpu_torch.nn.linear.Linear4bit` on
    ``device``. The words and scales are taken as they are (planar or
    pair); ``pair_pipeline`` and ``fp4_decode`` are the JAX layer's static
    fields of those names."""
    dev = resolve_device(device)
    state2 = None
    if f"{_QS}.state2.absmax" in tree:
        state2 = QuantState(
            absmax=_tensor(tree[f"{_QS}.state2.absmax"], dev),
            code=_tensor(tree[f"{_QS}.state2.code"], dev),
            blocksize=int(meta["nested_blocksize"]),
            quant_type="dynamic8bit",
            dtype=dtype_from_name(meta["nested_dtype"]),
            shape=tuple(tree[f"{_QS}.absmax"].shape))
    state = QuantState(
        absmax=_tensor(tree[f"{_QS}.absmax"], dev),
        code=_tensor(tree[f"{_QS}.code"], dev),
        offset=(_tensor(tree[f"{_QS}.offset"], dev) if state2 is not None
                else None),
        state2=state2, blocksize=int(meta["blocksize"]),
        quant_type=meta["quant_type"], dtype=dtype_from_name(meta["dtype"]),
        shape=tuple(meta["shape"]))
    weight = Params4bit(wp=_tensor(tree["weight.wp"], dev),
                        scales=_tensor(tree["weight.scales"], dev),
                        quant_state=state)
    bias = _tensor(tree["bias"], dev) if "bias" in tree else None
    return Linear4bit(weight, bias=bias, compute_dtype=compute_dtype,
                      pair_pipeline=pair_pipeline, fp4_decode=fp4_decode)


def linear4bit_to_numpy(lin: Linear4bit) -> Tuple[Tree, Dict[str, Any]]:
    """Inverse of :func:`linear4bit_from_numpy`: ``(tree, meta)``."""
    st = lin.quant_state
    tree = {"weight.wp": lin.weight.wp, "weight.scales": lin.weight.scales,
            f"{_QS}.absmax": st.absmax, f"{_QS}.code": st.code}
    if st.nested:
        tree.update({f"{_QS}.offset": st.offset,
                     f"{_QS}.state2.absmax": st.state2.absmax,
                     f"{_QS}.state2.code": st.state2.code})
    if lin.bias is not None:
        tree["bias"] = lin.bias
    return ({k: _array(t) for k, t in tree.items()},
            st.as_dict()["quant_state"])
