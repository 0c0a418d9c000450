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
(steps ``[L, P, KV, page]``). bf16 arrays
arrive as numpy's ``bfloat16`` extension dtype and are moved by bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

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
from .serve.paged import PagedKVCache

__all__ = ["params_from_numpy", "params_to_numpy", "cache_from_numpy",
           "cache_to_numpy", "paged_from_numpy", "paged_to_numpy"]

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
