"""The bridge between the JAX package and the port: JAX -> numpy -> port ->
numpy round-trips ``LlamaParams``, ``KVCache`` (bf16 and int8) and the
paged pool ``PagedKVCache`` bit for bit, with the
same storage (dtype and shape) on both sides and nothing repacked.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.models import llama as jl
from quantizations_tpu.serve import paged as jp
from quantizations_tpu_torch.bridge import (cache_from_numpy, cache_to_numpy,
                                            paged_from_numpy, paged_to_numpy,
                                            params_from_numpy,
                                            params_to_numpy)
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve import paged as tpg

torch.set_num_threads(1)

SMALL = dataclasses.replace(jl.TINY_LLAMA, vocab_size=256, hidden_size=128,
                            intermediate_size=256, num_attention_heads=4,
                            num_key_value_heads=2, head_dim=32)


def _tree(obj):
    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      v.view(np.uint8), err_msg=k)


@pytest.mark.parametrize("quant,knobs,fused", [
    (dict(quantize_embedding=True), {}, False),
    (dict(quantize_embedding=True), {}, True),
    (dict(scales_dtype="bf16x2", quantize_embedding=True), {}, True),
    (dict(scales_dtype=jnp.bfloat16, quantize_lm_head=False),
     dict(attention_bias=True, post_norms=True, qk_norm=True), False),
    (dict(quant_type="nf4"), dict(attention_bias=True), True),
])
def test_params_roundtrip_bit_exact(quant, knobs, fused):
    jcfg = dataclasses.replace(SMALL, quant=JQuantConfig(**quant), **knobs)
    jp = jl.init_llama_params(jcfg, seed=0)
    if fused:
        jp = jl.fuse_projections(jp)
    ref = _tree(jp)
    tcfg = dataclasses.replace(tl.TINY_LLAMA,
                               num_hidden_layers=SMALL.num_hidden_layers)
    tp = params_from_numpy(ref, tcfg, device="cpu")
    assert isinstance(tp.lm_head, tl.QLinear) == quant.get(
        "quantize_lm_head", True)
    if fused:
        assert tp.layers.q is None and tp.layers.qkv.wp.dim() == 3
        assert tp.layers.qkv.wp.dtype == torch.int32
    _assert_same(params_to_numpy(tp), ref)


def test_params_from_numpy_rejects_bad_trees():
    jcfg = dataclasses.replace(SMALL, quant=JQuantConfig())
    ref = _tree(jl.init_llama_params(jcfg, seed=0))
    tcfg = dataclasses.replace(tl.TINY_LLAMA,
                               num_hidden_layers=SMALL.num_hidden_layers)
    with pytest.raises(KeyError):
        params_from_numpy({**ref, "layers.nope": ref["final_norm"]}, tcfg,
                          device="cpu")
    with pytest.raises(ValueError):
        params_from_numpy(ref, dataclasses.replace(tcfg, num_hidden_layers=3),
                          device="cpu")


def test_cache_roundtrip_bit_exact(rng):
    cache = jl.KVCache.create(SMALL, 2, 16)
    filled = jl.KVCache(
        k=jnp.asarray(rng.standard_normal(cache.k.shape), jnp.bfloat16),
        v=jnp.asarray(rng.standard_normal(cache.v.shape), jnp.bfloat16))
    ref = _tree(filled)
    assert set(ref) == {"k", "v"}
    tc = cache_from_numpy(ref, device="cpu")
    assert tc.k.dtype == torch.bfloat16 and tc.max_seq == 16
    _assert_same(cache_to_numpy(tc), ref)


def test_int8_cache_roundtrip_bit_exact(rng):
    cfg = dataclasses.replace(SMALL, kv_cache_dtype="int8")
    cache = jl.KVCache.create(cfg, 2, 16)
    filled = jl.KVCache(
        k=jnp.asarray(rng.integers(-127, 128, cache.k.shape), jnp.int8),
        v=jnp.asarray(rng.integers(-127, 128, cache.v.shape), jnp.int8),
        k_scale=jnp.asarray(rng.random(cache.k_scale.shape), jnp.bfloat16),
        v_scale=jnp.asarray(rng.random(cache.v_scale.shape), jnp.bfloat16))
    ref = _tree(filled)
    assert set(ref) == {"k", "v", "k_scale", "v_scale"}
    tc = cache_from_numpy(ref, device="cpu")
    assert tc.k.dtype == torch.int8 and tc.k_scale.dtype == torch.bfloat16
    _assert_same(cache_to_numpy(tc), ref)
    # the port's own int8 cache has the JAX package's storage
    mine = tl.KVCache.create(dataclasses.replace(
        tl.TINY_LLAMA, kv_cache_dtype="int8"), 2, 16, device="cpu")
    assert mine.k.dtype == torch.int8 and mine.k_scale.shape == mine.k.shape[:4]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_pool_roundtrip_bit_exact(rng, kv_dtype):
    cfg = dataclasses.replace(SMALL, kv_cache_dtype=kv_dtype)
    pool = jp.PagedKVCache.create(cfg, num_pages=5, page_size=8)
    if kv_dtype == "int8":
        filled = pool.replace(
            pages_k=jnp.asarray(rng.integers(-127, 128, pool.pages_k.shape),
                                jnp.int8),
            pages_v=jnp.asarray(rng.integers(-127, 128, pool.pages_v.shape),
                                jnp.int8),
            k_scale=jnp.asarray(rng.random(pool.k_scale.shape), jnp.bfloat16),
            v_scale=jnp.asarray(rng.random(pool.v_scale.shape), jnp.bfloat16))
    else:
        filled = pool.replace(
            pages_k=jnp.asarray(rng.standard_normal(pool.pages_k.shape),
                                jnp.bfloat16),
            pages_v=jnp.asarray(rng.standard_normal(pool.pages_v.shape),
                                jnp.bfloat16))
    ref = _tree(filled)
    tp = paged_from_numpy(ref, device="cpu")
    assert tp.page_size == 8 and tp.num_pages == 5
    _assert_same(paged_to_numpy(tp), ref)
    mine = tpg.PagedKVCache.create(dataclasses.replace(
        tl.TINY_LLAMA, num_hidden_layers=SMALL.num_hidden_layers,
        num_key_value_heads=SMALL.num_key_value_heads,
        head_dim=SMALL.head_dim, kv_cache_dtype=kv_dtype), 5, 8, device="cpu")
    for (k, t), (k2, v) in zip(sorted(paged_to_numpy(mine).items()),
                               sorted(ref.items())):
        assert k == k2 and t.shape == v.shape and t.dtype == v.dtype
