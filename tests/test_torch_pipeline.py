"""The port's pipeline parallelism (``parallel/pipeline.py``) against the
JAX package's ``make_pp_generate_fn`` on the 8-device CPU mesh, with gloo
ranks on the CPU: pp = 2 and 4, pp x tp = 2 x 2, the family knobs (the
Gemma-2 window alternation crossing the stage boundary) and an int8
cache. The module top imports only torch, numpy and the port (the rank
bodies travel to spawned ranks); JAX is imported inside the tests.

The batches are the JAX tests' shapes (``tests/test_pipeline.py``) from
``default_rng(seed)``: seed 0 as there, except where the port's greedy
stream parts from the JAX package's at a near-tie on one device already
(pp = 4 takes seed 1, the family knobs seed 6, int8 seed 3: seed 0's
last token is a near-tie between the two packages' int8 pipelines). Greedy tokens equal the
JAX package's; the bf16 pipeline's equal the port's single-device
generate on the same batch as well.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.parallel import RankPool, make_mesh
from quantizations_tpu_torch.parallel import pipeline as tpp
from quantizations_tpu_torch.serve.generate import make_generate_fn

torch.set_num_threads(1)

MAX_SEQ = 32


def _ids(B, T, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def rank_pp(tree, cfg, pp, tp, ids, new, max_seq=MAX_SEQ):
    """The pipeline generate on a (pp,) or (pp, tp) mesh, its cache's
    shape and the single-device generate of the same batch."""
    params = params_from_numpy(tree, cfg, device="cpu")
    shape, axes = ((pp, tp), ("pp", "tp")) if tp else ((pp,), ("pp",))
    mesh = make_mesh(shape, axes, device="cpu")
    tp_axis = "tp" if tp else None
    serve = ServeConfig(max_seq_len=max_seq, max_new_tokens=new)
    ids = torch.from_numpy(ids)
    local = tpp.shard_llama_params_pp(params, mesh, cfg, tp_axis)
    cache = tpp.pp_cache(cfg, ids.shape[0], max_seq, mesh, tp_axis)
    toks, cache = tpp.make_pp_generate_fn(cfg, serve, mesh, tp_axis)(
        local, ids, cache, None)
    ref, _ = make_generate_fn(cfg, serve)(params, ids, tl.KVCache.create(
        cfg, ids.shape[0], max_seq, device="cpu"), None)
    return dict(toks=toks, ref=ref, cache=tuple(cache.k.shape),
                dtype=str(cache.k.dtype), steps=cache.k_scale is not None,
                layers=local.layers.attn_norm.shape[0])


def rank_pp_refuses(tree, cfg):
    """The reserved position, and a batch that does not split."""
    params = params_from_numpy(tree, cfg, device="cpu")
    mesh = make_mesh((2,), ("pp",), device="cpu")
    local = tpp.shard_llama_params_pp(params, mesh, cfg)
    out = []
    for B, new in ((2, 29), (3, 4)):
        fn = tpp.make_pp_generate_fn(
            cfg, ServeConfig(max_seq_len=MAX_SEQ, max_new_tokens=new), mesh)
        try:
            fn(local, torch.zeros((B, 4), dtype=torch.int32),
               tpp.pp_cache(cfg, B, MAX_SEQ, mesh), None)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _tree(obj):
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _cfgs(**knobs):
    from quantizations_tpu.config import QuantConfig as JQuantConfig
    from quantizations_tpu.models import llama as jl

    q = knobs.pop("quant", {})
    return (dataclasses.replace(jl.TINY_LLAMA, quant=JQuantConfig(**q),
                                **knobs),
            dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(**q),
                                **knobs))


def _jax_pp(jcfg, jp, pp, tp, ids, new):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from quantizations_tpu.config import ServeConfig as JServeConfig
    from quantizations_tpu.models.llama import KVCache
    from quantizations_tpu.parallel.pipeline import (
        make_pp_generate_fn, pp_cache_pspec, shard_llama_params_pp)

    devs = np.asarray(jax.devices()[:pp * (tp or 1)])
    mesh = (Mesh(devs.reshape(pp, tp), ("pp", "tp")) if tp
            else Mesh(devs, ("pp",)))
    tp_axis = "tp" if tp else None
    serve = JServeConfig(max_seq_len=MAX_SEQ, max_new_tokens=new,
                         temperature=0.0, donate_cache=False)
    cache = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        KVCache.create(jcfg, ids.shape[0], MAX_SEQ),
        pp_cache_pspec(tp_axis, jcfg))
    toks, _ = make_pp_generate_fn(jcfg, serve, mesh, tp_axis=tp_axis)(
        shard_llama_params_pp(jp, mesh, jcfg, tp_axis=tp_axis),
        jnp.asarray(ids), cache, jax.random.PRNGKey(0))
    return np.asarray(toks)


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", threads=1) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device="cpu", threads=1) as pool:
        yield pool


@pytest.mark.parametrize("pp,tp,seed", [(2, None, 0), (4, None, 1),
                                        (2, 2, 0)])
def test_pp_generate_matches_jax(pool2, pool4, pp, tp, seed):
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs(num_hidden_layers=pp)
    jp = jl.init_llama_params(jcfg, seed=0)
    ids = _ids(pp * 2, 4, tcfg.vocab_size, seed)
    pool = pool4 if pp * (tp or 1) == 4 else pool2
    res = pool.run(rank_pp, _tree(jp), tcfg, pp, tp, ids, 5)
    want = _jax_pp(jcfg, jp, pp, tp, ids, 5)
    kv = tcfg.num_key_value_heads // (tp or 1)
    for r in res:
        np.testing.assert_array_equal(r["toks"].numpy(), want)
        assert r["layers"] == 1
        assert r["cache"] == (1, pp * 2, kv, MAX_SEQ, tcfg.head_dim)
        if tp is None:
            assert torch.equal(r["toks"], r["ref"])


@pytest.mark.parametrize("knobs", [
    dict(sliding_window=6),
    dict(sliding_window=6, sliding_layers="even", post_norms=True,
         norm_plus_one=True, hidden_activation="gelu_tanh",
         embed_normalizer=True, attn_logit_softcap=50.0,
         final_logit_softcap=30.0, query_scale=24),
    dict(qk_norm=True),
], ids=["mistral", "gemma2", "qwen3"])
def test_pp_generate_family_knobs(pool2, knobs):
    """4 layers over 2 stages: the Gemma-2 alternation follows the global
    layer index across the boundary. fp32 scales and 4 new tokens, as the
    JAX test takes them (its docstring names the near-ties beyond)."""
    import jax.numpy as jnp

    from quantizations_tpu.config import QuantConfig as JQuantConfig
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs(num_hidden_layers=4, **knobs)
    jcfg = dataclasses.replace(jcfg, quant=JQuantConfig(
        scales_dtype=jnp.float32))
    tcfg = dataclasses.replace(tcfg, quant=QuantConfig(
        scales_dtype=torch.float32))
    jp = jl.init_llama_params(jcfg, seed=0)
    ids = _ids(4, 8, tcfg.vocab_size, seed=6)
    res = pool2.run(rank_pp, _tree(jp), tcfg, 2, None, ids, 4)
    want = _jax_pp(jcfg, jp, 2, None, ids, 4)
    for r in res:
        assert r["layers"] == 2
        np.testing.assert_array_equal(r["toks"].numpy(), want)


def test_pp_generate_int8(pool2, pool4):
    """int8 KV through PP and pp x tp: the step planes ride the same
    microbatch rows and kv heads as the codes."""
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs(kv_cache_dtype="int8")
    jp = jl.init_llama_params(jcfg, seed=0)
    ids = _ids(4, 4, tcfg.vocab_size, seed=3)
    want = _jax_pp(jcfg, jp, 2, None, ids, 5)
    for pool, tp in ((pool2, None), (pool4, 2)):
        res = pool.run(rank_pp, _tree(jp), tcfg, 2, tp, ids, 5)
        for r in res:
            assert r["dtype"] == "torch.int8" and r["steps"]
            np.testing.assert_array_equal(r["toks"].numpy(), want)


def test_pp_refuses_the_reserved_position_and_odd_batches(pool2):
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs()
    jp = jl.init_llama_params(jcfg, seed=0)
    for r in pool2.run(rank_pp_refuses, _tree(jp), tcfg):
        assert "kept in reserve" in r[0]
        assert "batch 3 % pp 2" in r[1]


def test_pp_one_stage_is_the_single_device_generate():
    """pp = 1 in this one process: no hand-off, the logits' broadcast the
    identity, the single-device generate's tokens."""
    from quantizations_tpu_torch.bridge import params_to_numpy

    params = tl.init_llama_params(tl.TINY_LLAMA, seed=0, device="cpu")
    res = rank_pp(params_to_numpy(params), tl.TINY_LLAMA, 1, None,
                  _ids(2, 4, tl.TINY_LLAMA.vocab_size), 5)
    assert torch.equal(res["toks"], res["ref"])
    assert res["layers"] == tl.TINY_LLAMA.num_hidden_layers


def rank_pp_layers(tree, cfg):
    params = params_from_numpy(tree, cfg, device="cpu")
    mesh = make_mesh((2,), ("pp",), device="cpu")
    with pytest.raises(ValueError, match="layers 3 % pp 2"):
        tpp.shard_llama_params_pp(params, mesh, cfg)
    with pytest.raises(ValueError, match="fused params"):
        tpp.shard_llama_params_pp(
            tl.fuse_projections(params),
            mesh, dataclasses.replace(cfg, num_hidden_layers=2))
    return True


def test_pp_refuses_layers_that_do_not_split(pool2):
    from quantizations_tpu_torch.bridge import params_to_numpy

    cfg = dataclasses.replace(tl.TINY_LLAMA, num_hidden_layers=3)
    params = tl.init_llama_params(cfg, seed=0, device="cpu")
    assert pool2.run(rank_pp_layers, params_to_numpy(params), cfg) == [
        True, True]


def test_pp_flash_attention_copies_rows_back(pool2):
    """With ``use_flash_attention`` each microbatch's cache rows reach
    the decode kernel as contiguous copies and are written back: the
    pipeline's tokens equal the single-device flash generate's."""
    from quantizations_tpu_torch.bridge import params_to_numpy

    cfg = dataclasses.replace(tl.TINY_LLAMA, use_flash_attention=True)
    params = tl.init_llama_params(cfg, seed=0, device="cpu")
    for r in pool2.run(rank_pp, params_to_numpy(params), cfg, 2, None,
                       _ids(4, 4, cfg.vocab_size), 5):
        assert r["layers"] == 1
        assert torch.equal(r["toks"], r["ref"])
