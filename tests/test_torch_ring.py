"""The port's ring attention and sequence-parallel prefill
(``parallel/ring.py``) against the JAX package's on the 8-device CPU mesh
and against the port's single-device prefill, with gloo ranks on the
CPU: ``ring_attention`` against dense attention, SP at sp = 2 and 4,
sp x tp = 2 x 2, a sliding window, the Gemma-2 and Qwen3 families, an
int8 cache, and one rank. The module top imports only torch, numpy and
the port; JAX is imported inside the tests.

Tolerances are the JAX tests' (``tests/test_ring.py``): the ring sums in
another fp32 order than the dense softmax, so logits agree within 2e-2
(5e-2 for Gemma-2's softcaps and ``1 + w`` norms), the filled cache's
deeper layers within 2e-2, and greedy argmaxes exactly. Layer 0 agrees
within one bf16 rounding step and the plain matmul's summation order
(see :func:`_layer0_close`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.parallel import (RankPool, make_mesh,
                                              shard_llama_params,
                                              sharded_cache)
from quantizations_tpu_torch.parallel import ring as tring
from quantizations_tpu_torch.parallel.shard import ensure_planar

torch.set_num_threads(1)

T, B, MAX_SEQ = 16, 2, 32
GEMMA2 = dict(hidden_activation="gelu_tanh", post_norms=True,
              norm_plus_one=True, embed_normalizer=True,
              attn_logit_softcap=50.0, final_logit_softcap=30.0,
              query_scale=48.0, sliding_window=5, sliding_layers="even")


def dense_causal(q, k, v):
    B_, T_, KVH, G, D = q.shape
    qf = q.astype(np.float64) * (D ** -0.5)
    sc = np.einsum("bqkgd,bskd->bqkgs", qf, k.astype(np.float64))
    mask = np.tril(np.ones((T_, T_), bool))
    sc = np.where(mask[None, :, None, None, :], sc, -np.inf)
    p = np.exp(sc - sc.max(axis=-1, keepdims=True))
    p = p / p.sum(axis=-1, keepdims=True)
    return np.einsum("bqkgs,bskd->bqkgd", p, v.astype(np.float64))


def rank_ring(q, k, v):
    mesh = make_mesh((-1,), ("sp",), device="cpu")
    return tring.make_ring_attention_fn(mesh, "sp")(
        *(torch.from_numpy(a) for a in (q, k, v)))


def _planar(params):
    st = params.layers
    return dataclasses.replace(params, layers=dataclasses.replace(
        st, o=ensure_planar(st.o), down=ensure_planar(st.down)))


def rank_sp(tree, cfg, n, tp, ids):
    """SP (or sp x tp) prefill, its cache, the single-device prefill of
    the same params (o and down planar under tp) and each cache's next
    greedy token."""
    params = params_from_numpy(tree, cfg, device="cpu")
    shape, axes = ((n, tp), ("sp", "tp")) if tp else ((n,), ("sp",))
    mesh = make_mesh(shape, axes, device="cpu")
    ids = torch.from_numpy(ids)
    ref_params = _planar(params) if tp else params
    ref_logits, ref_cache = tl.prefill(
        ref_params, ids, tl.KVCache.create(cfg, B, MAX_SEQ, device="cpu"),
        cfg, last_token_only=True)
    axis = None
    if tp:
        params = shard_llama_params(params, mesh, cfg)
        cache = sharded_cache(cfg, B, MAX_SEQ, mesh)
        axis = mesh.axis("tp")
    else:
        cache = tl.KVCache.create(cfg, B, MAX_SEQ, device="cpu")
    f = tring.make_sp_prefill_fn(mesh, cfg, tp_axis="tp" if tp else None)
    logits, cache = f(params, ids, cache)
    nxt = logits.argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((B,), T, dtype=torch.int64)
    l1, _ = tl.decode_step(params, nxt, cache, pos, cfg, axis_name=axis)
    l2, _ = tl.decode_step(ref_params, nxt, ref_cache, pos, cfg)
    planes = {k: getattr(cache, k) for k in ("k", "v", "k_scale", "v_scale")
              if getattr(cache, k) is not None}
    ref_planes = {k: getattr(ref_cache, k) for k in planes}
    if tp:        # this rank's kv heads of the single-device cache
        kv = cfg.num_key_value_heads // tp
        r = mesh.axis("tp").rank
        ref_planes = {k: p[:, :, r * kv:(r + 1) * kv]
                      for k, p in ref_planes.items()}
    return dict(logits=logits, ref_logits=ref_logits[:, 0], planes=planes,
                ref_planes=ref_planes, next=(l1.argmax(-1), l2.argmax(-1)))


def _tree(obj):
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _cfgs(**knobs):
    from quantizations_tpu.models import llama as jl

    return (dataclasses.replace(jl.TINY_LLAMA, **knobs),
            dataclasses.replace(tl.TINY_LLAMA, **knobs))


def _jax_sp(jcfg, jp, n, tp, ids):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from quantizations_tpu.models.llama import KVCache
    from quantizations_tpu.parallel.ring import make_sp_prefill_fn
    from quantizations_tpu.parallel.shard import (cache_pspec,
                                                  shard_llama_params)

    devs = np.asarray(jax.devices()[:n * (tp or 1)])
    cache = KVCache.create(jcfg, B, MAX_SEQ)
    if tp:
        mesh = Mesh(devs.reshape(n, tp), ("sp", "tp"))
        jp = shard_llama_params(jp, mesh, jcfg)
        cache = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), cache,
            cache_pspec(jcfg))
    else:
        mesh = Mesh(devs, ("sp",))
    logits, _ = make_sp_prefill_fn(mesh, jcfg, tp_axis="tp" if tp else None)(
        jp, jnp.asarray(ids), cache)
    return np.asarray(logits)


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", threads=1) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device="cpu", threads=1) as pool:
        yield pool


@pytest.mark.parametrize("n,T_", [(2, 16), (4, 32)])
def test_ring_attention_matches_dense_and_jax(pool2, pool4, n, T_):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from quantizations_tpu.parallel.ring import make_ring_attention_fn

    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, T_, 2, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, T_, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, T_, 2, 16)).astype(np.float32)
    res = (pool2 if n == 2 else pool4).run(rank_ring, q, k, v)
    ref = dense_causal(q, k, v)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    want = np.asarray(make_ring_attention_fn(mesh, "sp")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for out in res:
        assert torch.equal(out, res[0])
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=5e-6)
        np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=5e-6)


def test_ring_attention_one_rank_is_dense():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 8, 1, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 8, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, 8, 1, 8)).astype(np.float32)
    out = rank_ring(q, k, v)
    np.testing.assert_allclose(out.numpy(), dense_causal(q, k, v),
                               rtol=2e-5, atol=2e-5)


def _layer0_close(got, ref, name):
    """Layer 0's K/V have no attention upstream: the same projection of
    the same rows. The CPU's plain pair matmul orders a row's fp32 sum by
    the row count it is given (T / n rows a rank against T), which moves
    a small output by up to ~1e-5 of the plane's largest value before the
    bf16 rounding; so the planes agree within one bf16 step plus 1e-4 of
    the plane's largest value (one int8 code), and bit for bit at sp = 2,
    whose ranks' 16 rows block as the single device's 32 do."""
    if got.dtype == torch.int8:
        assert (got.int() - ref.int()).abs().max() <= 1, name
        return
    g, r = got.float(), ref.float()
    tol = r.abs() * 2 ** -7 + 1e-4 * r.abs().max()
    assert ((g - r).abs() <= tol).all(), name


def _check_sp(res, want, tol=2e-2, cache_tol=2e-2):
    for r in res:
        assert torch.equal(r["logits"], res[0]["logits"])
        np.testing.assert_allclose(r["logits"].numpy(), want, rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(r["logits"].numpy(),
                                   r["ref_logits"].numpy(), rtol=tol,
                                   atol=tol)
        assert torch.equal(r["logits"].argmax(-1),
                           r["ref_logits"].argmax(-1))
        assert (r["logits"].argmax(-1).numpy() == want.argmax(-1)).all()
        for name, plane in r["planes"].items():
            ref = r["ref_planes"][name]
            _layer0_close(plane[0, :, :, :T], ref[0, :, :, :T], name)
            if cache_tol is not None:
                np.testing.assert_allclose(
                    plane[:, :, :, :T].float().numpy(),
                    ref[:, :, :, :T].float().numpy(), rtol=cache_tol,
                    atol=cache_tol)
        assert torch.equal(*r["next"])


@pytest.mark.parametrize("n", [2, 4])
def test_sp_prefill_matches_jax_and_single_device(pool2, pool4, n):
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs()
    jp = jl.init_llama_params(jcfg, seed=0)
    ids = np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, T)
                                            ).astype(np.int32)
    res = (pool2 if n == 2 else pool4).run(rank_sp, _tree(jp), tcfg, n,
                                           None, ids)
    _check_sp(res, _jax_sp(jcfg, jp, n, None, ids))


def test_sp_tp_prefill_matches_jax_and_single_device(pool4):
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs()
    jp = jl.init_llama_params(jcfg, seed=0)
    ids = np.random.default_rng(3).integers(0, tcfg.vocab_size, (B, T)
                                            ).astype(np.int32)
    res = pool4.run(rank_sp, _tree(jp), tcfg, 2, 2, ids)
    for r in res:
        assert r["planes"]["k"].shape[2] == tcfg.num_key_value_heads // 2
    _check_sp(res, _jax_sp(jcfg, jp, 2, 2, ids))


@pytest.mark.parametrize("knobs,tol", [
    (dict(sliding_window=5), 2e-2),
    (GEMMA2, 5e-2),
    (dict(qk_norm=True), 5e-2),
], ids=["sliding_window", "gemma2", "qwen3"])
def test_sp_prefill_family_knobs(pool4, knobs, tol):
    """A sliding window across chunks, and the Gemma-2 and Qwen3 layers
    through the ring trunk, at sp = 4 (the JAX tests' seeds 4 and 5)."""
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs(**knobs)
    jp = jl.init_llama_params(jcfg, seed=0)
    seed = 4 if "qk_norm" not in knobs and "post_norms" not in knobs else 5
    ids = np.random.default_rng(seed).integers(0, tcfg.vocab_size, (B, T)
                                               ).astype(np.int32)
    res = pool4.run(rank_sp, _tree(jp), tcfg, 4, None, ids)
    _check_sp(res, _jax_sp(jcfg, jp, 4, None, ids), tol=tol, cache_tol=None)


def test_sp_prefill_int8(pool2):
    """int8 quantize-on-write in the ring: layer 0's codes and steps equal
    the single-device int8 prefill's, and the greedy continuation agrees."""
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs(kv_cache_dtype="int8")
    jp = jl.init_llama_params(jcfg, seed=0)
    ids = np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, T)
                                            ).astype(np.int32)
    res = pool2.run(rank_sp, _tree(jp), tcfg, 2, None, ids)
    for r in res:
        assert r["planes"]["k"].dtype == torch.int8
        assert set(r["planes"]) == {"k", "v", "k_scale", "v_scale"}
    _check_sp(res, _jax_sp(jcfg, jp, 2, None, ids), cache_tol=None)


def test_sp_prefill_refusals():
    params = tl.init_llama_params(tl.TINY_LLAMA, seed=0, device="cpu")
    mesh = make_mesh((1, 1), ("sp", "tp"), device="cpu")
    with pytest.raises(ValueError, match="named 'tp'"):
        tring.make_sp_prefill_fn(mesh, tl.TINY_LLAMA, tp_axis="sp")
    f = tring.make_sp_prefill_fn(mesh, tl.TINY_LLAMA, tp_axis="tp")
    cache = tl.KVCache.create(tl.TINY_LLAMA, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="must be planar"):
        f(params, torch.zeros((1, 4), dtype=torch.int32), cache)
    f = tring.make_sp_prefill_fn(make_mesh((1,), ("sp",), device="cpu"),
                                 tl.TINY_LLAMA)
    with pytest.raises(ValueError, match="runs past"):
        f(params, torch.zeros((1, 16), dtype=torch.int32), cache)
