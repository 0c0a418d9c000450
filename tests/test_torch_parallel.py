"""The port's tensor parallelism (``quantizations_tpu_torch/parallel``:
the mesh, the launcher, the collectives, ``shard``, ``multihost``) against
the JAX package's sharded functions on the 8-device CPU mesh of
``tests/conftest.py``, with gloo ranks on the CPU.

The module imports only torch, numpy and the port at its top: the rank
bodies below are unpickled in spawned ranks, which must not import JAX.
Each test imports JAX inside. One pool of 4 ranks and one of 2 serve the
module; each rank runs with one thread.

The parameters are the JAX package's ``TINY_LLAMA`` (seed 0) through
``bridge.py``. The port's TP path equals its single-device path on the
same planar o/down bit for bit on the CPU (the plain kernels' fp32 sums
do not depend on the row split, and the sum over ranks is in coordinate
order), and its tokens equal the JAX package's sharded generate on the
JAX tests' prompts.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.parallel import (RankError, RankPool, launch,
                                              make_mesh)
from quantizations_tpu_torch.parallel import collectives as coll
from quantizations_tpu_torch.parallel import multihost as tmh
from quantizations_tpu_torch.parallel import shard as tsh
from quantizations_tpu_torch.serve.generate import make_generate_fn

torch.set_num_threads(1)

MAX_SEQ = 32
PROMPT = [3, 1, 4, 1, 5]
# 8 tokens from seed 200: the JAX tests' [3, 1, 4, 1, 5, 9, 2, 6] parts
# the port's Gemma-2 stream from the JAX package's at its second token
# on one device already (top-2 logits 2.339 and 2.305)
KNOB_PROMPT = [int(t) for t in np.random.default_rng(200).integers(1, 1024, 8)]
FAMILY_KNOBS = [
    dict(sliding_window=6),                               # Mistral
    dict(sliding_window=6, sliding_layers="even",         # Gemma-2
         post_norms=True, norm_plus_one=True,
         hidden_activation="gelu_tanh", embed_normalizer=True,
         attn_logit_softcap=50.0, final_logit_softcap=30.0,
         query_scale=24),
    dict(qk_norm=True),                                   # Qwen3
]


# -- rank bodies (module level: they travel to the ranks by import path) ----

def _planar(params):
    st = params.layers
    return dataclasses.replace(params, layers=dataclasses.replace(
        st, o=tsh.ensure_planar(st.o), down=tsh.ensure_planar(st.down)))


def rank_generate(tree, cfg, tp, ids, new, chunks=1):
    """TP generate on a ``(tp,)`` mesh, the single-device generate on the
    same planar o/down, and both prefills' logits."""
    cfg = dataclasses.replace(cfg, tp_overlap_chunks=chunks)
    params = params_from_numpy(tree, cfg, device="cpu")
    mesh = make_mesh((tp,), ("tp",), device="cpu")
    serve = ServeConfig(max_seq_len=MAX_SEQ, max_new_tokens=new)
    ids = torch.tensor(ids, dtype=torch.int32)
    local = tsh.shard_llama_params(params, mesh, cfg)
    toks, cache = tsh.make_sharded_generate_fn(cfg, serve, mesh)(
        local, ids, tsh.sharded_cache(cfg, ids.shape[0], MAX_SEQ, mesh),
        None)
    logits, _ = tl.prefill(local, ids, tsh.sharded_cache(
        cfg, ids.shape[0], MAX_SEQ, mesh), cfg, axis_name=mesh.axis("tp"))
    ref = _planar(params)
    ref_toks, _ = make_generate_fn(cfg, serve)(
        ref, ids, tl.KVCache.create(cfg, ids.shape[0], MAX_SEQ,
                                    device="cpu"), None)
    ref_logits, _ = tl.prefill(ref, ids, tl.KVCache.create(
        cfg, ids.shape[0], MAX_SEQ, device="cpu"), cfg)
    return dict(toks=toks, ref_toks=ref_toks, logits=logits,
                ref_logits=ref_logits, kv_heads=cache.k.shape[2],
                stats=mesh.stats.as_dict())


def rank_dp_tp(tree, cfg, tp, ids, new, temperature=0.0):
    params = params_from_numpy(tree, cfg, device="cpu")
    mesh = tmh.make_dp_tp_mesh(tp=tp, device="cpu")
    serve = ServeConfig(max_seq_len=48, max_new_tokens=new,
                        temperature=temperature)
    ids = torch.tensor(ids, dtype=torch.int32)
    g = torch.Generator()
    g.manual_seed(7)
    cache = tsh.sharded_cache(cfg, ids.shape[0] // mesh.shape["dp"], 48,
                              mesh)
    toks, _ = tmh.make_dp_tp_generate_fn(cfg, serve, mesh)(
        tsh.shard_llama_params(params, mesh, cfg), ids, cache, g)
    return toks, mesh.axis("dp").rank, tmh.is_multihost(), \
        tmh.host_local_batch(8)


def rank_collectives():
    """Every collective of the helper on a (2, 2) mesh."""
    mesh = make_mesh((2, 2), ("a", "b"), device="cpu")
    a, b = mesh.axis("a"), mesh.axis("b")
    me = float(dist.get_rank())
    t = torch.full((3,), me)
    return dict(
        coords=(a.rank, b.rank), lines=(a.ranks, b.ranks),
        sum_b=coll.all_reduce_sum(t, b), cat_a=coll.all_gather_cat(t, a),
        ring_b=coll.ring_shift(t, b),
        bcast_a=coll.broadcast(t.clone(), a, 1),
        pending=coll.ordered_sum(coll.start_all_gather(t, b).wait()),
        calls=mesh.stats.as_dict()["calls"])


def rank_raises():
    if dist.get_rank() == 1:
        raise ValueError("rank one refuses")
    return dist.get_rank()


def rank_blocks():
    """Rank 0 waits in a collective that rank 1 never joins."""
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))
    return dist.get_rank()


# -- helpers on the JAX side --------------------------------------------------

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


def _jax_sharded_generate(jcfg, jparams, tp, ids, new):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from quantizations_tpu.config import ServeConfig as JServeConfig
    from quantizations_tpu.models.llama import KVCache
    from quantizations_tpu.parallel import (make_mesh as jmesh,
                                            make_sharded_generate_fn,
                                            shard_llama_params)
    from quantizations_tpu.parallel.shard import cache_pspec

    mesh = jmesh((tp,), ("tp",))
    serve = JServeConfig(max_seq_len=MAX_SEQ, max_new_tokens=new,
                         temperature=0.0, donate_cache=False)
    cache = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        KVCache.create(jcfg, len(ids), MAX_SEQ), cache_pspec(jcfg))
    toks, _ = make_sharded_generate_fn(jcfg, serve, mesh)(
        shard_llama_params(jparams, mesh, jcfg),
        jnp.asarray(ids, jnp.int32), cache, jax.random.PRNGKey(0))
    return np.asarray(toks)


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", threads=1) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device="cpu", threads=1) as pool:
        yield pool


@pytest.fixture(scope="module")
def tiny():
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs()
    jp = jl.init_llama_params(jcfg, seed=0)
    return jp, _tree(jp), jcfg, tcfg


# -- validate_tp --------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("preset", ["TINY_LLAMA", "LLAMA3_8B", "GEMMA2_9B",
                                    "LLAMA3_70B"])
def test_validate_tp_matches_jax(preset, tp):
    from quantizations_tpu.models import llama as jl
    from quantizations_tpu.parallel.shard import validate_tp as jvalidate

    def outcome(fn, cfg):
        try:
            fn(cfg, tp)
            return None
        except ValueError as e:
            return str(e)

    want = outcome(jvalidate, getattr(jl, preset))
    got = outcome(tsh.validate_tp, getattr(tl, preset))
    assert got == want


# -- shard_for_rank against the JAX shards ----------------------------------

def _jax_shards(jparams, jcfg, tp, fused=False):
    """{path: [shard of mesh position d]} of the JAX package's placement."""
    import jax

    from quantizations_tpu.parallel import make_mesh as jmesh
    from quantizations_tpu.parallel.shard import (fuse_projections_tp,
                                                  shard_llama_params)

    mesh = jmesh((tp,), ("tp",))
    placed = shard_llama_params(jparams, mesh, jcfg)
    if fused:
        placed = fuse_projections_tp(placed, mesh, jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(placed)
    out = {}
    for path, leaf in flat:
        by_dev = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        out[".".join(k.name for k in path)] = [
            by_dev[d] for d in mesh.devices.flat]
    return out


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("layout", ["pair", "planar", "bf16x2", "fused"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_for_rank_equals_jax_shards(layout, tp):
    from quantizations_tpu.models import llama as jl
    from quantizations_tpu.parallel.shard import _ensure_planar

    q = dict(scales_dtype="bf16x2") if layout == "bf16x2" else {}
    jcfg, tcfg = _cfgs(quant=q, attention_bias=True)
    jp = jl.init_llama_params(jcfg, seed=0)
    if layout == "planar":
        st = jp.layers
        jp = jp.replace(layers=st.replace(**{
            n: _ensure_planar(getattr(st, n))
            for n in ("q", "k", "v", "gate", "up")}))
    want = _jax_shards(jp, jcfg, tp, fused=layout == "fused")
    full = params_from_numpy(_tree(jp), tcfg, device="cpu")
    for r in range(tp):
        got = tsh.shard_for_rank(full, tcfg, tp, r)
        if layout == "fused":
            got = tsh.fuse_projections(got)
        got = dict(tl.named_tensors(got))
        assert set(got) == set(want)
        for name, t in got.items():
            assert t.is_contiguous(), name
            w = want[name][r]
            g = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
                else t.numpy()
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, _bits(w), err_msg=name)


def test_shard_refuses_fused_params_and_bad_meshes(tiny):
    _, tree, _, tcfg = tiny
    full = params_from_numpy(tree, tcfg, device="cpu")
    with pytest.raises(ValueError, match="fused params"):
        tsh.shard_for_rank(tl.fuse_projections(full), tcfg, 2, 0)
    with pytest.raises(ValueError, match="does not shard over tp=3"):
        tsh.shard_for_rank(full, tcfg, 3, 0)
    with pytest.raises(TypeError, match="parallel.make_mesh"):
        tsh.shard_llama_params(full, object(), tcfg)
    with pytest.raises(ValueError, match="no axis 'tp'"):
        tsh.shard_llama_params(full, make_mesh((1,), ("dp",), device="cpu"),
                               tcfg)
    with pytest.raises(TypeError, match="mesh axis"):
        tl.prefill(full, torch.zeros((1, 2), dtype=torch.int32),
                   tl.KVCache.create(tcfg, 1, MAX_SEQ, device="cpu"), tcfg,
                   axis_name="tp")


def test_one_process_mesh_degenerates_to_single_device(tiny):
    """n = 1: a mesh over this one process, every collective the
    identity, the generate the single-device one bit for bit."""
    _, tree, _, tcfg = tiny
    mesh = make_mesh((-1,), ("tp",), device="cpu")
    assert mesh.shape == {"tp": 1} and mesh.axis("tp").group is None
    full = params_from_numpy(tree, tcfg, device="cpu")
    serve = ServeConfig(max_seq_len=MAX_SEQ, max_new_tokens=4)
    ids = torch.tensor([PROMPT], dtype=torch.int32)
    toks, _ = tsh.make_sharded_generate_fn(tcfg, serve, mesh)(
        tsh.shard_llama_params(full, mesh, tcfg), ids,
        tsh.sharded_cache(tcfg, 1, MAX_SEQ, mesh), None)
    ref, _ = make_generate_fn(tcfg, serve)(
        _planar(full), ids, tl.KVCache.create(tcfg, 1, MAX_SEQ,
                                              device="cpu"), None)
    assert torch.equal(toks, ref)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((2,), ("tp",), device="cpu")


# -- TP generate ---------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_tp_generate_matches_jax_and_single_device(tiny, pool2, pool4, tp):
    jp, tree, jcfg, tcfg = tiny
    pool = pool2 if tp == 2 else pool4
    res = pool.run(rank_generate, tree, tcfg, tp, [PROMPT], 5)
    want = _jax_sharded_generate(jcfg, jp, tp, [PROMPT], 5)
    for r in res:
        assert r["kv_heads"] == tcfg.num_key_value_heads // tp
        np.testing.assert_array_equal(r["toks"].numpy(), want)
        assert torch.equal(r["toks"], res[0]["toks"])
        # the shard path is the single-device one on planar o/down
        assert torch.equal(r["toks"], r["ref_toks"])
        assert torch.equal(r["logits"], r["ref_logits"])
        # 2 sums a layer and the logits gather a forward (5 of the
        # generate, 1 prefill), none staged
        assert r["stats"]["calls"]["all_gather"] == 6 * (
            2 * tcfg.num_hidden_layers + 1)
        assert r["stats"]["staged"] == {}


@pytest.mark.parametrize("knobs", FAMILY_KNOBS,
                         ids=["mistral", "gemma2", "qwen3"])
def test_tp_generate_family_knobs(pool2, knobs):
    from quantizations_tpu.models import llama as jl

    jcfg, tcfg = _cfgs(**knobs)
    jp = jl.init_llama_params(jcfg, seed=0)
    res = pool2.run(rank_generate, _tree(jp), tcfg, 2, [KNOB_PROMPT], 5)
    want = _jax_sharded_generate(jcfg, jp, 2, [KNOB_PROMPT], 5)
    for r in res:
        np.testing.assert_array_equal(r["toks"].numpy(), want)
        assert torch.equal(r["toks"], r["ref_toks"])


def test_tp_overlap_chunks_bit_identical(tiny, pool4):
    """``tp_overlap_chunks`` 4 gives the unchunked logits bit for bit;
    7 (which does not divide the rows) falls back to the single sum."""
    _, tree, _, tcfg = tiny
    base = pool4.run(rank_generate, tree, tcfg, 4, [PROMPT], 6)
    for chunks in (4, 7):
        res = pool4.run(rank_generate, tree, tcfg, 4, [PROMPT], 6, chunks)
        for r, b in zip(res, base):
            assert torch.equal(r["logits"], b["logits"])
            assert torch.equal(r["toks"], b["toks"])
        # 7 forwards (6 of the generate, 1 prefill): one gather per chunk
        # of each o and down, and the logits gather
        per = (chunks if chunks == 4 else 1) * 2 * tcfg.num_hidden_layers
        assert res[0]["stats"]["calls"]["all_gather"] == 7 * (per + 1)


def test_dp_tp_generate_matches_jax(tiny, pool4):
    import jax
    import jax.numpy as jnp

    from quantizations_tpu.config import ServeConfig as JServeConfig
    from quantizations_tpu.models.llama import KVCache
    from quantizations_tpu.parallel.multihost import (
        make_dp_tp_generate_fn, make_dp_tp_mesh)
    from quantizations_tpu.parallel.shard import shard_llama_params

    jp, tree, jcfg, tcfg = tiny
    ids = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2]]
    res = pool4.run(rank_dp_tp, tree, tcfg, 2, ids, 6)
    mesh = make_dp_tp_mesh(tp=2, dp=4)
    serve = JServeConfig(max_seq_len=48, max_new_tokens=6, temperature=0.0)
    want = np.asarray(make_dp_tp_generate_fn(jcfg, serve, mesh)(
        shard_llama_params(jp, mesh, jcfg), jnp.asarray(ids * 2, jnp.int32),
        KVCache.create(jcfg, 4, 48), jax.random.PRNGKey(0))[0])[:2]
    for toks, _, multi, share in res:
        np.testing.assert_array_equal(toks.numpy(), want)
        assert multi and share == 2
    assert [r[1] for r in res] == [0, 0, 1, 1]
    # at temperature > 0 each replica samples from its own generator:
    # the same prompt on both replicas gives different streams
    res = pool4.run(rank_dp_tp, tree, tcfg, 2, [ids[0], ids[0]], 6, 1.0)
    toks = res[0][0]
    assert all(torch.equal(r[0], toks) for r in res)
    assert not torch.equal(toks[0], toks[1])


def test_dp_tp_mesh_is_tp_minor(pool4):
    res = pool4.run(rank_collectives)
    assert [r["coords"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["lines"] for r in res] == [((0, 2), (0, 1)), ((1, 3), (0, 1)),
                                         ((0, 2), (2, 3)), ((1, 3), (2, 3))]
    for rank, r in enumerate(res):
        base = 2 * (rank // 2)
        assert torch.equal(r["sum_b"], torch.full((3,), 2.0 * base + 1))
        assert torch.equal(r["pending"], r["sum_b"])
        col = rank % 2
        assert torch.equal(r["cat_a"], torch.tensor([col] * 3 + [col + 2] * 3,
                                                    dtype=torch.float32))
        assert torch.equal(r["ring_b"], torch.full((3,), float(
            base + (rank + 1) % 2)))
        assert torch.equal(r["bcast_a"], torch.full((3,), float(col + 2)))
        assert r["calls"] == {"all_gather": 3, "send_recv": 1,
                              "broadcast": 1}


# -- the launcher ----------------------------------------------------------------

def test_launcher_raises_when_a_rank_raises():
    with pytest.raises(RankError, match="rank 1 failed"):
        launch(rank_raises, 2, device="cpu", threads=1, deadline=60)


def test_launcher_kills_a_rank_blocked_in_a_collective():
    import time

    t0 = time.monotonic()
    with pytest.raises(RankError, match="missed the 5 s deadline"):
        launch(rank_blocks, 2, device="cpu", threads=1, deadline=5)
    assert time.monotonic() - t0 < 60


def test_launcher_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RankPool(2)
    assert tsh.AXIS == "tp"
