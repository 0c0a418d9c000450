"""The port's paged serving path against the JAX package on the CPU.

- The engines' shared helpers (``iter_prefill_chunks``, ``clamp_buckets``,
  ``run_chunk_rounds``, ``draft_lookup_host``): equal outputs.
- ``sample_rows``: the same truncation mask as the JAX package (its
  masked logits are read where they enter ``jax.random.categorical``)
  and the same greedy rows. Draws are not compared: torch cannot give
  JAX's random stream.
- ``PageAllocator``, and ``insert_prefill``/``_gather_page`` bit-exact
  with the JAX package's pools.
- ``paged_decode_step`` and ``PagedEngine``: the JAX package's greedy
  output ids on ``TINY_LLAMA`` with bf16 and int8 pools, the Gemma-2 and
  Qwen3 knob stacks, the prefix cache, ``step_window``, the OOM rollback,
  and the same ``stats()`` after ``recover()``.

Greedy ids agree where the top-2 logit margin is clear. The port and the
JAX package round this tiny random model's activations and weights at
different places (``tests/test_torch_llama.py`` holds its logits within
2e-2 of max|logit|), and its top candidates often sit closer than that:
prompts of seeds 10 to 15 meet near-ties of 0.01% to 0.07% (checked on
the JAX package's own logits). The prompts are seeded where no greedy
choice is that close.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.models import llama as jl
from quantizations_tpu.serve import engine as je
from quantizations_tpu.serve import paged as jp
from quantizations_tpu_torch import QuantConfig
from quantizations_tpu_torch.bridge import (cache_from_numpy,
                                            paged_from_numpy, paged_to_numpy,
                                            params_from_numpy)
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve import engine as te
from quantizations_tpu_torch.serve import paged as tp

torch.set_num_threads(1)

PSZ = 16
SEED_DECODE, SEED_PREFIX, SEED_WINDOW = 30, 30, 40
GEMMA2 = dict(sliding_window=6, sliding_layers="even", post_norms=True,
              norm_plus_one=True, hidden_activation="gelu_tanh",
              embed_normalizer=True, attn_logit_softcap=50.0,
              final_logit_softcap=30.0, query_scale=24)
QWEN3 = dict(qk_norm=True)
# the Gemma-2 knobs at Gemma2-9B's head_dim 256: 2 kv heads of 2 query
# heads each
GEMMA2_256 = dict(GEMMA2, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=256, query_scale=256, tie_word_embeddings=True)
SEED_256 = 50


def _tree(obj):
    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _cfgs(**knobs):
    q = dict(quantize_embedding=True)
    return (dataclasses.replace(jl.TINY_LLAMA, quant=JQuantConfig(**q),
                                **knobs),
            dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(**q),
                                **knobs))


_MODELS = {}


def _model(**knobs):
    """(jax params, port params, jax cfg, port cfg), one init per knob
    set (int8 KV changes no parameter)."""
    key = tuple(sorted((k, v) for k, v in knobs.items()
                       if k != "kv_cache_dtype"))
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(**dict(key))
        p = jl.fuse_projections(jl.init_llama_params(jcfg, seed=0))
        _MODELS[key] = (p, params_from_numpy(_tree(p), tcfg, device="cpu"))
    jcfg, tcfg = _cfgs(**knobs)
    return _MODELS[key] + (jcfg, tcfg)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(
        1, jl.TINY_LLAMA.vocab_size, n)]


# -- shared helpers -----------------------------------------------------------

@pytest.mark.parametrize("plen,buckets,max_len,base", [
    (5, (8,), 0, 0), (40, (8, 16), 64, 0), (44, (8, 32), 48, 0),
    (20, (8, 16), 48, 16), (1, (64, 256), 2048, 0),
    (1900, (64, 256), 2048, 0), (700 - 512, (64, 256), 2048, 512)])
def test_iter_prefill_chunks_matches_jax(plen, buckets, max_len, base):
    assert (te.iter_prefill_chunks(plen, buckets, max_len, base)
            == je.iter_prefill_chunks(plen, buckets, max_len, base))


def test_iter_prefill_chunks_refuses_what_jax_refuses():
    for args in ((40, (64,), 32, 0), (30, (8,), 32, 8)):
        with pytest.raises(ValueError):
            je.iter_prefill_chunks(*args)
        with pytest.raises(ValueError):
            te.iter_prefill_chunks(*args)


@pytest.mark.parametrize("buckets,max_seq", [
    ((64, 256), 2048), ((256, 64, 16), 128), ((512,), 256)])
def test_clamp_buckets_matches_jax(buckets, max_seq):
    assert te.clamp_buckets(buckets, max_seq) == je.clamp_buckets(buckets,
                                                                  max_seq)


def test_run_chunk_rounds_matches_jax():
    prompts = [_prompt(1, 40), _prompt(2, 7), _prompt(3, 25)]
    covs = [16, 0, 0]
    bks = (8, 16)

    def entries(mod):
        return [(row, p, c, mod.iter_prefill_chunks(len(p) - c, bks,
                                                    max_len=64, base=c))
                for row, (p, c) in enumerate(zip(prompts, covs))]

    def recorder(log):
        def dispatch(ids, starts, plens):
            log.append((ids.tolist(), starts.tolist(), plens.tolist()))
            return ids.sum(axis=1) + starts * 7 + plens
        return dispatch

    jlog, tlog = [], []
    jout = je.run_chunk_rounds(entries(je), 4, np.zeros(4, np.int32),
                               recorder(jlog))
    tout = te.run_chunk_rounds(entries(te), 4, np.zeros(4, np.int32),
                               recorder(tlog))
    assert tout == jout and tlog == jlog


def test_draft_lookup_host_matches_jax():
    for hist in ([], [5], [3, 1, 4, 3, 1, 4, 3], [2, 7, 2, 7, 9, 2, 7],
                 _prompt(4, 30) * 2):
        for k in (1, 4, 8):
            assert te.draft_lookup_host(hist, k) == je.draft_lookup_host(
                hist, k)


# -- sampling -----------------------------------------------------------------

def _jax_truncated(monkeypatch, logits, samp):
    """The JAX package's truncated logits, read where they enter the
    categorical draw."""
    seen = {}

    def categorical(key, lt, axis=-1):
        seen["lt"] = np.asarray(lt)
        return jnp.argmax(lt, axis=axis)

    monkeypatch.setattr(je.jax.random, "categorical", categorical)
    greedy_rows = np.asarray(je.sample_rows_samp(
        jnp.asarray(logits), jnp.asarray(samp), jax.random.PRNGKey(0)))
    return seen["lt"], greedy_rows


@pytest.mark.parametrize("samp", [
    [[0.7, 5, 1.0], [1.0, 0, 0.9], [0.0, 0, 1.0], [1.3, 40, 0.5]],
    [[1.0, 0, 1.0], [0.5, 0, 1.0], [0.0, 0, 1.0], [2.0, 0, 1.0]],
    [[1.0, 1, 1.0], [1.0, 3, 0.2], [0.9, 0, 0.05], [1.0, 64, 0.999]],
])
def test_sample_rows_truncation_matches_jax(monkeypatch, samp):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    samp = np.asarray(samp, np.float32)
    jlt, jrows = _jax_truncated(monkeypatch, logits, samp)
    lt = torch.from_numpy(logits) / torch.clamp(
        torch.from_numpy(samp[:, 0]), min=1e-6)[:, None]
    got = te.truncate_rows(lt, torch.from_numpy(samp[:, 1]).int(),
                           torch.from_numpy(samp[:, 2]))
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(jlt))
    # greedy rows take the argmax; sampled rows stay inside the mask
    g = torch.Generator().manual_seed(1)
    for _ in range(10):
        tok = te.sample_rows_samp(torch.from_numpy(logits),
                                  torch.from_numpy(samp), g).numpy()
        for r in range(4):
            if samp[r, 0] == 0.0:
                assert tok[r] == jrows[r] == logits[r].argmax()
            else:
                assert np.isfinite(jlt[r, tok[r]])


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (12, 0.3)])
def test_sample_rows_scalar_truncation_matches_jax(monkeypatch, top_k,
                                                   top_p):
    logits = (np.random.default_rng(1).standard_normal((3, 64)) * 2).astype(
        np.float32)
    temps = np.asarray([0.8, 1.0, 1.5], np.float32)
    seen = {}

    def categorical(key, lt, axis=-1):
        seen["lt"] = np.asarray(lt)
        return jnp.argmax(lt, axis=axis)

    monkeypatch.setattr(je.jax.random, "categorical", categorical)
    je.sample_rows(jnp.asarray(logits), jnp.asarray(temps),
                   jax.random.PRNGKey(0), top_k=top_k, top_p=top_p)
    lt = torch.from_numpy(logits) / torch.from_numpy(temps)[:, None]
    got = te.truncate_rows(lt, top_k, top_p)
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(seen["lt"]))


def test_sample_rows_all_greedy_skips_the_draw():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    out = te.sample_rows(logits, torch.zeros(3), g, top_k=5)
    assert torch.equal(out, logits.argmax(-1).int())
    assert torch.equal(g.get_state(), state)


# -- allocator and page copies ------------------------------------------------

def test_page_allocator_matches_jax():
    ja_, ta_ = jp.PageAllocator(8), tp.PageAllocator(8)
    ops = [("alloc", 3), ("retain", None), ("free", None), ("alloc", 4),
           ("free_all", None), ("alloc", 7)]
    held = []
    for op, n in ops:
        if op == "alloc":
            a, b = ja_.alloc(n), ta_.alloc(n)
            assert a == b and 0 not in b
            held += b
        elif op == "retain":
            ja_.retain(held[0])
            ta_.retain(held[0])
        elif op == "free":
            ja_.free(held[:2] + [0])
            ta_.free(held[:2] + [0])
        else:
            ja_.free(held[2:] + [held[0]])
            ta_.free(held[2:] + [held[0]])
            held = []
        assert ta_.available == ja_.available
        assert all(ta_.refs(p) == ja_.refs(p) for p in range(8))
    assert ta_.num_usable == ja_.num_usable == 7
    with pytest.raises(MemoryError):
        ta_.alloc(1)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_insert_prefill_and_gather_page_match_jax(kv_dtype):
    rng = np.random.default_rng(0)
    jcfg, tcfg = _cfgs(kv_cache_dtype=kv_dtype)
    scratch = jl.KVCache.create(jcfg, 2, 64)
    if kv_dtype == "int8":
        scratch = scratch.replace(
            k=jnp.asarray(rng.integers(-127, 128, scratch.k.shape), jnp.int8),
            v=jnp.asarray(rng.integers(-127, 128, scratch.v.shape), jnp.int8),
            k_scale=jnp.asarray(rng.random(scratch.k_scale.shape),
                                jnp.bfloat16),
            v_scale=jnp.asarray(rng.random(scratch.v_scale.shape),
                                jnp.bfloat16))
    else:
        scratch = scratch.replace(
            k=jnp.asarray(rng.standard_normal(scratch.k.shape), jnp.bfloat16),
            v=jnp.asarray(rng.standard_normal(scratch.v.shape), jnp.bfloat16))
    tscratch = cache_from_numpy(_tree(scratch), device="cpu")
    page_ids = [5, 2, 7]
    jpool = jp.insert_prefill(jp.PagedKVCache.create(jcfg, 8, PSZ), scratch,
                              page_ids, 37, start_page=1, row=1)
    tpool = tp.insert_prefill(tp.PagedKVCache.create(tcfg, 8, PSZ,
                                                     device="cpu"),
                              tscratch, page_ids, 37, start_page=1, row=1)
    ref = _tree(jpool)
    got = paged_to_numpy(tpool)
    for k in ref:
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      ref[k].view(np.uint8), err_msg=k)
    # and back: page 7 into row 0 at position 16 of a fresh scratch
    js = jp._gather_page(jl.KVCache.create(jcfg, 2, 64), jpool,
                         jnp.int32(16), jnp.int32(7), jnp.int32(0))
    ts = tp._gather_page(tl.KVCache.create(tcfg, 2, 64, device="cpu"),
                         paged_from_numpy(ref, device="cpu"), 16, 7, 0)
    for k, t in tl.named_tensors(ts):
        a = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(getattr(js, k)).view(a.numpy().dtype))
    np.testing.assert_array_equal(
        ts.k[:, 0, :, 16:32].view(torch.uint8).numpy(),
        tscratch.k[:, 1, :, 32:48].view(torch.uint8).numpy())


# -- the paged decode step ----------------------------------------------------

def _decode_ids(mod, params, cfg, prompts, n, max_pages=2, **dev):
    """Prefill each prompt into a scratch, scatter it to pages, then ``n``
    batched greedy paged decode steps: the ids per row."""
    is_jax = mod is jp
    pages = (jp.PagedKVCache.create(cfg, num_pages=12, page_size=PSZ)
             if is_jax else tp.PagedKVCache.create(cfg, 12, PSZ, **dev))
    alloc = mod.PageAllocator(12)
    table = np.zeros((len(prompts), 4), np.int32)
    out = []
    for b, p in enumerate(prompts):
        if is_jax:
            scratch = jl.KVCache.create(cfg, 1, 64)
            lg, scratch = jl.prefill(params, jnp.asarray([p], jnp.int32),
                                     scratch, cfg, last_token_only=True)
            out.append([int(jnp.argmax(lg[0, -1]))])
        else:
            scratch = tl.KVCache.create(cfg, 1, 64, **dev)
            lg, scratch = tl.prefill(params, torch.tensor([p]), scratch, cfg,
                                     last_token_only=True)
            out.append([int(lg[0, -1].argmax())])
        ids = alloc.alloc(-(-(len(p) + n) // PSZ))
        pages = mod.insert_prefill(pages, scratch, ids, len(p))
        table[b, :len(ids)] = ids
    pos = np.asarray([len(p) for p in prompts], np.int32)
    for _ in range(n - 1):
        cur = np.asarray([[o[-1]] for o in out], np.int32)
        if is_jax:
            lg, pages = jp.paged_decode_step(
                params, jnp.asarray(cur), pages, jnp.asarray(table),
                jnp.asarray(pos), cfg, max_pages=max_pages)
            nxt = np.asarray(jnp.argmax(lg, -1))
        else:
            lg, pages = tp.paged_decode_step(
                params, torch.from_numpy(cur), pages, torch.from_numpy(table),
                torch.from_numpy(pos), cfg, max_pages=max_pages)
            nxt = lg.argmax(-1).numpy()
        for b in range(len(prompts)):
            out[b].append(int(nxt[b]))
        pos = pos + 1
    return out


@pytest.mark.parametrize("knobs", [
    {}, dict(kv_cache_dtype="int8"), GEMMA2, QWEN3,
    dict(paged_pages_per_step=1, kv_cache_dtype="int8", **GEMMA2)],
    ids=["bf16", "int8", "gemma2", "qwen3", "gemma2-int8"])
def test_paged_decode_step_matches_jax(knobs):
    jparams, tparams, jcfg, tcfg = _model(**knobs)
    prompts = [_prompt(SEED_DECODE, 8), _prompt(SEED_DECODE + 1, 21)]
    ref = _decode_ids(jp, jparams, jcfg, prompts, 6)
    got = _decode_ids(tp, tparams, tcfg, prompts, 6, device="cpu")
    assert got == ref


# -- the engine ---------------------------------------------------------------

def _run_engine(mod, params, cfg, prompts, lens, steps_per_dispatch=1,
                **kw):
    eng = mod.PagedEngine(params, cfg, **kw)
    uids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, lens)]
    done = eng.run(steps_per_dispatch=steps_per_dispatch)
    return eng, [done[u].output_ids for u in uids]


ENGINE = dict(num_pages=24, page_size=PSZ, slots=2, max_seq=64,
              prefill_buckets=(8, 16))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_engine_prefix_cache_matches_jax(kv_dtype):
    """Mixed prompts, two of them sharing a two-page prefix, through the
    batched admission (admit_width 2) with the prefix cache on."""
    jparams, tparams, jcfg, tcfg = _model(kv_cache_dtype=kv_dtype)
    base = _prompt(SEED_PREFIX, 40)
    prompts = [base, _prompt(6, 5), base[:36] + [7, 7, 7], _prompt(8, 19)]
    lens = [4, 6, 5, 3]
    kw = dict(ENGINE, prefix_cache=True, admit_width=2)
    jeng, ref = _run_engine(jp, jparams, jcfg, prompts, lens, **kw)
    teng, got = _run_engine(tp, tparams, tcfg, prompts, lens, **kw)
    assert got == ref
    assert teng.stats() == jeng.stats()
    assert list(teng._prefix.values()) == list(jeng._prefix.values())
    assert teng.stats()["pages_free"] == 23 - len(teng._prefix)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_engine_gemma2_head_dim_256_matches_jax(kv_dtype):
    """A tiny Gemma-2 at head_dim 256 through the engine: batched
    admission with the prefix cache, decode past the window of 6 on the
    even layer. The prompts of seeds 50-52 meet no near-tie on either
    pool (see the module docstring)."""
    jparams, tparams, jcfg, tcfg = _model(kv_cache_dtype=kv_dtype,
                                          **GEMMA2_256)
    assert tcfg.head_dim == 256
    base = _prompt(SEED_256, 36)
    prompts = [base, _prompt(SEED_256 + 1, 5), base[:33] + [9, 9],
               _prompt(SEED_256 + 2, 19)]
    lens = [6, 8, 5, 7]
    kw = dict(ENGINE, prefix_cache=True, admit_width=2)
    jeng, ref = _run_engine(jp, jparams, jcfg, prompts, lens, **kw)
    teng, got = _run_engine(tp, tparams, tcfg, prompts, lens, **kw)
    assert got == ref
    assert teng.stats() == jeng.stats()


def test_paged_engine_step_window_matches_jax():
    """run(steps_per_dispatch=4): mid-window finishes, a request admitted
    at a window boundary after a retirement, and the near-max_seq
    fallback to plain steps."""
    jparams, tparams, jcfg, tcfg = _model()
    prompts = [_prompt(SEED_WINDOW + i, n) for i, n in enumerate((3, 6, 5,
                                                                  25))]
    lens = [5, 9, 4, 6]
    kw = dict(ENGINE, max_seq=32, prefill_buckets=(8,))
    jeng, ref = _run_engine(jp, jparams, jcfg, prompts, lens,
                            steps_per_dispatch=4, **kw)
    teng, got = _run_engine(tp, tparams, tcfg, prompts, lens,
                            steps_per_dispatch=4, **kw)
    assert got == ref
    assert teng.stats() == jeng.stats()
    _, plain = _run_engine(tp, tparams, tcfg, prompts, lens, **kw)
    assert plain == got


def test_paged_engine_oom_rollback_matches_jax():
    """A pool with room for one sequence at a time: the second request's
    admission fails after it retained a shared prefix page, rolls back to
    the queue front with refcounts exact, and admits once the first
    retires: the same ids and allocator state as the JAX engine."""
    jparams, tparams, jcfg, tcfg = _model()
    pa = _prompt(3, 20)
    pb = pa[:16] + _prompt(4, 17)
    kw = dict(num_pages=4, page_size=PSZ, slots=2, max_seq=48,
              prefill_buckets=(8,), prefix_cache=True)
    engines = []
    for mod, params, cfg in ((jp, jparams, jcfg), (tp, tparams, tcfg)):
        eng = mod.PagedEngine(params, cfg, **kw)
        ua = eng.submit(pa, max_new_tokens=6)
        eng.step()
        shared = int(eng.table[0, 0])
        assert eng.alloc.refs(shared) == 2
        ub = eng.submit(pb, max_new_tokens=4)
        eng.step()
        assert eng.active[1] is None and len(eng.queue) == 1
        assert eng.alloc.refs(shared) == 2
        done = eng.run()
        engines.append((eng, done[ua].output_ids, done[ub].output_ids))
    (je_, ja_ids, jb_ids), (te_, ta_ids, tb_ids) = engines
    assert (ta_ids, tb_ids) == (ja_ids, jb_ids)
    assert te_.stats() == je_.stats()
    assert te_.alloc.available == je_.alloc.available


def test_paged_engine_tight_pool_and_rejections_match_jax():
    """admit_width 2 over a pool that fits one 2-page sequence: the
    batched group's second row rolls back (_AdmitOOM path) and retries;
    impossible requests are refused at submit."""
    jparams, tparams, jcfg, tcfg = _model()
    p1, p2 = _prompt(31, 20), _prompt(32, 20)
    kw = dict(num_pages=3, page_size=PSZ, slots=2, max_seq=32,
              prefill_buckets=(8,), admit_width=2)
    outs = []
    for mod, params, cfg in ((jp, jparams, jcfg), (tp, tparams, tcfg)):
        small = mod.PagedEngine(params, cfg, **dict(kw, num_pages=2))
        with pytest.raises(ValueError, match="usable pages"):
            small.submit(list(range(1, 21)), max_new_tokens=4)  # 2 pages > 1
        eng = mod.PagedEngine(params, cfg, **kw)
        with pytest.raises(ValueError, match="max_seq"):
            eng.submit(list(range(1, 30)), max_new_tokens=4)
        u1 = eng.submit(p1, max_new_tokens=6)
        u2 = eng.submit(p2, max_new_tokens=6)
        done = eng.run()
        assert eng.alloc.available == 2
        assert not any(eng.owned[s] for s in range(2))
        outs.append((done[u1].output_ids, done[u2].output_ids))
    assert outs[1] == outs[0]


def test_paged_engine_recover_matches_jax():
    jparams, tparams, jcfg, tcfg = _model()
    prompts = [_prompt(20, 5), _prompt(21, 4)]
    lens = [8, 7]
    res = []
    for mod, params, cfg in ((jp, jparams, jcfg), (tp, tparams, tcfg)):
        eng = mod.PagedEngine(params, cfg, **ENGINE, prefix_cache=True)
        uids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, lens)]
        for _ in range(3):
            eng.step()
        mid = eng.stats()
        assert eng.recover() == 2
        after = eng.stats()
        done = eng.run()
        res.append((mid, after, [done[u].output_ids for u in uids],
                    eng.stats()))
    assert res[1] == res[0]
    assert res[1][1]["pages_free"] == 23 and res[1][1]["live_tokens"] == 0


def test_paged_engine_page_size_pick_and_unported_paths():
    _, tparams, _, tcfg = _model()
    assert tp.PagedEngine(tparams, tcfg, num_pages=8,
                          max_seq=512).page_size == 256
    assert tp.PagedEngine(tparams, tcfg, num_pages=8,
                          max_seq=192).page_size == 64
    assert tp.PagedEngine(tparams, tcfg, num_pages=8,
                          max_seq=2048).page_size == 256
    with pytest.raises(ValueError, match="multiple"):
        tp.PagedEngine(tparams, tcfg, num_pages=8, max_seq=60, page_size=16)
    # the tensor-parallel pool is tests/test_torch_engine_tp.py's; a mesh
    # that is not the port's is refused
    with pytest.raises(TypeError, match="parallel.make_mesh"):
        tp.PagedEngine(tparams, tcfg, mesh=object(), **ENGINE)


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_paged_cache_create_matches_jax(kv_cache_dtype):
    """``PagedKVCache.create``: the JAX package's shapes and dtypes with
    its default ``kv_heads`` and ``dtype``."""
    jcfg = dataclasses.replace(jl.TINY_LLAMA, kv_cache_dtype=kv_cache_dtype)
    tcfg = dataclasses.replace(tl.TINY_LLAMA, kv_cache_dtype=kv_cache_dtype)
    want = jp.PagedKVCache.create(jcfg, 5, page_size=16)
    got = tp.PagedKVCache.create(tcfg, 5, page_size=16, device="cpu")
    for name in ("pages_k", "pages_v", "k_scale", "v_scale"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            assert tuple(g.shape) == tuple(w.shape), name
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
