"""The port's speculative decoding against the JAX package on the CPU.

- ``spec_window_tokens`` and ``draft_prompt_lookup``: equal outputs on
  random inputs (wrap-around reads and the bonus slot included).
- ``spec_accept_sample``/``spec_accept_sample_vec``: greedy rows equal;
  with the JAX package's uniforms injected (``jax.random.uniform``
  patched), the same accept mask, and the same masked correction logits
  (read where they enter ``jax.random.categorical``). The port's draws
  come from a ``torch.Generator``, so the combined law is held by a
  distribution test at a fixed seed instead: the emitted token's law is
  ``p`` within a total variation of 0.02, at an ordinary position and at
  the bonus slot.
- ``paged_verify_step``: logits within 2e-2 * max|logit| of the JAX
  package's on the same pool (bf16 and int8), one row's window across a
  page boundary; the pool's other positions untouched, bit for bit, and
  the window's K/V within the same tolerance. The window write itself is
  bit-exact with the JAX package's ``_write_row_window`` on the same rows.
- Greedy ids (and the speculative counters) equal to the JAX package's:
  ``PagedEngine.step_spec``, ``run(spec_k, steps_per_dispatch)`` (that
  is, ``step_spec_multi``), a custom ``draft_fn``, the near-cache-end
  fallback, eos inside a window, and ``make_speculative_generate_fn``.
- The refusals: ``k > page_size``, a window longer than a page, a cache
  too short for the speculative generate (before any forward).

Greedy ids agree where the top-2 logit margin is clear (see
``tests/test_torch_paged.py``). The prompts are 6 tokens from seeds 202,
204 and 209, whose greedy streams agree with the JAX package's over 26
new tokens; seeds 201, 203, 205-208 part within 10 tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.config import ServeConfig as JServeConfig
from quantizations_tpu.models import llama as jl
from quantizations_tpu.serve import paged as jp
from quantizations_tpu.serve import speculative as jsp
from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.bridge import (paged_from_numpy, paged_to_numpy,
                                            params_from_numpy)
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve import paged as tp
from quantizations_tpu_torch.serve import speculative as tsp

torch.set_num_threads(1)

PSZ = 16
SEEDS = (204, 210, 212)
TOL = 2e-2
ENGINE = dict(num_pages=24, page_size=PSZ, slots=2, max_seq=64,
              prefill_buckets=(8,))


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


@pytest.fixture(scope="module")
def params():
    jcfg, tcfg = _cfgs()
    p = jl.fuse_projections(jl.init_llama_params(jcfg, seed=0))
    return p, params_from_numpy(_tree(p), tcfg, device="cpu")


def _prompt(seed, n=6):
    return [int(t) for t in np.random.default_rng(seed).integers(
        1, jl.TINY_LLAMA.vocab_size, n)]


# -- the accept rule, the window and the drafter ------------------------------

@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_spec_window_tokens_matches_jax(K):
    rng = np.random.default_rng(K)
    B = 64
    okk = rng.random((B, K)) < 0.8
    okk[:8] = True                         # full accepts: the bonus slot
    okk[8:12, -1] = False
    corr = rng.integers(0, 50, (B, K)).astype(np.int32)
    draft = rng.integers(0, 50, (B, K)).astype(np.int32)
    jg, ja = jsp.spec_window_tokens(jnp.asarray(okk), jnp.asarray(corr),
                                    jnp.asarray(draft))
    tg, ta = tsp.spec_window_tokens(torch.from_numpy(okk),
                                    torch.from_numpy(corr),
                                    torch.from_numpy(draft))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_draft_prompt_lookup_matches_jax(k):
    rng = np.random.default_rng(k)
    B, S = 32, 24
    hist = rng.integers(0, 4, (B, S)).astype(np.int32)   # matches are common
    hcnt = rng.integers(2, S + 1, B).astype(np.int32)
    hcnt[:3] = (2, 3, S)                   # shortest rows and a full row
    hist[3, :] = np.arange(S)              # no match: repeat from the end
    want = np.asarray(jsp.draft_prompt_lookup(jnp.asarray(hist),
                                              jnp.asarray(hcnt), k))
    got = tsp.draft_prompt_lookup(torch.from_numpy(hist),
                                  torch.from_numpy(hcnt), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_draft_prompt_lookup_reference_cases():
    hist = torch.tensor([[5, 6, 7, 8, 9, 5, 6, 0, 0, 0]])
    got = tsp.draft_prompt_lookup(hist, torch.tensor([7]), 3)
    assert got.tolist() == [[7, 8, 9]]
    got = tsp.draft_prompt_lookup(torch.tensor([[1, 2, 3, 4, 0, 0]]),
                                  torch.tensor([4]), 2)
    assert got.tolist() == [[4, 0]]


def _accept_inputs(seed=0, B=6, K=5, V=40):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, K, V)) * 2).astype(np.float32)
    draft = rng.integers(0, V, (B, K)).astype(np.int32)
    draft[:, 1] = logits[:, 1].argmax(-1)          # some greedy accepts
    return logits, draft


def test_spec_accept_greedy_matches_jax():
    logits, draft = _accept_inputs()
    jok, jcorr = jsp.spec_accept_sample(jnp.asarray(logits),
                                        jnp.asarray(draft),
                                        jax.random.PRNGKey(0), 0.0)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    tok, tcorr = tsp.spec_accept_sample(torch.from_numpy(logits),
                                        torch.from_numpy(draft), g, 0.0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tcorr.numpy(), np.asarray(jcorr))
    vok, vcorr = tsp.spec_accept_sample_vec(
        torch.from_numpy(logits), torch.from_numpy(draft), g, torch.zeros(6))
    assert torch.equal(vok, tok) and torch.equal(vcorr, tcorr)
    assert torch.equal(g.get_state(), state)       # greedy draws nothing


def _jax_accept(monkeypatch, fn, *args):
    """Run the JAX package's accept rule with its uniforms replaced by
    ``u`` and its correction draw by the argmax of the logits it is given;
    returns (ok, corr, u, masked correction logits)."""
    seen = {}

    def uniform(key, shape):
        seen["u"] = np.random.default_rng(7).random(shape).astype(np.float32)
        return jnp.asarray(seen["u"])

    def categorical(key, lt, axis=-1):
        seen["lt"] = np.asarray(lt)
        return jnp.argmax(lt, axis=axis)

    monkeypatch.setattr(jsp.jax.random, "uniform", uniform)
    monkeypatch.setattr(jsp.jax.random, "categorical", categorical)
    ok, corr = fn(*args)
    return np.asarray(ok), np.asarray(corr), seen["u"], seen["lt"]


@pytest.mark.parametrize("temps", [[0.7, 0.0, 1.3, 1.0, 0.0, 2.5],
                                   [1.0] * 6])
def test_spec_accept_injected_uniforms_match_jax(monkeypatch, temps):
    logits, draft = _accept_inputs(1)
    temps = np.asarray(temps, np.float32)
    jok, jcorr, u, jmasked = _jax_accept(
        monkeypatch, jsp.spec_accept_sample_vec, jnp.asarray(logits),
        jnp.asarray(draft), jax.random.PRNGKey(0), jnp.asarray(temps))
    tl_, td, tt = (torch.from_numpy(logits), torch.from_numpy(draft),
                   torch.from_numpy(temps))
    masked = tsp.spec_correction_logits(tl_, td, tt).numpy()
    np.testing.assert_array_equal(np.isfinite(masked), np.isfinite(jmasked))
    fin = np.isfinite(masked)
    np.testing.assert_allclose(masked[fin], jmasked[fin], rtol=1e-6)
    ok, corr = tsp.spec_accept_from(tl_, td, tt, torch.from_numpy(u),
                                    torch.from_numpy(jmasked.argmax(-1)))
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(corr.numpy(), jcorr)
    assert 0 < jok.sum() < jok.size           # both outcomes occur


def test_spec_accept_scalar_temperature_matches_jax(monkeypatch):
    logits, draft = _accept_inputs(2)
    jok, jcorr, u, jmasked = _jax_accept(
        monkeypatch, jsp.spec_accept_sample, jnp.asarray(logits),
        jnp.asarray(draft), jax.random.PRNGKey(0), 0.8)
    tl_, td = torch.from_numpy(logits), torch.from_numpy(draft)
    temps = torch.full((6,), 0.8)
    np.testing.assert_allclose(
        tsp.spec_correction_logits(tl_, td, temps).numpy(), jmasked,
        rtol=1e-6)
    ok, corr = tsp.spec_accept_from(tl_, td, temps, torch.from_numpy(u),
                                    torch.from_numpy(jmasked.argmax(-1)))
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(corr.numpy(), jcorr)


def _tv(counts, p):
    return 0.5 * np.abs(counts / counts.sum() - p).sum()


def test_spec_accept_sample_is_distributionally_exact():
    """Accept the draft with probability p(draft), else draw from p
    without it: the emitted token follows p, whatever the draft (20,000
    rows in one call, generator seed 0)."""
    temp, n = 0.8, 20000
    base = torch.tensor([2.0, 1.0, 0.0, -1.0])
    p = torch.softmax(base / temp, -1).numpy()
    logits = base.expand(n, 1, 4).contiguous()
    for d in (0, 1, 3):
        g = torch.Generator().manual_seed(0)
        ok, corr = tsp.spec_accept_sample(
            logits, torch.full((n, 1), d, dtype=torch.int32), g, temp)
        tok = torch.where(ok[:, 0], torch.full_like(corr[:, 0], d),
                          corr[:, 0])
        counts = np.bincount(tok.numpy(), minlength=4).astype(float)
        assert _tv(counts, p) < 0.02, (d, counts)
    ok, corr = tsp.spec_accept_sample(logits[:1], torch.tensor([[1]]),
                                      None, 0.0)
    assert not bool(ok[0, 0]) and int(corr[0, 0]) == 0


def test_spec_window_bonus_slot_is_distributionally_exact():
    """A window whose fed drafts are all accepted emits its bonus slot by
    that slot's own accept event: the token there follows p, and takes
    the draft's mass too."""
    K, temp, n = 3, 0.8, 20000
    base = torch.tensor([2.0, 1.0, 0.0, -1.0])
    p = torch.softmax(base / temp, -1).numpy()
    g = torch.Generator().manual_seed(0)
    draft = torch.zeros((n, K), dtype=torch.int32)
    okk, corr = tsp.spec_accept_sample(base.expand(n, K, 4).contiguous(),
                                       draft, g, temp)
    gt, a = tsp.spec_window_tokens(okk, corr, draft)
    full = a == K - 1
    counts = np.bincount(gt[full, K - 1].numpy(), minlength=4).astype(float)
    assert counts.sum() > 3000 and counts[0] > 0
    assert _tv(counts, p) < 0.02, counts


# -- the paged verify window --------------------------------------------------

def _write_pool(jcfg, rng, page_size=PSZ, pages=8):
    pool = jp.PagedKVCache.create(jcfg, pages, page_size)
    if pool.k_scale is not None:
        return pool.replace(
            pages_k=jnp.asarray(rng.integers(-127, 128, pool.pages_k.shape),
                                jnp.int8),
            pages_v=jnp.asarray(rng.integers(-127, 128, pool.pages_v.shape),
                                jnp.int8),
            k_scale=jnp.asarray(rng.random(pool.k_scale.shape) * 0.02,
                                jnp.bfloat16),
            v_scale=jnp.asarray(rng.random(pool.v_scale.shape) * 0.02,
                                jnp.bfloat16))
    return pool.replace(
        pages_k=jnp.asarray(rng.standard_normal(pool.pages_k.shape),
                            jnp.bfloat16),
        pages_v=jnp.asarray(rng.standard_normal(pool.pages_v.shape),
                            jnp.bfloat16))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_write_window_matches_jax_write_row_window(kv_dtype):
    """K/V windows of 4 and 16 rows, inside a page, ending on its last
    offset and across a boundary, into a pool of random pages: the same
    bits as the JAX package's two-slab write."""
    rng = np.random.default_rng(3)
    jcfg, _ = _cfgs(kv_cache_dtype=kv_dtype)
    jpool = _write_pool(jcfg, rng)
    tpool = paged_from_numpy(_tree(jpool), device="cpu")
    L, _, KV, _, D = jpool.pages_k.shape
    for layer, (p0, p1, off0, T) in enumerate(
            [(3, 5, 2, 4), (6, 2, 12, 4), (1, 7, 9, 16)]):
        layer %= L
        k, v = (torch.from_numpy(rng.standard_normal((1, T, KV, D)).astype(
            np.float32)).to(torch.bfloat16).float().numpy() for _ in "kv")
        kn, vn = (jnp.asarray(k[0]).swapaxes(0, 1),
                  jnp.asarray(v[0]).swapaxes(0, 1))     # [KV, T, D]
        if kv_dtype == "int8":
            kn, ks = jl.quantize_kv_i8(kn)
            vn, vs = jl.quantize_kv_i8(vn)
        args = (layer, jnp.int32(p0), jnp.int32(p1), jnp.int32(off0), PSZ)
        jpool = jpool.replace(
            pages_k=jp._write_row_window(jpool.pages_k, kn, *args),
            pages_v=jp._write_row_window(jpool.pages_v, vn, *args))
        if kv_dtype == "int8":
            jpool = jpool.replace(
                k_scale=jp._write_row_window(jpool.k_scale, ks, *args),
                v_scale=jp._write_row_window(jpool.v_scale, vs, *args))
        pos = off0 + np.arange(T)
        page_of = torch.tensor([[p0 if q < PSZ else p1 for q in pos]])
        tp.write_window(tpool, layer, page_of,
                        torch.from_numpy(pos % PSZ)[None],
                        torch.from_numpy(k), torch.from_numpy(v))
    ref, got = _tree(jpool), paged_to_numpy(tpool)
    for name in ref:
        np.testing.assert_array_equal(got[name].view(np.uint8),
                                      ref[name].view(np.uint8), err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_verify_step_matches_jax(params, kv_dtype):
    """Two rows over a pool of random pages (the JAX package's, carried
    over through numpy): row 0's 4-token window at positions 14-17 crosses
    from its first page into its second, row 1's at 5-8 does not."""
    jparams, tparams = params
    jcfg, tcfg = _cfgs(kv_cache_dtype=kv_dtype)
    rng = np.random.default_rng(5)
    jpool = _write_pool(jcfg, rng)
    tpool = paged_from_numpy(_tree(jpool), device="cpu")
    table = np.asarray([[3, 6, 0, 0], [5, 0, 0, 0]], np.int32)
    pos = np.asarray([14, 5], np.int32)
    feed = np.asarray([_prompt(1, 4), _prompt(2, 4)], np.int32)
    jlg, jpool = jp.paged_verify_step(jparams, jnp.asarray(feed), jpool,
                                      jnp.asarray(table), jnp.asarray(pos),
                                      jcfg, max_pages=2)
    before = paged_to_numpy(tpool)
    tlg, tpool = tp.paged_verify_step(tparams, torch.from_numpy(feed), tpool,
                                      torch.from_numpy(table),
                                      torch.from_numpy(pos), tcfg, 2)
    jlg = np.asarray(jlg)
    assert tlg.shape == jlg.shape == (2, 4, tcfg.vocab_size)
    assert np.abs(tlg.numpy() - jlg).max() <= TOL * np.abs(jlg).max()
    ref, got = _tree(jpool), paged_to_numpy(tpool)
    written = np.zeros(ref["pages_k"].shape[1:4:2], bool)   # [pages, page]
    for b in range(2):
        for q in pos[b] + np.arange(4):
            written[table[b, q // PSZ], q % PSZ] = True
    for name in ref:
        keep = ~written[None, :, None, :]
        same = np.broadcast_to(keep, ref[name].shape[:4])
        np.testing.assert_array_equal(got[name][same].view(np.uint8),
                                      before[name][same].view(np.uint8))
        np.testing.assert_array_equal(ref[name][same].view(np.uint8),
                                      before[name][same].view(np.uint8))
    if kv_dtype == "int8":
        for p, s in (("pages_k", "k_scale"), ("pages_v", "v_scale")):
            vals = [t[p].astype(np.float32) * t[s].astype(np.float32)[
                ..., None] for t in (ref, got)]
            w = np.broadcast_to(written[None, :, None, :], vals[0].shape[:4])
            assert (np.abs(vals[1] - vals[0])[w].max()
                    <= TOL * np.abs(vals[0][w]).max())
    else:
        for p in ("pages_k", "pages_v"):
            a, b_ = (t[p].astype(np.float32) for t in (ref, got))
            w = np.broadcast_to(written[None, :, None, :], a.shape[:4])
            assert np.abs(b_ - a)[w].max() <= TOL * np.abs(a[w]).max()


def test_paged_window_refusals(params):
    _, tparams = params
    _, tcfg = _cfgs()
    pool = tp.PagedKVCache.create(tcfg, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="exceeds page_size"):
        tp.paged_verify_step(tparams, torch.zeros((1, 9), dtype=torch.int32),
                             pool, torch.zeros((1, 2), dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int64), tcfg, 2)
    eng = tp.PagedEngine(tparams, tcfg, **ENGINE)
    eng.submit([1, 2, 3], max_new_tokens=4)
    for call in (lambda: eng.step_spec(PSZ + 1),
                 lambda: eng.step_spec_multi(PSZ + 1, 2),
                 lambda: eng.run(spec_k=PSZ + 1)):
        with pytest.raises(ValueError, match="exceeds page_size"):
            call()
    assert eng.stats()["steps"] == 0 and eng.has_work()


# -- the paged engine ---------------------------------------------------------

def _serve(mod, params, cfg, prompts, lens, draft_fn=None, eos=None,
           engine=ENGINE, **run):
    eng = mod.PagedEngine(params, cfg, **engine)
    if draft_fn is not None:
        eng.draft_fn = draft_fn
    uids = [eng.submit(p, max_new_tokens=n, eos_id=eos)
            for p, n in zip(prompts, lens)]
    done = eng.run(**run)
    return [done[u].output_ids for u in uids], eng.stats()


PROMPTS = [_prompt(s) for s in SEEDS]
LENS = [12, 10, 11]


@pytest.fixture(scope="module")
def plain(params):
    """The port's plain greedy streams (they equal the JAX package's on
    these seeds: ``tests/test_torch_paged.py`` holds the plain engine)."""
    _, tparams = params
    return _serve(tp, tparams, _cfgs()[1], PROMPTS, LENS)[0]


@pytest.mark.parametrize("run", [dict(spec_k=4),
                                 dict(spec_k=4, steps_per_dispatch=3)],
                         ids=["spec4", "spec4x3"])
def test_paged_engine_speculative_matches_jax(params, plain, run):
    jparams, tparams = params
    jcfg, tcfg = _cfgs()
    ref, jstats = _serve(jp, jparams, jcfg, PROMPTS, LENS, **run)
    got, tstats = _serve(tp, tparams, tcfg, PROMPTS, LENS, **run)
    assert got == ref == plain
    assert tstats == jstats
    assert 0 < tstats["spec_windows"] < sum(LENS)


def test_paged_engine_spec8_windows_match_plain(params, plain):
    """k = 8 (Llama3-8B's 32 query rows on the card), one and two windows
    a dispatch: the plain engine's ids."""
    _, tparams = params
    for run in (dict(spec_k=8), dict(spec_k=8, steps_per_dispatch=2)):
        got, st = _serve(tp, tparams, _cfgs()[1], PROMPTS, LENS, **run)
        assert got == plain and 0 < st["spec_windows"] < sum(LENS)


def test_paged_engine_custom_draft_fn_matches_jax(params, plain):
    """An always-wrong drafter: the same greedy ids and counters as the
    JAX engine with the same drafter; an oracle that replays the plain
    stream: the plain ids, most drafts accepted."""
    jparams, tparams = params
    jcfg, tcfg = _cfgs()
    recorded = [p + r for p, r in zip(PROMPTS, plain)]

    def oracle(hist, k):
        for s in recorded:
            if len(s) > len(hist) and s[:len(hist)] == hist:
                nxt = s[len(hist):len(hist) + k]
                return nxt + [0] * (k - len(nxt))
        return [0] * k

    wrong = lambda hist, k: [0] * k                 # noqa: E731
    ref, jstats = _serve(jp, jparams, jcfg, PROMPTS, LENS, draft_fn=wrong,
                         spec_k=4)
    got, tstats = _serve(tp, tparams, tcfg, PROMPTS, LENS, draft_fn=wrong,
                         spec_k=4)
    assert got == ref == plain and tstats == jstats
    assert tstats["spec_accept_rate"] < 0.3
    got, tstats = _serve(tp, tparams, tcfg, PROMPTS, LENS, draft_fn=oracle,
                         spec_k=4)
    assert got == plain and tstats["spec_accept_rate"] > 0.6


def test_paged_engine_spec_cache_end_and_eos_match_jax(params):
    """A request that runs to max_seq - 1 through the fallbacks (windows,
    then one window, then plain steps), and one that stops at an eos
    inside a window: the same ids as the JAX engine and the port's plain
    engine."""
    jparams, tparams = params
    jcfg, tcfg = _cfgs()
    tight = dict(ENGINE, max_seq=32, num_pages=9)
    prompts, lens = PROMPTS[:1], [25]
    want, _ = _serve(tp, tparams, tcfg, prompts, lens, engine=tight)
    assert len(want[0]) == 32 - 1 - len(prompts[0])
    run = dict(spec_k=4, steps_per_dispatch=3)
    ref, _ = _serve(jp, jparams, jcfg, prompts, lens, engine=tight, **run)
    got, _ = _serve(tp, tparams, tcfg, prompts, lens, engine=tight, **run)
    assert got == ref == want
    assert _serve(tp, tparams, tcfg, prompts, lens, engine=tight,
                  spec_k=8)[0] == want
    full = _serve(tp, tparams, tcfg, PROMPTS[:1], [24])[0][0]
    eos = full[len(full) // 2]
    cut = full[:full.index(eos) + 1]
    ref, jstats = _serve(jp, jparams, jcfg, PROMPTS[:1], [24], eos=eos,
                         spec_k=4, steps_per_dispatch=3)
    got, tstats = _serve(tp, tparams, tcfg, PROMPTS[:1], [24], eos=eos,
                         spec_k=4, steps_per_dispatch=3)
    assert got == ref == [cut] and tstats == jstats


def test_paged_engine_spec_returns_every_page(params):
    """Speculative runs allocate pages ahead of the windows and free them
    at retirement: the pool ends as it began, and temperature > 0 rows
    sample from the engine's generator (the same seed, the same ids)."""
    _, tparams = params
    _, tcfg = _cfgs()
    outs = []
    for _ in range(2):
        eng = tp.PagedEngine(tparams, tcfg, seed=3, **ENGINE)
        free = eng.alloc.available
        uids = [eng.submit(p, max_new_tokens=n, temperature=t)
                for p, n, t in zip(PROMPTS, LENS, (0.0, 0.9, 1.3))]
        done = eng.run(spec_k=4, steps_per_dispatch=2)
        assert eng.alloc.available == free
        assert not any(eng.owned) and not eng.table.any()
        outs.append([done[u].output_ids for u in uids])
        assert all(len(o) == n and all(0 <= t < tcfg.vocab_size for t in o)
                   for o, n in zip(outs[-1], LENS))
    assert outs[0] == outs[1]


# -- the slot speculative generate ---------------------------------------------

def test_speculative_generate_matches_jax(params):
    jparams, tparams = params
    jcfg, tcfg = _cfgs()
    N, K, S = 20, 4, 64
    ids = np.asarray(PROMPTS[:2], np.int32)
    jfn = jsp.make_speculative_generate_fn(
        jcfg, JServeConfig(max_seq_len=S, max_new_tokens=N,
                           donate_cache=False), draft_k=K)
    jt, jsteps, _ = jfn(jparams, jnp.asarray(ids),
                        jl.KVCache.create(jcfg, 2, S), jax.random.PRNGKey(0))
    tfn = tsp.make_speculative_generate_fn(
        tcfg, ServeConfig(max_seq_len=S, max_new_tokens=N), draft_k=K)
    tt, tsteps, _ = tfn(tparams, torch.from_numpy(ids),
                        tl.KVCache.create(tcfg, 2, S, device="cpu"), None)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tsteps == int(jsteps) < N - 1
    # temperature > 0: tokens in range, the same with the same seed
    hot = tsp.make_speculative_generate_fn(
        tcfg, ServeConfig(max_seq_len=S, max_new_tokens=N, temperature=0.9),
        draft_k=K)
    runs = [hot(tparams, torch.from_numpy(ids),
                tl.KVCache.create(tcfg, 2, S, device="cpu"),
                torch.Generator().manual_seed(1))[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (2, N)
    assert 0 <= int(runs[0].min()) and int(runs[0].max()) < tcfg.vocab_size


def test_speculative_generate_refuses_a_short_cache(params, monkeypatch):
    _, tparams = params
    _, tcfg = _cfgs()
    fn = tsp.make_speculative_generate_fn(
        tcfg, ServeConfig(max_seq_len=32, max_new_tokens=24), draft_k=4)
    forwards = []
    monkeypatch.setattr(tsp, "prefill", lambda *a, **k: forwards.append(1))
    with pytest.raises(ValueError, match="max_seq"):
        fn(tparams, torch.tensor([PROMPTS[0]]),
           tl.KVCache.create(tcfg, 1, 32, device="cpu"), None)
    assert forwards == []
