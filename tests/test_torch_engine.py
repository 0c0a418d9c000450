"""The port's slot ``Engine`` against the JAX package's on the CPU.

Greedy ids and ``stats()`` equal to the JAX engine's on ``TINY_LLAMA``:
``step`` (batched admission over two chunks a prompt, retirement and
refill), ``step_window``, ``step_spec`` with the default drafter and with
an always-wrong one, ``step_spec`` near the cache end (its fallback to
plain steps), the scratch admission when a live slot sits near the cache
end, eos inside a window, ``recover()`` mid-generation, and an int8
cache. With ``use_flash_attention`` the decode steps run K3's plain
version on the CPU: the JAX einsum engine's ids. Sampled rows are held
by determinism and range only (torch cannot give JAX's random stream).

Greedy ids agree where the top-2 logit margin is clear (see
``tests/test_torch_paged.py``). The prompts are 6 tokens from seeds 204,
210 and 212, whose greedy streams agree with the JAX package's over 24
new tokens through ``T = 4`` verify windows as well as ``T = 1`` steps
(seeds 200, 202, 209 and 213 part within 20); the int8 cache parts from
it on seed 204's tenth token, so that test takes the other two.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.config import ServeConfig as JServeConfig
from quantizations_tpu.models import llama as jl
from quantizations_tpu.serve import engine as je
from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve import engine as te

torch.set_num_threads(1)

SEEDS = (204, 210, 212)
LENS = [12, 10, 11]
MAX_SEQ = 64
BUCKETS = (4,)          # two chunks a 6-token prompt, garbage rounds


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


PROMPTS = [_prompt(s) for s in SEEDS]


def _engine(mod, params, cfg, max_seq=MAX_SEQ, buckets=BUCKETS, **kw):
    serve = JServeConfig if mod is je else ServeConfig
    return mod.Engine(params, cfg, serve(max_seq_len=max_seq), slots=2,
                      prefill_buckets=buckets, **kw)


def _serve(mod, params, cfg, prompts=PROMPTS, lens=LENS, eos=None,
           draft_fn=None, engine=None, **run):
    eng = _engine(mod, params, cfg, **(engine or {}))
    if draft_fn is not None:
        eng.draft_fn = draft_fn
    uids = [eng.submit(p, max_new_tokens=n, eos_id=eos)
            for p, n in zip(prompts, lens)]
    done = eng.run(**run)
    return [done[u].output_ids for u in uids], eng.stats()


def _both(params, **kw):
    jparams, tparams = params
    jcfg, tcfg = _cfgs()
    return (_serve(je, jparams, jcfg, **kw), _serve(te, tparams, tcfg, **kw))


@pytest.fixture(scope="module")
def plain(params):
    """The JAX engine's plain greedy streams and stats, and the port's."""
    return _both(params)


def test_engine_step_matches_jax(plain):
    (ref, jstats), (got, tstats) = plain
    assert got == ref and tstats == jstats
    assert [len(o) for o in got] == LENS


@pytest.mark.parametrize("run", [dict(steps_per_dispatch=4), dict(spec_k=4)],
                         ids=["window4", "spec4"])
def test_engine_windows_match_jax(params, plain, run):
    (want, _), _ = plain
    (ref, jstats), (got, tstats) = _both(params, **run)
    assert got == ref == want and tstats == jstats
    if "spec_k" in run:
        assert 0 < tstats["spec_windows"] < sum(LENS)
        assert tstats["spec_accepted"] > 0


def test_engine_custom_draft_fn_matches_jax(params, plain):
    (want, _), _ = plain
    wrong = lambda hist, k: [0] * k                 # noqa: E731
    (ref, jstats), (got, tstats) = _both(params, draft_fn=wrong, spec_k=4)
    assert got == ref == want and tstats == jstats
    assert tstats["spec_accept_rate"] < 0.3


def test_engine_spec_cache_end_matches_jax(params):
    """Two requests that run into the end of a 32-position cache: the
    verify windows fall back to plain steps within k of it."""
    kw = dict(prompts=PROMPTS[:2], lens=[40, 40], engine=dict(max_seq=32))
    (ref, jstats), (got, tstats) = _both(params, spec_k=4, **kw)
    assert got == ref and tstats == jstats
    assert [len(o) for o in got] == [32 - 1 - 6] * 2
    _, tparams = params
    assert _serve(te, tparams, _cfgs()[1], **kw)[0] == got


def test_engine_scratch_admission_matches_jax(params):
    """A live slot near the end of a 24-position cache: the second
    request is admitted through a scratch cache, not the batched prefill
    (whose garbage rows would run past the cache)."""
    outs = []
    for mod, p, cfg in ((je, params[0], _cfgs()[0]),
                        (te, params[1], _cfgs()[1])):
        eng = _engine(mod, p, cfg, max_seq=24, buckets=(16,))
        u1 = eng.submit(PROMPTS[0], max_new_tokens=18)
        for _ in range(14):
            eng.step()
        u2 = eng.submit(PROMPTS[1], max_new_tokens=4)
        done = eng.run()
        outs.append(([done[u1].output_ids, done[u2].output_ids],
                     eng.stats()))
    assert outs[1] == outs[0]


def test_engine_scratch_admission_takes_the_scratch_path(params,
                                                         monkeypatch):
    _, tparams = params
    eng = _engine(te, tparams, _cfgs()[1], max_seq=24, buckets=(16,))
    eng.submit(PROMPTS[0], max_new_tokens=18)
    eng.step()
    seen = []
    monkeypatch.setattr(eng, "_admit_scratch",
                        lambda admits: seen.append(len(admits)))
    for _ in range(13):
        eng.step()
    eng.submit(PROMPTS[1], max_new_tokens=4)
    eng.step()
    assert seen == [1]


def test_engine_eos_inside_a_window_matches_jax(params, plain):
    (want, _), _ = plain
    eos = want[0][len(want[0]) // 2]
    cut = want[0][:want[0].index(eos) + 1]
    (ref, jstats), (got, tstats) = _both(params, prompts=PROMPTS[:1],
                                         lens=[LENS[0]], eos=eos, spec_k=4)
    assert got == ref == [cut] and tstats == jstats


def test_engine_recover_matches_jax(params, plain):
    (want, _), _ = plain
    res = []
    for mod, p, cfg in ((je, params[0], _cfgs()[0]),
                        (te, params[1], _cfgs()[1])):
        eng = _engine(mod, p, cfg)
        uids = [eng.submit(q, max_new_tokens=n)
                for q, n in zip(PROMPTS, LENS)]
        for _ in range(3):
            eng.step()
        mid = eng.stats()
        assert eng.recover() == 2
        after = eng.stats()
        done = eng.run()
        res.append((mid, after, [done[u].output_ids for u in uids],
                    eng.stats()))
    assert res[1] == res[0]
    assert res[1][2] == want
    assert res[1][1]["active_slots"] == 0 and res[1][1]["queued"] == 3


def test_engine_int8_cache_matches_jax(params):
    jparams, tparams = params
    jcfg, tcfg = _cfgs(kv_cache_dtype="int8")
    kw = dict(prompts=PROMPTS[1:], lens=LENS[1:])
    ref = _serve(je, jparams, jcfg, spec_k=4, **kw)
    got = _serve(te, tparams, tcfg, spec_k=4, **kw)
    assert got == ref
    assert _serve(te, tparams, tcfg, **kw)[0] == got[0]


def test_engine_flash_decode_matches_einsum(params, plain, monkeypatch):
    """``use_flash_attention``: every decode step through K3's slot form
    (its plain version here, 2 layers a step), the einsum engine's ids;
    verify windows stay on the einsum path."""
    (want, _), _ = plain
    _, tparams = params
    _, tcfg = _cfgs(use_flash_attention=True)
    calls = []
    real = tl.flash_decode_attention_stacked
    monkeypatch.setattr(tl, "flash_decode_attention_stacked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, st = _serve(te, tparams, tcfg)
    assert got == want and len(calls) == 2 * st["steps"]
    calls.clear()
    got, st = _serve(te, tparams, tcfg, spec_k=4)
    assert got == want
    plain_steps = st["steps"] - st["spec_windows"]
    assert len(calls) == 2 * plain_steps


def test_engine_sampling_and_refusals(params):
    """Sampled requests beside a greedy one: in range, the same with the
    same seed, the greedy stream unchanged; a prompt as long as the cache
    and a mesh are refused."""
    _, tparams = params
    _, tcfg = _cfgs()
    outs = []
    for _ in range(2):
        eng = _engine(te, tparams, tcfg, seed=5, temperature=0.9)
        uids = [eng.submit(PROMPTS[0], max_new_tokens=10, temperature=0.0),
                eng.submit(PROMPTS[1], max_new_tokens=10),
                eng.submit(PROMPTS[2], max_new_tokens=10, top_k=5)]
        done = eng.run(spec_k=4)
        outs.append([done[u].output_ids for u in uids])
    assert outs[0] == outs[1]
    assert all(len(o) == 10 and all(0 <= t < tcfg.vocab_size for t in o)
               for o in outs[0])
    assert outs[0][0] == _serve(te, tparams, tcfg, prompts=PROMPTS[:1],
                                lens=[10])[0][0]
    eng = _engine(te, tparams, tcfg)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(list(range(1, MAX_SEQ + 1)))
    # the tensor-parallel engine is tests/test_torch_engine_tp.py's; a
    # mesh that is not the port's is refused
    with pytest.raises(TypeError, match="parallel.make_mesh"):
        _engine(te, tparams, tcfg, mesh=object())
