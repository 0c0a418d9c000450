"""The port's ``Watchdog`` against the JAX package's greedy streams on the
CPU: the five cases of ``tests/test_watchdog.py`` (an engine killed
mid-run, every engine dead, a hung step, a mixed slot and paged pool, a
pool with no failure) on ``TINY_LLAMA`` parameters bridged from the JAX
package's (``bridge.params_from_numpy``; fused projections, 4-bit
embedding, as in ``tests/test_torch_engine.py``).

Greedy ids agree with the JAX package's where the top-2 logit margin is
clear. The prompts [3, 1, 4], [2, 7, 1, 8], [5, 5, 5, 5] (those of
``tests/test_watchdog.py``) and [992, 648, 457] are tie-free over 8 new
tokens, also when a request resumes with its emitted tokens appended to
its prompt: the port's generate, its engines and the JAX generate give
the same ids. ([9, 9, 5] of ``tests/test_watchdog.py`` parts from the
JAX stream at its sixth token, so it is not used.)
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.config import ServeConfig as JServeConfig
from quantizations_tpu.models import llama as jl
from quantizations_tpu.serve.generate import make_generate_fn
from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve.engine import Engine
from quantizations_tpu_torch.serve.paged import PagedEngine
from quantizations_tpu_torch.serve.watchdog import Watchdog, _heartbeat_age

torch.set_num_threads(1)

MAX_SEQ = 48
N_REF = 8
PROMPTS = [[3, 1, 4], [2, 7, 1, 8], [5, 5, 5, 5], [992, 648, 457]]
LENS = [6, 6, 5, 5]
SERVE = ServeConfig(max_seq_len=MAX_SEQ)


def _cfgs():
    q = dict(quantize_embedding=True)
    return (dataclasses.replace(jl.TINY_LLAMA, quant=JQuantConfig(**q)),
            dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(**q)))


CFG = _cfgs()[1]


@pytest.fixture(scope="module")
def setup():
    """(the port's params, the JAX greedy stream of each prompt)."""
    jcfg, tcfg = _cfgs()
    jparams = jl.fuse_projections(jl.init_llama_params(jcfg, seed=0))
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    tree = {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}
    gen = make_generate_fn(jcfg, JServeConfig(
        max_seq_len=MAX_SEQ, max_new_tokens=N_REF, donate_cache=False))
    ref = {}
    for p in PROMPTS:
        toks, _ = gen(jparams, jnp.asarray([p], jnp.int32),
                      jl.KVCache.create(jcfg, 1, MAX_SEQ),
                      jax.random.PRNGKey(0))
        ref[tuple(p)] = [int(t) for t in np.asarray(toks)[0]]
    return params_from_numpy(tree, tcfg, device="cpu"), ref


class FailingEngine(Engine):
    """A slot engine whose step raises after ``fail_after`` steps."""

    fail_after = 3

    def step(self):
        if self._steps >= self.fail_after:
            raise RuntimeError("injected device failure")
        return super().step()


def _engine(params, cls=Engine, slots=2):
    return cls(params, CFG, SERVE, slots=slots, prefill_buckets=(8,))


def _check_streams(done, ref, prompts, lens):
    """Every request finished with its length and the JAX stream (a
    resumed request keeps its tokens, and its prompt carries them)."""
    assert len(done) == len(prompts)
    for p, n in zip(prompts, lens):
        r = next(r for r in done if r.prompt_ids[:len(p)] == p)
        assert r.done and r.output_ids == ref[tuple(p)][:n], p
        assert r.prompt_ids[len(p):] == r.output_ids[:len(r.prompt_ids)
                                                     - len(p)], p


def test_requests_survive_engine_kill(setup):
    params, ref = setup
    bad, good = _engine(params, FailingEngine), _engine(params)
    for p, n in zip(PROMPTS, LENS):
        bad.submit(p, max_new_tokens=n)
    wd = Watchdog([bad, good])
    done = wd.run()
    assert wd.dead == [True, False] and wd.failures == [0]
    # the two requests in flight resumed with their first tokens
    resumed = [p for p in PROMPTS for r in done
               if r.prompt_ids[:len(p)] == p and len(r.prompt_ids) > len(p)]
    assert len(resumed) == 2
    _check_streams(done, ref, PROMPTS, LENS)
    assert wd.stats()["dead"] == [0]


def test_all_engines_dead_raises(setup):
    params, _ = setup
    bad = _engine(params, FailingEngine, slots=1)
    bad.fail_after = 0
    bad.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="no live engine"):
        Watchdog([bad]).run()


def test_hung_step_detected_by_timeout(setup):
    """A step that does not return within ``step_timeout_s`` (2 s) marks
    its engine dead and the request finishes elsewhere. The hang waits on
    an Event that the test sets at the end, so no thread outlives it."""
    params, ref = setup
    release = threading.Event()

    class HangingEngine(Engine):
        def step(self):
            if self._steps >= 1:
                release.wait(60)
                return 0                  # abandoned: does nothing
            return super().step()

    bad, good = _engine(params, HangingEngine, slots=1), _engine(params)
    prompt = PROMPTS[0]
    bad.submit(prompt, max_new_tokens=5)
    wd = Watchdog([bad, good], step_timeout_s=2.0)
    before = set(threading.enumerate())
    try:
        done = wd.run()
    finally:
        release.set()
    assert wd.dead == [True, False]
    _check_streams(done, ref, [prompt], [5])
    for t in set(threading.enumerate()) - before:   # the abandoned step
        t.join(10)
        assert not t.is_alive()


def test_mixed_slot_and_paged_pool(setup):
    """A dying slot engine's requests finish on a healthy ``PagedEngine``
    with the JAX streams, and the pool's pages all return."""
    params, ref = setup
    bad = _engine(params, FailingEngine)
    good = PagedEngine(params, CFG, num_pages=16, page_size=16, slots=2,
                       max_seq=MAX_SEQ, prefill_buckets=(8,))
    prompts, lens = PROMPTS[:3], LENS[:3]
    for p, n in zip(prompts, lens):
        bad.submit(p, max_new_tokens=n)
    wd = Watchdog([bad, good])
    done = wd.run()
    assert wd.dead == [True, False]
    _check_streams(done, ref, prompts, lens)
    st = good.stats()
    assert st["pages_free"] == good.alloc.num_usable and st["live_tokens"] == 0


def test_moved_requests_with_colliding_uids_all_return(setup):
    """Requests moved onto an engine whose own requests carry the same
    engine-local uids are all returned (the JAX package's watchdog reads
    them from the engines' uid-keyed ``finished`` dicts, where a moved
    request and the target's own one overwrite each other)."""
    params, ref = setup
    bad, good = _engine(params, FailingEngine), _engine(params)
    for p, n in zip(PROMPTS[:2], LENS[:2]):
        bad.submit(p, max_new_tokens=n)             # uids 1, 2
    for p, n in zip(PROMPTS[2:], LENS[2:]):
        good.submit(p, max_new_tokens=n)            # uids 1, 2 as well
    wd = Watchdog([bad, good])
    done = wd.run()
    assert wd.dead == [True, False]
    assert len(good.finished) == 2                  # the dict lost two
    _check_streams(done, ref, PROMPTS, LENS)


@pytest.mark.parametrize("steps_per_dispatch", [1, 3])
def test_no_failure_passthrough(setup, steps_per_dispatch):
    """With healthy engines the watchdog only steps them (``step`` or
    ``step_window``): the JAX streams, every engine alive."""
    params, ref = setup
    e1, e2 = _engine(params), _engine(params)
    e1.submit(PROMPTS[0], max_new_tokens=5)
    e2.submit(PROMPTS[1], max_new_tokens=5)
    wd = Watchdog([e1, e2], steps_per_dispatch=steps_per_dispatch)
    done = wd.run()
    assert not any(wd.dead) and wd.failures == []
    _check_streams(done, ref, PROMPTS[:2], [5, 5])


def test_watchdog_needs_an_engine_and_ages_beats():
    with pytest.raises(ValueError, match="at least one engine"):
        Watchdog([])
    import time

    assert 0.0 <= _heartbeat_age(time.time()) < 5.0
