"""Two faults of the port against the reference, repaired, on the CPU.

- A generate, prefill or decode step that would write past the slot
  cache raises ``ValueError`` before any forward. (The JAX package's
  ``dynamic_update_slice`` clamps such a write to the wrong positions; the
  port used to fail partway with an ``IndexError``.)
- ``PagedEngine`` admission samples each request's first token once,
  after its last prefill chunk, as the reference's single admission
  does (its batched admission samples every round; the port's samples
  the group once): a chunk round samples nothing and draws nothing from
  the generator. Its greedy
  tokens against the JAX package's stay held by
  ``tests/test_torch_paged.py`` (multi-chunk prompts, single and batched
  admission).
"""

import dataclasses

import pytest
import torch

from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve import paged as tp
from quantizations_tpu_torch.serve.generate import make_generate_fn

torch.set_num_threads(1)

PROMPT = 16
CACHE = 32


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(tl.TINY_LLAMA, num_hidden_layers=1,
                              quant=QuantConfig(quantize_embedding=True))
    return cfg, tl.fuse_projections(
        tl.init_llama_params(cfg, seed=0, device="cpu"))


def _generate(cfg, params, new_tokens):
    ids = torch.arange(1, PROMPT + 1, dtype=torch.int32)[None]
    serve = ServeConfig(max_seq_len=CACHE, max_new_tokens=new_tokens)
    cache = tl.KVCache.create(cfg, 1, CACHE, device="cpu")
    return make_generate_fn(cfg, serve)(params, ids, cache, None)


def test_generate_fills_the_cache_and_refuses_to_overrun_it(tiny,
                                                            monkeypatch):
    """P = 16 in a 32-position cache: 17 new tokens write positions up to
    31 and run; 18 would write position 32 and raise before any forward."""
    cfg, params = tiny
    toks, _ = _generate(cfg, params, PROMPT + 1)
    assert toks.shape == (1, PROMPT + 1)
    forwards = []
    monkeypatch.setattr(tl, "_forward",
                        lambda *a, **k: forwards.append(1))
    with pytest.raises(ValueError, match="past the cache"):
        _generate(cfg, params, PROMPT + 2)
    assert forwards == []


@pytest.mark.parametrize("call,pos,T", [
    ("prefill", 16, 16), ("prefill", 0, 33), ("prefill", 17, 16),
    ("decode", 31, 1), ("decode", 32, 1), ("decode_rows", 31, 1),
    ("decode_rows", 32, 1)])
def test_prefill_and_decode_step_refuse_positions_past_the_cache(
        tiny, monkeypatch, call, pos, T):
    """``pos + T > max_seq`` raises before any forward, for an int
    position and for per-row positions on the CPU."""
    cfg, params = tiny
    forwards = []
    monkeypatch.setattr(tl, "_forward", lambda *a, **k: (
        forwards.append(1), (None, None))[1])
    cache = tl.KVCache.create(cfg, 2, CACHE, device="cpu")
    ids = torch.ones((2, T), dtype=torch.int32)
    if call == "prefill":
        run = lambda: tl.prefill(params, ids, cache, cfg, pos=pos)
    elif call == "decode":
        run = lambda: tl.decode_step(params, ids, cache, pos, cfg)
    else:
        run = lambda: tl.decode_step(params, ids, cache,
                                     torch.tensor([3, pos]), cfg)
    if pos + T > CACHE:
        with pytest.raises(ValueError, match="past the cache"):
            run()
        assert forwards == []
    else:
        if call == "prefill":
            run()
        else:
            with pytest.raises(TypeError):    # the stub returns no logits
                run()
        assert forwards == [1]


ENGINE = dict(num_pages=24, page_size=16, slots=2, max_seq=64,
              prefill_buckets=(8, 16))


def _counted_engine(tiny, monkeypatch, admit_width):
    """An engine whose admission rounds and sampling calls are counted."""
    cfg, params = tiny
    eng = tp.PagedEngine(params, cfg, admit_width=admit_width, **ENGINE)
    seen = {"rounds": 0, "samples": [], "draws": 0}
    rnd, sample, multinomial = (eng._prefill_round, tp.sample_rows_samp,
                                torch.multinomial)

    def counted_round(*a):
        seen["rounds"] += 1
        return rnd(*a)

    def counted_sample(logits, samp, gen=None):
        seen["samples"].append(int(logits.shape[0]))
        return sample(logits, samp, gen)

    def counted_draw(*a, **k):
        seen["draws"] += 1
        return multinomial(*a, **k)

    eng._prefill_round = counted_round
    monkeypatch.setattr(tp, "sample_rows_samp", counted_sample)
    monkeypatch.setattr(torch, "multinomial", counted_draw)
    return eng, seen


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_single_admission_samples_once_after_its_chunks(tiny, monkeypatch,
                                                        temperature):
    """A 40-token prompt admitted alone runs three chunk rounds (16, 16,
    8) and one sampling call; at temperature 0.7 one draw, none at 0."""
    eng, seen = _counted_engine(tiny, monkeypatch, admit_width=1)
    eng.submit(list(range(1, 41)), max_new_tokens=4,
               temperature=temperature)
    eng._admit()
    assert seen["rounds"] == 3
    assert seen["samples"] == [1]
    assert seen["draws"] == (1 if temperature else 0)
    assert 0 <= int(eng._cur[0]) < tiny[0].vocab_size


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_batched_admission_samples_once_after_its_rounds(tiny, monkeypatch,
                                                         temperature):
    """Two prompts (40 and 19 tokens) admitted as one group run three
    rounds; their first tokens come from one sampling call over the two
    rows, each from its own final round."""
    eng, seen = _counted_engine(tiny, monkeypatch, admit_width=2)
    for n in (40, 19):
        eng.submit(list(range(1, n + 1)), max_new_tokens=4,
                   temperature=temperature)
    eng._admit()
    assert seen["rounds"] == 3
    assert seen["samples"] == [2]
    assert seen["draws"] == (1 if temperature else 0)
    assert all(r is not None for r in eng.active)
