"""The port's spans and counters (``utils/profiling.py``) on the CPU.

- ``span`` as a context manager and a decorator: paths, calls, self time
  (the total less the children's), the shared null context while both
  switches are off, ``count`` and ``reset``.
- A ``PagedEngine`` at ``TINY_LLAMA`` with the tracer on, through a lone
  admission (a padded bucket), a group of two in four scratch rows (one
  row running out of chunks) and decode steps: each span recorded the
  expected number of times, each path's self time its total less its
  children's, and ``prefill.rows``/``prefill.tokens`` equal to a hand
  count from ``iter_prefill_chunks``.
- With both switches off nothing is recorded, no clock is read and
  ``record_function`` is never entered.
- Under a CPU ``torch.profiler`` with ``ranges`` on the ``qt:`` ranges
  nest as ``engine.step`` > ``decode.forward`` > ``linear.4bit``, and the
  admission ranges carry their request uids; a profiler alone enters no
  range, and ``trace()`` turns the ranges on for its block only.
- The emitted tokens are the same with tracing on and off.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve.engine import iter_prefill_chunks
from quantizations_tpu_torch.serve.paged import PagedEngine
from quantizations_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

BUCKETS = (8, 16)
LONE, GROUP = 20, (5, 30)      # prompt lengths
NEW_TOKENS = 3


@pytest.fixture(autouse=True)
def quiet_tracer():
    prof.tracer.disable()
    prof.ranges.disable()
    prof.tracer.reset()
    yield
    prof.tracer.disable()
    prof.ranges.disable()
    prof.tracer.reset()


@pytest.fixture(scope="module")
def tiny():
    cfg = tl.TINY_LLAMA
    params = tl.fuse_projections(tl.init_llama_params(cfg, seed=0,
                                                      device="cpu"))
    return params, cfg


def _prompt(seed, n, cfg):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size,
                                                n).tolist()


def _serve(params, cfg):
    """One lone admission, then a group of two, then decode until every
    request is done. Returns (outputs by uid, step calls, decode steps)."""
    eng = PagedEngine(params, cfg, num_pages=33, page_size=16, slots=4,
                      max_seq=128, prefill_buckets=BUCKETS, admit_width=4)
    eng.submit(_prompt(1, LONE, cfg), max_new_tokens=NEW_TOKENS)
    calls, decoded = 1, int(eng.step() > 0)
    for i, n in enumerate(GROUP):
        eng.submit(_prompt(2 + i, n, cfg), max_new_tokens=NEW_TOKENS)
    while eng.has_work():
        calls += 1
        decoded += eng.step() > 0
    return ({u: r.output_ids for u, r in eng.finished.items()}, calls,
            decoded)


def _children_total(spans, path):
    return sum(s["total_ns"] for p, s in spans.items()
               if p.rsplit("/", 1)[0] == path and "/" in p)


def _check_self_times(spans):
    for path, s in spans.items():
        assert s["self_ns"] == s["total_ns"] - _children_total(spans, path)
        assert s["self_ns"] >= 0


# -- the facility --------------------------------------------------------

@prof.span("test.outer")
def _outer(n):
    """Doc of the outer function."""
    for _ in range(n):
        with prof.span("test.inner"):
            prof.count("test.items", 2)
    return n * 10


@pytest.mark.parametrize("n", [0, 1, 3])
def test_span_paths_calls_and_self_time(n):
    prof.tracer.enable()
    assert _outer(n) == n * 10
    assert _outer(n) == n * 10
    snap = prof.tracer.snapshot()
    spans = snap["spans"]
    assert spans["test.outer"]["calls"] == 2
    if n:
        assert spans["test.outer/test.inner"]["calls"] == 2 * n
        assert snap["counters"] == {"test.items": 4 * n}
    else:
        assert set(spans) == {"test.outer"}
        assert snap["counters"] == {}
    _check_self_times(spans)


def test_decorator_keeps_the_function():
    assert _outer.__name__ == "_outer"
    assert _outer.__doc__ == "Doc of the outer function."
    assert _outer(2) == 20


def test_off_is_a_shared_null_context_and_counts_nothing():
    assert prof.span("test.a") is prof.span("test.a")
    assert prof.span("test.a") is not prof.span("test.b")
    with prof.span("test.a"):
        prof.count("test.items", 5)
    assert _outer(2) == 20
    assert prof.tracer.snapshot() == {"spans": {}, "counters": {}}
    prof.tracer.enable()
    assert prof.span("test.a") is not prof.span("test.a")


def test_reset_keeps_open_spans_and_disable_stops_recording():
    prof.tracer.enable()
    with prof.span("test.outer"):
        with prof.span("test.inner"):
            pass
        prof.count("test.items", 1)
        prof.tracer.reset()
    spans = prof.tracer.snapshot()["spans"]
    assert set(spans) == {"test.outer"} and spans["test.outer"]["calls"] == 1
    assert prof.tracer.snapshot()["counters"] == {}
    prof.tracer.disable()
    _outer(3)
    assert prof.tracer.snapshot()["spans"]["test.outer"]["calls"] == 1


def test_snapshot_is_a_copy():
    prof.tracer.enable()
    _outer(1)
    snap = prof.tracer.snapshot()
    _outer(1)
    assert snap["spans"]["test.outer"]["calls"] == 1
    assert prof.tracer.snapshot()["spans"]["test.outer"]["calls"] == 2


# -- the serving path ----------------------------------------------------

def _rounds(plen):
    return iter_prefill_chunks(plen, BUCKETS, max_len=128)


def test_engine_records_each_span_its_expected_times(tiny):
    params, cfg = tiny
    prof.tracer.enable()
    _, calls, decoded = _serve(params, cfg)
    spans = prof.tracer.snapshot()["spans"]
    per_forward = 4 * cfg.num_hidden_layers + 1   # fused q|k|v, o, gate|up,
    #                                               down; the lm_head
    lone, group = len(_rounds(LONE)), max(len(_rounds(n)) for n in GROUP)
    adm = "engine.step/engine.admit"
    want = {
        "engine.step": calls,
        adm: calls,
        f"{adm}/admit.one": 1,
        f"{adm}/admit.one/prefill.round": lone,
        f"{adm}/admit.one/prefill.round/linear.4bit": lone * per_forward,
        f"{adm}/admit.one/prefill.round/attn.prefill":
            lone * cfg.num_hidden_layers,
        f"{adm}/admit.one/admit.sample": 1,
        f"{adm}/admit.one/admit.insert": 1,
        f"{adm}/admit.group": 1,
        f"{adm}/admit.group/prefill.round": group,
        f"{adm}/admit.group/prefill.round/linear.4bit": group * per_forward,
        f"{adm}/admit.group/prefill.round/attn.prefill":
            group * cfg.num_hidden_layers,
        f"{adm}/admit.group/admit.sample": 1,
        f"{adm}/admit.group/admit.insert": len(GROUP),
        "engine.step/decode.prepare": decoded,
        "engine.step/decode.forward": decoded,
        "engine.step/decode.forward/linear.4bit": decoded * per_forward,
        "engine.step/decode.sample": decoded,
        "engine.step/decode.readback": decoded,
        "engine.step/decode.commit": decoded,
    }
    assert {p: s["calls"] for p, s in spans.items()} == want
    _check_self_times(spans)


def test_prefill_rows_and_tokens_by_hand(tiny):
    """The lone 20-token prompt: chunks of 16 and 4 tokens in buckets of
    16 and 8. The group of 5 and 30 tokens in four scratch rows: round 0
    feeds 5 and 16 tokens in 4 x 16 rows, round 1 feeds 14 (the 5-token
    row has run out of chunks) in 4 x 16 rows."""
    params, cfg = tiny
    prof.tracer.enable()
    _serve(params, cfg)
    counters = prof.tracer.snapshot()["counters"]
    lone = _rounds(LONE)
    rows = sum(blen for _, _, blen in lone)
    tokens = sum(take for _, take, _ in lone)
    chunks = [_rounds(n) for n in GROUP]
    for j in range(max(len(c) for c in chunks)):
        rows += 4 * max(c[j][2] for c in chunks if j < len(c))
        tokens += sum(c[j][1] for c in chunks if j < len(c))
    assert (rows, tokens) == (24 + 128, 20 + 35)
    assert counters == {"prefill.rows": rows, "prefill.tokens": tokens}


def test_off_reads_no_clock_and_enters_no_range(tiny, monkeypatch):
    params, cfg = tiny

    def boom(*a, **k):
        raise AssertionError("a span did work while both switches were off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(prof, "time", types.SimpleNamespace(
        perf_counter_ns=boom))
    outputs, _, _ = _serve(params, cfg)
    assert len(outputs) == 1 + len(GROUP)
    assert prof.tracer.snapshot() == {"spans": {}, "counters": {}}


def _cpu_ranges(p):
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[3:])
            for e in p.profiler.kineto_results.events()
            if e.name().startswith(prof.RANGE_PREFIX)]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_profiler_ranges_nest_and_carry_uids(tiny, monkeypatch):
    params, cfg = tiny
    seen = []
    real = torch.profiler.record_function

    def recording(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    prof.ranges.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        _serve(params, cfg)
    assert prof.tracer.snapshot() == {"spans": {}, "counters": {}}
    ranges = _cpu_ranges(p)
    by = {n: [r for r in ranges if r[2] == n]
          for n in ("engine.step", "decode.forward", "linear.4bit")}
    assert by["decode.forward"]
    for fwd in by["decode.forward"]:
        assert any(_inside(fwd, s) for s in by["engine.step"])
        assert sum(_inside(q, fwd) for q in by["linear.4bit"]) == \
            4 * cfg.num_hidden_layers + 1
    assert ("qt:admit.one", "uids=1") in seen
    assert ("qt:admit.group", "uids=2,3") in seen
    assert {("qt:admit.insert", f"uids={u}") for u in (1, 2, 3)} <= set(seen)
    assert ("qt:decode.forward", None) in seen


def test_profiler_alone_enters_no_range(tiny, monkeypatch):
    """A profiler that did not ask for the ranges (a benchmark's, whose
    trace reader does not know the prefix) sees none of them."""
    params, cfg = tiny

    def boom(*a, **k):
        raise AssertionError("a span entered a range it was not asked for")

    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with real("bench:engine.step"):
            outputs, _, _ = _serve(params, cfg)
    assert len(outputs) == 1 + len(GROUP)
    assert _cpu_ranges(p) == []


def test_trace_turns_the_ranges_on_for_its_block(tiny, tmp_path):
    params, cfg = tiny
    with prof.trace(str(tmp_path)) as p:
        assert prof.ranges.on
        _serve(params, cfg)
    assert not prof.ranges.on
    assert {"engine.step", "decode.forward", "linear.4bit", "admit.one"} \
        <= {r[2] for r in _cpu_ranges(p)}
    assert (tmp_path / "trace.json").stat().st_size > 0
    prof.ranges.enable()
    with prof.trace(str(tmp_path)):
        pass
    assert prof.ranges.on


@pytest.mark.parametrize("kv_cache_dtype", ["bf16", "int8"])
def test_tokens_equal_with_tracing_on_and_off(tiny, kv_cache_dtype):
    params, cfg = tiny
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    off, _, _ = _serve(params, cfg)
    prof.tracer.enable()
    prof.ranges.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on, _, _ = _serve(params, cfg)
    assert prof.tracer.snapshot()["spans"]["engine.step"]["calls"] > 0
    assert on == off
    assert all(len(t) == NEW_TOKENS for t in off.values())
