"""The metrics that read the program's own spans and counters
(``utils/profiling.py tracer``): the readers against hand counts, the
counter that switches the tracer over the clean window, and whole traced
runs of the tiny cell with and without the tracer in the program."""

import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from bench_port import harness, spans
from bench_port.traffic import Req

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
PROGRAM_METRICS = ("forward.enqueue_ms_per_step.decode",
                   "engine.readback_wait_ms_per_step.decode",
                   "engine.bookkeeping_ms_per_step.decode",
                   "engine.admit_pad_share.prefill")


@pytest.fixture(autouse=True)
def quiet_tracer():
    from quantizations_tpu_torch.utils.profiling import tracer
    yield
    tracer.disable()
    tracer.reset()


def _program(spans_, counters=None):
    return {"spans": {p: {"calls": c, "total_ns": t, "self_ns": t}
                      for p, (c, t) in spans_.items()},
            "counters": counters or {}}


def _record(program=None):
    bench = harness.Bench(ROOT)
    run = harness.RunRecord(bench.cell("m7b.longgen"), 0.0, 1.0, 1.0, 0,
                            {0: harness.Rec(Req([1] * 10, 4), 0.0)})
    if program is not None:
        run.rec = spans.Recorder()
        run.rec.program = program
    return bench, run


def test_program_span_readers_by_hand():
    """Ten decode steps: 400 ms of forward enqueue, 50 ms waiting at the
    read-back, 30 ms preparing and 20 ms committing; admission rounds of
    1,000 rows that carried 350 prompt tokens."""
    bench, run = _record()
    assert all(bench.reader(m)(run) is None for m in PROGRAM_METRICS)
    run.rec = spans.Recorder()         # traced, the program without spans
    assert all(bench.reader(m)(run) is None for m in PROGRAM_METRICS)
    bench, run = _record(_program({
        "engine.step": (12, 900_000_000),
        "engine.step/decode.prepare": (10, 30_000_000),
        "engine.step/decode.forward": (10, 400_000_000),
        "engine.step/decode.forward/linear.4bit": (1290, 300_000_000),
        "engine.step/decode.readback": (10, 50_000_000),
        "engine.step/decode.commit": (10, 20_000_000)},
        {"prefill.rows": 1000, "prefill.tokens": 350}))
    read = {m: bench.reader(m)(run) for m in PROGRAM_METRICS}
    assert read == pytest.approx({
        "forward.enqueue_ms_per_step.decode": 40.0,
        "engine.readback_wait_ms_per_step.decode": 5.0,
        "engine.bookkeeping_ms_per_step.decode": 5.0,
        "engine.admit_pad_share.prefill": 65.0})
    # a window with no admission round and no decode step
    run.rec.program = _program({"engine.step": (3, 1_000)})
    assert all(bench.reader(m)(run) is None for m in PROGRAM_METRICS)


def test_tracer_counter_covers_the_clean_window_alone():
    """Reset and on before the window, a copy of the totals after each
    clean step, off at the first call of the profiler's stretch; what
    runs after that is not counted."""
    from quantizations_tpu_torch.utils import profiling
    counter = spans._load_counter(ROOT / "bench_port", "program_tracer")
    tracer = profiling.tracer
    rec = spans.Recorder()
    profiling.count("prefill.rows", 99)            # before any switch
    tracer.enable()
    profiling.count("prefill.rows", 5)             # set-up, forgotten
    tracer.disable()
    counter.count(rec, None)                       # before the window
    assert tracer.on and tracer.snapshot()["counters"] == {}
    rec.in_window = True
    for step in range(3):
        with profiling.span("engine.step"):
            profiling.count("prefill.rows", 8)
        counter.count(rec, None)
        assert rec.program["spans"]["engine.step"]["calls"] == step + 1
    rec.in_window = False                          # the stretch
    with profiling.span("engine.step"):
        profiling.count("prefill.rows", 8)
    counter.count(rec, None)
    assert not tracer.on
    counter.count(rec, None)                       # later calls: nothing
    assert not tracer.on
    assert rec.program["spans"]["engine.step"]["calls"] == 3
    assert rec.program["counters"] == {"prefill.rows": 24}


def _tiny_root_reading_all(tiny_root):
    """The tiny cell added to the workloads of each program metric, its
    clean window 3.6 s of a 6 s run, so that it admits and reaches the
    profiler's stretch on a slow host."""
    work = tiny_root / "bench_port/workloads/tiny.cell.json"
    w = json.loads(work.read_text())
    w["trace_start"] = 0.6
    work.write_text(json.dumps(w))
    path = tiny_root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    for m in spec["per_layer"]:
        if m["name"] in PROGRAM_METRICS and \
                "tiny.cell" not in m["workloads"]:
            m["workloads"].append("tiny.cell")
    path.write_text(json.dumps(spec))
    return tiny_root


def _run(root, traced=True, seconds=6.0):
    bench = harness.Bench(root)
    return harness.run_cell(bench, "tiny.cell", SEED, seconds, traced, CPU,
                            time.perf_counter())


def test_traced_run_reads_the_program_metrics(tiny_root):
    from quantizations_tpu_torch.utils.profiling import tracer
    res, checks, msgs = _run(_tiny_root_reading_all(tiny_root))
    assert res["correct"]
    for name in PROGRAM_METRICS:
        assert res["metrics"][name]["value"] > 0, (name, msgs)
    assert res["metrics"]["engine.admit_pad_share.prefill"]["value"] < 100
    # off from the stretch's first step on (a window too slow to reach
    # its stretch keeps it on: the counter's test covers both)
    assert tracer.on == (res["trace"]["stretch_steps"] == 0)
    # the wrap that switches the tracer launches nothing: the device
    # fields and the spans the other metrics read are as before
    assert res["trace"]["missing"] == []
    assert res["trace"]["spans"]["engine.step"] == \
        res["trace"]["stretch_steps"]
    assert {"engine.admit_share.decode", "mfu.decode",
            "pool.pages_peak_share"} <= set(res["metrics"])


def test_untraced_run_leaves_the_tracer_off(tiny_root):
    from quantizations_tpu_torch.utils.profiling import tracer
    res, _, _ = _run(_tiny_root_reading_all(tiny_root), traced=False,
                     seconds=1.5)
    assert res["correct"]
    assert not tracer.on and tracer.snapshot()["spans"] == {}
    assert not set(PROGRAM_METRICS) & set(res["metrics"])


def test_program_without_a_tracer_leaves_its_metrics_out(tiny_root,
                                                         monkeypatch):
    """The program of a commit before its spans: the four metrics that
    read them find nothing, with a message; every other one reads."""
    monkeypatch.setitem(sys.modules,
                        "quantizations_tpu_torch.utils.profiling",
                        types.ModuleType("profiling_without_a_tracer"))
    res, checks, msgs = _run(_tiny_root_reading_all(tiny_root))
    assert res["correct"]
    assert not set(PROGRAM_METRICS) & set(res["metrics"])
    for name in PROGRAM_METRICS:
        assert f"metric {name}: nothing to read" in msgs
    assert {"engine.admit_share.decode", "mfu.decode",
            "pool.pages_peak_share"} <= set(res["metrics"])
