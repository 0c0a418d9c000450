"""The end-to-end arithmetic, the roofline and MFU counts against hand
counts at Mistral-7B's shapes, and the device trace's attribution."""

import json
from pathlib import Path

import pytest

from bench_port import harness, roofline, trace
from bench_port import weights as W
from bench_port.traffic import Req

ROOT = Path(__file__).resolve().parents[2]
M7B = W.Dims.from_config(json.loads(
    (ROOT / "bench_port/configs/mistral-7b-v0.3.json").read_text()))


def _run(stall_at=None, stall=0.5, n_req=8, n_tok=50, step=0.01):
    """Eight requests in lockstep, one token each every ``step`` seconds,
    with one stall of ``stall`` seconds before step ``stall_at``."""
    bench = harness.Bench(ROOT)
    cell = bench.cell("m7b.longgen")
    recs, t = {}, 0.0
    times = []
    for j in range(n_tok):
        if j == stall_at:
            t += stall
        t += step
        times.append(t)
    for i in range(n_req):
        recs[i] = harness.Rec(Req([1] * 100, n_tok), 0.0, list(times))
    return harness.RunRecord(cell, 0.0, t, 1.0, 2 ** 30, recs)


def _read(bench, name, run):
    return bench.reader(name)(run)


def test_stall_moves_rate_and_tails():
    bench = harness.Bench(ROOT)
    calm, stalled = _run(), _run(stall_at=25)
    assert _read(bench, "output_tok_s", calm) == pytest.approx(400 / 0.5)
    assert _read(bench, "output_tok_s", stalled) == pytest.approx(400 / 1.0)
    assert _read(bench, "itl_p95_ms", calm) == pytest.approx(10.0)
    assert _read(bench, "itl_p95_ms", _run(stall_at=5, n_tok=10)) > 100
    assert harness.RunRecord.first_token_s(calm) == \
        pytest.approx([0.01] * 8)
    assert harness.RunRecord.first_token_s(_run(stall_at=0)) == \
        pytest.approx([0.51] * 8)
    assert _read(bench, "peak_mem_gib", calm) == 1.0
    assert _read(bench, "setup_s", calm) == 1.0


def test_gaps_only_inside_window():
    run = _run()
    run.t_start = 0.2
    assert len(run.token_times()) == 8 * 31
    assert len(run.gaps_s()) == 8 * 30
    assert run.first_token_s() == []


def test_mistral_7b_counts_by_hand():
    assert M7B.layer_params() == (4096 * 4096 * 2 + 4096 * 1024 * 2
                                  + 3 * 14336 * 4096) == 218_103_808
    assert M7B.head_params() == 32768 * 4096
    per_tok = 2 * (32 * 218_103_808 + 32768 * 4096)
    assert roofline.decode_token_ops(M7B, 1000) == \
        per_tok + 4 * 32 * 32 * 128 * 1000
    assert roofline.prefill_ops(M7B, 300) == pytest.approx(
        2 * 32 * 218_103_808 * 300 + 2 * 32768 * 4096
        + 4 * 32 * 32 * 128 * 300 * 301 / 2)
    # the fused q|k|v at 128 rows: fp4 codes plus fp32 scales a 64-block
    w = 6144 * 4096 // 2 + 6144 * 64 * 4
    ops, nbytes = roofline.linear(128, 6144, 4096, w, 2, 2)
    assert ops == 2 * 128 * 6144 * 4096
    assert nbytes == w + 128 * 4096 * 2 + 128 * 6144 * 2
    # at 128 rows the operations bound it, at one row the bytes
    assert roofline.least_seconds(ops, nbytes) == pytest.approx(ops / 989e12)
    ops1, nbytes1 = roofline.linear(1, 6144, 4096, w, 2, 2)
    assert roofline.least_seconds(ops1, nbytes1) == pytest.approx(
        nbytes1 / 3.35e12)
    ops, nbytes = roofline.decode_attention([100, 300], 32, 8, 128, 2, 2)
    assert ops == 4 * 32 * 128 * 400
    assert nbytes == 2 * 400 * 8 * 128 * 2 + 2 * 2 * 32 * 128 * 2
    ops, _ = roofline.causal_prefill_attention([0, 256], [256, 64], 32, 8,
                                               128, 2, 2)
    assert ops == 4 * 32 * 128 * (256 * 257 / 2 + 64 * 256 + 64 * 65 / 2)


def test_mfu_of_a_run_by_hand():
    """Each token is a decode row fed at position ``100 + j`` (token 0
    came from the prefill; its row makes token 1), attending ``101 + j``
    positions."""
    bench = harness.Bench(ROOT)
    run = _run(n_req=2, n_tok=3)
    ops = 2 * (roofline.prefill_ops(M7B, 100)
               + sum(roofline.decode_token_ops(M7B, 101 + j)
                     for j in range(3)))
    assert _read(bench, "mfu.decode", run) == pytest.approx(
        ops / (run.clean_s * 989e12) * 100)


class _Ev:
    def __init__(self, name, st, dur, dev=False, corr=0, link=0):
        self._n, self._s, self._d = name, st, dur
        self._dev, self._c, self._l = dev, corr, link

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def test_trace_attribution_busy_and_idle():
    evs = [
        _Ev("bench:engine.step", 0, 1000, corr=1),
        _Ev("bench:engine.admit", 100, 300, corr=2),
        _Ev("bench:linear.4bit", 150, 100, corr=3),
        _Ev("cudaLaunchKernel", 160, 5, corr=900),      # in linear/admit
        _Ev("bench:linear.4bit", 600, 100, corr=4),
        _Ev("aten::mm", 610, 50, corr=5),
        _Ev("cudaLaunchKernel", 620, 5, corr=901),      # in linear, decode
        _Ev("cudaMemcpyAsync", 950, 5, corr=902),       # in step
        _Ev("k_admit", 200, 100, dev=True, corr=900, link=3),
        _Ev("k_decode", 650, 150, dev=True, corr=901, link=5),
        _Ev("Memcpy DtoH", 960, 20, dev=True, corr=902, link=1),
        _Ev("k_lost", 820, 30, dev=True, corr=999, link=0),
        _Ev("k_linked", 700, 50, dev=True, corr=998, link=5),
        _Ev("bench:engine.step", 0, 1000, dev=True),    # the device's copy
    ]
    d = trace.summarize(evs)
    assert d.window_s == pytest.approx(1000 / 1e9)
    assert d.busy_s == pytest.approx((100 + 150 + 30 + 20) / 1e9)
    assert d.select("linear.4bit", "prefill") == (pytest.approx(100e-9), 1)
    assert d.select("linear.4bit", "decode") == (pytest.approx(200e-9), 2)
    assert d.select("engine.step", "decode")[1] == 2      # memcpy no kernel
    assert d.device_s[""] == pytest.approx(30e-9)
    assert (d.launch_found, d.link_found, d.unlinked) == (3, 1, 1)
    assert d.spans == {"engine.step": 1, "engine.admit": 1, "linear.4bit": 2}
    idle = dict(d.idle_by_host)
    assert idle["engine.step/engine.admit"] == pytest.approx(200e-9)
    assert sum(idle.values()) == pytest.approx(d.window_s - d.busy_s)
    assert d.top_ops[0][0] == "k_decode"


def _graphed_step_trace(n_steps, k1_ns, k3_ns, other_ns, admit_ns=0):
    """``n_steps`` decode steps as a CUDA graph would run them: one launch
    a step inside ``engine.step`` and no span a projection, each launch
    running K1's tensor-core body, K3 and another kernel; with
    ``admit_ns``, an admission kernel in the first step."""
    evs, corr = [], 100
    for i in range(n_steps):
        t = i * 10_000
        evs.append(_Ev("bench:engine.step", t, 9_000, corr=corr))
        corr += 1
        if admit_ns and i == 0:
            evs.append(_Ev("bench:engine.admit", t + 10, 1_000, corr=corr))
            evs.append(_Ev("cudaLaunchKernel", t + 20, 5, corr=corr + 1))
            evs.append(_Ev("void dequantize_pair_kernel<0>(int const*)",
                           t + 30, admit_ns, dev=True, corr=corr + 1))
            corr += 2
        evs.append(_Ev("cudaGraphLaunch", t + 1_500, 5, corr=corr))
        at = t + 2_000
        for name, dur in (("void pair_mma_kernel<64, 128>(int const*)", k1_ns),
                          ("void flash_decode_split<__nv_bfloat16, 4, 128>"
                           "(Params)", k3_ns),
                          ("void at::native::elementwise_kernel<128>()",
                           other_ns)):
            evs.append(_Ev(name, at, dur, dev=True, corr=corr))
            at += dur
        corr += 1
    return trace.summarize(evs)


def _decode_run(n_clean=6, n_stretch=4, rows=3, plen=100):
    """A run of ``rows`` requests, first answered before the window,
    decoding one token a step, the profiler on for the last
    ``n_stretch`` of its steps."""
    bench = harness.Bench(ROOT)
    cell = bench.cell("m7b.longgen")
    n = n_clean + n_stretch
    steps = [(i * 1.0, i * 1.0 + 0.5, rows) for i in range(n)]
    recs = {r: harness.Rec(Req([1] * plen, n + 1), -1.0,
                           [-0.75] + [i * 1.0 + 0.25 for i in range(n)])
            for r in range(rows)}
    run = harness.RunRecord(cell, 0.0, n * 1.0, 1.0, 2 ** 30, recs, steps,
                            t_prof_on=n_clean - 0.1,
                            t_prof_off=n * 1.0 - 0.2)
    run.kernel_groups = bench.kernel_groups()
    return run


def test_decode_rooflines_read_a_graphed_step_by_kernel_name():
    bench = harness.Bench(ROOT)
    run = _decode_run()
    run.device = _graphed_step_trace(4, k1_ns=3_000, k3_ns=1_000,
                                     other_ns=500)
    assert run.device.launch_found == 12
    q = run.cell.config["quant"]
    lin = 4 * roofline.decode_step_linear_least(M7B, 3, True,
                                                q["blocksize"], 4, True)
    # token j of a 100-token prompt is fed at 100 + j, attends 101 + j;
    # step i emits token i + 1
    att = sum(roofline.decode_step_attention_least(M7B, [102 + i] * 3)
              for i in range(6, 10))
    assert run.stretch_lengths() == [[102 + i] * 3 for i in range(6, 10)]
    assert _read(bench, "linear_roofline.decode", run) == pytest.approx(
        lin / (4 * 3_000e-9) * 100)
    assert _read(bench, "attn_roofline.decode", run) == pytest.approx(
        att / (4 * 1_000e-9) * 100)
    assert _read(bench, "forward.kernels_per_step.decode", run) == 3
    run.kernel_groups = {}
    assert _read(bench, "linear_roofline.decode", run) is None


def test_decode_step_linear_least_by_hand():
    # one row: every weight's bytes, fp32 scales a 64-block, bf16 in/out
    w = sum(o * i // 2 + o * i // 64 * 4 + i * 2 + o * 2
            for o, i in [(6144, 4096), (4096, 4096), (28672, 4096),
                         (4096, 14336)])
    head = 32768 * 4096 // 2 + 32768 * 4096 // 64 * 4 + 4096 * 2 + 32768 * 2
    assert roofline.decode_step_linear_least(M7B, 1, True, 64, 4, True) == \
        pytest.approx((32 * w + head) / 3.35e12)


def test_idle_of_the_clean_window_from_the_stretch():
    """The stretch's decode device time a step (4.5 us) times the clean
    window's 6 steps over its 5.9 s; its own idle share stays apart."""
    bench = harness.Bench(ROOT)
    run = _decode_run()
    run.device = _graphed_step_trace(4, k1_ns=3_000, k3_ns=1_000,
                                     other_ns=500)
    assert run.clean_s == pytest.approx(5.9)
    assert run.clean_busy_s() == pytest.approx(6 * 4_500e-9)
    assert _read(bench, "device_idle.decode", run) == pytest.approx(
        (1 - 6 * 4_500e-9 / 5.9) * 100)
    # an admission in the stretch and none before it: its time is not
    # carried into the clean window
    run.device = _graphed_step_trace(4, 3_000, 1_000, 500, admit_ns=700)
    assert run.clean_busy_s() == pytest.approx(6 * 4_500e-9)


def test_stretch_wraps_are_in_place_only_while_profiled():
    from quantizations_tpu_torch.models import llama
    from quantizations_tpu_torch.serve import paged
    from bench_port import spans
    ql, step = llama._ql, paged.PagedEngine.__dict__["step"]
    rec = spans.Recorder()
    wraps = spans.Spans(rec, ROOT / "bench_port")
    assert rec.missing == []
    wraps.on("window")
    try:
        assert llama._ql is ql
        assert paged.PagedEngine.__dict__["step"] is not step
        wraps.on("stretch")
        assert llama._ql is not ql
        wraps.off("stretch")
        assert llama._ql is ql
    finally:
        wraps.remove()
    assert paged.PagedEngine.__dict__["step"] is step
