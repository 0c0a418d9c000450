"""Whole runs of a tiny cell on the CPU: the result line, the
correctness check against the plain reference and the faults it has to
catch, a cell and a metric added as files only, the guards."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench_port import harness
from bench_port import weights as W
from bench_port.reference import model as ref_model
from bench_port.reference import quant as ref_quant

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 99


def _run(root, seed=SEED, traced=False, seconds=1.5, control=None):
    bench = harness.Bench(root)
    return harness.run_cell(bench, "tiny.cell", seed, seconds, traced, CPU,
                            time.perf_counter(), control=control)


def test_tiny_cell_is_correct_and_its_line_has_the_keys(tiny_root):
    sys.path.insert(0, str(ROOT / "bench_port"))
    import run as run_py
    res, checks, msgs = _run(tiny_root)
    line = json.loads(run_py.result_line(res, checks, "tiny.cell", SEED,
                                         "cpu", torch))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 4
    assert set(line["metrics"]) == {"output_tok_s", "itl_p95_ms", "setup_s"}
    assert line["checks"]["logit_gap"]["limit"] == 0.008
    assert line["checks"]["logit_gap"]["value"] < 0.008
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])


def test_traced_run_reads_the_span_metrics(tiny_root):
    res, checks, msgs = _run(tiny_root, traced=True, seconds=3.0)
    assert res["correct"]
    assert "engine.admit_share.decode" in res["metrics"]
    assert 0 < res["metrics"]["mfu.decode"]["value"] < 100
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])


def _fault(monkeypatch, tiny_root, target, attr, make):
    import importlib
    mod = importlib.import_module(target)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    res, checks, _ = _run(tiny_root)
    return res, dict((c[0], c) for c in checks)


def test_fault_state_left_unchanged(monkeypatch, tiny_root):
    res, checks = _fault(monkeypatch, tiny_root,
                         "quantizations_tpu_torch.serve.paged",
                         "write_window", lambda f: lambda *a, **k: None)
    assert res["correct"] is False
    assert checks["logit_gap"][1] > checks["logit_gap"][2]


def test_fault_half_the_batch_left_out(monkeypatch, tiny_root):
    def make(step):
        def half(params, token_ids, pages, table, pos, cfg, mp, axis=None):
            logits, pages = step(params, token_ids, pages, table, pos, cfg,
                                 mp, axis)
            h = logits.shape[0] // 2
            return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), \
                pages
        return half
    res, checks = _fault(monkeypatch, tiny_root,
                         "quantizations_tpu_torch.serve.paged",
                         "paged_decode_step", make)
    assert res["correct"] is False
    assert checks["logit_gap"][1] > checks["logit_gap"][2]


def test_fault_token_altered_where_produced(monkeypatch, tiny_root):
    def make(sample):
        def altered(logits, samp, gen=None):
            tok = sample(logits, samp, gen)
            tok[0] = (tok[0] + 1) % logits.shape[-1]
            return tok
        return altered
    res, checks = _fault(monkeypatch, tiny_root,
                         "quantizations_tpu_torch.serve.paged",
                         "sample_rows_samp", make)
    assert res["correct"] is False
    assert checks["logit_gap"][1] > checks["logit_gap"][2]


def test_control_fails_the_limit(tiny_root):
    """The control (the reference with fp8 e4m3 projection inputs) reads
    more than three times the program's gap, past the limit."""
    res, checks, _ = _run(tiny_root, control=torch.float8_e4m3fn)
    gap = checks[0][1]
    assert res["control_gap"] > max(3 * gap, checks[0][2])


def test_cell_and_metric_added_as_files(tiny_root):
    (tiny_root / "bench_port/metrics/requests_done.py").write_text(
        "def read(run):\n"
        "    return sum(r.done_t is not None for r in run.recs.values())\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["tiny.cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    res, _, _ = _run(tiny_root)
    assert res["metrics"]["requests_done"]["value"] >= res["attempted"]


def test_missing_span_point_leaves_its_metric_out(tiny_root):
    (tiny_root / "bench_port/spans/program.json").write_text(json.dumps([
        {"name": "engine.admit", "module": "quantizations_tpu_torch.serve"
         ".paged", "object": "PagedEngine", "attr": "_gone"}]))
    res, _, msgs = _run(tiny_root, traced=True)
    assert "engine.admit_share.decode" not in res["metrics"]
    assert any("engine.admit" in m for m in msgs)
    assert res["correct"]


def test_no_jax_by_whole_top_level_name():
    b = harness.banned_modules
    assert b(["quantizations_tpu_torch", "quantizations_tpu_torch.serve",
              "numpy", "jaxtyping", "flax_like"]) == []
    assert b(["quantizations_tpu.ops.qmatmul"]) == ["quantizations_tpu"]
    assert b(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax",
                                                         "jaxlib"]
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_port.harness, bench_port.reference.model\n"
            "import quantizations_tpu_torch.serve.paged\n"
            "import quantizations_tpu_torch.models.hf_loader\n"
            "from bench_port.harness import banned_modules\n"
            "print(banned_modules())") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "bench_port/run.py"),
                          "--workload", "m7b.longgen", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode == 2
    assert out.stdout == ""


def test_reference_quantizer_is_the_programs():
    from quantizations_tpu_torch.models.llama import quantize_linear
    from quantizations_tpu_torch.ops.quantize import \
        dequantize_4bit_kernel_plain
    g = torch.Generator().manual_seed(3)
    w = (torch.randn(384, 512, generator=g) * 0.02).to(torch.bfloat16)
    ql = quantize_linear(w, layout="planar")
    ref = ref_quant.dequantized_weight(w)
    assert torch.equal(ref, dequantize_4bit_kernel_plain(ql.wp, ql.scales))


def test_reference_against_the_ports_cpu_forward(tiny_root):
    """The port's full-sequence forward on the CPU (bf16 activations) and
    the fp32 reference on the same seeded weights."""
    from quantizations_tpu_torch.models.llama import KVCache, prefill
    bench = harness.Bench(tiny_root)
    cell = bench.cell("tiny.cell")
    cfg = harness.program_config(cell)
    params = harness.build_program(cell, cfg, 17, CPU)
    ids = torch.randint(0, cell.dims.vocab, (1, 40),
                        generator=torch.Generator().manual_seed(1))
    cache = KVCache.create(cfg, 1, 64, CPU)
    with torch.inference_mode():
        got, _ = prefill(params, ids, cache, cfg)
    ref = ref_model.forward_logits(cell.dims, 17, CPU, [ids[0].tolist()],
                                   [1])[0]
    got = got[0, :-1].float()
    scale = ref.abs().max()
    assert (got - ref).abs().max() < 0.02 * scale
    assert (got.argmax(-1) == ref.argmax(-1)).float().mean() > 0.8
    gaps = harness.logit_gaps(ref, got.argmax(-1))
    assert gaps.max() < 0.02


def test_weights_redraw_layer_alone():
    d = W.Dims(vocab=256, hidden=128, inter=256, layers=3, n_q=4, n_kv=2,
               head_dim=32, rope_theta=1e6, eps=1e-5)
    a = W.layer_weights(d, 5, 2, CPU)
    b = W.layer_weights(d, 5, 2, CPU)
    c = W.layer_weights(d, 6, 2, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["q"], c["q"])
    assert a["down"].shape == (128, 256) and a["q"].dtype == torch.bfloat16
    assert abs(float(a["gate"].float().std()) - 0.02) < 0.001
