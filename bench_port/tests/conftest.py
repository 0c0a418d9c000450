"""A tiny benchmark root for the CPU tests: ``BENCHMARK.json`` with one
tiny configuration and cell, beside a copy of this folder, so that a
test adds files the way a later change would."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = {
    "source": "a tiny Mistral-shaped test model",
    "architectures": ["MistralForCausalLM"], "hidden_size": 128,
    "intermediate_size": 256, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "head_dim": 32,
    "rms_norm_eps": 1e-5, "rope_theta": 1000000.0, "sliding_window": None,
    "tie_word_embeddings": False, "vocab_size": 256,
    "max_position_embeddings": 4096,
    "quant": {"quant_type": "fp4", "blocksize": 64,
              "compress_statistics": True, "scales_dtype": "float32",
              "quantize_lm_head": True, "quantize_embedding": False},
    "kv_cache_dtype": "bf16", "fuse_projections": True,
    "weights": {"sigma": 0.02},
}
TINY_TRAFFIC = {
    "loop": "closed", "clients": 4,
    "prompt_tokens": {"dist": "log_uniform", "low": 8, "high": 40},
    "output_tokens": {"dist": "uniform", "low": 4, "high": 12},
    "first_wave_output_tokens": {"dist": "uniform", "low": 1, "high": 12},
    "sampling": "greedy",
}
TINY_WORK = {
    "config": "tiny", "traffic": "tiny",
    "engine": {"slots": 4, "max_seq": 64, "page_size": 16, "num_pages": 17,
               "prefill_buckets": [8, 16], "admit_width": 4,
               "prefix_cache": False},
    "trace_start": 0.2, "trace_seconds": 0.5,
    "check": {"served_tokens": 1000, "max_requests": 64,
              # program 0.0003-0.0052 on nine seeds, control 0.017-0.042 on
              # eight
              "logit_gap_limit": 0.008},
}


def make_root(tmp: Path) -> Path:
    """A benchmark root under ``tmp``: this folder copied, the tiny cell
    added as files, and a ``BENCHMARK.json`` naming it."""
    shutil.copytree(BENCH, tmp / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp / "bench_port"
    (b / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (b / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (b / "workloads" / "tiny.cell.json").write_text(json.dumps(TINY_WORK))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "bench_port/configs/tiny.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": "tiny.cell", "config": "tiny",
                              "traffic": "tiny", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and (m["name"].endswith((".decode", "_ms"))
                                 or m["name"].startswith("pool.")):
            m["workloads"].append("tiny.cell")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
