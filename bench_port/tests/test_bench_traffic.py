"""The traffic generator: the same requests from the same seed, the
stated distributions, the same sizes from every seed in an order of its
own, and the mixes' cited statistics."""

import collections
import json
import math
from pathlib import Path

import numpy as np

from bench_port.traffic import Traffic, quantiles

SPEC = {"loop": "closed", "clients": 64, "sampling": "greedy",
        "prompt_tokens": {"dist": "log_uniform", "low": 128, "high": 512},
        "output_tokens": {"dist": "uniform", "low": 256, "high": 1024},
        "first_wave_output_tokens": {"dist": "uniform", "low": 1,
                                     "high": 1024}}


def _requests(seed, n):
    t = Traffic(SPEC, seed, 32768)
    return t.first_wave() + [t.next() for _ in range(n)]


def test_same_seed_same_requests():
    a, b = _requests(2 ** 31 + 7, 100), _requests(2 ** 31 + 7, 100)
    assert [(r.prompt, r.max_new) for r in a] == \
        [(r.prompt, r.max_new) for r in b]


def test_every_seed_the_same_sizes_in_its_own_order():
    a, b = _requests(1, 128), _requests(2, 128)
    for lo in (0, 64, 128):
        assert sorted(len(r.prompt) for r in a[lo:lo + 64]) == \
            sorted(len(r.prompt) for r in b[lo:lo + 64])
        assert sorted(r.max_new for r in a[lo:lo + 64]) == \
            sorted(r.max_new for r in b[lo:lo + 64])
    assert [r.max_new for r in a] != [r.max_new for r in b]
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert [r.prompt[:8] for r in a] != [r.prompt[:8] for r in b]


def test_each_block_the_same_sizes_in_another_order():
    reqs = _requests(1, 128)
    for lo in (64, 128):
        block = reqs[lo:lo + 64]
        assert sorted(len(r.prompt) for r in block) == \
            sorted(quantiles(SPEC["prompt_tokens"], 64))
        assert sorted(r.max_new for r in block) == \
            sorted(quantiles(SPEC["output_tokens"], 64))
    assert [r.max_new for r in reqs[64:128]] != \
        [r.max_new for r in reqs[128:192]]


def test_stated_distributions():
    reqs = _requests(5, 64 * 20)
    first, rest = reqs[:64], reqs[64:]
    outs = [r.max_new for r in rest]
    assert min(outs) >= 256 and max(outs) <= 1024
    assert abs(np.mean(outs) - 640) < 8
    assert min(r.max_new for r in first) <= 16
    assert max(r.max_new for r in first) >= 1000
    plens = np.array([len(r.prompt) for r in rest])
    assert plens.min() >= 128 and plens.max() <= 512
    # log-uniform: the median is the geometric mean, each octave holds half
    assert abs(np.median(plens) - math.sqrt(128 * 513)) < 6
    assert abs(np.mean(plens < 256) - 0.5) < 0.02
    ids = np.concatenate([r.prompt for r in rest])
    assert ids.min() >= 0 and ids.max() < 32768
    counts = collections.Counter((ids * 8 // 32768).tolist())
    assert max(counts.values()) / min(counts.values()) < 1.1


def test_quantiles_bounds():
    assert quantiles({"dist": "uniform", "low": 60, "high": 60},
                     3).tolist() == [60] * 3
    q = quantiles({"dist": "uniform", "low": 16, "high": 64}, 49)
    assert q.tolist() == list(range(16, 65))


MIXES = Path(__file__).resolve().parents[1] / "traffic"


def _sizes(name):
    spec = json.loads((MIXES / f"{name}.json").read_text())
    t = Traffic(spec, 2 ** 31 + 5, 32768)
    t.first_wave()
    reqs = [t.next() for _ in range(4 * spec["clients"])]
    return (np.array([len(r.prompt) for r in reqs]),
            np.array([r.max_new for r in reqs]), spec)


def test_longgen_follows_lmsys_chat_means():
    """LMSYS-Chat-1M (arXiv:2309.11998, Table 1): 69.5 tokens a prompt,
    214.5 a response on average."""
    plens, outs, spec = _sizes("longgen")
    assert "2309.11998" in spec["source"]
    assert abs(plens.mean() / 69.5 - 1) < 0.02
    assert abs(outs.mean() / 214.5 - 1) < 0.02


def test_rag_follows_azure_code_medians():
    """The Azure LLM inference trace 2023, code (Splitwise,
    arXiv:2311.18677): median prompt 1,500 tokens, median output 13."""
    plens, outs, spec = _sizes("rag")
    assert "2311.18677" in spec["source"]
    assert abs(np.median(plens) / 1500 - 1) < 0.01
    assert abs(np.median(outs) - 13) <= 1
