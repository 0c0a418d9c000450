"""The port's utilities (``utils/``) against the JAX package's on the CPU.

- ``model_weight_bytes`` equals the JAX package's on the same bridged
  ``TINY_LLAMA`` params.
- ``time_scan_chain(device="cpu")`` returns a positive float, calls the
  function in a chain as long as asked, and leaves x unchanged; a device
  other than x's raises.
- ``trace()`` writes a Chrome trace holding the enclosed ops.
- ``golden``'s functions (``csrc/golden.cpp`` through ctypes, built into
  the port's build directory) equal the JAX package's binding on the
  same buffers, bit for bit.
"""

import json

import jax
import numpy as np
import pytest
import torch

from quantizations_tpu.models import llama as jl
from quantizations_tpu.utils import golden as jg
from quantizations_tpu.utils import profiling as jprof
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.utils import golden as tg
from quantizations_tpu_torch.utils import profiling as tprof
from quantizations_tpu_torch.utils.timing import time_scan_chain

torch.set_num_threads(1)


def _tree(obj):
    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


@pytest.mark.parametrize("quantize_embedding", [False, True])
def test_model_weight_bytes_equals_jax(quantize_embedding):
    import dataclasses

    from quantizations_tpu.config import QuantConfig as JQuantConfig

    jcfg = dataclasses.replace(jl.TINY_LLAMA, quant=JQuantConfig(
        quantize_embedding=quantize_embedding))
    jpar = jl.init_llama_params(jcfg, seed=0)
    tpar = params_from_numpy(_tree(jpar), tl.TINY_LLAMA, device="cpu")
    want = jprof.model_weight_bytes(jpar)
    assert tprof.model_weight_bytes(tpar) == want > 0


def test_time_scan_chain_cpu():
    calls = []
    x0 = torch.randn(64, 64)
    keep = x0.clone()
    W = torch.randn(64, 64)

    def fn(x, w):
        calls.append(1)
        return x @ w

    t = time_scan_chain(fn, x0, iters=8, trials=2, min_total_s=0.0,
                        consts=(W,), device="cpu")
    assert isinstance(t, float) and t > 0.0
    # (warm-up + 2 trials) x (8 calls, then 4 for the slope)
    assert len(calls) == 3 * 8 + 3 * 4
    assert torch.equal(x0, keep)


def test_time_scan_chain_grows_the_chain():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    time_scan_chain(fn, torch.ones(4), iters=2, trials=1,
                    min_total_s=1e9, max_iters=32, device="cpu")
    # 2, 8, 32 calls (warm-up + 1 trial each), then 16 for the slope
    assert len(calls) == 2 * (2 + 8 + 32 + 16)


def test_time_scan_chain_keeps_x_numerically():
    """The chain's perturbation, 1e-30 * sum(out), is below x's last
    bit, so every call sees x0's values."""
    seen = []
    x0 = torch.full((8,), 3.0)

    def fn(x):
        seen.append(x.clone())
        return x * 1e3

    time_scan_chain(fn, x0, iters=4, trials=1, min_total_s=0.0,
                    device="cpu")
    assert all(torch.equal(s, x0) for s in seen)


def test_time_scan_chain_refuses_another_device():
    with pytest.raises((ValueError, RuntimeError)):
        time_scan_chain(lambda x: x, torch.ones(2), device="cuda")


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "t")):
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    path = tmp_path / "t" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_golden_4bit_equals_jax(quant_type):
    rng = np.random.default_rng(0)
    A = (rng.standard_normal(4096) * 0.1).astype(np.float32)
    A[100:164] = 0.0                        # a zero block
    for bs in (64, 256):
        p, a = tg.quantize_4bit(A, bs, quant_type)
        jp, ja = jg.quantize_4bit(A, bs, quant_type)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(
            tg.dequantize_4bit(p, a, A.size, bs, quant_type),
            jg.dequantize_4bit(jp, ja, A.size, bs, quant_type))
    M, K = 16, 256
    p, a = tg.quantize_4bit(A[:M * K], 64, quant_type)
    x = rng.standard_normal(K).astype(np.float32)
    np.testing.assert_array_equal(
        tg.gemv_4bit(p, a, x, M, K, 64, quant_type),
        jg.gemv_4bit(p, a, x, M, K, 64, quant_type))


def test_golden_8bit_and_packing_equal_jax():
    from quantizations_tpu_torch.quant.codebooks import create_dynamic_map

    rng = np.random.default_rng(1)
    code = create_dynamic_map().astype(np.float32)
    A = rng.standard_normal(1000).astype(np.float32)
    q, a = tg.quantize_blockwise_8bit(code, A, 256)
    jq, ja = jg.quantize_blockwise_8bit(code, A, 256)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(tg.dequantize_blockwise_8bit(code, q, a),
                                  jg.dequantize_blockwise_8bit(code, q, a))
    packed = rng.integers(0, 256, 8 * 64, dtype=np.uint8)
    np.testing.assert_array_equal(tg.repack_bytes_to_i32(packed),
                                  jg.repack_bytes_to_i32(packed))
    np.testing.assert_array_equal(tg.pack_pair(packed, 8, 128),
                                  jg.pack_pair(packed, 8, 128))


def test_golden_builds_into_the_port():
    path = tg._build()
    assert path.parent.name == "build"
    assert path.parent.parent.name == "quantizations_tpu_torch"
    assert path.exists()
