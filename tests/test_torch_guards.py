"""Static and device guards of the port, and its card-only checks.

- No module of ``quantizations_tpu_torch`` and not ``chip_smoke.py``
  imports JAX, Flax or the JAX package (read from the parsed imports).
- Entry points run on CUDA unless they are given ``device="cpu"``: with
  no card they raise rather than fall back to the CPU.
- ``chip_smoke.py`` exits non-zero, printing no result, without a card.
- Tests marked ``cuda`` hold each kernel against its plain version on
  the card; they skip where ``torch.cuda.is_available()`` is False.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quantizations_tpu_torch import QuantConfig
from quantizations_tpu_torch.bridge import cache_from_numpy, params_from_numpy
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.ops import qmatmul as tqm
from quantizations_tpu_torch.ops import quantize as tqz

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "quantizations_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "quantizations_tpu"}


def _imported_roots(path):
    """Top-level names of every absolute import in ``path``."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_import_guard_sees_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\n"
                     "from quantizations_tpu.ops import x\n"
                     "from . import y\nimport quantizations_tpu_torch\n")
    assert _imported_roots(probe) == {"jax", "quantizations_tpu",
                                      "quantizations_tpu_torch"}


def test_entry_points_need_a_card(monkeypatch):
    """With no card, every entry point called without a device raises;
    ``device="cpu"`` is the only way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(tl.TINY_LLAMA, num_hidden_layers=1)
    for call in (lambda: tl.init_llama_params(cfg),
                 lambda: tl.KVCache.create(cfg, 1, 8),
                 lambda: params_from_numpy({}, cfg),
                 lambda: cache_from_numpy({"k": np.zeros(1),
                                           "v": np.zeros(1)})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tl.KVCache.create(cfg, 1, 8, device="cpu").k.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# -- on the card ------------------------------------------------------------
# A machine with a card may have no JAX, which tests/conftest.py imports:
# there these tests run as ``python -m pytest --noconftest -m cuda
# tests/test_torch_guards.py``, so they need no fixture from conftest.

@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("T", [1, 3, 8, 16, 40])
def test_k1_matches_plain_on_card(cuda, rng, quant_type, scale_kind, T):
    M, K = 256, 512
    wp2 = torch.from_numpy(rng.integers(-2**31, 2**31, (3, M // 2, K // 4),
                                        dtype=np.int64).astype(np.int32))
    scales = torch.from_numpy(
        (rng.random((3, M, K // 64)) * 0.05 + 0.01).astype(np.float32))
    if scale_kind == "bf16":
        scales = scales.to(torch.bfloat16)
    elif scale_kind == "bf16x2":
        scales = tqm.pack_scale_pairs(scales)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(
        np.float32)).to(torch.bfloat16)
    ref = tqm.matmul_4bit_pair_stacked(wp2, scales, x, 1, quant_type)
    got = tqm.matmul_4bit_pair_stacked(wp2.to(cuda), scales.to(cuda),
                                       x.to(cuda), 1, quant_type)
    torch.cuda.synchronize()
    # same rounding class on both sides: fp32 summation order only
    assert (got.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_bit_exact_on_card(cuda, rng, quant_type, dtype):
    W = torch.from_numpy((rng.standard_normal((128, 512)) * 0.02).astype(
        np.float32)).to(dtype)
    W[1] = 0.0
    ref = tqz.quantize_4bit_kernel(W, 64, quant_type)
    got = tqz.quantize_4bit_kernel(W.to(cuda), 64, quant_type)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
def test_planar_weights_raise_on_card(cuda, rng):
    """Planar 4-bit weights have no ported kernel: on the card they raise
    instead of running a plain path."""
    from quantizations_tpu_torch.nn.linear import apply_4bit

    wp = torch.from_numpy(rng.integers(-2**31, 2**31, (64, 512 // 8),
                                       dtype=np.int64).astype(np.int32))
    scales = torch.ones(64, 512 // 64)
    x = torch.ones(2, 512, dtype=torch.bfloat16)
    assert apply_4bit(x, wp, scales, "fp4").shape == (2, 64)
    with pytest.raises(NotImplementedError, match="not ported"):
        apply_4bit(x.to(cuda), wp.to(cuda), scales.to(cuda), "fp4")


@pytest.mark.cuda
def test_tiny_model_on_card_matches_cpu(cuda):
    cfg = dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(
        quantize_embedding=True))
    p = tl.fuse_projections(tl.init_llama_params(cfg, seed=1, device=cuda))
    pc = tl.map_tensors(lambda t: t.cpu(), p)
    ids = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(0))
    lg, _ = tl.prefill(p, ids.to(cuda), tl.KVCache.create(cfg, 2, 32, cuda),
                       cfg)
    lc, _ = tl.prefill(pc, ids, tl.KVCache.create(cfg, 2, 32, "cpu"), cfg)
    # bf16 attention operands on the card, fp32 on the CPU
    assert (lg.cpu() - lc).abs().max() <= 2e-2 * lc.abs().max()
