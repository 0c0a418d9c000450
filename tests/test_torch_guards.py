"""Static and device guards of the port, and its card-only checks.

- No module of ``quantizations_tpu_torch`` and not ``chip_smoke.py``
  imports JAX, Flax or the JAX package (read from the parsed imports).
- Entry points run on CUDA unless they are given ``device="cpu"``: with
  no card they raise rather than fall back to the CPU.
- ``chip_smoke.py`` exits non-zero, printing no result, without a card,
  and raises on a spill or a missing instantiation in the ``ptxas -v``
  log of K1/K9 or of ``csrc/planar_matmul.cu`` (K5's two bodies, K6).
- The checkpoint path and the CLIs import no ``safetensors`` or
  ``orbax``, and only the serving CLI's optional tokenizer imports
  ``transformers``.
- Tests marked ``cuda`` hold each kernel (K1 to K10, and both of K5's
  bodies) against its plain version on the card (K9 against K1, bit for
  bit; K1 above 128 rows,
  its tensor-core body, against its CUDA-core body and K8; K10 bit for
  bit, and the dense bands' bf16 products within 1e-5 * max|y| of their
  fp32 plain products), the per-body launch counts, and the wrappers'
  refusals; they skip where ``torch.cuda.is_available()`` is False.
"""

import ast
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quantizations_tpu_torch import QuantConfig
from quantizations_tpu_torch.bridge import (cache_from_numpy,
                                            linear4bit_from_numpy,
                                            params_from_numpy)
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.nn.linear import Linear4bit
from quantizations_tpu_torch.ops import (FLASH_DECODE, FLASH_DECODE_I8,
                                         PAIR_MANUAL, PAIR_MATMUL,
                                         PAIR_PREFILL, QUANTIZE_4BIT)
from quantizations_tpu_torch.ops import attention as tat
from quantizations_tpu_torch.ops import gemv as tgv
from quantizations_tpu_torch.ops import paged_attention as tpa
from quantizations_tpu_torch.ops import qmatmul as tqm
from quantizations_tpu_torch.ops import quantize as tqz
from quantizations_tpu_torch.quant import bnb_io as tbnb
from quantizations_tpu_torch.serve import paged as tpg

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


# the checkpoint path and the command line: the card's machine has no
# safetensors, orbax or transformers package
CHECKPOINT_PATH = ("models/safetensors_io.py", "models/hf_loader.py",
                   "models/checkpoint.py", "convert.py", "serve/watchdog.py",
                   "serve/__main__.py")


def test_import_guard_covers_every_module():
    """The guard walks the whole package: the planar slice's modules and
    the bnb loader are among the files it reads."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("quant/bnb_io.py", "quant/state.py", "quant/functional.py",
                "nn/linear.py", "ops/gemv.py", "ops/qmatmul.py",
                "ops/quantize.py", "ops/cuda.py", "bridge.py",
                "models/llama.py", "serve/speculative.py",
                "serve/engine.py", "serve/paged.py",
                *CHECKPOINT_PATH):
        assert f"quantizations_tpu_torch/{mod}" in names, mod


@pytest.mark.parametrize("mod", CHECKPOINT_PATH)
def test_checkpoint_path_imports_no_file_format_package(mod):
    roots = _imported_roots(ROOT / "quantizations_tpu_torch" / mod)
    assert not roots & {"safetensors", "orbax"}, mod


def test_only_the_cli_tokenizer_imports_transformers():
    """``transformers`` is allowed in one place: the serving CLI's
    optional tokenizer, inside a ``try``."""
    users = {str(p.relative_to(ROOT)) for p in PORT_FILES
             if "transformers" in _imported_roots(p)}
    assert users == {"quantizations_tpu_torch/serve/__main__.py"}


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
    lin = Linear4bit.create(torch.ones(8, 64), device="cpu")
    state = lin.quant_state
    flat = tbnb.bnb_flat_tensors("p", lin.weight.packed_u8(), state)
    for call in (lambda: tl.init_llama_params(cfg),
                 lambda: tl.KVCache.create(cfg, 1, 8),
                 lambda: params_from_numpy({}, cfg),
                 lambda: cache_from_numpy({"k": np.zeros(1),
                                           "v": np.zeros(1)}),
                 lambda: tpg.PagedKVCache.create(cfg, 4, 8),
                 lambda: Linear4bit.create(torch.ones(8, 64)),
                 lambda: linear4bit_from_numpy({}, {}),
                 lambda: tbnb.qlinear_arrays_from_bnb(
                     np.zeros((256, 1), np.uint8), state),
                 lambda: tbnb.load_bnb_linear4bit(flat.__getitem__,
                                                  set(flat), "p")):
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


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _DoneNvcc:
    """A finished ``nvcc -Xptxas -v`` process with the given log."""

    returncode = 0

    def __init__(self, out):
        self.out = out

    def communicate(self, timeout=None):
        return self.out, None


@pytest.mark.parametrize("tiles,spilled,ok", [
    ((1, 2, 4, 8, 16), (), True),
    ((1, 2, 4, 8), (), False),            # an instantiation missing
    ((1, 2, 4, 8, 16), (8,), False)])     # a spill
def test_chip_smoke_checks_pair_matmul_ptxas(tiles, spilled, ok):
    """``chip_smoke.py`` reads K1/K9's ``ptxas -v`` log: every token tile
    of ``PAIR_TILES`` once, no spill, or it raises."""
    cs = _chip_smoke()
    name = ("_ZN12_GLOBAL__N_118pair_matmul_kernelILi{}EEEvPKiPKviPK13"
            "__nv_bfloat16S8_Pfiiiiifi")
    log = "".join(
        f"ptxas info    : Compiling entry function '{name.format(t)}' for "
        f"'sm_90a'\nptxas info    : Function properties for "
        f"{name.format(t)}\n    0 bytes stack frame, {44 * (t in spilled)} "
        f"bytes spill stores, {56 * (t in spilled)} bytes spill loads\n"
        f"ptxas info    : Used 64 registers, used 1 barriers, 2080 bytes "
        f"smem, 420 bytes cmem[0]\n" for t in tiles)
    results = {}
    if not ok:
        with pytest.raises(AssertionError):
            cs.read_ptxas_report({"pair_matmul": _DoneNvcc(log)}, results)
        return
    cs.read_ptxas_report({"pair_matmul": _DoneNvcc(log)}, results)
    assert [e["kernel"] for e in results["ptxas_pair_matmul"]] == [
        f"TT={t}" for t in cs.PAIR_TILES]
    assert {e["registers"] for e in results["ptxas_pair_matmul"]} == {64}


def _planar_ptxas_log(cs, drop=None, spilled=None):
    """A ``ptxas -v`` log of ``csrc/planar_matmul.cu`` with every
    instantiation that its dispatch launches (less ``drop``; ``spilled``
    with a spill)."""
    tail = "EEvPKiPKviPKfS4_Pfiiiiif"
    names = {f"K5 TT={t}": f"13planar_kernelILi{t}ELb1ELi2E{tail}"
             for t in cs.K5_TILES}
    names |= {f"K6 TT={t}{x}": f"13planar_kernelILi{t}ELb0ELi{xb}E{tail}"
              for t in cs.K6_TILES for x, xb in (("", 2), (" fp32 x", 4))}
    names |= {f"K5 mma NT={n} MT={m}":
              f"17planar_mma_kernelILi{n}ELi{m}ELi8ELi2EEEvPKiPKviPKfPK13"
              "__nv_bfloat16Pfiiiiif" for n, m in cs.PLANAR_MMA_TILES}
    log = ""
    for label, tail in names.items():
        if label == drop:
            continue
        fn = "_ZN12_GLOBAL__N_1" + tail
        sp = 8 * (label == spilled)
        log += (f"ptxas info    : Compiling entry function '{fn}' for "
                f"'sm_90a'\nptxas info    : Function properties for {fn}\n"
                f"    0 bytes stack frame, {sp} bytes spill stores, {sp} "
                f"bytes spill loads\nptxas info    : Used 96 registers, used 1 "
                f"barriers, 64 bytes smem, 420 bytes cmem[0]\n")
    return log, set(names)


@pytest.mark.parametrize("case", ["complete", "missing", "spill"])
def test_chip_smoke_checks_planar_matmul_ptxas(case):
    """``chip_smoke.py`` reads ``csrc/planar_matmul.cu``'s ``ptxas -v``
    log: every K5 and K6 token tile of the CUDA-core body and every tile
    of K5's tensor-core body once, no spill, or it raises."""
    cs = _chip_smoke()
    mma = "K5 mma NT={} MT={}".format(*cs.PLANAR_MMA_TILES[-1])
    log, labels = _planar_ptxas_log(
        cs, drop=mma if case == "missing" else None,
        spilled="K6 TT=8" if case == "spill" else None)
    results = {}
    if case != "complete":
        with pytest.raises(AssertionError):
            cs.read_ptxas_report({"planar_matmul": _DoneNvcc(log)}, results)
        return
    cs.read_ptxas_report({"planar_matmul": _DoneNvcc(log)}, results)
    assert {e["kernel"] for e in results["ptxas_planar_matmul"]} == labels
    assert {e["smem"] for e in results["ptxas_planar_matmul"]} == {64}


def _quantize_ptxas_log(cs, drop=None, spilled=None):
    """A ``ptxas -v`` log of ``csrc/quantize.cu`` with every K2
    instantiation that its dispatch launches (less ``drop``; ``spilled``
    with a spill)."""
    args = "EEEvPKT_PKfPiPfx"
    names = {}
    for t, mt in (("fp32", "f"), ("bf16", "13__nv_bfloat16")):
        for q, b in (("fp4", 0), ("nf4", 1)):
            names |= {f"L={n} {t} {q}":
                      f"21quantize_group_kernelI{mt}Li{n}ELb{b}{args}"
                      for n in cs.K2_GROUP_LANES}
            names[f"warp {t} {q}"] = (f"21quantize_block_kernelI{mt}Lb{b}"
                                      f"{args}i")
    log = ""
    for label, tail in names.items():
        if label == drop:
            continue
        fn = "_ZN12_GLOBAL__N_1" + tail
        sp = 8 * (label == spilled)
        log += (f"ptxas info    : Compiling entry function '{fn}' for "
                f"'sm_90a'\nptxas info    : Function properties for {fn}\n"
                f"    0 bytes stack frame, {sp} bytes spill stores, {sp} "
                f"bytes spill loads\nptxas info    : Used 40 registers, "
                f"used 0 barriers, 420 bytes cmem[0]\n")
    return log, set(names)


@pytest.mark.parametrize("case", ["complete", "missing", "spill"])
def test_chip_smoke_checks_quantize_ptxas(case):
    """``chip_smoke.py`` reads ``csrc/quantize.cu``'s ``ptxas -v`` log:
    K2's group body at every lane count and its one-warp body, each for
    fp32 and bf16 input and FP4 and NF4, once, no spill, or it raises."""
    cs = _chip_smoke()
    log, labels = _quantize_ptxas_log(
        cs, drop="warp bf16 nf4" if case == "missing" else None,
        spilled="L=8 fp32 fp4" if case == "spill" else None)
    results = {}
    if case != "complete":
        with pytest.raises(AssertionError):
            cs.read_ptxas_report({"quantize": _DoneNvcc(log)}, results)
        return
    cs.read_ptxas_report({"quantize": _DoneNvcc(log)}, results)
    assert {e["kernel"] for e in results["ptxas_quantize"]} == labels
    assert len(labels) == 4 * (len(cs.K2_GROUP_LANES) + 1)


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


# K1's CUDA-core body (and K9) on the tails its ring must handle: token
# tiles cut short (T 2, 5, 7, 12, 17: zero-filled rows), row pairs past
# the block's 8 (M 18 and 130), an odd count of scale blocks (K 576, the
# 4-byte copies) and more than 64 of them (K 4608: two chunks a step).
PAIR_TAIL_T = [1, 2, 3, 5, 7, 8, 12, 16, 17, 40]
PAIR_TAIL_MK = [(256, 512), (18, 576), (130, 4608)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("T", PAIR_TAIL_T)
@pytest.mark.parametrize("M,K", PAIR_TAIL_MK)
def test_k1_matches_plain_on_card(cuda, rng, quant_type, scale_kind, T, M,
                                  K):
    """K1 within 1e-5 * max|y| of its plain version, and two launches give
    the same bits."""
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
    on = [t.to(cuda) for t in (wp2, scales, x)]
    got = tqm.matmul_4bit_pair_stacked(*on, 1, quant_type)
    again = tqm.matmul_4bit_pair_stacked(*on, 1, quant_type)
    torch.cuda.synchronize()
    # same rounding class on both sides: fp32 summation order only
    assert (got.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _k2_check(W, blocksize, quant_type, cuda):
    """K2 on the card against its plain version on the CPU: the same
    words, and the same absmax (NaN at the same places)."""
    cs = _chip_smoke()
    ref = tqz.quantize_4bit_kernel(W, blocksize, quant_type)
    before = QUANTIZE_4BIT.launches
    got = tqz.quantize_4bit_kernel(W.to(cuda), blocksize, quant_type)
    torch.cuda.synchronize()
    assert QUANTIZE_4BIT.launches == before + 1
    assert torch.equal(got[0].cpu(), ref[0])
    assert cs.nan_equal(got[1].cpu(), ref[1])


# K2's bodies and their tails: every blocksize path (the group body at 8
# to 256, L = blocksize / 8 lanes a block; the one-warp body at 512, 1024,
# 4096 and at 72, not a power of two), M = 1, 3 and 130, and quant-block
# counts that are no multiple of a warp's groups or of its two segments
# (9 blocks a row up to blocksize 64, 3 at 128-512); the threshold edges
# and the non-finite blocks of chip_smoke.k2_special_blocks first. The
# last case is the earlier [128, 512] check at blocksize 64.
K2_TAIL_K = {8: 72, 16: 144, 32: 288, 64: 576, 128: 384, 256: 768,
             512: 1536, 1024: 2048, 4096: 4096, 72: 576}
K2_CASES = [(bs, M, K) for bs, K in sorted(K2_TAIL_K.items())
            for M in (1, 3, 130)] + [(64, 128, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocksize,M,K", K2_CASES)
def test_k2_bit_exact_on_card(cuda, rng, quant_type, dtype, blocksize, M, K):
    W = (rng.standard_normal((M, K)) * 0.02).astype(np.float32)
    special = _chip_smoke().k2_special_blocks(blocksize)
    flat = W.reshape(-1, blocksize)
    n = min(len(flat), len(special))
    flat[:n] = special[:n]
    _k2_check(torch.from_numpy(W).to(dtype), blocksize, quant_type, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocksize", [64, 512])
def test_k2_non_finite_blocks_on_card(cuda, quant_type, dtype, blocksize):
    """C.3: a block that holds a NaN gets a NaN absmax and the plain
    version's words (every finite element the code of 0), as the plain
    version and the JAX functional give; likewise +inf, -inf, -0.0, an
    all-zero block with one NaN and a subnormal absmax (1/absmax = inf).
    The ``eb81530`` body took the absmax with ``fmaxf``, which drops a
    NaN, and failed here."""
    special = _chip_smoke().k2_special_blocks(blocksize)
    W = np.concatenate([special, special[::-1]]).reshape(-1, 2 * blocksize)
    _k2_check(torch.from_numpy(np.ascontiguousarray(W)).to(dtype),
              blocksize, quant_type, cuda)


def _planar_operands(rng, M, K, L=3, scale_kind="fp32"):
    wp = torch.from_numpy(rng.integers(-2**31, 2**31, (L, M, K // 8),
                                       dtype=np.int64).astype(np.int32))
    scales = torch.from_numpy(
        (rng.random((L, M, K // 64)) * 0.05 + 0.01).astype(np.float32))
    if scale_kind == "bf16":
        scales = scales.to(torch.bfloat16)
    return wp, scales


# K5's bodies on their tails: token tiles cut short (T 3, 5, 9, 17, 40 and
# 100, above one 64-token tile), row tails (M 33 and 130 against 16- and
# 32-row blocks), 9 scale blocks over 8 warps (K 576) and 72 (K 4608)
K5_TAIL_T = [1, 2, 3, 5, 8, 9, 16, 17, 40, 48, 64, 100]
K5_TAIL_MK = [(256, 512), (33, 576), (130, 4608)]


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["cuda_core", "mma"])
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16"])
@pytest.mark.parametrize("T", K5_TAIL_T)
@pytest.mark.parametrize("M,K", K5_TAIL_MK)
def test_k5_matches_plain_on_card(cuda, rng, body, quant_type, scale_kind, T,
                                  M, K):
    """Each of K5's bodies, launched directly on layer 1 of a stack (a
    pointer offset), within 1e-5 * max|y| of the plain version, and two
    launches give the same bits; the dispatch on the stack gives the bits
    of the body ``planar_body`` names."""
    wp, scales = _planar_operands(rng, M, K, scale_kind=scale_kind)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(
        np.float32)).to(torch.bfloat16)
    ref = tqm.matmul_4bit_planar_stacked(wp, scales, x, 1, quant_type)
    on = [t.to(cuda) for t in (wp, scales, x)]
    fn = getattr(tqm, f"matmul_4bit_planar_{body}")
    got = fn(on[0][1], on[1][1], on[2], quant_type)
    again = fn(on[0][1], on[1][1], on[2], quant_type)
    # the same bf16 rounding on both sides: fp32 summation order only
    _agree(got, ref)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    if tqm.planar_body(T) == body:
        assert torch.equal(tqm.matmul_4bit_planar_stacked(
            *on, 1, quant_type).view(torch.int32), got.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 48])
def test_k5_counts_each_body_on_card(cuda, rng, T):
    """``PLANAR_MATMUL`` counts every K5 launch, ``PLANAR_MATMUL_MMA``
    those of the tensor-core body; a direct launch of either body counts
    in its own record only."""
    from quantizations_tpu_torch.ops import PLANAR_MATMUL, PLANAR_MATMUL_MMA

    wp, scales = [t.to(cuda) for t in _planar_operands(rng, 64, 256)]
    x = torch.zeros((T, 256), dtype=torch.bfloat16, device=cuda)
    kerns = (PLANAR_MATMUL, PLANAR_MATMUL_MMA)

    def counted(fn, *a):
        before = [k.launches for k in kerns]
        fn(*a)
        return tuple(k.launches - b for k, b in zip(kerns, before))

    mma = int(tqm.planar_body(T) == "mma")
    assert counted(tqm.matmul_4bit_planar_stacked, wp, scales, x, 2) == (
        1, mma)
    assert counted(tqm.matmul_4bit_planar, wp[0], scales[0], x) == (1, mma)
    assert counted(tqm.matmul_4bit_planar_cuda_core, wp[0], scales[0],
                   x) == (1, 0)
    assert counted(tqm.matmul_4bit_planar_mma, wp[0], scales[0], x) == (0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 6, 7, 8])
@pytest.mark.parametrize("M,K", K5_TAIL_MK + [(256, 1024)])
def test_k6_matches_plain_on_card(cuda, rng, quant_type, scale_kind, x_dtype,
                                  B, M, K):
    """K6 on layer 2 of a stack within 1e-5 * max|y| of the plain version,
    on its ring's tails (token tiles cut short, row tails, K8 = 72 and
    576: a part step), and two launches give the same bits."""
    wp, scales = _planar_operands(rng, M, K, scale_kind=scale_kind)
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(
        np.float32)).to(x_dtype)
    ref = tgv.gemv_4bit_stacked(wp, scales, x, 2, quant_type)
    on = [t.to(cuda) for t in (wp, scales, x)]
    got = tgv.gemv_4bit_stacked(*on, 2, quant_type)
    again = tgv.gemv_4bit_stacked(*on, 2, quant_type)
    # fp32 throughout on both sides: summation order only
    _agree(got, ref)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


# The planar CUDA-core body's bits (K6 at T = 3 and 8, bf16 and fp32
# activations; K5's CUDA-core body at T = 1) at two shapes, FP4/NF4,
# fp32/bf16 scales, from default_rng(0) inputs: the first 16 hex digits of
# the SHA-256 of y.view(torch.int32).
PLANAR_GOLDEN_MK = [(256, 4096), (130, 4608)]
PLANAR_GOLDEN_CASES = [("k5", 1, "bf16"), ("k6", 3, "bf16"), ("k6", 3, "fp32"),
                       ("k6", 8, "bf16"), ("k6", 8, "fp32")]
PLANAR_GOLDEN = {
    "k5 T=1 x=bf16 [256,4096] fp4 fp32": "25e0069ef3f6400a",
    "k6 T=3 x=bf16 [256,4096] fp4 fp32": "f4bc71508fd00d47",
    "k6 T=3 x=fp32 [256,4096] fp4 fp32": "95c77990da9940f3",
    "k6 T=8 x=bf16 [256,4096] fp4 fp32": "ddcc76bf815e6cf1",
    "k6 T=8 x=fp32 [256,4096] fp4 fp32": "19b5fe8e5f73ed56",
    "k5 T=1 x=bf16 [256,4096] fp4 bf16": "25e0069ef3f6400a",
    "k6 T=3 x=bf16 [256,4096] fp4 bf16": "e9cc00aa6b3baef9",
    "k6 T=3 x=fp32 [256,4096] fp4 bf16": "78d4a9d744169773",
    "k6 T=8 x=bf16 [256,4096] fp4 bf16": "fd8469e9b2cdcfe4",
    "k6 T=8 x=fp32 [256,4096] fp4 bf16": "9f8bf5e2cf60f279",
    "k5 T=1 x=bf16 [256,4096] nf4 fp32": "0abafff3881b5fba",
    "k6 T=3 x=bf16 [256,4096] nf4 fp32": "0e84547fbf7e3e42",
    "k6 T=3 x=fp32 [256,4096] nf4 fp32": "f0ebb2e5d4a3cb06",
    "k6 T=8 x=bf16 [256,4096] nf4 fp32": "77ffd5b265917725",
    "k6 T=8 x=fp32 [256,4096] nf4 fp32": "d2edf49ed1f8911e",
    "k5 T=1 x=bf16 [256,4096] nf4 bf16": "0abafff3881b5fba",
    "k6 T=3 x=bf16 [256,4096] nf4 bf16": "7939065efdc3a5ab",
    "k6 T=3 x=fp32 [256,4096] nf4 bf16": "de30213d68fd1f4f",
    "k6 T=8 x=bf16 [256,4096] nf4 bf16": "19186ab0e23e5ef6",
    "k6 T=8 x=fp32 [256,4096] nf4 bf16": "8934fb4938a16516",
    "k5 T=1 x=bf16 [130,4608] fp4 fp32": "ff5d7d485e4033d3",
    "k6 T=3 x=bf16 [130,4608] fp4 fp32": "b2f38d348e4adcfc",
    "k6 T=3 x=fp32 [130,4608] fp4 fp32": "b32724504ba100a3",
    "k6 T=8 x=bf16 [130,4608] fp4 fp32": "dfc9b64e42c65745",
    "k6 T=8 x=fp32 [130,4608] fp4 fp32": "1a183747059de582",
    "k5 T=1 x=bf16 [130,4608] fp4 bf16": "ff5d7d485e4033d3",
    "k6 T=3 x=bf16 [130,4608] fp4 bf16": "654adb784007aab6",
    "k6 T=3 x=fp32 [130,4608] fp4 bf16": "1651d904d28bf8d3",
    "k6 T=8 x=bf16 [130,4608] fp4 bf16": "b8fbace18441cc78",
    "k6 T=8 x=fp32 [130,4608] fp4 bf16": "31bc816598e7e20b",
    "k5 T=1 x=bf16 [130,4608] nf4 fp32": "14e0ac2a903aa925",
    "k6 T=3 x=bf16 [130,4608] nf4 fp32": "7ba5f200693e971e",
    "k6 T=3 x=fp32 [130,4608] nf4 fp32": "e6d305166f6553a7",
    "k6 T=8 x=bf16 [130,4608] nf4 fp32": "eff5fbef22927502",
    "k6 T=8 x=fp32 [130,4608] nf4 fp32": "b02e9b3430648d92",
    "k5 T=1 x=bf16 [130,4608] nf4 bf16": "14e0ac2a903aa925",
    "k6 T=3 x=bf16 [130,4608] nf4 bf16": "7555f06841b9439d",
    "k6 T=3 x=fp32 [130,4608] nf4 bf16": "5957bd182a959761",
    "k6 T=8 x=bf16 [130,4608] nf4 bf16": "0c304ca3faba70fc",
    "k6 T=8 x=fp32 [130,4608] nf4 bf16": "ae359720e089c3e8"}


def planar_golden_digests(device):
    """{case: digest} of every PLANAR_GOLDEN case on ``device``. To record
    them anew on a card: ``python3 -c "import sys, json, torch;
    sys.path[:0] = ['.', 'tests']; import test_torch_guards as g;
    print(json.dumps(g.planar_golden_digests(torch.device('cuda')),
    indent=1))"``."""
    import hashlib

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    out = {}
    for M, K in PLANAR_GOLDEN_MK:
        rng = np.random.default_rng(0)
        wp, s32 = _planar_operands(rng, M, K, L=1)
        x = torch.from_numpy(rng.standard_normal((8, K)).astype(np.float32))
        wp, s32, x = wp[0].to(device), s32[0].to(device), x.to(device)
        for qt in ("fp4", "nf4"):
            for sk, s in (("fp32", s32), ("bf16", s32.to(torch.bfloat16))):
                for kern, T, xk in PLANAR_GOLDEN_CASES:
                    xt = x[:T].to(dtypes[xk])
                    y = (tqm.matmul_4bit_planar_cuda_core(wp, s, xt, qt)
                         if kern == "k5" else tgv.gemv_4bit(wp, s, xt, qt))
                    out[f"{kern} T={T} x={xk} [{M},{K}] {qt} {sk}"] = (
                        hashlib.sha256(y.view(torch.int32).cpu().numpy()
                                       .tobytes()).hexdigest()[:16])
    return out


@pytest.mark.cuda
def test_planar_cuda_core_golden_bits_on_card(cuda):
    """K6 and K5's CUDA-core body give the bits of the body at commit
    f995fc3 (before its ``cp.async`` ring), recorded on an H100 from that
    body: the ring changes when data arrives, not each lane's fp32
    order."""
    assert planar_golden_digests(cuda) == PLANAR_GOLDEN


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_k7_bit_exact_on_card(cuda, rng, quant_type, scale_kind, dtype):
    wp, scales = _planar_operands(rng, 33, 512, L=1, scale_kind=scale_kind)
    ref = tqz.dequantize_4bit_kernel(wp[0], scales[0], quant_type, dtype)
    got = tqz.dequantize_4bit_kernel(wp[0].to(cuda), scales[0].to(cuda),
                                     quant_type, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.cuda
def test_planar_bands_launch_their_kernels_on_card(cuda, rng):
    """A planar weight on the card reaches K5 or K6 through apply_4bit,
    Linear4bit and the bnb loader, and never a CPU path; at T = 48 K5
    runs its tensor-core body."""
    from quantizations_tpu_torch.nn.linear import Linear4bit
    from quantizations_tpu_torch.ops import (GEMV_4BIT, PLANAR_MATMUL,
                                             PLANAR_MATMUL_MMA)
    from quantizations_tpu_torch.quant.bnb_io import (bnb_flat_tensors,
                                                      load_bnb_linear4bit)

    W = torch.from_numpy((rng.standard_normal((96, 512)) * 0.1).astype(
        np.float32))
    lin = Linear4bit.create(W, bias=torch.ones(96), device=cuda)
    flat = bnb_flat_tensors("l", lin.weight.packed_u8(), lin.quant_state)
    flat["l.bias"] = np.ones(96, np.float32)
    loaded = load_bnb_linear4bit(flat.__getitem__, set(flat), "l",
                                 device=cuda)
    for T, kern in ((1, PLANAR_MATMUL), (3, GEMV_4BIT), (16, PLANAR_MATMUL),
                    (48, PLANAR_MATMUL)):
        x = torch.from_numpy(rng.standard_normal((T, 512)).astype(
            np.float32)).to(cuda)
        before, mma = kern.launches, PLANAR_MATMUL_MMA.launches
        y = lin(x)
        assert kern.launches == before + 1 and y.is_cuda
        assert PLANAR_MATMUL_MMA.launches == mma + (
            kern is PLANAR_MATMUL and tqm.planar_body(T) == "mma")
        if T == 48:
            assert PLANAR_MATMUL_MMA.launches == mma + 1
        assert torch.equal(loaded(x), y)
    y = lin(torch.zeros((100, 512), device=cuda))      # the dense band
    assert y.shape == (100, 96) and torch.isfinite(y).all()


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


def _decode_operands(rng, int8, blocks, KVH, page, D):
    shape = (3, blocks, KVH, page, D)
    if int8:
        k = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
        ks = torch.from_numpy(rng.uniform(0.005, 0.05, shape[:4]).astype(
            np.float32)).to(torch.bfloat16)
        vs = torch.from_numpy(rng.uniform(0.005, 0.05, shape[:4]).astype(
            np.float32)).to(torch.bfloat16)
        return k, v, ks, vs
    k = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
    return k, v, None, None


def _agree(got, ref):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # both read the same values in fp32: summation order only
    assert (got.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()


# (B, page, max_pages, lengths): one split (128 positions); many splits
# (B = 1, 1152 positions: 9 splits of 128, each boundary inside a
# 96-position page); and B = 3 over 1024 positions with short rows whose
# later splits see nothing
PAGED_LAYOUTS = {
    "one_split": (3, 32, 4, (1, 40, None)),
    "many_splits": (1, 96, 12, (None,)),
    "short_rows": (3, 128, 8, (1, 200, None)),
}


def _paged_operands(rng, int8, layout, q_span, G, D, KVH=2):
    """(q, k, v, ks, vs, table, lengths) for PAGED_LAYOUTS[layout]: each
    row's pages shuffled over the pool, page 0 in the unused entries;
    None in the lengths is the longest the table allows."""
    B, page, mp, lens = PAGED_LAYOUTS[layout]
    lens = [mp * page - q_span + 1 if n is None else n for n in lens]
    need = [-(-(n + q_span - 1) // page) for n in lens]
    P = 1 + sum(need)
    k, v, ks, vs = _decode_operands(rng, int8, P, KVH, page, D)
    perm = torch.from_numpy(rng.permutation(np.arange(1, P)).astype(np.int32))
    table = torch.zeros((B, mp), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at:at + n]
        at += n
    q = torch.from_numpy(rng.standard_normal((B, KVH, q_span * G, D)).astype(
        np.float32))
    return q, k, v, ks, vs, table, torch.tensor(lens, dtype=torch.int32)


def _paged(q, k, v, ks, vs, table, lengths, **kw):
    if ks is None:
        return tpa.paged_flash_decode_attention(q, k, v, table, 2, lengths,
                                                **kw)
    return tpa.paged_flash_decode_attention_i8(q, k, v, ks, vs, table, 2,
                                               lengths, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("q_span,G,window,softcap", [
    (1, 4, None, None), (1, 1, 7, 50.0), (3, 2, 2 ** 30, None),
    (4, 8, 20, 30.0), (8, 4, None, None), (8, 4, 150, 30.0)])
@pytest.mark.parametrize("layout", sorted(PAGED_LAYOUTS))
def test_k3_k4_paged_match_plain_on_card(cuda, rng, int8, D, q_span, G,
                                         window, softcap, layout):
    ops = _paged_operands(rng, int8, layout, q_span, G, D)
    kw = dict(softcap=softcap, window=window, q_span=q_span,
              pages_per_step=2)
    ref = _paged(*ops, **kw)
    got = _paged(*[None if t is None else t.to(cuda) for t in ops], **kw)
    _agree(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("attend_len,window,softcap,S", [
    (None, None, None, 320), (96, 7, 50.0, 320), (300, 2 ** 30, None, 320),
    (None, None, None, 1300), (1200, 40, 30.0, 1300)])
def test_k3_k4_slot_match_plain_on_card(cuda, rng, int8, attend_len, window,
                                        softcap, S):
    B, KVH, G, D = 3, 2, 4, 128
    k, v, ks, vs = _decode_operands(rng, int8, B, KVH, S, D)
    n = attend_len or S
    lengths = torch.tensor([1, 33, n], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, KVH, G, D)).astype(
        np.float32)).to(torch.bfloat16)
    kw = dict(attend_len=attend_len, softcap=softcap, window=window)
    on = [t.to(cuda) for t in (q, k, v)]
    if int8:
        ref = tat.flash_decode_attention_stacked_i8(q, k, v, ks, vs, 1,
                                                    lengths, **kw)
        got = tat.flash_decode_attention_stacked_i8(
            *on, ks.to(cuda), vs.to(cuda), 1, lengths.to(cuda), **kw)
    else:
        ref = tat.flash_decode_attention_stacked(q, k, v, 1, lengths, **kw)
        got = tat.flash_decode_attention_stacked(*on, 1, lengths.to(cuda),
                                                 **kw)
        # the unstacked form is the stacked one at L = 1
        ref1 = tat.flash_decode_attention(q, k[1], v[1], lengths,
                                          softcap=softcap, window=window)
        got1 = tat.flash_decode_attention(on[0], on[1][1].contiguous(),
                                          on[2][1].contiguous(),
                                          lengths.to(cuda), softcap=softcap,
                                          window=window)
        _agree(got1, ref1)
    _agree(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("split", [(1, 1152), (72, 16), (24, 48), (3, 400)])
@pytest.mark.parametrize("q_span", [1, 8])
def test_k3_k4_any_split_matches_plain_on_card(cuda, rng, int8, split,
                                               q_span):
    """Splits the rule never picks (one split over 1152 positions, chunks
    of one warp tile, of three, and not a multiple of the tile) at 4 and
    32 query rows (both row tiles, and K4's two warp counts)."""
    q, k, v, ks, vs, table, lengths = _paged_operands(
        rng, int8, "many_splits", q_span, 4, 128)
    ref = _paged(q, k, v, ks, vs, table, lengths, q_span=q_span)
    c = [None if t is None else t.to(cuda) for t in (q, k, v, ks, vs, table,
                                                     lengths)]
    got = tat.launch_decode(c[0], c[1][2], c[2][2], c[6], page=96, n_pos=0,
                            scale=128 ** -0.5, softcap=None, window=None,
                            q_span=q_span, table=c[5],
                            k_step=None if ks is None else c[3][2],
                            v_step=None if ks is None else c[4][2],
                            split=split)
    _agree(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layout", sorted(PAGED_LAYOUTS))
def test_k3_k4_launches_are_bit_identical_on_card(cuda, rng, int8, layout):
    """The splits are folded in a fixed order with no atomics: two
    launches on the same inputs give the same bits."""
    ops = [None if t is None else t.to(cuda)
           for t in _paged_operands(rng, int8, layout, 8, 4, 128)]
    kern = FLASH_DECODE_I8 if int8 else FLASH_DECODE
    before = kern.launches
    a = _paged(*ops, q_span=8)
    b = _paged(*ops, q_span=8)
    torch.cuda.synchronize()
    assert kern.launches == before + 2      # one count per wrapper call
    assert torch.equal(a, b)
    # the record keeps the grid launched: the rule's split, 4 row groups
    B, page, mp, _ = PAGED_LAYOUTS[layout]
    n_split, chunk = tat.decode_split(mp * page, B * 2 * 4)
    assert kern.last_grid == (n_split, chunk, B * 2 * 4 * n_split)


@pytest.mark.cuda
def test_k3_refuses_what_it_cannot_take_on_card(cuda):
    q = torch.zeros((1, 2, 4, 96), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 2, 16, 96), dtype=torch.bfloat16, device=cuda)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tat.flash_decode_attention(q, k, k, lengths)
    with pytest.raises(ValueError, match="int32"):
        tat.flash_decode_attention(q[..., :64].contiguous(),
                                   k[..., :64].contiguous(),
                                   k[..., :64].contiguous(), lengths.long())


@pytest.mark.cuda
def test_flash_and_int8_generate_on_card(cuda):
    """The tiny model generates through K3/K4 on the card: tokens in the
    vocabulary, and each kernel launched once per layer per decode
    step."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    for knobs in (dict(use_flash_attention=True),
                  dict(use_flash_attention=True, kv_cache_dtype="int8")):
        cfg = dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(
            quantize_embedding=True), **knobs)
        p = tl.fuse_projections(tl.init_llama_params(cfg, seed=1,
                                                     device=cuda))
        ids = torch.randint(0, cfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(0))
        gen = make_generate_fn(cfg, ServeConfig(max_seq_len=32,
                                                max_new_tokens=6))
        kern = (FLASH_DECODE_I8 if "kv_cache_dtype" in knobs
                else FLASH_DECODE)
        before = kern.launches
        toks, _ = gen(p, ids.to(cuda), tl.KVCache.create(cfg, 2, 32, cuda),
                      None)
        torch.cuda.synchronize()
        assert kern.launches - before == 5 * cfg.num_hidden_layers
        assert toks.shape == (2, 6)
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


def _random_pool(cfg, pages, page, gen):
    pool = tpg.PagedKVCache.create(cfg, pages, page, device="cpu")
    for t in pool.tensors():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
        else:
            t.copy_(torch.rand(t.shape, generator=gen) * (
                0.02 if t.dim() == 4 else 1.0))
    return pool


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_verify_window_on_card(cuda, kv):
    """One verify window of 8 tokens at 4 query heads per kv head (32
    query rows, Llama3-8B's q_span x G) over a pool of random pages, row
    0's window across a page boundary: K3 (K4 over an int8 pool) launched
    once per layer, the logits within 2e-2 * max|logit| of the CPU's plain
    path on the same parameters and pool, the positions outside the
    windows untouched, and the window write bit-equal to the CPU's on the
    same rows. A window of 9 (36 query rows) raises before any launch."""
    cfg = dataclasses.replace(tl.TINY_LLAMA, num_key_value_heads=2,
                              kv_cache_dtype=kv, quant=QuantConfig(
                                  quantize_embedding=True))
    p = tl.fuse_projections(tl.init_llama_params(cfg, seed=1, device=cuda))
    pc = tl.map_tensors(lambda t: t.cpu(), p)
    gen = torch.Generator().manual_seed(0)
    pool_c = _random_pool(cfg, 8, 16, gen)
    before_pool = [t.clone() for t in pool_c.tensors()]
    pool_g = tpg.PagedKVCache(*[t.to(cuda) for t in pool_c.tensors()])
    table = torch.tensor([[3, 6, 0, 0], [5, 0, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([12, 3])
    feed = torch.randint(1, cfg.vocab_size, (2, 8), generator=gen)
    kern = FLASH_DECODE_I8 if kv == "int8" else FLASH_DECODE
    before = kern.launches
    lg, pool_g = tpg.paged_verify_step(p, feed.to(cuda), pool_g,
                                       table.to(cuda), pos.to(cuda), cfg, 2)
    torch.cuda.synchronize()
    assert kern.launches - before == cfg.num_hidden_layers
    assert kern.last_grid[2] > 0
    lc, pool_c = tpg.paged_verify_step(pc, feed, pool_c, table, pos, cfg, 2)
    assert lg.shape == (2, 8, cfg.vocab_size) and torch.isfinite(lg).all()
    assert (lg.cpu() - lc).abs().max() <= 2e-2 * lc.abs().max()
    written = torch.zeros((8, 16), dtype=torch.bool)      # [pages, page]
    for b in range(2):
        for q in range(int(pos[b]), int(pos[b]) + 8):
            written[table[b, q // 16], q % 16] = True
    for g_, c_, b_ in zip(pool_g.tensors(), pool_c.tensors(), before_pool):
        keep = ~written[None, :, None, :].expand(b_.shape[:4])
        assert torch.equal(g_.cpu()[keep], b_[keep])
        assert torch.equal(c_[keep], b_[keep])
    # the window write alone: the same rows, the same bits
    k = torch.randn((2, 8, 2, 64), generator=gen)
    v = torch.randn((2, 8, 2, 64), generator=gen)
    page_of = torch.tensor([[3] * 4 + [6] * 4, [5] * 8])
    off = torch.tensor([list(range(12, 16)) + list(range(4)),
                        list(range(3, 11))])
    tpg.write_window(pool_g, 1, page_of.to(cuda), off.to(cuda), k.to(cuda),
                     v.to(cuda))
    tpg.write_window(pool_c, 1, page_of, off, k, v)
    torch.cuda.synchronize()
    for g_, c_ in zip(pool_g.tensors(), pool_c.tensors()):
        assert torch.equal(g_[1].cpu(), c_[1])
    k1, k3 = PAIR_MATMUL.launches, kern.launches
    with pytest.raises(ValueError, match="query rows"):
        tpg.paged_verify_step(p, torch.zeros((2, 9), dtype=torch.int32,
                                             device=cuda), pool_g,
                              table.to(cuda), pos.to(cuda), cfg, 2)
    assert (PAIR_MATMUL.launches, kern.launches) == (k1, k3)


def _pair_operands(rng, M, K, L=3, scale_kind="fp32"):
    wp2 = torch.from_numpy(rng.integers(-2**31, 2**31, (L, M // 2, K // 4),
                                        dtype=np.int64).astype(np.int32))
    scales = torch.from_numpy(
        (rng.random((L, M, K // 64)) * 0.05 + 0.01).astype(np.float32))
    if scale_kind == "bf16":
        scales = scales.to(torch.bfloat16)
    elif scale_kind == "bf16x2":
        scales = tqm.pack_scale_pairs(scales)
    return wp2, scales


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("T,M,K", [(8, 256, 512), (40, 130, 576),
                                   (100, 384, 1024), (1, 256, 512)])
def test_k8_matches_plain_on_card(cuda, rng, quant_type, scale_kind, T, M,
                                  K):
    """K8 (tensor cores) against its plain version and K1, stacked at
    layer 1 and unstacked; masked token and row tails (T 40 and 100 are
    not tile multiples, M 130 is not a multiple of 128)."""
    wp2, scales = _pair_operands(rng, M, K, scale_kind=scale_kind)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(
        np.float32)).to(torch.bfloat16)
    ref = tqm.matmul_4bit_pair_prefill_stacked(wp2, scales, x, 1, quant_type)
    on = [t.to(cuda) for t in (wp2, scales, x)]
    before = PAIR_PREFILL.launches
    got = tqm.matmul_4bit_pair_prefill_stacked(*on, 1, quant_type)
    assert PAIR_PREFILL.launches == before + 1
    _agree(got, ref)
    _agree(tqm.matmul_4bit_pair_prefill(on[0][1], on[1][1], on[2],
                                        quant_type), ref)
    k1 = tqm.matmul_4bit_pair_stacked(*on, 1, quant_type)
    torch.cuda.synchronize()
    assert (got - k1).abs().max() <= 1e-5 * k1.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("T", PAIR_TAIL_T)
@pytest.mark.parametrize("M,K", PAIR_TAIL_MK)
def test_k9_equals_k1_on_card(cuda, rng, quant_type, scale_kind, T, M, K):
    """K9 is K1 bit for bit, with 16-byte (K 512, 4608) and 4-byte (K 576,
    an odd number of scale blocks) word copies, on the tails of
    ``PAIR_TAIL_T`` and ``PAIR_TAIL_MK``, and within 1e-5 * max|y| of the
    plain version."""
    wp2, scales = _pair_operands(rng, M, K, scale_kind=scale_kind)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(
        np.float32)).to(torch.bfloat16)
    on = [t.to(cuda) for t in (wp2, scales, x)]
    before = PAIR_MANUAL.launches
    got = tqm.matmul_4bit_pair_manual_stacked(*on, 2, quant_type)
    assert PAIR_MANUAL.launches == before + 1
    k1 = tqm.matmul_4bit_pair_stacked(*on, 2, quant_type)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), k1.view(torch.int32))
    assert torch.equal(tqm.matmul_4bit_pair_manual(
        on[0][0], on[1][0], on[2], quant_type).view(torch.int32),
        tqm.matmul_4bit_pair(on[0][0], on[1][0], on[2],
                             quant_type).view(torch.int32))
    _agree(got, tqm.matmul_4bit_pair_manual_stacked(wp2, scales, x, 2,
                                                    quant_type))


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("T", [129, 200, 256])
@pytest.mark.parametrize("M,K", [(256, 512), (130, 576)])
def test_k1_tensor_core_body_on_card(cuda, rng, quant_type, scale_kind, T,
                                     M, K):
    """Above 128 rows K1 runs its tensor-core body: within 1e-5 * max|y|
    of its plain version and of its CUDA-core body, and K8 bit for bit
    (one body, one tile rule). Token tails at T 129 and 200, row tails at
    M 130 (65 row pairs), an odd count of scale blocks at K 576."""
    wp2, scales = _pair_operands(rng, M, K, scale_kind=scale_kind)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(
        np.float32)).to(torch.bfloat16)
    ref = tqm.matmul_4bit_pair_stacked(wp2, scales, x, 1, quant_type)
    on = [t.to(cuda) for t in (wp2, scales, x)]
    got = tqm.matmul_4bit_pair_stacked(*on, 1, quant_type)
    _agree(got, ref)
    cc = tqm.matmul_4bit_pair_cuda_core(on[0][1], on[1][1], on[2],
                                        quant_type)
    k8 = tqm.matmul_4bit_pair_prefill_stacked(*on, 1, quant_type)
    torch.cuda.synchronize()
    assert (got - cc).abs().max() <= 1e-5 * cc.abs().max()
    assert torch.equal(got.view(torch.int32), k8.view(torch.int32))
    _agree(tqm.matmul_4bit_pair(on[0][1], on[1][1], on[2], quant_type), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("T,bodies", [(1, (1, 0)), (128, (1, 0)),
                                      (129, (1, 1)), (300, (1, 1))])
def test_k1_counts_each_body_on_card(cuda, rng, T, bodies):
    """``PAIR_MATMUL`` counts every K1 launch, ``PAIR_MATMUL_MMA`` those
    of the tensor-core body; a direct launch of either body counts in its
    own record only, and K8 in ``PAIR_PREFILL`` only."""
    from quantizations_tpu_torch.ops import PAIR_MATMUL, PAIR_MATMUL_MMA

    wp2, scales = [t.to(cuda) for t in _pair_operands(rng, 64, 256)]
    x = torch.zeros((T, 256), dtype=torch.bfloat16, device=cuda)
    kerns = (PAIR_MATMUL, PAIR_MATMUL_MMA, PAIR_PREFILL)

    def counted(fn, *a):
        before = [k.launches for k in kerns]
        fn(*a)
        return tuple(k.launches - b for k, b in zip(kerns, before))

    assert counted(tqm.matmul_4bit_pair_stacked, wp2, scales, x, 2) == (
        bodies + (0,))
    assert counted(tqm.matmul_4bit_pair, wp2[0], scales[0], x) == (
        bodies + (0,))
    assert counted(tqm.matmul_4bit_pair_cuda_core, wp2[0], scales[0],
                   x) == (1, 0, 0)
    assert counted(tqm.matmul_4bit_pair_mma, wp2[0], scales[0], x) == (
        0, 1, 0)
    assert counted(tqm.matmul_4bit_pair_prefill, wp2[0], scales[0], x) == (
        0, 0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", [tqm.matmul_4bit_pair_prefill,
                                tqm.matmul_4bit_pair_manual],
                         ids=["k8", "k9"])
def test_k8_k9_refuse_what_they_cannot_take_on_card(cuda, fn):
    wp2 = torch.zeros((64, 128), dtype=torch.int32, device=cuda)
    s = torch.ones((128, 8), device=cuda)
    x = torch.zeros((4, 512), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        fn(wp2, s, x.float())                          # wrong dtype
    with pytest.raises(ValueError, match="x must be"):
        fn(wp2, s, x[:, :256])                         # wrong width
    with pytest.raises(ValueError, match="scales shape"):
        fn(wp2, s[:64], x)
    with pytest.raises(ValueError, match="int32"):
        fn(wp2.float(), s, x)
    with pytest.raises(ValueError, match="contiguous"):
        fn(wp2, s.t().contiguous().t(), x)             # non-contiguous
    with pytest.raises(ValueError, match="multiple of 64"):
        fn(wp2[:, :120].contiguous(), s, x[:, :480].contiguous())
    with pytest.raises(ValueError, match="same CUDA device"):
        fn(wp2.cpu(), s, x)


@pytest.mark.cuda
def test_pair_variants_route_on_card(cuda, monkeypatch):
    """The tiny model on the card: ``pair_pipeline="manual"`` generates
    the grid run's tokens with K9 launches and no K1 launch on its
    stacked projections; ``QT_PREFILL_PAIR=1`` with the K1 band lowered
    to 8 rows launches K8 on the prompt; ``dense_twin`` launches
    neither."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.ops import PAIR_MATMUL
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    base = dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(
        quantize_embedding=True))
    p = tl.fuse_projections(tl.init_llama_params(base, seed=1, device=cuda))
    ids = torch.randint(0, base.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    serve = ServeConfig(max_seq_len=32, max_new_tokens=6)

    def run(cfg):
        counts = [k.launches for k in (PAIR_MATMUL, PAIR_MANUAL,
                                       PAIR_PREFILL)]
        toks, _ = make_generate_fn(cfg, serve)(
            p, ids, tl.KVCache.create(cfg, 2, 32, cuda), None)
        torch.cuda.synchronize()
        return toks.cpu(), [k.launches - c for k, c in zip(
            (PAIR_MATMUL, PAIR_MANUAL, PAIR_PREFILL), counts)]

    grid, n = run(base)
    assert n == [6 * 9, 0, 0]
    manual, n = run(dataclasses.replace(base, quant=QuantConfig(
        quantize_embedding=True, pair_pipeline="manual")))
    assert torch.equal(manual, grid) and n == [0, 6 * 9, 0]
    monkeypatch.setenv("QT_PREFILL_PAIR", "1")
    monkeypatch.setenv("QT_PAIR_MAX_TOKENS", "8")
    _, n = run(base)
    assert n == [5 * 9 + 1, 0, 8]
    monkeypatch.delenv("QT_PREFILL_PAIR")
    _, n = run(dataclasses.replace(base, quant=QuantConfig(
        quantize_embedding=True, dense_twin=True)))
    assert n == [0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("M,K", [(256, 512), (18, 576), (4, 4096)])
def test_k10_bit_exact_on_card(cuda, rng, quant_type, scale_kind, dtype, M,
                               K):
    """K10 against its plain version, bit for bit, stacked at layer 1 and
    unstacked (K 576: 9 blocks a row, an odd shared-memory stride)."""
    from quantizations_tpu_torch.ops import DEQUANTIZE_4BIT_PAIR

    wp2, scales = _pair_operands(rng, M, K, scale_kind=scale_kind)
    ref = tqz.dequantize_4bit_pair(wp2, scales, quant_type, dtype, 1)
    on = [t.to(cuda) for t in (wp2, scales)]
    before = DEQUANTIZE_4BIT_PAIR.launches
    got = tqz.dequantize_4bit_pair(*on, quant_type, dtype, 1)
    alone = tqz.dequantize_4bit_pair(on[0][1], on[1][1], quant_type, dtype)
    torch.cuda.synchronize()
    assert DEQUANTIZE_4BIT_PAIR.launches == before + 2
    assert got.dtype == dtype and got.shape == (M, K)
    for y in (got, alone):
        assert torch.equal(y.cpu().view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16x2"])
@pytest.mark.parametrize("T", [9, 300])
def test_dense_pair_band_on_card(cuda, rng, quant_type, scale_kind, T):
    """The dense pair band on the card (K10, then bf16 products with fp32
    output over K = 4608: two 2048-column chunks and a 512-column tail)
    within 1e-5 * max|y| of its fp32 plain version on the same card: the
    same bf16 values, fp32 summation order only."""
    from quantizations_tpu_torch.nn import linear as tlin
    from quantizations_tpu_torch.ops import DEQUANTIZE_4BIT_PAIR

    wp2, scales = [t.to(cuda) for t in _pair_operands(
        rng, 256, 4608, L=1, scale_kind=scale_kind)]
    x = torch.from_numpy(rng.standard_normal((T, 4608)).astype(
        np.float32)).to(cuda)
    before = DEQUANTIZE_4BIT_PAIR.launches
    got = tlin.dense_matmul_pair(x, wp2[0], scales[0], quant_type)
    assert DEQUANTIZE_4BIT_PAIR.launches == before + 1
    ref = tlin.dense_matmul_pair_plain(x, wp2[0], scales[0], quant_type)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (T, 256)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_planar_dense_band_on_card(cuda, rng, quant_type):
    """Above the planar kernel bands: K7, then the bf16 product with fp32
    output, within 1e-5 * max|y| of the fp32 product of the same
    values."""
    from quantizations_tpu_torch.nn import linear as tlin
    from quantizations_tpu_torch.ops import DEQUANTIZE_4BIT

    wp, scales = [t.to(cuda) for t in _planar_operands(rng, 96, 2560, L=1)]
    x = torch.from_numpy(rng.standard_normal((100, 2560)).astype(
        np.float32)).to(cuda)
    before = DEQUANTIZE_4BIT.launches
    got = tlin.apply_4bit(x, wp[0], scales[0], quant_type)
    assert DEQUANTIZE_4BIT.launches == before + 1
    W = tqz.dequantize_4bit_kernel(wp[0], scales[0], quant_type,
                                   torch.bfloat16)
    ref = x.to(torch.bfloat16).float() @ W.float().T
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["pair", "planar"])
def test_dense_twin_on_card(cuda, rng, layout):
    """``dense_twin`` on the card: K10 (pair) or K7 (planar) and the bf16
    product, within 1e-5 * max|y| of the plain twin (``dense_weight``
    and an fp32 product) at layer 1 of a stack."""
    from quantizations_tpu_torch.nn.linear import dense_weight
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT,
                                             DEQUANTIZE_4BIT_PAIR)

    ops = (_pair_operands(rng, 256, 512) if layout == "pair"
           else _planar_operands(rng, 256, 512))
    lin = tl.QLinear(wp=ops[0].to(cuda), scales=ops[1].to(cuda))
    qcfg = QuantConfig(dense_twin=True)
    x = torch.from_numpy(rng.standard_normal((5, 512)).astype(
        np.float32)).to(cuda)
    kern = DEQUANTIZE_4BIT_PAIR if layout == "pair" else DEQUANTIZE_4BIT
    before = kern.launches
    got = tl._ql(x, lin, qcfg, 1)
    assert kern.launches == before + 1
    W = dense_weight(lin.wp[1], lin.scales[1], "fp4", layout)
    ref = x.to(torch.bfloat16).float() @ W.float().T
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_tiny_prefill_reaches_k10_on_card(cuda, monkeypatch):
    """With the K1 band lowered to 8 rows, a 2 x 12-token prefill of the
    tiny model runs every projection and the lm_head on the dense pair
    band: exactly 4 * 2 + 1 K10 launches, logits within 2e-2 * max|logit|
    of the CPU's plain path (bf16 attention operands on the card), and
    the same greedy next tokens (seed 4: top-2 margins of 12% and 7% of
    max|logit| on the CPU)."""
    from quantizations_tpu_torch.ops import DEQUANTIZE_4BIT_PAIR

    monkeypatch.setenv("QT_PAIR_MAX_TOKENS", "8")
    cfg = dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(
        quantize_embedding=True))
    p = tl.fuse_projections(tl.init_llama_params(cfg, seed=1, device=cuda))
    pc = tl.map_tensors(lambda t: t.cpu(), p)
    ids = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(4))
    before = DEQUANTIZE_4BIT_PAIR.launches
    lg, _ = tl.prefill(p, ids.to(cuda), tl.KVCache.create(cfg, 2, 32, cuda),
                       cfg)
    torch.cuda.synchronize()
    assert DEQUANTIZE_4BIT_PAIR.launches == before + 4 * 2 + 1
    lc, _ = tl.prefill(pc, ids, tl.KVCache.create(cfg, 2, 32, "cpu"), cfg)
    assert (lg.cpu() - lc).abs().max() <= 2e-2 * lc.abs().max()
    assert torch.equal(lg[:, -1].argmax(-1).cpu(), lc[:, -1].argmax(-1))


def _write_tiny_hf(d, rng, layers=2, h=128, inter=256, vocab=256):
    """A tiny bf16 HF Llama directory written by the port's own writer
    (the card's machine has no safetensors package); returns its
    tensors."""
    import json

    from quantizations_tpu_torch.models.safetensors_io import save_file

    hd, heads, kv = 64, 2, 1
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "vocab_size": vocab,
        "hidden_size": h, "intermediate_size": inter,
        "num_hidden_layers": layers, "num_attention_heads": heads,
        "num_key_value_heads": kv, "head_dim": hd}))

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.02).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": w(vocab, h),
         "model.norm.weight": torch.ones(h, dtype=torch.bfloat16),
         "lm_head.weight": w(vocab, h)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = torch.ones(h, dtype=torch.bfloat16)
        t[p + "post_attention_layernorm.weight"] = torch.ones(
            h, dtype=torch.bfloat16)
        for name, shape in (("self_attn.q_proj", (heads * hd, h)),
                            ("self_attn.k_proj", (kv * hd, h)),
                            ("self_attn.v_proj", (kv * hd, h)),
                            ("self_attn.o_proj", (h, heads * hd)),
                            ("mlp.gate_proj", (inter, h)),
                            ("mlp.up_proj", (inter, h)),
                            ("mlp.down_proj", (h, inter))):
            t[p + name + ".weight"] = w(*shape)
    save_file(t, str(d / "model.safetensors"))
    return t


_PROJ = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
         ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
         ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
         ("down", "mlp.down_proj"))


@pytest.mark.cuda
def test_hf_load_and_bnb_export_on_card(cuda, rng, tmp_path):
    """A tiny HF directory loaded on the card: 7 K2 launches a layer and
    one each for the embedding and the lm_head, every projection's words
    and scales ``torch.equal`` to ``quantize_linear`` of the same weight
    on the card. Its bnb export (without double quantization) runs K10 on
    the 4-bit embedding and lm_head and reloads to the same words and
    scales; the native file reloads equal."""
    from quantizations_tpu_torch.models import hf_loader as th
    from quantizations_tpu_torch.ops import DEQUANTIZE_4BIT_PAIR

    src = tmp_path / "hf"
    src.mkdir()
    t = _write_tiny_hf(src, rng)
    q = QuantConfig(quantize_embedding=True)
    before = QUANTIZE_4BIT.launches
    cfg, params = th.load_hf_llama(str(src), quant=q, device=cuda)
    torch.cuda.synchronize()
    assert QUANTIZE_4BIT.launches - before == 7 * cfg.num_hidden_layers + 2

    def ref(name):
        return tl.quantize_linear(t[name].to(cuda), quant_type="fp4")

    for i in range(cfg.num_hidden_layers):
        for attr, hf in _PROJ:
            got, want = getattr(params.layers, attr), ref(
                f"model.layers.{i}.{hf}.weight")
            assert torch.equal(got.wp[i], want.wp), (i, attr)
            assert torch.equal(got.scales[i], want.scales), (i, attr)
    for got, name in ((params.embed, "model.embed_tokens.weight"),
                      (params.lm_head, "lm_head.weight")):
        want = ref(name)
        assert torch.equal(got.wp, want.wp) and torch.equal(
            got.scales, want.scales), name

    before = DEQUANTIZE_4BIT_PAIR.launches
    th.save_bnb_checkpoint(params, cfg, str(tmp_path / "bnb"),
                           compress_statistics=False)
    assert DEQUANTIZE_4BIT_PAIR.launches - before == 2
    _, back = th.load_hf_llama(str(tmp_path / "bnb"), quant=q, device=cuda)
    for attr, _ in _PROJ:
        a, b = getattr(params.layers, attr), getattr(back.layers, attr)
        assert torch.equal(a.wp, b.wp) and torch.equal(a.scales, b.scales), \
            attr
    th.save_quantized(params, str(tmp_path / "q.safetensors"))
    native = th.load_quantized(str(tmp_path / "q.safetensors"), cfg,
                               device=cuda)
    for (k, a), (_, b) in zip(tl.named_tensors(params),
                              tl.named_tensors(native)):
        assert torch.equal(a, b), k
