"""K1's three bodies: their routing on the CPU.

- :func:`pair_body` sends K1 below ``PAIR_SPLITK_MIN_TOKENS`` rows to its
  CUDA-core body, from there up to 128 rows to its split-K tensor-core
  body, and from ``PAIR_MMA_MIN_TOKENS`` = 129 on to the tensor-core body
  it shares with K8. K9 picks its body by the same rule, so it stays
  K1's bits at every row count.
- :func:`pair_mma_tiles`, the body's tile rule, is a pure function of
  the row count: 128-token tiles from 128 rows on, and 64-row tiles (the
  fastest measured on the card at 128-512 rows), with grids that cover
  ragged T and M.
- Every body computes K1's function: their plain versions (the CUDA-core
  body's in pair column order, the split-K and the tensor-core body's in
  original order) against the JAX package's pair kernel in interpret
  mode, within 1e-5 * max|y| (fp32 summation order only). The kernels
  themselves run on the card (``tests/test_torch_guards.py``, ``cuda``
  marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.ops import qmatmul as jqm
from quantizations_tpu_torch.ops import qmatmul as tqm

torch.set_num_threads(1)

M, K = 256, 512
# (T, M) of the main path's projections above 128 rows: an admission
# chunk (256), a prefill chunk of K8 (512) and ragged counts
LAYER_M = (6144, 4096, 28672, 4096, 6142)


SWITCH = tqm.PAIR_SPLITK_MIN_TOKENS


@pytest.mark.parametrize("T", sorted({1, SWITCH - 1, SWITCH, 16, 64, 128,
                                      129, 256} - {0}))
def test_pair_body_switches_above_128_rows(T):
    want = ("cuda_core" if T < SWITCH else "splitk" if T <= 128
            else "mma")
    assert tqm.pair_body(T) == want
    assert tqm.PAIR_MMA_MIN_TOKENS == 129
    # the split-K body's switch is the crossover measured on the card at 1
    # to 4 rows (chip_smoke.py phase_body_time)
    assert 1 <= SWITCH <= 4


def _routed(monkeypatch, wp2, s, x, kernel, entry):
    """The body that ``_launch_k1`` launches for ``x``'s rows, counted in
    ``kernel`` (K1's or K9's record), with each body's launch replaced by
    a stub that counts in that body's record as its launch does. Returns
    (body, launches added to kernel, to the split-K record, to the
    tensor-core record)."""
    from quantizations_tpu_torch.ops import (PAIR_MATMUL_MMA,
                                             PAIR_MATMUL_SPLITK)

    called = []

    def launch_pair(wp2_, s_, x_, qt, kern, ent, tiles=()):
        called.append(("cuda_core", kern.name, ent))
        kern.launches += 1
        return "y"

    def stub(body, kern):
        def fn(*a):
            called.append((body,))
            kern.launches += 1
            return "y"
        return fn

    monkeypatch.setattr(tqm, "_launch_pair", launch_pair)
    monkeypatch.setattr(tqm, "matmul_4bit_pair_splitk",
                        stub("splitk", PAIR_MATMUL_SPLITK))
    monkeypatch.setattr(tqm, "matmul_4bit_pair_mma",
                        stub("mma", PAIR_MATMUL_MMA))
    kerns = (kernel, PAIR_MATMUL_SPLITK, PAIR_MATMUL_MMA)
    before = [k.launches for k in kerns]
    assert tqm._launch_k1(wp2, s, x, "fp4", kernel, entry) == "y"
    assert len(called) == 1
    if called[0][0] == "cuda_core":
        # the CUDA-core body under the record's own entry point
        assert called[0][1:] == (kernel.name, entry)
    return (called[0][0],) + tuple(k.launches - b
                                   for k, b in zip(kerns, before))


def test_switch_lies_above_every_k9_row_count(monkeypatch):
    """K9 and K1 pick the same body at every T of 1-256, so K9 stays K1
    bit for bit on either side of both switches (K9 is taken or compared
    at up to 128 rows: ``chip_smoke.py K9_TOKENS``)."""
    from quantizations_tpu_torch.ops import PAIR_MANUAL, PAIR_MATMUL

    w = torch.zeros((4, 16), dtype=torch.int32)
    s = torch.ones((8, 1))
    for T in range(1, 257):
        x = torch.zeros((T, 64), dtype=torch.bfloat16)
        k1 = _routed(monkeypatch, w, s, x, PAIR_MATMUL, "qt_pair_matmul")
        k9 = _routed(monkeypatch, w, s, x, PAIR_MANUAL, "qt_pair_manual")
        assert k1 == k9 and k1[0] == tqm.pair_body(T)


@pytest.mark.parametrize("T", [1, 2, 3, 4, 8, 16, 64, 100, 128, 129, 256])
def test_pair_body_routing(rng, monkeypatch, T):
    """``_launch_k1`` (K1's dispatch and K9's) launches the body that
    ``pair_body`` names and counts every launch in ``PAIR_MATMUL`` (K9's
    in ``PAIR_MANUAL``), the split-K body's also in
    ``PAIR_MATMUL_SPLITK``, the tensor-core body's in ``PAIR_MATMUL_MMA``;
    on a CPU tensor each body's wrapper returns its plain version."""
    from quantizations_tpu_torch.ops import PAIR_MANUAL, PAIR_MATMUL

    body = tqm.pair_body(T)
    wp2, _, ts = _operands(rng, "bf16x2")
    w = torch.from_numpy(wp2)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(
        np.float32)).to(torch.bfloat16)
    plain = tqm.matmul_4bit_pair_plain(w, ts, x, "nf4")
    original = tqm.matmul_4bit_pair_prefill_plain(w, ts, x, "nf4")
    assert torch.equal(tqm.matmul_4bit_pair_cuda_core(w, ts, x, "nf4"),
                       plain)
    for fn in (tqm.matmul_4bit_pair_splitk, tqm.matmul_4bit_pair_mma):
        assert torch.equal(fn(w, ts, x, "nf4"), original)
    for fn in (tqm.matmul_4bit_pair, tqm.matmul_4bit_pair_manual):
        assert torch.equal(fn(w, ts, x, "nf4"), plain)
    for kern, entry in ((PAIR_MATMUL, "qt_pair_matmul"),
                        (PAIR_MANUAL, "qt_pair_manual")):
        assert _routed(monkeypatch, w, ts, x, kern, entry) == (
            body, 1, int(body == "splitk"), int(body == "mma"))


def test_tile_rule_at_an_admission_chunk():
    """T = 256 on o (M = 4096): 128-token tiles and 64-row tiles, 2 x 64
    = 128 blocks of 8 warps for the 132 SMs (the fastest row tile there,
    measured against 32 rows' 256 blocks of 4 warps)."""
    bm, bn = tqm.pair_mma_tiles(256)
    assert (bm, bn) == (64, 128)
    assert -(-256 // bn) * -(-4096 // bm) == 128


@pytest.mark.parametrize("T", [1, 8, 100, 127, 128, 129, 200, 256, 512,
                               1000])
@pytest.mark.parametrize("Mp", LAYER_M + (130, 18))
def test_tile_rule_covers_ragged_shapes(T, Mp):
    """Any T and even M: bn is 128 from 128 rows on, else 64, and bm 64,
    a whole number of row pairs; the grid covers every row and token and
    leaves no tile empty."""
    bm, bn = tqm.pair_mma_tiles(T)
    assert bn == (128 if T >= 128 else 64) and bm == 64
    gt, gm = -(-T // bn), -(-Mp // bm)
    assert gt * bn >= T > (gt - 1) * bn
    assert gm * bm >= Mp > (gm - 1) * bm


def _operands(rng, scale_kind):
    wp2 = rng.integers(-2**31, 2**31, (M // 2, K // 4),
                       dtype=np.int64).astype(np.int32)
    scales = (rng.random((M, K // 64)) * 0.05 + 0.01).astype(np.float32)
    js, ts = jnp.asarray(scales), torch.from_numpy(scales)
    if scale_kind == "bf16":
        js, ts = js.astype(jnp.bfloat16), ts.to(torch.bfloat16)
    elif scale_kind == "bf16x2":
        js = jqm.pack_scale_pairs(js)
        ts = torch.from_numpy(np.asarray(js))
    return wp2, js, ts


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("T", [129, 200])
def test_both_bodies_plain_versions_match_pallas_above_128_rows(
        rng, quant_type, scale_kind, T):
    wp2, js, ts = _operands(rng, scale_kind)
    x = rng.standard_normal((T, K)).astype(np.float32)
    # the JAX side on rows padded with zeros to a multiple of 8: a row tile
    # of 1 would let XLA fuse away the bf16 weight rounding on the CPU
    pad = np.zeros((-(-T // 8) * 8, K), np.float32)
    pad[:T] = x
    xj = jnp.asarray(pad).astype(jnp.bfloat16)
    ref = np.asarray(jqm.matmul_4bit_pair_pallas(
        jnp.asarray(wp2), js, xj, quant_type=quant_type,
        interpret=True))[:T]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tol = 1e-5 * np.abs(ref).max()
    k1 = tqm.matmul_4bit_pair(torch.from_numpy(wp2), ts, xt, quant_type)
    k8 = tqm.matmul_4bit_pair_prefill(torch.from_numpy(wp2), ts, xt,
                                      quant_type)
    assert k1.shape == k8.shape == (T, M)
    assert np.abs(k1.numpy() - ref).max() <= tol
    assert np.abs(k8.numpy() - ref).max() <= tol
    # each body's own wrapper: on a CPU tensor, that body's plain version
    w = torch.from_numpy(wp2)
    assert torch.equal(tqm.matmul_4bit_pair_cuda_core(w, ts, xt, quant_type),
                       k1)
    assert torch.equal(tqm.matmul_4bit_pair_mma(w, ts, xt, quant_type), k8)


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("T", [4, 16, 32, 64, 128])
def test_splitk_plain_matches_pallas(rng, quant_type, scale_kind, T):
    """The split-K body's plain version (``matmul_4bit_pair_splitk`` on a
    CPU tensor: K1's weights in original column order) against the JAX
    package's pair kernel in interpret mode, rows padded to 8, within
    1e-5 * max|y|; K1's own plain version agrees as closely."""
    wp2, js, ts = _operands(rng, scale_kind)
    x = rng.standard_normal((T, K)).astype(np.float32)
    pad = np.zeros((-(-T // 8) * 8, K), np.float32)
    pad[:T] = x
    xj = jnp.asarray(pad).astype(jnp.bfloat16)
    ref = np.asarray(jqm.matmul_4bit_pair_pallas(
        jnp.asarray(wp2), js, xj, quant_type=quant_type,
        interpret=True))[:T]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tol = 1e-5 * np.abs(ref).max()
    w = torch.from_numpy(wp2)
    got = tqm.matmul_4bit_pair_splitk(w, ts, xt, quant_type)
    assert got.dtype == torch.float32 and got.shape == (T, M)
    assert np.abs(got.numpy() - ref).max() <= tol
    assert np.abs(tqm.matmul_4bit_pair(w, ts, xt, quant_type).numpy()
                  - ref).max() <= tol
