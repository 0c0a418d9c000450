"""K1 above 128 token rows: the tensor-core body's routing on the CPU.

- :func:`pair_body` sends up to 128 rows to K1's CUDA-core body and from
  ``PAIR_MMA_MIN_TOKENS`` = 129 on to the tensor-core body it shares with
  K8: above every row count at which K9 is taken or held bit-identical to
  K1 (at most 128), so those identities keep their meaning.
- :func:`pair_mma_tiles`, the body's tile rule, is a pure function of
  the row count: 128-token tiles from 128 rows on, and 64-row tiles (the
  fastest measured on the card at 128-512 rows), with grids that cover
  ragged T and M.
- At those row counts both bodies compute K1's function: their plain
  versions (K1's in pair column order, K8's in original order) against
  the JAX package's pair kernel in interpret mode, within 1e-5 * max|y|
  (fp32 summation order only). The kernels themselves run on the card
  (``tests/test_torch_guards.py``, ``cuda`` marker).
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


@pytest.mark.parametrize("T,body", [(1, "cuda_core"), (16, "cuda_core"),
                                    (128, "cuda_core"), (129, "mma"),
                                    (256, "mma"), (4096, "mma")])
def test_pair_body_switches_above_128_rows(T, body):
    assert tqm.pair_body(T) == body


def test_switch_lies_above_every_k9_row_count():
    """K9 is bit-identical to K1's CUDA-core body and is taken or
    compared at no more than 128 rows (the manual generates' largest
    prefill, ``chip_smoke.py K9_TOKENS``)."""
    assert tqm.PAIR_MMA_MIN_TOKENS == 129
    assert tqm.pair_body(tqm.PAIR_MMA_MIN_TOKENS - 1) == "cuda_core"


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
