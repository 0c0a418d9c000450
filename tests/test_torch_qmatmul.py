"""K1's plain version (the pair-layout 4-bit dequant-matmul) and the
module-layer dispatch against the JAX package.

K1 reproduces the TPU pair kernel's rounding class: bf16 scale, times
bf16(out_factor) in bf16, the bf16 weight ``decoded * scale`` rounded to
nearest even, bf16 activations, fp32 products and sums. So against
``matmul_4bit_pair_pallas[_stacked](interpret=True)`` the tolerance is
1e-5 * max|y|: fp32 summation order only.

One catch of interpret mode: for fewer than 8 token rows XLA on the CPU
turns the kernel's small dot into a multiply-reduce and fuses the bf16
weight product into it without rounding it to bf16, so the JAX result is
then not the TPU kernel's arithmetic (off by ~1e-3 * max|y|). The JAX
side is therefore run on the activations padded with zero rows to 8,
which keeps the bf16 rounding, and only the first T rows are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.nn import linear as jlin
from quantizations_tpu.ops import qmatmul as jqm
from quantizations_tpu_torch.nn import linear as tlin
from quantizations_tpu_torch.ops import qmatmul as tqm

torch.set_num_threads(1)

M, K, L = 256, 512, 3
TOL = 1e-5


def _operands(rng, lead=()):
    wp2 = rng.integers(-2**31, 2**31, lead + (M // 2, K // 4),
                       dtype=np.int64).astype(np.int32)
    scales = (rng.random(lead + (M, K // 64)) * 0.05 + 0.01).astype(
        np.float32)
    return wp2, scales


def _scales(scales, kind):
    """(jax scales, torch scales) in storage ``kind``."""
    js, ts = jnp.asarray(scales), torch.from_numpy(scales)
    if kind == "bf16":
        return js.astype(jnp.bfloat16), ts.to(torch.bfloat16)
    if kind == "bf16x2":
        packed = jqm.pack_scale_pairs(js)
        return packed, torch.from_numpy(np.asarray(packed))
    return js, ts


def _x(rng, T):
    """bf16-valued activations ``[T, K]`` (as fp32 numpy) and the same
    rows padded with zeros to at least 8 for the JAX side."""
    x = rng.standard_normal((T, K)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    pad = np.zeros((max(T, 8), K), np.float32)
    pad[:T] = x
    return x, jnp.asarray(pad).astype(jnp.bfloat16)


def _close(got, ref):
    ref = np.asarray(ref)
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("T", [1, 3, 8, 16])
def test_pair_plain_matches_pallas(rng, quant_type, scale_kind, T):
    wp2, scales = _operands(rng)
    js, ts = _scales(scales, scale_kind)
    x, xj = _x(rng, T)
    ref = jqm.matmul_4bit_pair_pallas(jnp.asarray(wp2), js, xj,
                                      quant_type=quant_type,
                                      interpret=True)[:T]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tqm.matmul_4bit_pair_plain(torch.from_numpy(wp2), ts, xt,
                                     quant_type)
    assert got.dtype == torch.float32 and got.shape == (T, M)
    _close(got.numpy(), ref)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        tqm.matmul_4bit_pair(torch.from_numpy(wp2), ts, xt,
                             quant_type).numpy(), got.numpy())


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16x2"])
@pytest.mark.parametrize("T", [3, 16])
def test_pair_stacked_plain_matches_pallas(rng, quant_type, scale_kind, T):
    """The stacked form at layer 2 of 3 (the TPU kernel reads it through
    scalar prefetch; the port through a view of the stack)."""
    wp2, scales = _operands(rng, (L,))
    js, ts = _scales(scales, scale_kind)
    x, xj = _x(rng, T)
    ref = jqm.matmul_4bit_pair_pallas_stacked(
        jnp.asarray(wp2), js, xj, jnp.int32(2), quant_type=quant_type,
        interpret=True)[:T]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tqm.matmul_4bit_pair_stacked(torch.from_numpy(wp2), ts, xt, 2,
                                       quant_type)
    _close(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(),
        tqm.matmul_4bit_pair_plain(torch.from_numpy(wp2[2]), ts[2], xt,
                                   quant_type).numpy())


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16x2"])
def test_dense_matmul_pair_matches_jax(rng, quant_type, scale_kind):
    """Above the kernel band: the dense pair matmul, fp32 decode x fp32
    scale -> bf16 weights on both sides; fp32 summation order only."""
    wp2, scales = _operands(rng)
    js, ts = _scales(scales, scale_kind)
    x = rng.standard_normal((300, K)).astype(np.float32)
    jscales = jqm.unpack_scale_pairs(js) if scale_kind == "bf16x2" else js
    ref = jlin.dense_matmul_pair(jnp.asarray(x), jnp.asarray(wp2), jscales,
                                 quant_type)
    got = tlin.dense_matmul_pair(torch.from_numpy(x), torch.from_numpy(wp2),
                                 ts, quant_type)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_apply_4bit_above_band_matches_jax(rng, quant_type):
    """``apply_4bit`` above 256 tokens: the port's dense pair matmul
    against the JAX package's CPU path (pair_to_planar + planar dequant),
    the same fp32-decode rounding class."""
    wp2, scales = _operands(rng)
    x = rng.standard_normal((300, K)).astype(np.float32)
    ref = jlin.apply_4bit(jnp.asarray(x), jnp.asarray(wp2),
                          jnp.asarray(scales), quant_type)
    got = tlin.apply_4bit(torch.from_numpy(x), torch.from_numpy(wp2),
                          torch.from_numpy(scales), quant_type)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_apply_4bit_in_band_takes_k1(rng, quant_type):
    """In the band the port runs K1's class (bf16 scale x bf16
    out_factor) while the JAX CPU path dequantizes with fp32 scales: the
    two differ by the bf16 scale rounding, ~2^-8 of each weight, so the
    comparison with the JAX package is loose (1e-2 * max|y|); against
    K1's plain version it is exact."""
    wp2, scales = _operands(rng)
    x = rng.standard_normal((5, K)).astype(np.float32)
    got = tlin.apply_4bit(torch.from_numpy(x), torch.from_numpy(wp2),
                          torch.from_numpy(scales), quant_type)
    np.testing.assert_array_equal(
        got.numpy(),
        tqm.matmul_4bit_pair_plain(
            torch.from_numpy(wp2), torch.from_numpy(scales),
            torch.from_numpy(x).to(torch.bfloat16), quant_type).numpy())
    ref = np.asarray(jlin.apply_4bit(jnp.asarray(x), jnp.asarray(wp2),
                                     jnp.asarray(scales), quant_type))
    assert np.abs(got.numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


def test_pair_max_tokens_is_validated(monkeypatch, rng):
    monkeypatch.delenv("QT_PAIR_MAX_TOKENS", raising=False)
    assert tlin.pair_max_tokens() == 256
    for bad in ("abc", "0", "-4", "1.5", ""):
        monkeypatch.setenv("QT_PAIR_MAX_TOKENS", bad)
        with pytest.raises(ValueError):
            tlin.pair_max_tokens()
    monkeypatch.setenv("QT_PAIR_MAX_TOKENS", "4")
    assert tlin.pair_max_tokens() == 4
    # 5 tokens are now above the band: the dense pair matmul runs
    wp2, scales = _operands(rng)
    x = torch.from_numpy(rng.standard_normal((5, K)).astype(np.float32))
    np.testing.assert_array_equal(
        tlin.apply_4bit(x, torch.from_numpy(wp2), torch.from_numpy(scales),
                        "fp4").numpy(),
        tlin.dense_matmul_pair(x, torch.from_numpy(wp2),
                               torch.from_numpy(scales), "fp4").numpy())


@pytest.mark.parametrize("layout", ["planar", "pair"])
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_dense_weight_and_permutes_bit_exact(rng, layout, quant_type):
    wp = rng.integers(-2**31, 2**31, (M, K // 8),
                      dtype=np.int64).astype(np.int32)
    scales = (rng.random((M, K // 64)) * 0.05).astype(np.float32)
    if layout == "pair":
        wp = np.asarray(jqm.planar_to_pair(jnp.asarray(wp)))
    ref = jlin.dense_weight(jnp.asarray(wp), jnp.asarray(scales),
                            quant_type, layout)
    got = tlin.dense_weight(torch.from_numpy(wp), torch.from_numpy(scales),
                            quant_type, layout)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    x = rng.standard_normal((2, K)).astype(np.float32)
    np.testing.assert_array_equal(tlin.permute_cols(torch.from_numpy(x)),
                                  np.asarray(jlin.permute_cols(
                                      jnp.asarray(x))))


def test_planar_apply_4bit_matches_jax_on_cpu(rng):
    """Planar weights at 4 token rows take K5 (here its plain version):
    within 1e-5 * max|y| of the TPU planar kernel in interpret mode (the
    JAX side padded to 8 rows, as above), and within 1e-2 of the JAX
    package's CPU path, which dequantizes with fp32 scales."""
    wp = rng.integers(-2**31, 2**31, (M, K // 8),
                      dtype=np.int64).astype(np.int32)
    scales = (rng.random((M, K // 64)) * 0.05).astype(np.float32)
    x, xj = _x(rng, 4)
    got = tlin.apply_4bit(torch.from_numpy(x), torch.from_numpy(wp),
                          torch.from_numpy(scales), "nf4")
    np.testing.assert_array_equal(
        got.numpy(),
        tqm.matmul_4bit_planar_plain(torch.from_numpy(wp),
                                     torch.from_numpy(scales),
                                     torch.from_numpy(x).to(torch.bfloat16),
                                     "nf4").numpy())
    ref = jqm.matmul_4bit_pallas(jnp.asarray(wp), jnp.asarray(scales), xj,
                                 quant_type="nf4", tile_m=128, tile_t=8,
                                 interpret=True)[:4]
    _close(got.numpy(), ref)
    ref = np.asarray(jlin.apply_4bit(jnp.asarray(x), jnp.asarray(wp),
                                     jnp.asarray(scales), "nf4"))
    assert np.abs(got.numpy() - ref).max() <= 1e-2 * np.abs(ref).max()
