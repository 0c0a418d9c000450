"""The dense pair band against the JAX package: K10's column map
(``ops/qmatmul.py pair_column``), its plain version
(``ops/quantize.py dequantize_4bit_pair``, bit-exact with the pair
branch of ``nn/linear.py dense_weight``), the band itself
(``nn/linear.py dense_matmul_pair``) and the wrapper's refusals.

On the CPU every wrapper here runs its plain version; the card's kernel
is held against the same plain version in ``tests/test_torch_guards.py``
(marker ``cuda``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.nn import linear as jlin
from quantizations_tpu.ops import qmatmul as jqm
from quantizations_tpu_torch.nn import linear as tlin
from quantizations_tpu_torch.ops import qmatmul as tqm
from quantizations_tpu_torch.ops import quantize as tqz

torch.set_num_threads(1)

M, K, L = 64, 320, 3           # K = 320: 5 quant blocks a row, an odd count


def _words(rng, lead=(), M=M, K=K):
    return rng.integers(-2**31, 2**31, lead + (M // 2, K // 4),
                        dtype=np.int64).astype(np.int32)


def _scales(rng, lead=(), M=M, K=K):
    return (rng.random(lead + (M, K // 64)) * 0.05 + 0.01).astype(np.float32)


def _stored(scales, kind):
    """(torch scales in storage ``kind``, the fp32 values they hold)."""
    ts = torch.from_numpy(scales)
    if kind == "bf16":
        ts = ts.to(torch.bfloat16)
        return ts, ts.float().numpy()
    if kind == "bf16x2":
        ts = tqm.pack_scale_pairs(ts)
        return ts, tqm.unpack_scale_pairs(ts).numpy()
    return ts, scales


def _jax_dense(wp2, scales, quant_type, dtype=jnp.bfloat16):
    """The JAX package's pair dequantize in the original order: the pair
    branch of ``dense_weight`` for bf16, its planar dequantize at
    ``dtype`` otherwise."""
    if dtype == jnp.bfloat16:
        return np.asarray(jlin.dense_weight(jnp.asarray(wp2),
                                            jnp.asarray(scales), quant_type,
                                            "pair").astype(jnp.float32))
    Wp = jlin.dequantize_permuted(jqm.pair_to_planar(jnp.asarray(wp2)),
                                  jnp.asarray(scales), quant_type, dtype)
    m, k = Wp.shape
    return np.asarray(Wp.reshape(m, 8, k // 8).swapaxes(1, 2).reshape(m, k))


def test_pair_column_places_every_nibble():
    """A hand-built [4, 128] FP4 weight: one nibble at a time set to code
    7 in otherwise zero words (code 0 decodes to 0), unit scales.
    The JAX package's ``dense_weight`` has exactly one nonzero, where
    ``pair_column`` says, for all 2 x 32 x 2 x 4 nibbles."""
    m, k = 4, 128
    dense = jax.jit(functools.partial(jlin.dense_weight, quant_type="fp4",
                                      layout="pair"))
    scales = jnp.ones((m, k // 64), jnp.float32)
    seven = float(jlin.get_4bit_code("fp4")[7])
    for i in range(m // 2):
        for w in range(k // 4):
            for half in range(2):
                for p in range(4):
                    wp2 = np.zeros((m // 2, k // 4), np.int64)
                    wp2[i, w] = 7 << (16 * half + 4 * p)
                    got = np.asarray(dense(jnp.asarray(wp2.astype(np.int32)),
                                           scales)).astype(np.float32)
                    row, col = tqm.pair_column(w, half, p, k)
                    nz = np.argwhere(got)
                    assert nz.tolist() == [[2 * i + row, col]], (i, w, half, p)
                    assert got[2 * i + row, col] == seven != 0


def test_pair_column_on_random_words(rng):
    """Random words and scales: every nibble decoded where
    ``pair_column`` puts it gives the JAX package's ``dense_weight``, bit
    for bit (and the map is a permutation of the row pair's columns)."""
    wp2, scales = _words(rng), _scales(rng)
    code = np.asarray(jlin.get_4bit_code("nf4"), np.float32)
    w = np.arange(K // 4)
    got = np.zeros((M // 2, 2, K), np.float32)
    seen = np.zeros((2, K), np.int64)
    for half in range(2):
        for p in range(4):
            row, col = tqm.pair_column(w, half, p, K)
            seen[row, col] += 1
            codes = (wp2.view(np.uint32) >> (16 * half + 4 * p)) & 15
            vals = code[codes] * scales.reshape(M // 2, 2, -1)[:, row,
                                                              col // 64]
            got[:, row, col] = np.asarray(jnp.asarray(vals).astype(
                jnp.bfloat16).astype(jnp.float32))
    assert (seen == 1).all()
    np.testing.assert_array_equal(got.reshape(M, K),
                                  _jax_dense(wp2, scales, "nf4"))


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_k10_plain_is_the_jax_dequantize(rng, quant_type, scale_kind,
                                         dtype):
    """K10's plain version (what the wrapper runs on a CPU tensor) at layer
    1 of a stack, unstacked, and through the plain entry point: bit-exact
    with the JAX package's dequantize of the same words and scales."""
    wp2, scales = _words(rng, (L,)), _scales(rng, (L,))
    ts, values = _stored(scales, scale_kind)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "fp32": (torch.float32, jnp.float32)}[dtype]
    ref = _jax_dense(wp2[1], values[1], quant_type, jdt)
    t2 = torch.from_numpy(wp2)
    for got in (tqz.dequantize_4bit_pair(t2, ts, quant_type, tdt, 1),
                tqz.dequantize_4bit_pair(t2[1], ts[1], quant_type, tdt),
                tqz.dequantize_4bit_pair_plain(t2, ts, quant_type, tdt, 1)):
        assert got.dtype == tdt and got.shape == (M, K)
        np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_k10_and_k7_plain_are_dense_weight(rng, quant_type):
    """``dense_twin`` dequantizes through K10 (pair) or K7 (planar); on the
    CPU their plain versions give the port's ``dense_weight`` bit for
    bit, fp16 output included against an fp16 cast of the fp32 values."""
    wp2, scales = _words(rng), _scales(rng)
    t2, ts = torch.from_numpy(wp2), torch.from_numpy(scales)
    planar = tqm.pair_to_planar(t2)
    for wp, layout, dq in ((t2, "pair", tqz.dequantize_4bit_pair),
                           (planar, "planar", tqz.dequantize_4bit_kernel)):
        want = tlin.dense_weight(wp, ts, quant_type, layout)
        got = dq(wp, ts, quant_type, torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        f16 = dq(wp, ts, quant_type, torch.float16)
        assert torch.equal(f16, dq(wp, ts, quant_type, torch.float32).to(
            torch.float16))


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16x2"])
@pytest.mark.parametrize("compute", ["bf16", "fp32"])
def test_dense_pair_band_matches_jax(rng, quant_type, scale_kind, compute):
    """``dense_matmul_pair`` on a CPU tensor is its plain version, and both
    stay within 1e-5 * max|y| of the JAX package's ``dense_matmul_pair``
    (the same weight values; fp32 summation order only)."""
    wp2, scales = _words(rng), _scales(rng)
    ts, values = _stored(scales, scale_kind)
    x = rng.standard_normal((300, K)).astype(np.float32)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "fp32": (torch.float32, jnp.float32)}[compute]
    ref = np.asarray(jlin.dense_matmul_pair(
        jnp.asarray(x), jnp.asarray(wp2), jnp.asarray(values), quant_type,
        compute_dtype=jdt))
    xt, t2 = torch.from_numpy(x), torch.from_numpy(wp2)
    got = tlin.dense_matmul_pair(xt, t2, ts, quant_type, compute_dtype=tdt)
    plain = tlin.dense_matmul_pair_plain(xt, t2, ts, quant_type,
                                         compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (300, M)
    assert torch.equal(got, plain)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_dense_product_on_the_cpu_is_fp32():
    """On the CPU the dense bands' product is the fp32 matmul of the same
    values, whatever their dtype."""
    x = torch.tensor([[1.5, -2.0]], dtype=torch.bfloat16)
    W = torch.tensor([[0.25, 4.0], [3.0, 0.5]], dtype=torch.bfloat16)
    y = tlin.dense_product(x, W)
    assert y.dtype == torch.float32
    assert torch.equal(y, torch.tensor([[-7.625, 3.5]]))


@pytest.mark.parametrize("case,match", [
    ("words dtype", "int32"),
    ("words rank", "int32"),
    ("K", "multiple of 64"),
    ("scales shape", "scales must be"),
    ("scales dtype", "scales must be"),
    ("layer", "layer_idx"),
    ("stack", "layer_idx"),
    ("device", "device"),
    ("out dtype", "dtype"),
])
def test_k10_wrapper_refuses(rng, case, match):
    wp2 = torch.from_numpy(_words(rng, (L,)))
    s = torch.from_numpy(_scales(rng, (L,)))
    kw = dict(layer_idx=1)
    if case == "words dtype":
        wp2 = wp2.float()
    elif case == "words rank":
        kw = {}
    elif case == "K":
        wp2 = wp2[..., :72].contiguous()              # K = 288
    elif case == "scales shape":
        s = s[:, :32]
    elif case == "scales dtype":
        s = s.to(torch.float16)
    elif case == "layer":
        kw = dict(layer_idx=L)
    elif case == "stack":
        s = s[:2]
    elif case == "device":
        s = s.to("meta")
    elif case == "out dtype":
        kw["dtype"] = torch.int8
    with pytest.raises(ValueError, match=match):
        tqz.dequantize_4bit_pair(wp2, s, "fp4", **kw)
