"""The port's quantization core, layout converters and quantize kernel
(plain version) against the JAX package: bit for bit.

Every input is drawn with numpy from a seed and handed to both packages.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import quantizations_tpu.quant.codebooks as jcb
import quantizations_tpu.quant.functional as jq
from quantizations_tpu.ops import gemv as jgemv
from quantizations_tpu.ops import lut as jlut
from quantizations_tpu.ops import qmatmul as jqm
from quantizations_tpu.ops.quantize import quantize_4bit_pallas
from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch import quant as tq
from quantizations_tpu_torch.ops import gemv as tgemv
from quantizations_tpu_torch.ops import lut as tlut
from quantizations_tpu_torch.ops import qmatmul as tqm
from quantizations_tpu_torch.ops.quantize import (quantize_4bit_kernel,
                                                  quantize_4bit_kernel_plain)

torch.set_num_threads(1)

FP4_THRESHOLDS = (0.29166667, 0.583333, 0.8333333, 0.4166667, 0.0859375,
                  0.20833333, 0.00260417)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return np.asarray(a)


def _threshold_weight(rng, M, K):
    """A weight whose first rows hold blocks with absmax 1 and values
    exactly on every FP4 threshold and NF4 midpoint, and their fp32
    neighbours (w * (1/1) = w, so the code ladders see them exactly)."""
    th = np.array(FP4_THRESHOLDS + tuple(
        jcb.code_midpoints(jcb.NF4_CODE).tolist()), np.float32)
    vals = np.concatenate([th, np.nextafter(th, np.float32(2)),
                           np.nextafter(th, np.float32(0))])
    vals = np.concatenate([vals, -vals])
    W = (rng.standard_normal((M, K)) * 0.2).astype(np.float32)
    flat = W.reshape(-1)
    for i in range(0, len(vals), 63):
        blk = vals[i:i + 63]
        flat[64 * (i // 63): 64 * (i // 63) + 1 + len(blk)] = np.concatenate(
            [[1.0], blk])
    flat[64 * 4: 64 * 5] = 0.0                      # a zero block
    return W


def test_codebooks_bit_exact():
    for name in ("FP4_CODE", "NF4_CODE"):
        np.testing.assert_array_equal(getattr(tq, name), getattr(jcb, name))
    for qt in ("fp4", "nf4"):
        np.testing.assert_array_equal(tq.get_4bit_code(qt),
                                      jcb.get_4bit_code(qt))
        np.testing.assert_array_equal(
            tq.code_midpoints(tq.get_4bit_code(qt)),
            jcb.code_midpoints(jcb.get_4bit_code(qt)))
    for kw in ({}, dict(signed=False), dict(max_exponent_bits=5)):
        np.testing.assert_array_equal(tq.create_dynamic_map(**kw),
                                      jcb.create_dynamic_map(**kw))
    with pytest.raises(NotImplementedError):
        tq.get_4bit_code("int4")


def test_pack_unpack_4bit_bit_exact_and_roundtrip(rng):
    codes = rng.integers(0, 16, 4096).astype(np.uint8)
    packed = tq.pack_4bit(_t(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  _j(jq.pack_4bit(jnp.asarray(codes))))
    np.testing.assert_array_equal(tq.unpack_4bit(packed).numpy(), codes)
    np.testing.assert_array_equal(
        tq.unpack_4bit(packed).numpy(),
        _j(jq.unpack_4bit(jnp.asarray(packed.numpy()))))


def test_pack_i32_rows_bit_exact(rng):
    M, K = 16, 256
    by = rng.integers(0, 256, (M * K // 2, 1)).astype(np.uint8)
    np.testing.assert_array_equal(
        tgemv.pack_i32_rows(_t(by), M, K).numpy(),
        _j(jgemv.pack_i32_rows(jnp.asarray(by), M, K)))
    assert tgemv._SHIFTS == jgemv._SHIFTS


@pytest.mark.parametrize("lead", [(), (3,)])
def test_pair_layout_bit_exact_and_roundtrip(rng, lead):
    M, K = 64, 512
    wp = rng.integers(-2**31, 2**31, lead + (M, K // 8),
                      dtype=np.int64).astype(np.int32)
    wp2 = tqm.planar_to_pair(_t(wp))
    np.testing.assert_array_equal(wp2.numpy(),
                                  _j(jqm.planar_to_pair(jnp.asarray(wp))))
    np.testing.assert_array_equal(tqm.pair_to_planar(wp2).numpy(), wp)
    np.testing.assert_array_equal(
        tqm.pair_to_planar(wp2).numpy(),
        _j(jqm.pair_to_planar(jnp.asarray(wp2.numpy()))))
    np.testing.assert_array_equal(tqm.nibble_swap(_t(wp)).numpy(),
                                  _j(jqm.nibble_swap(jnp.asarray(wp))))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_scale_pairs_bit_exact_and_roundtrip(rng, dtype):
    s = (rng.random((2, 64, 8)) * 0.1).astype(dtype)
    ts = _t(s.view(np.int16)).view(torch.bfloat16) if dtype != np.float32 \
        else _t(s)
    packed = tqm.pack_scale_pairs(ts)
    ref = _j(jqm.pack_scale_pairs(jnp.asarray(s)))
    assert packed.dtype == torch.int32 and packed.shape == (2, 32, 8)
    np.testing.assert_array_equal(packed.numpy(), ref)
    back = tqm.unpack_scale_pairs(packed)
    np.testing.assert_array_equal(
        back.numpy(), _j(jqm.unpack_scale_pairs(jnp.asarray(ref))))
    np.testing.assert_array_equal(
        back.numpy(), s.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_pair_permute_activation_bit_exact(rng):
    x = rng.standard_normal((3, 512)).astype(np.float32)
    np.testing.assert_array_equal(
        tqm.pair_permute_activation(_t(x)).numpy(),
        _j(jqm.pair_permute_activation(jnp.asarray(x))))


def test_pair_tokens_ok_matches():
    for T in range(1, 300):
        assert tqm.pair_tokens_ok(T) == jqm.pair_tokens_ok(T), T


def test_lut_decodes_bit_exact():
    codes = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(tlut.lut_fp4_bits(_t(codes)).numpy(),
                                  _j(jlut.lut_fp4_bits(jnp.asarray(codes))))
    np.testing.assert_array_equal(
        tlut.lut_fp4_bits_raw(_t(codes)).numpy(),
        _j(jlut.lut_fp4_bits_raw(jnp.asarray(codes))))
    np.testing.assert_array_equal(tlut.lut_fp4_bits(_t(codes)).numpy(),
                                  jcb.FP4_CODE)
    np.testing.assert_array_equal(
        tlut.lut_tree(_t(codes), jcb.NF4_CODE).numpy(),
        _j(jlut.lut_tree(jnp.asarray(codes), tuple(jcb.NF4_CODE))))


def test_pair_table_is_the_tpu_decode():
    """K1's 16-entry bf16 table is what the TPU pair decodes produce:
    the RAW FP4 codebook (x 12) and bf16(NF4)."""
    tbl, f = tqm.pair_table("fp4")
    raw = _j(jlut.lut_fp4_bits_raw(jnp.arange(16, dtype=jnp.int32)))
    np.testing.assert_array_equal(tbl.float().numpy(), raw)
    assert f == 1.0 / 12.0
    tbl, f = tqm.pair_table("nf4")
    np.testing.assert_array_equal(
        tbl.float().numpy(),
        jcb.NF4_CODE.astype(ml_dtypes.bfloat16).astype(np.float32))
    assert f == 1.0


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_code_ladders_hit_thresholds_exactly(rng, quant_type):
    W = _threshold_weight(rng, 2, 512)
    fn = {"fp4": (tq.quantize_fp4_codes, jq.quantize_fp4_codes),
          "nf4": (tq.quantize_nf4_codes, jq.quantize_nf4_codes)}[quant_type]
    np.testing.assert_array_equal(fn[0](_t(W)).numpy(),
                                  _j(fn[1](jnp.asarray(W))))


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("compress", [False, True])
def test_quantize_4bit_bit_exact(rng, quant_type, compress):
    W = _threshold_weight(rng, 64, 512)
    tp, ts = tq.quantize_4bit(_t(W), quant_type=quant_type,
                              compress_statistics=compress)
    jp, js = jq.quantize_4bit(jnp.asarray(W), quant_type=quant_type,
                              compress_statistics=compress)
    np.testing.assert_array_equal(tp.numpy(), _j(jp))
    np.testing.assert_array_equal(ts.absmax.numpy(), _j(js.absmax))
    np.testing.assert_array_equal(ts.code.numpy(), _j(js.code))
    assert ts.nested == js.nested
    if compress:
        np.testing.assert_array_equal(ts.offset.numpy(), _j(js.offset))
        np.testing.assert_array_equal(ts.state2.absmax.numpy(),
                                      _j(js.state2.absmax))
    # resolved scales and the dense values
    np.testing.assert_array_equal(tq.dequantize_absmax(ts).numpy(),
                                  _j(jq.dequantize_absmax(js)))
    np.testing.assert_array_equal(
        tq.dequantize_4bit(tp, ts, dtype=torch.float32).numpy(),
        _j(jq.dequantize_4bit(jp, js, dtype=jnp.float32)))


def test_quantize_blockwise_bit_exact(rng):
    A = (rng.standard_normal(1000) * 0.01).astype(np.float32)
    tq8, tst = tq.quantize_blockwise(_t(A), blocksize=256)
    jq8, jst = jq.quantize_blockwise(jnp.asarray(A), blocksize=256)
    np.testing.assert_array_equal(tq8.numpy(), _j(jq8))
    np.testing.assert_array_equal(tst.absmax.numpy(), _j(jst.absmax))
    np.testing.assert_array_equal(tq.dequantize_blockwise(tq8, tst).numpy(),
                                  _j(jq.dequantize_blockwise(jq8, jst)))
    code = np.sort(rng.standard_normal(256).astype(np.float32))
    x = rng.standard_normal((4, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        tq.quantize_codebook_codes(_t(x), _t(code)).numpy(),
        _j(jq.quantize_codebook_codes(jnp.asarray(x), jnp.asarray(code))))


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("blocksize", [64, 128])
@pytest.mark.parametrize("bf16_in", [False, True])
def test_quantize_kernel_plain_matches_pallas(rng, quant_type, blocksize,
                                              bf16_in):
    """K2's plain version against ``quantize_4bit_pallas`` in interpret
    mode (as tests/test_quantize_kernel.py runs it), and the wrapper on a
    CPU tensor: bit-exact words and absmax."""
    M, K = 256, 512
    W = _threshold_weight(rng, M, K)
    jw, tw = jnp.asarray(W), _t(W)
    if bf16_in:
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    jwp, jam = quantize_4bit_pallas(jw, blocksize=blocksize,
                                    quant_type=quant_type, tile_m=128,
                                    interpret=True)
    for fn in (quantize_4bit_kernel_plain, quantize_4bit_kernel):
        wp, am = fn(tw, blocksize, quant_type)
        assert wp.dtype == torch.int32 and wp.shape == (M, K // 8)
        np.testing.assert_array_equal(wp.numpy(), _j(jwp))
        np.testing.assert_array_equal(am.numpy(), _j(jam))


def _k2_special_blocks():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.k2_special_blocks(64)


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("bf16_in", [False, True])
def test_quantize_kernel_plain_non_finite_matches_functional(quant_type,
                                                             bf16_in):
    """C.3: K2's plain version on the blocks the card tests feed K2 (the
    threshold edges, a zero block, a NaN, an all-zero block with one NaN,
    +inf, -inf, NaN beside inf, -0.0, a subnormal absmax) against the JAX
    functional ``quantize_4bit(..., compress_statistics=False)``: the same
    words, and the same absmax with NaN at the same places. A NaN poisons
    its block's absmax and makes every finite element the code of 0.

    The functional path, not ``quantize_4bit_pallas``: the Pallas kernel's
    one-hot selection ``_select_stride`` (``ops/quantize.py:82-90``)
    multiplies 0 by the NaN or inf, and in interpret mode one non-finite
    value turns every absmax of its row NaN and changes the row's other
    words, a fault of the reference that the port does not copy.

    The subnormal block is held to the IEEE result instead: XLA's CPU
    backend flushes subnormal inputs to zero (absmax 0, every code of 0),
    where PyTorch and K2 keep them (absmax the largest |w|, 1/absmax =
    inf)."""
    special = _k2_special_blocks()
    sub = len(special) - 1
    W = special.reshape(1, -1)
    jw, tw = jnp.asarray(W), _t(W)
    if bf16_in:
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    wp, am = quantize_4bit_kernel_plain(tw, 64, quant_type)
    jp, js = jq.quantize_4bit(jw, blocksize=64, quant_type=quant_type,
                              compress_statistics=False)
    words = wp.view(torch.uint8).numpy().reshape(-1, 32)
    jwords = _j(jp).reshape(-1, 32)
    absmax, jabsmax = am.numpy().reshape(-1), _j(js.absmax)
    keep = np.arange(len(special)) != sub
    np.testing.assert_array_equal(words[keep], jwords[keep])
    np.testing.assert_array_equal(absmax[keep], jabsmax[keep])
    assert np.isnan(absmax).sum() == 3               # the three NaN blocks
    tiny = tw.float().numpy().reshape(-1, 64)[sub]
    assert absmax[sub] == np.abs(tiny).max() > 0 and jabsmax[sub] == 0


@pytest.mark.parametrize("field,value", [
    ("quant_type", "int4"), ("pair_pipeline", "dma"),
    ("fp4_decode", "tree"), ("nf4_decode", "arith"),
    ("scales_dtype", torch.float16), ("scales_dtype", "bf16"),
    ("blocksize", 32), ("stats_blocksize", 100)])
def test_quant_config_validation(field, value):
    with pytest.raises(ValueError):
        QuantConfig(**{field: value})


def test_quant_config_accepts_every_decode_value():
    for v in ("arith", "arith_sr", "mixg0", "mixg02"):
        assert QuantConfig(fp4_decode=v).pair_decode == v
    for v in ("mix", "mix_bt", "mix_g3"):
        assert QuantConfig(quant_type="nf4", nf4_decode=v).pair_decode == v
    for s in (torch.float32, torch.bfloat16, "bf16x2"):
        QuantConfig(scales_dtype=s)
    from quantizations_tpu.config import QuantConfig as JQuantConfig
    from quantizations_tpu.config import ServeConfig as JServeConfig

    jf = {f.name for f in dataclasses.fields(JQuantConfig)}
    assert {f.name for f in dataclasses.fields(QuantConfig)} == jf
    assert ServeConfig().tp == JServeConfig().tp == 1
    assert ServeConfig(mesh_shape=(2, 4), mesh_axes=("dp", "tp")).tp == 4


# -- the stochastic quantizer (A.5): JAX's uniforms injected ------------------

def _stoch_inputs(n=4096, seed=0):
    import jax

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    x[:8] = [-1.0, 1.0, 0.0, -0.0, 1.5, -1.5, 1e-9, -1e-9]  # ends, outside
    key = jax.random.PRNGKey(seed)
    r = np.asarray(jax.random.uniform(key, (n,), jnp.float32))
    return x, key, r


def test_stochastic_codes_equal_jax_with_its_uniforms():
    code = jcb.create_dynamic_map().astype(np.float32)
    x, key, r = _stoch_inputs()
    want = np.asarray(jq.quantize_codebook_codes_stochastic(
        jnp.asarray(x), jnp.asarray(code), key))
    got = tq.stochastic_codes_from_uniforms(
        torch.from_numpy(x), torch.from_numpy(code), torch.from_numpy(r))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_stochastic_blockwise_equals_jax_with_its_uniforms(monkeypatch):
    """``quantize_blockwise(stochastic=True)``: the JAX package's codes and
    absmax when the port draws JAX's uniforms (over the padded blocks)."""
    import jax

    from quantizations_tpu_torch.quant import functional as tf

    rng = np.random.default_rng(1)
    A = rng.standard_normal((3, 300)).astype(np.float32)   # pads to 1024
    key = jax.random.PRNGKey(7)
    want_q, want_s = jq.quantize_blockwise(jnp.asarray(A), blocksize=256,
                                           stochastic=True, key=key)
    r = torch.from_numpy(np.asarray(jax.random.uniform(key, (1024,),
                                                       jnp.float32)))
    monkeypatch.setattr(tf, "quantize_codebook_codes_stochastic",
                        lambda x, code, g: tf.stochastic_codes_from_uniforms(
                            x, code, r))
    q, st = tq.quantize_blockwise(torch.from_numpy(A), blocksize=256,
                                  stochastic=True,
                                  generator=torch.Generator())
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(st.absmax.numpy(),
                                  np.asarray(want_s.absmax))


def test_stochastic_draws_are_unbiased_and_bracketing():
    """With the port's own draws: every code is one of the two entries
    bracketing x, and the mean dequantized value over 4000 draws is x
    (within 5 standard errors)."""
    code = torch.from_numpy(jcb.create_dynamic_map().astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.9, 0.9, 64).astype(np.float32))
    g = torch.Generator()
    g.manual_seed(0)
    n = 4000
    draws = torch.stack([tq.quantize_codebook_codes_stochastic(x, code, g)
                         for _ in range(n)]).long()
    hi = torch.searchsorted(code, x, side="left")
    lo = hi - 1
    assert ((draws == hi) | (draws == lo)).all()
    vals = code[draws]
    se = (code[hi] - code[lo]) / (2 * n ** 0.5)
    assert ((vals.mean(0) - x).abs() <= 5 * se + 1e-7).all()
    # the deterministic rounding is biased on the same inputs
    det = code[tq.quantize_codebook_codes(x, code).long()]
    assert (det - x).abs().max() > 10 * se.max()


def test_stochastic_needs_a_generator():
    with pytest.raises(ValueError, match="Generator"):
        tq.quantize_blockwise(torch.ones(256), stochastic=True)
    with pytest.raises(ValueError, match="key"):
        jq.quantize_blockwise(jnp.ones(256), stochastic=True)




# -- the JAX package's knobs the port leaves out (ROADMAP queue C) ----------

def _left_out_calls():
    from quantizations_tpu_torch.models.llama import TINY_LLAMA, KVCache
    from quantizations_tpu_torch.nn import linear as tlin
    from quantizations_tpu_torch.serve.paged import PagedKVCache

    W = np.random.default_rng(4).standard_normal((64, 128)).astype(np.float32)
    wp, sc = torch.zeros((2, 8), dtype=torch.int32), torch.ones((2, 1))
    return {
        "apply_4bit(use_pallas=)": lambda: tlin.apply_4bit(
            torch.ones((1, 64)), wp, sc, "fp4", use_pallas=False),
        "Linear4bit.create(use_pallas=)": lambda: tlin.Linear4bit.create(
            W, device="cpu", use_pallas=False),
        "dequantize_permuted(lut=)": lambda: tlin.dequantize_permuted(
            wp, sc, "fp4", lut="take"),
        "KVCache.create(kv_heads=)": lambda: KVCache.create(
            TINY_LLAMA, 1, 8, device="cpu", kv_heads=2),
        "KVCache.create(dtype=)": lambda: KVCache.create(
            TINY_LLAMA, 1, 8, device="cpu", dtype=torch.float32),
        "PagedKVCache.create(kv_heads=)": lambda: PagedKVCache.create(
            TINY_LLAMA, 4, page_size=16, device="cpu", kv_heads=2),
        "PagedKVCache.create(dtype=)": lambda: PagedKVCache.create(
            TINY_LLAMA, 4, page_size=16, device="cpu", dtype=torch.float32),
    }


@pytest.mark.parametrize("call", sorted(_left_out_calls()))
def test_left_out_knobs_are_refused(call):
    """No caller of either package sets these: the port has no plain
    route selected by ``use_pallas=False``, one decode for
    ``dequantize_permuted``, and caches shaped by the config alone."""
    with pytest.raises(TypeError, match="unexpected keyword"):
        _left_out_calls()[call]()
