"""The planar layout in the port against the JAX package: the plain
versions of K5 (planar dequant-matmul), K6 (planar fp32 GEMV) and K7
(dequantize) against the TPU kernels in interpret mode, QuantState's bnb
dict, ``bnb_io``, ``Params4bit``/``Linear4bit``, the functional
``gemv_4bit``/``matmul_4bit``, and ``TINY_LLAMA`` converted to planar
words.

Tolerances:
- K7: bit-exact (one fp32 product rounded to the output type on both
  sides).
- K5: 1e-5 * max|y|. Both sides round every operand identically (bf16
  scale times bf16(1/12), ``bf16(decoded * scale)``, bf16 activations);
  only the fp32 summation order differs. As for K1, XLA on the CPU fuses
  away the bf16 weight rounding of the interpret-mode kernel below 8
  token rows, so the JAX side runs on activations padded with zero rows
  to 8 and only the first T rows are compared.
- K6: 1e-5 * max|y|: fp32 throughout on both sides, summation order only.
- Linear4bit and the model: the JAX package on the CPU takes the dense
  path (fp32 decode x fp32 scale -> bf16 weights) in every band, while
  the port runs K5's class (bf16 scales) or K6's (unrounded fp32 weights)
  in theirs: the weights differ by up to ~2^-8 relative, so those
  comparisons are 1e-2 * max|y| for one layer and 2e-2 * max|logit| for
  the model; above the bands both sides are the dense path (1e-5).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import quantizations_tpu.quant.functional as jq
from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.models import llama as jl
from quantizations_tpu.nn import linear as jlin
from quantizations_tpu.ops import qmatmul as jqm
from quantizations_tpu.ops.gemv import (gemv_4bit_pallas,
                                        gemv_4bit_pallas_stacked)
from quantizations_tpu.ops.gemv import permute_activation as j_permute
from quantizations_tpu.ops.quantize import dequantize_4bit_pallas
from quantizations_tpu.quant import bnb_io as jbnb
from quantizations_tpu.quant.state import QuantState as JQuantState
from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch import quant as tq
from quantizations_tpu_torch.bridge import (linear4bit_from_numpy,
                                            linear4bit_to_numpy,
                                            params_from_numpy)
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.nn import linear as tlin
from quantizations_tpu_torch.ops import gemv as tgemv
from quantizations_tpu_torch.ops import qmatmul as tqm
from quantizations_tpu_torch.ops import quantize as tqz
from quantizations_tpu_torch.quant import bnb_io as tbnb
from quantizations_tpu_torch.quant.state import QuantState
from quantizations_tpu_torch.serve.generate import make_generate_fn

torch.set_num_threads(1)

M, K, L = 256, 512, 3
ODD_M = 33
TOL = 1e-5


def _words(rng, lead, m=M):
    return rng.integers(-2**31, 2**31, lead + (m, K // 8),
                        dtype=np.int64).astype(np.int32)


def _scales(rng, lead, m=M, kind="fp32"):
    s = (rng.random(lead + (m, K // 64)) * 0.05 + 0.01).astype(np.float32)
    if kind == "bf16":
        s = s.astype(ml_dtypes.bfloat16)
    return s


def _t(a):
    """numpy -> torch, bf16 moved by bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _bf16_rows(rng, T, pad_to=8):
    """bf16-valued activations [T, K] (fp32 numpy), and the same rows
    padded with zeros to ``pad_to`` as a JAX bf16 array."""
    x = rng.standard_normal((T, K)).astype(np.float32)
    x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    pad = np.zeros((max(T, pad_to), K), np.float32)
    pad[:T] = x
    return x, jnp.asarray(pad).astype(jnp.bfloat16)


# -- K5 ----------------------------------------------------------------------

@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 3, 8, 16, 48, 64])
def test_k5_plain_matches_pallas(rng, quant_type, scale_kind, T):
    wp, s = _words(rng, ()), _scales(rng, (), kind=scale_kind)
    x, xj = _bf16_rows(rng, T)
    ref = jqm.matmul_4bit_pallas(jnp.asarray(wp), jnp.asarray(s), xj,
                                 quant_type=quant_type, tile_m=128, tile_t=8,
                                 interpret=True)[:T]
    xt = _t(x).to(torch.bfloat16)
    got = tqm.matmul_4bit_planar_plain(_t(wp), _t(s), xt, quant_type)
    assert got.dtype == torch.float32 and got.shape == (T, M)
    _close(got, ref)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(tqm.matmul_4bit_planar(_t(wp), _t(s), xt, quant_type),
                       got)


# K5's band (nn/linear.py): 1, 2, 4 and the multiples of 8 up to 64 rows
K5_BAND = [1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64]


@pytest.mark.parametrize("T", K5_BAND)
def test_k5_body_routing(rng, monkeypatch, T):
    """``planar_body`` picks the CUDA-core body below
    ``PLANAR_MMA_MIN_TOKENS`` rows (the band's 1 and 2, the crossover
    measured on an H100) and the tensor-core body from there on; the
    dispatch launches that body (and counts every launch in
    ``PLANAR_MATMUL``); both entry points run the plain version on CPU
    tensors."""
    from quantizations_tpu_torch.ops import PLANAR_MATMUL

    assert T <= tlin.QMATMUL_MAX_TOKENS and tlin.qmm_ok(T)
    assert [t for t in K5_BAND if tqm.planar_body(t) == "cuda_core"] == [
        1, 2]
    want = "mma" if T >= tqm.PLANAR_MMA_MIN_TOKENS else "cuda_core"
    assert tqm.planar_body(T) == want
    wp, s = _t(_words(rng, ())), _t(_scales(rng, ()))
    x = _t(rng.standard_normal((T, K)).astype(np.float32)).to(torch.bfloat16)
    plain = tqm.matmul_4bit_planar_plain(wp, s, x, "nf4")
    for fn in (tqm.matmul_4bit_planar_cuda_core, tqm.matmul_4bit_planar_mma,
               tqm.matmul_4bit_planar):
        assert torch.equal(fn(wp, s, x, "nf4"), plain)
    called = []
    for body in ("cuda_core", "mma"):
        monkeypatch.setattr(tqm, f"matmul_4bit_planar_{body}",
                            lambda *a, body=body: called.append(body) or plain)
    before = PLANAR_MATMUL.launches
    assert tqm._launch_k5(wp, s, x, "nf4") is plain
    assert called == [want]
    # a launch of the CUDA-core body counts itself; the dispatch counts
    # the tensor-core body's in PLANAR_MATMUL too
    assert PLANAR_MATMUL.launches == before + (want == "mma")


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("T", [2, 16])
def test_k5_stacked_plain_matches_pallas(rng, quant_type, T):
    """Layer 2 of 3: scalar prefetch on the TPU, a view of the stack in
    the port."""
    wp, s = _words(rng, (L,)), _scales(rng, (L,))
    x, xj = _bf16_rows(rng, T)
    ref = jqm.matmul_4bit_pallas_stacked(
        jnp.asarray(wp), jnp.asarray(s), xj, jnp.int32(2),
        quant_type=quant_type, tile_m=128, tile_t=8, interpret=True)[:T]
    xt = _t(x).to(torch.bfloat16)
    got = tqm.matmul_4bit_planar_stacked(_t(wp), _t(s), xt, 2, quant_type)
    _close(got, ref)
    assert torch.equal(got, tqm.matmul_4bit_planar_plain(
        _t(wp[2]), _t(s[2]), xt, quant_type))


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_k5_plain_odd_rows(rng, quant_type):
    wp, s = _words(rng, (), ODD_M), _scales(rng, (), ODD_M)
    x, xj = _bf16_rows(rng, 4)
    # one row tile of all 33 rows: a tile of 1 row lets XLA fuse away the
    # bf16 weight rounding, as fewer than 8 token rows do
    ref = jqm.matmul_4bit_pallas(jnp.asarray(wp), jnp.asarray(s), xj,
                                 quant_type=quant_type, tile_m=ODD_M,
                                 interpret=True)[:4]
    _close(tqm.matmul_4bit_planar_plain(_t(wp), _t(s),
                                        _t(x).to(torch.bfloat16), quant_type),
           ref)


def test_k5_nf4_decodes_the_fp32_codebook(rng):
    """K5 decodes NF4 to the fp32 codebook, as the planar TPU kernel does;
    K1's pair decode uses the bf16 codebook. Rounding the NF4 table to
    bf16 first (K1's table) double-rounds the weight and misses the JAX
    kernel by far more than the summation order."""
    wp, s = _words(rng, ()), _scales(rng, ())
    x, xj = _bf16_rows(rng, 8)
    ref = np.asarray(jqm.matmul_4bit_pallas(
        jnp.asarray(wp), jnp.asarray(s), xj, quant_type="nf4", tile_m=128,
        tile_t=8, interpret=True))
    table, _ = tgemv.planar_table("nf4")
    np.testing.assert_array_equal(table.numpy(), tq.NF4_CODE)
    pair_tbl = tqm.pair_table("nf4")[0].float()
    sb = _t(s).to(torch.bfloat16).float().repeat_interleave(8, dim=1)
    planes = [(pair_tbl[((_t(wp) >> sh) & 15).long()] * sb).to(
        torch.bfloat16) for sh in tgemv._SHIFTS]
    W = torch.stack(planes, dim=-1).reshape(M, K).float()
    wrong = (_t(x) @ W.T).numpy()
    assert np.abs(wrong - ref).max() > 100 * TOL * np.abs(ref).max()


# -- K6 ----------------------------------------------------------------------

@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16"])
@pytest.mark.parametrize("B", [1, 3, 5, 8])
def test_k6_plain_matches_pallas(rng, quant_type, scale_kind, B):
    wp, s = _words(rng, ()), _scales(rng, (), kind=scale_kind)
    x = rng.standard_normal((B, K)).astype(np.float32)
    ref = gemv_4bit_pallas(jnp.asarray(wp), jnp.asarray(s), jnp.asarray(x),
                           quant_type=quant_type, tile_m=128, interpret=True)
    got = tgemv.gemv_4bit_plain(_t(wp), _t(s), _t(x), quant_type)
    assert got.dtype == torch.float32 and got.shape == (B, M)
    _close(got, ref)
    assert torch.equal(tgemv.gemv_4bit(_t(wp), _t(s), _t(x), quant_type), got)


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
def test_k6_stacked_bf16_activations_and_odd_rows(rng, quant_type):
    wp, s = _words(rng, (L,)), _scales(rng, (L,))
    x = rng.standard_normal((6, K)).astype(ml_dtypes.bfloat16)
    ref = gemv_4bit_pallas_stacked(
        jnp.asarray(wp), jnp.asarray(s), jnp.asarray(x), jnp.int32(1),
        quant_type=quant_type, tile_m=128, interpret=True)
    got = tgemv.gemv_4bit_stacked(_t(wp), _t(s), _t(x), 1, quant_type)
    _close(got, ref)
    wo, so = _words(rng, (), ODD_M), _scales(rng, (), ODD_M)
    ref = gemv_4bit_pallas(jnp.asarray(wo), jnp.asarray(so), jnp.asarray(x),
                           quant_type=quant_type, interpret=True)
    _close(tgemv.gemv_4bit_plain(_t(wo), _t(so), _t(x), quant_type), ref)


def test_permute_activation_bit_exact(rng):
    x = rng.standard_normal((3, K)).astype(np.float32)
    np.testing.assert_array_equal(tgemv.permute_activation(_t(x)).numpy(),
                                  np.asarray(j_permute(jnp.asarray(x))))


# -- K7 ----------------------------------------------------------------------

@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [M, ODD_M])
def test_k7_plain_bit_exact_with_pallas(rng, quant_type, dtype, m):
    wp, s = _words(rng, (), m), _scales(rng, (), m)
    ref = np.asarray(dequantize_4bit_pallas(
        jnp.asarray(wp), jnp.asarray(s), quant_type=quant_type,
        dtype=getattr(jnp, dtype), tile_m=128, interpret=True))
    for fn in (tqz.dequantize_4bit_kernel_plain, tqz.dequantize_4bit_kernel):
        got = fn(_t(wp), _t(s), quant_type, getattr(torch, dtype))
        assert got.shape == (m, K) and got.dtype == getattr(torch, dtype)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          ref.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), ref)


# -- QuantState and bnb_io ---------------------------------------------------

def _quantized(rng, quant_type, compress, shape=(64, 256), blocksize=64):
    W = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    tp, ts = tq.quantize_4bit(_t(W), blocksize=blocksize,
                              quant_type=quant_type,
                              compress_statistics=compress)
    jp, js = jq.quantize_4bit(jnp.asarray(W), blocksize=blocksize,
                              quant_type=quant_type,
                              compress_statistics=compress)
    return W, (tp, ts), (np.asarray(jp), js)


def _same_dict(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k == "quant_state":
            assert got[k] == v
        else:
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _same_state(got: QuantState, ref: JQuantState):
    for f in ("absmax", "code"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert (got.blocksize, got.quant_type, tuple(got.shape)) == (
        ref.blocksize, ref.quant_type, tuple(ref.shape))
    assert got.nested == ref.nested
    if ref.nested:
        np.testing.assert_array_equal(got.offset.numpy(),
                                      np.asarray(ref.offset))
        _same_state(got.state2, ref.state2)


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("compress", [False, True])
def test_quant_state_dict_bit_exact(rng, quant_type, compress):
    _, (_, ts), (_, js) = _quantized(rng, quant_type, compress)
    d = ts.as_dict()
    _same_dict(d, js.as_dict())
    assert d["quant_state"]["dtype"] == "float32"
    # from_dict of the JAX package's dict, and back
    back = QuantState.from_dict(js.as_dict())
    _same_state(back, js)
    _same_dict(back.as_dict(), js.as_dict())
    _same_state(QuantState.from_dict(d), js)


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("compress", [False, True])
def test_bnb_flat_tensors_and_parse_bit_exact(rng, quant_type, compress):
    """Export, the JSON metadata tensor included, and parse of the JAX
    package's export: the same keys and bytes, the same state, and the
    same runtime arrays (planar and pair)."""
    _, (tp, ts), (jp, js) = _quantized(rng, quant_type, compress)
    prefix = "model.layers.0.mlp.down_proj"
    got = tbnb.bnb_flat_tensors(prefix, tp, ts)
    ref = jbnb.bnb_flat_tensors(prefix, jp, js)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    qs_key = f"{prefix}.weight.quant_state.bitsandbytes__{quant_type}"
    meta = json.loads(bytes(got[qs_key]).decode("utf-8"))
    assert meta["shape"] == [64, 256] and ("nested_offset" in meta) == compress
    assert tbnb.is_bnb_quantized(set(ref), prefix)
    assert not tbnb.is_bnb_quantized(set(ref), "model.layers.1")
    packed, state = tbnb.parse_bnb_flat(ref.__getitem__, set(ref), prefix)
    jpacked, jstate = jbnb.parse_bnb_flat(ref.__getitem__, set(ref), prefix)
    np.testing.assert_array_equal(packed, jpacked)
    _same_state(state, jstate)
    for layout in ("planar", "pair"):
        wp, s = tbnb.qlinear_arrays_from_bnb(packed, state, layout=layout,
                                             device="cpu")
        jwp, js_ = jbnb.qlinear_arrays_from_bnb(jpacked, jstate, layout)
        np.testing.assert_array_equal(wp.numpy(), np.asarray(jwp))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js_))


def test_bnb_strided_bytes_and_blocksize_128(rng):
    """A payload read from a file may be a strided view; blocksize 128
    scales are expanded to per-64 before any kernel reads them."""
    _, (tp, ts), _ = _quantized(rng, "nf4", True, blocksize=128)
    flat = tbnb.bnb_flat_tensors("p", tp, ts)
    wide = np.zeros((flat["p.weight"].shape[0], 2), np.uint8)
    wide[:, :1] = flat["p.weight"]
    flat["p.weight"] = wide[:, :1]                  # not contiguous
    assert not flat["p.weight"].flags["C_CONTIGUOUS"]
    packed, state = tbnb.parse_bnb_flat(flat.__getitem__, set(flat), "p")
    wp, s = tbnb.qlinear_arrays_from_bnb(packed, state, device="cpu")
    jwp, js_ = jbnb.qlinear_arrays_from_bnb(
        *jbnb.parse_bnb_flat(flat.__getitem__, set(flat), "p"))
    np.testing.assert_array_equal(wp.numpy(), np.asarray(jwp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_))
    assert s.shape == (64, 256 // 64)


def test_load_bnb_linear4bit_round_trip(rng):
    """Linear4bit -> bnb flat tensors -> load_bnb_linear4bit gives the
    same words, scales and (bit-identical) outputs, bias included; the
    JAX package loads the same tensors to the same arrays."""
    W = (rng.standard_normal((96, 256)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    lin = tlin.Linear4bit.create(W, bias=bias, quant_type="nf4",
                                 device="cpu")
    flat = tbnb.bnb_flat_tensors("q", lin.weight.packed_u8(), lin.quant_state)
    flat["q.bias"] = bias
    got = tbnb.load_bnb_linear4bit(flat.__getitem__, set(flat), "q",
                                   device="cpu")
    assert torch.equal(got.weight.wp, lin.weight.wp)
    assert torch.equal(got.weight.scales, lin.weight.scales)
    for T in (1, 3, 70):
        x = _t(rng.standard_normal((T, 256)).astype(np.float32))
        assert torch.equal(got(x), lin(x))
    ref = jbnb.load_bnb_linear4bit(flat.__getitem__, set(flat), "q")
    np.testing.assert_array_equal(got.weight.wp.numpy(),
                                  np.asarray(ref.weight.wp))
    np.testing.assert_array_equal(got.weight.scales.numpy(),
                                  np.asarray(ref.weight.scales))
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(ref.bias))


# -- Params4bit / Linear4bit -------------------------------------------------

@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("blocksize,layout", [(64, "planar"), (128, "planar"),
                                              (64, "pair"), (256, "pair")])
def test_params4bit_quantize_bit_exact(rng, quant_type, compress, blocksize,
                                       layout):
    W = (rng.standard_normal((64, 512)) * 0.1).astype(np.float32)
    got = tlin.Params4bit.quantize(_t(W), blocksize, quant_type, compress,
                                   layout)
    ref = jlin.Params4bit.quantize(jnp.asarray(W), blocksize, quant_type,
                                   compress, layout)
    assert got.layout == ref.layout == layout
    assert got.shape == tuple(ref.shape)
    np.testing.assert_array_equal(got.wp.numpy(), np.asarray(ref.wp))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    assert got.scales.shape == (64, 512 // 64)
    np.testing.assert_array_equal(got.packed_u8().numpy(),
                                  np.asarray(ref.packed_u8()))
    _same_state(got.quant_state, ref.quant_state)


def test_params4bit_refuses_bad_shapes():
    for shape, kw in (((16, 63), {}), ((16, 96), dict(blocksize=64)),
                      ((16, 128), dict(blocksize=32)),
                      ((15, 128), dict(layout="pair"))):
        with pytest.raises(ValueError):
            tlin.Params4bit.quantize(torch.ones(shape), **kw)


def _linears(rng, quant_type, bias, compute_dtype=("bf16", torch.bfloat16,
                                                     jnp.bfloat16)):
    W = (rng.standard_normal((96, 512)) * 0.1).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32) if bias else None
    j = jlin.Linear4bit.create(jnp.asarray(W),
                               bias=None if b is None else jnp.asarray(b),
                               quant_type=quant_type,
                               compute_dtype=compute_dtype[2])
    tree, meta = linear4bit_to_numpy(tlin.Linear4bit.create(
        W, bias=b, quant_type=quant_type, compute_dtype=compute_dtype[1],
        device="cpu"))
    return j, tree, meta


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("T", [1, 3, 16, 100])
def test_linear4bit_forward_matches_jax(rng, quant_type, T):
    """T = 1 and 16 take K5's class, T = 3 K6's, T = 100 the dense path
    (the JAX package runs the dense path at every T on the CPU)."""
    W = (rng.standard_normal((96, 512)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    jlayer = jlin.Linear4bit.create(jnp.asarray(W), bias=jnp.asarray(bias),
                                    quant_type=quant_type)
    tlayer = tlin.Linear4bit.create(W, bias=bias, quant_type=quant_type,
                                    device="cpu")
    assert (tlayer.in_features, tlayer.out_features) == (512, 96)
    x = rng.standard_normal((T, 512)).astype(np.float32)
    ref = np.asarray(jlayer(jnp.asarray(x)))
    got = tlayer(_t(x))
    assert got.dtype == torch.float32 and got.shape == (T, 96)
    _close(got.numpy(), ref, TOL if T == 100 else 1e-2)
    # the band's kernel (plain version here) is what ran
    x2 = tlin.kernel_activation(_t(x), torch.bfloat16)
    s, wp = tlayer.weight.scales, tlayer.weight.wp
    if T in (1, 16):
        band = tqm.matmul_4bit_planar_plain(wp, s, x2, quant_type)
    elif T == 3:
        band = tgemv.gemv_4bit_plain(wp, s, x2, quant_type)
    else:
        band = tlin.apply_4bit(_t(x), wp, s, quant_type)
    assert torch.equal(got, band + tlayer.bias)


def test_linear4bit_casts_and_leading_dims(rng):
    """Input cast to compute_dtype, output cast back to the input dtype,
    leading dims kept; a 1-D input is one row."""
    jlayer, tree, meta = _linears(rng, "fp4", True)
    tlayer = linear4bit_from_numpy(tree, meta, device="cpu")
    x = rng.standard_normal((2, 5, 512)).astype(ml_dtypes.bfloat16)
    got = tlayer(_t(x))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5, 96)
    ref = np.asarray(jlayer(jnp.asarray(x)).astype(jnp.float32))
    _close(got.float().numpy(), ref, 1e-2)
    v = _t(rng.standard_normal(512).astype(np.float32))
    assert tlayer(v).shape == (96,)
    assert torch.equal(tlayer(v), tlayer(v[None])[0])


@pytest.mark.parametrize("compress", [False, True])
def test_linear4bit_bridge_round_trip(rng, compress):
    """A JAX Linear4bit crosses through numpy with nothing repacked: the
    same leaves back, and a dense-band forward within 1e-5."""
    W = (rng.standard_normal((64, 256)) * 0.1).astype(np.float32)
    j = jlin.Linear4bit.create(jnp.asarray(W), bias=jnp.ones(64),
                               compress_statistics=compress, layout="pair")
    flat, _ = jax.tree_util.tree_flatten_with_path(j)
    tree = {".".join(k.name for k in p): np.asarray(v) for p, v in flat}
    meta = j.quant_state.as_dict()["quant_state"]
    t = linear4bit_from_numpy(tree, meta, device="cpu")
    assert t.weight.layout == "pair" and t.quant_state.nested == compress
    back, meta2 = linear4bit_to_numpy(t)
    assert meta2 == meta and set(back) == set(tree)
    for k, v in tree.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    x = rng.standard_normal((300, 256)).astype(np.float32)
    _close(t(_t(x)).numpy(), np.asarray(j(jnp.asarray(x))))


# -- functional gemv_4bit / matmul_4bit --------------------------------------

@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("compress", [False, True])
def test_functional_gemv_and_matmul_match_jax(rng, quant_type, compress):
    _, (tp, ts), (jp, js) = _quantized(rng, quant_type, compress)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(tq.gemv_4bit(_t(x), tp, ts).numpy(),
           jq.gemv_4bit(jnp.asarray(x), jnp.asarray(jp), js))
    got = tq.matmul_4bit(_t(x), tp, ts, bias=_t(bias))
    _close(got.numpy(), jq.matmul_4bit(jnp.asarray(x), jnp.asarray(jp), js,
                                       bias=jnp.asarray(bias)))
    absmax = tq.dequantize_absmax(ts)
    assert torch.equal(tq.matmul_4bit(_t(x), tp, ts, absmax_f32=absmax),
                       tq.matmul_4bit(_t(x), tp, ts))
    xb = _t(x).to(torch.bfloat16)
    assert tq.gemv_4bit(xb, tp, ts).dtype == torch.bfloat16


# -- the planar model --------------------------------------------------------

def _tree(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _planar_jax(params):
    """Every pair QLinear of a JAX LlamaParams converted to planar words
    (and unpacked scales), as the tensor-parallel placement does."""
    def conv(x):
        if isinstance(x, jl.QLinear) and x.layout == "pair":
            s = (jqm.unpack_scale_pairs(x.scales) if x.scales_packed
                 else x.scales)
            return jl.QLinear(wp=jqm.pair_to_planar(x.wp), scales=s)
        return x
    return jax.tree_util.tree_map(
        conv, params, is_leaf=lambda x: isinstance(x, jl.QLinear))


@pytest.fixture(scope="module")
def planar_models():
    q = dict(quantize_embedding=True)
    jcfg = dataclasses.replace(jl.TINY_LLAMA, quant=JQuantConfig(**q))
    tcfg = dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(**q))
    jp = _planar_jax(jl.fuse_projections(jl.init_llama_params(jcfg, seed=0)))
    assert jp.layers.qkv.layout == "planar" and jp.lm_head.layout == "planar"
    tp = params_from_numpy(_tree(jp), tcfg, device="cpu")
    assert tp.layers.qkv.layout == "planar"
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("B", [1, 3, 8])
def test_planar_tiny_llama_matches_jax(planar_models, B):
    """Prefill 16 tokens, then greedy decode 3: at B = 1 every projection
    takes K5's class, at B = 3 the 48-row prefill K5's and each decode
    step K6's, at B = 8 the 128-row prefill the dense path and decode
    K5's. Logits within 2e-2 * max|logit|, greedy tokens equal."""
    jcfg, tcfg, jp, tp = planar_models
    P, N, S = 16, 3, 32
    ids = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, P)).astype(np.int32)
    jlog, jc = jax.jit(functools.partial(jl.prefill, cfg=jcfg))(
        jp, jnp.asarray(ids), jl.KVCache.create(jcfg, B, S))
    tc = tl.KVCache.create(tcfg, B, S, device="cpu")
    tlog, tc = tl.prefill(tp, torch.from_numpy(ids), tc, tcfg)
    _close(tlog.numpy(), jlog, 2e-2)
    jdecode = jax.jit(functools.partial(jl.decode_step, cfg=jcfg))
    tok = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(tlog[:, -1].argmax(-1).numpy(), tok)
    for t in range(P, P + N):
        jlog, jc = jdecode(jp, jnp.asarray(tok[:, None]), jc, jnp.int32(t))
        tlog, tc = tl.decode_step(tp, torch.from_numpy(tok[:, None]), tc, t,
                                  tcfg)
        _close(tlog.numpy(), jlog, 2e-2)
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(), tok)


@pytest.mark.parametrize("B,k5,k6,k7", [(1, 6 * 9, 0, 0),
                                        (3, 8, 5 * 9 + 1, 0),
                                        (8, 5 * 9 + 1, 0, 8)])
def test_planar_generate_takes_the_bands(planar_models, monkeypatch, B, k5,
                                         k6, k7):
    """Which band each projection of a 16-token prompt and 6 greedy
    tokens takes (2 layers x 4 projections + the lm_head a forward): the
    counts that the full-size run checks as kernel launches, on the
    plain versions. B = 1: K5 everywhere. B = 3: K5 on the 48-row
    prefill's projections, K6 on its lm_head (3 rows) and every decode
    step. B = 8: the dense path (K7's dequantize, then a matmul) on the
    128-row prefill, K5 on its lm_head and every decode step."""
    _, tcfg, _, tp = planar_models
    calls = {"k5": 0, "k6": 0, "k7": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for mod in (tl, tlin):
        for attr, name in (("matmul_4bit_planar_stacked", "k5"),
                           ("matmul_4bit_planar", "k5"),
                           ("gemv_4bit_stacked", "k6"), ("gemv_4bit", "k6"),
                           ("dequantize_4bit_kernel", "k7")):
            if hasattr(mod, attr):
                monkeypatch.setattr(mod, attr,
                                    counted(name, getattr(mod, attr)))
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, 16)).astype(np.int32))
    gen = make_generate_fn(tcfg, ServeConfig(max_seq_len=32,
                                             max_new_tokens=6))
    toks, _ = gen(tp, ids, tl.KVCache.create(tcfg, B, 32, device="cpu"),
                  None)
    assert toks.shape == (B, 6)
    assert calls == {"k5": k5, "k6": k6, "k7": k7}
