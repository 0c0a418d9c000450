"""The port's decode attention against the JAX package on the CPU.

- The plain versions of the five attention functions (slot cache
  unstacked, stacked, stacked int8; paged pool bf16 and int8) against the
  JAX Pallas kernels run with ``interpret=True``, over lengths, window,
  softcap, scale, ``attend_len``, ``q_span`` and ``pages_per_step``.
  Tolerance: 1e-5 * max|out|. Both sides read the same bf16 or int8
  values and compute in fp32; they differ in summation order and in the
  online softmax's rescaling only.
- ``quantize_kv_i8`` bit-exact.
- Greedy generation with ``use_flash_attention`` and/or an int8 KV cache
  gives the JAX package's tokens on ``TINY_LLAMA``. The port's projections
  round weights in K1's class (``tests/test_torch_llama.py``), which moves
  this tiny model's logits by about 1% of their range, so two candidates
  closer than that may swap: the prompts are seeded where the greedy
  margins are clear (the prompt of seed 2 meets a 0.06% tie at its 7th
  Gemma-2 token, on the einsum path as on the flash one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.config import ServeConfig as JServeConfig
from quantizations_tpu.models import llama as jl
from quantizations_tpu.ops import attention as ja
from quantizations_tpu.ops import paged_attention as jpa
from quantizations_tpu.serve.generate import make_generate_fn as j_make_gen
from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.ops import attention as ta
from quantizations_tpu_torch.ops import paged_attention as tpa
from quantizations_tpu_torch.serve.generate import make_generate_fn

torch.set_num_threads(1)

TOL = 1e-5
B, KVH, G, D = 3, 2, 2, 32


def _t(a):
    """numpy (incl. bfloat16) -> torch, by bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(ref).all()
    err = np.abs(got.numpy() - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _bf16(rng, shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)


def _i8(rng, shape):
    return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)


def _steps(rng, shape):
    return jnp.asarray(rng.uniform(0.005, 0.05, shape), jnp.bfloat16)


@pytest.mark.parametrize("window,softcap,scale", [
    (None, None, None), (7, None, None), (None, 50.0, 0.2), (5, 30.0, None)])
def test_unstacked_plain_matches_jax(window, softcap, scale):
    rng = np.random.default_rng(0)
    S = 48
    q = _bf16(rng, (B, KVH, G, D))
    ck, cv = _bf16(rng, (B, KVH, S, D)), _bf16(rng, (B, KVH, S, D))
    lengths = jnp.asarray([1, 17, 48], jnp.int32)
    ref = ja.flash_decode_attention(q, ck, cv, lengths, s_blk=16,
                                    interpret=True, scale=scale,
                                    softcap=softcap, window=window)
    got = ta.flash_decode_attention(_t(q), _t(ck), _t(cv), _t(lengths),
                                    scale=scale, softcap=softcap,
                                    window=window)
    _close(got, ref)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window,softcap,attend_len", [
    (None, None, None), (7, 50.0, 32), (2 ** 30, None, 32)])
def test_stacked_plain_matches_jax(int8, window, softcap, attend_len):
    rng = np.random.default_rng(1)
    L, S, li = 3, 48, 1
    q = _bf16(rng, (B, KVH, G, D))
    lengths = jnp.asarray([1, 17, attend_len or S], jnp.int32)
    win = None if window is None else jnp.int32(window)
    if int8:
        ck, cv = _i8(rng, (L, B, KVH, S, D)), _i8(rng, (L, B, KVH, S, D))
        ks, vs = _steps(rng, (L, B, KVH, S)), _steps(rng, (L, B, KVH, S))
        ref = ja.flash_decode_attention_stacked_i8(
            q, ck, cv, ks, vs, jnp.int32(li), lengths, attend_len=attend_len,
            s_blk=16, interpret=True, softcap=softcap, window=win)
        got = ta.flash_decode_attention_stacked_i8(
            _t(q), _t(ck), _t(cv), _t(ks), _t(vs), li, _t(lengths),
            attend_len=attend_len, softcap=softcap, window=window)
    else:
        ck, cv = _bf16(rng, (L, B, KVH, S, D)), _bf16(rng, (L, B, KVH, S, D))
        ref = ja.flash_decode_attention_stacked(
            q, ck, cv, jnp.int32(li), lengths, attend_len=attend_len,
            s_blk=16, interpret=True, softcap=softcap, window=win)
        got = ta.flash_decode_attention_stacked(
            _t(q), _t(ck), _t(cv), li, _t(lengths), attend_len=attend_len,
            softcap=softcap, window=window)
    _close(got, ref)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("q_span,window,softcap,pps", [
    (1, None, None, 1), (1, 7, 50.0, 2), (3, None, None, 2),
    (3, 2 ** 30, 30.0, 1), (2, 9, None, 3)])
def test_paged_plain_matches_jax(int8, q_span, window, softcap, pps):
    rng = np.random.default_rng(2)
    L, P, page, mp = 2, 9, 16, 4
    perm = rng.permutation(np.arange(1, P))
    table = np.zeros((B, mp), np.int32)           # unused entries: page 0
    table[0, :1] = perm[:1]
    table[1, :2] = perm[1:3]
    table[2, :4] = perm[3:7]
    lengths = np.asarray([1, 17, 64 - q_span + 1], np.int32)
    q = _bf16(rng, (B, KVH, q_span * G, D))
    win = None if window is None else jnp.int32(window)
    common = dict(softcap=softcap, q_span=q_span, pages_per_step=pps)
    if int8:
        pk, pv = _i8(rng, (L, P, KVH, page, D)), _i8(rng, (L, P, KVH, page, D))
        ks, vs = _steps(rng, (L, P, KVH, page)), _steps(rng, (L, P, KVH, page))
        ref = jpa.paged_flash_decode_attention_i8(
            q, pk, pv, ks, vs, jnp.asarray(table), jnp.int32(1),
            jnp.asarray(lengths), interpret=True, window=win, **common)
        got = tpa.paged_flash_decode_attention_i8(
            _t(q), _t(pk), _t(pv), _t(ks), _t(vs), _t(table), 1,
            _t(lengths), window=window, **common)
    else:
        pk, pv = (_bf16(rng, (L, P, KVH, page, D)),
                  _bf16(rng, (L, P, KVH, page, D)))
        ref = jpa.paged_flash_decode_attention(
            q, pk, pv, jnp.asarray(table), jnp.int32(1),
            jnp.asarray(lengths), interpret=True, window=win, **common)
        got = tpa.paged_flash_decode_attention(
            _t(q), _t(pk), _t(pv), _t(table), 1, _t(lengths), window=window,
            **common)
    _close(got, ref)


def test_paged_result_ignores_pages_per_step():
    rng = np.random.default_rng(3)
    pk = _t(_bf16(rng, (1, 5, KVH, 8, D)))
    q = _t(_bf16(rng, (B, KVH, G, D)))
    table = torch.tensor([[1, 2, 3, 4]] * B, dtype=torch.int32)
    lengths = torch.tensor([3, 20, 32], dtype=torch.int32)
    outs = [tpa.paged_flash_decode_attention(q, pk, pk, table, 0, lengths,
                                             pages_per_step=p)
            for p in (1, 2, 3, 4)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert tpa._clamp_pps(4, 3) == jpa._clamp_pps(4, 3) == 1
    assert tpa._clamp_pps(6, 4) == jpa._clamp_pps(6, 4) == 2
    with pytest.raises(ValueError, match="pages_per_step"):
        tpa.paged_flash_decode_attention(q, pk, pk, table, 0, lengths,
                                         pages_per_step=0)


def test_unseen_rows_are_zero_and_finite():
    """A row with no visible position (length 0) writes zeros, no NaN."""
    rng = np.random.default_rng(4)
    q = _t(_bf16(rng, (2, KVH, G, D)))
    ck = _t(_bf16(rng, (2, KVH, 16, D)))
    out = ta.flash_decode_attention(q, ck, ck, torch.tensor(
        [0, 5], dtype=torch.int32))
    assert torch.isfinite(out).all() and (out[0] == 0).all()


@pytest.mark.parametrize("shape,scale", [((2, 3, 5, 64), 1.0),
                                         ((4, 7, 128), 30.0),
                                         ((1, 2, 1, 32), 1e-3)])
def test_quantize_kv_i8_bit_exact(shape, scale):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, 0] = 0.0                                  # an all-zero row
    x.reshape(-1)[3] = x.reshape(-1)[:32].max() * 1.5   # a clear absmax
    jc, js = jl.quantize_kv_i8(jnp.asarray(x))
    tc, ts = tl.quantize_kv_i8(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))


def test_quantize_kv_i8_rounds_half_to_even():
    # absmax 127 -> step 1: codes are round(x), with ties to even
    x = np.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -127.0]],
                   np.float32)
    tc, _ = tl.quantize_kv_i8(torch.from_numpy(x))
    jc, _ = jl.quantize_kv_i8(jnp.asarray(x))
    assert tc.tolist() == [[127, 0, 2, 2, 0, -2, 126, -127]]
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# -- generation through the flash / int8 branches ----------------------------

MAX_SEQ = 32
GEMMA2_KNOBS = dict(sliding_window=6, sliding_layers="even",
                    attn_logit_softcap=50.0, query_scale=24)


def _tree(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


@pytest.fixture(scope="module")
def tiny():
    q = dict(quantize_embedding=True)
    jcfg = dataclasses.replace(jl.TINY_LLAMA, quant=JQuantConfig(**q))
    tcfg = dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(**q))
    jp = jl.fuse_projections(jl.init_llama_params(jcfg, seed=0))
    return jp, params_from_numpy(_tree(jp), tcfg, device="cpu"), jcfg, tcfg


@pytest.mark.parametrize("knobs", [
    dict(use_flash_attention=True),
    dict(kv_cache_dtype="int8"),
    dict(use_flash_attention=True, kv_cache_dtype="int8"),
    dict(use_flash_attention=True, **GEMMA2_KNOBS),
])
def test_flash_and_int8_generate_match_jax(tiny, knobs):
    jp, tp, jcfg, tcfg = tiny
    jcfg = dataclasses.replace(jcfg, **knobs)
    tcfg = dataclasses.replace(tcfg, **knobs)
    ids = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    jgen = j_make_gen(jcfg, JServeConfig(max_seq_len=MAX_SEQ,
                                         max_new_tokens=8,
                                         donate_cache=False))
    jt, _ = jgen(jp, jnp.asarray(ids), jl.KVCache.create(jcfg, 2, MAX_SEQ),
                 jax.random.PRNGKey(0))
    cache = tl.KVCache.create(tcfg, 2, MAX_SEQ, device="cpu")
    assert (cache.k_scale is not None) == (tcfg.kv_cache_dtype == "int8")
    tgen = make_generate_fn(tcfg, ServeConfig(max_seq_len=MAX_SEQ,
                                              max_new_tokens=8))
    tt, _ = tgen(tp, torch.from_numpy(ids), cache, None)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_flash_branch_equals_einsum_branch(tiny):
    """On the CPU both branches attend in fp32 over the same cache: the
    decode logits agree to fp32 rounding."""
    _, tp, _, tcfg = tiny
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (2, 5)).astype(np.int32))
    outs = []
    for flash in (False, True):
        cfg = dataclasses.replace(tcfg, use_flash_attention=flash,
                                  **GEMMA2_KNOBS)
        cache = tl.KVCache.create(cfg, 2, MAX_SEQ, device="cpu")
        tl.prefill(tp, ids[:, :4], cache, cfg)
        lg, _ = tl.decode_step(tp, ids[:, 4:], cache, 4, cfg)
        outs.append(lg)
    assert (outs[0] - outs[1]).abs().max() <= 1e-4 * outs[0].abs().max()
