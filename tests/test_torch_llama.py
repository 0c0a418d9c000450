"""The port's Llama forward, model build and generation against the JAX
package on ``TINY_LLAMA`` (2 layers, hidden 512), with the JAX
parameters loaded through the bridge.

Logit tolerance: 2e-2 * max|logit|. The port runs every projection
through K1's plain version, which rounds each block scale to bf16 and
multiplies it by bf16(1/12) for FP4 (the TPU kernel's class), while the
JAX package on the CPU dequantizes through ``pair_to_planar`` and fp32
scales (``nn/linear.py:223-256``). The two weights differ by up to ~2^-8
relative, which moves the logits of this tiny random model by about 1%
of their range. Greedy tokens still agree exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.config import ServeConfig as JServeConfig
from quantizations_tpu.models import llama as jl
from quantizations_tpu.serve.generate import make_generate_fn as j_make_gen
from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve.generate import (make_generate_fn,
                                                    sample_logits)

torch.set_num_threads(1)

MAX_SEQ = 32
TOL = 2e-2
GEMMA2_KNOBS = dict(sliding_window=6, sliding_layers="even",
                    attn_logit_softcap=50.0, query_scale=24)


def _tree(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _cfgs(**knobs):
    q = dict(quantize_embedding=True)
    return (dataclasses.replace(jl.TINY_LLAMA, quant=JQuantConfig(**q),
                                **knobs),
            dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(**q),
                                **knobs))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jp = jl.init_llama_params(jcfg, seed=0)
    out = {}
    for fused in (False, True):
        p = jl.fuse_projections(jp) if fused else jp
        out[fused] = (p, params_from_numpy(_tree(p), tcfg, device="cpu"))
    return out


def _ids(seed, B, T):
    return np.random.default_rng(seed).integers(
        0, jl.TINY_LLAMA.vocab_size, (B, T)).astype(np.int32)


def _close(got, ref):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


def _prefill_decode(jp, tp, jcfg, tcfg, B=2, P=5, N=8):
    """Prefill P tokens, then decode N - P: compare every step's
    logits."""
    ids = _ids(1, B, N)
    jprefill = jax.jit(functools.partial(jl.prefill, cfg=jcfg))
    jdecode = jax.jit(functools.partial(jl.decode_step, cfg=jcfg))
    jlog, jc = jprefill(jp, jnp.asarray(ids[:, :P]),
                        jl.KVCache.create(jcfg, B, MAX_SEQ))
    tc = tl.KVCache.create(tcfg, B, MAX_SEQ, device="cpu")
    tlog, tc = tl.prefill(tp, torch.from_numpy(ids[:, :P]), tc, tcfg)
    assert tlog.shape == (B, P, tcfg.vocab_size)
    _close(tlog.numpy(), jlog)
    for t in range(P, N):
        jlog, jc = jdecode(jp, jnp.asarray(ids[:, t:t + 1]), jc,
                           jnp.int32(t))
        tlog, tc = tl.decode_step(tp, torch.from_numpy(ids[:, t:t + 1]), tc,
                                  t, tcfg)
        assert tlog.shape == (B, tcfg.vocab_size)
        _close(tlog.numpy(), jlog)
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                      np.asarray(jlog).argmax(-1))


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_decode_logits_match_jax(models, fused):
    jp, tp = models[fused]
    jcfg, tcfg = _cfgs()
    _prefill_decode(jp, tp, jcfg, tcfg)


def test_gemma2_knobs_match_jax(models):
    """The Gemma-2 knob set on the einsum path: alternating sliding
    window, attention softcap, query scale."""
    jp, tp = models[True]
    jcfg, tcfg = _cfgs(**GEMMA2_KNOBS)
    _prefill_decode(jp, tp, jcfg, tcfg, N=10)


def test_family_knob_stack_matches_jax():
    """Bias, post-norms, qk-norm, GeGLU, final softcap, embedding
    normalizer and rope scaling, from one JAX init."""
    knobs = dict(attention_bias=True, post_norms=True, qk_norm=True,
                 hidden_activation="gelu_tanh", norm_plus_one=True,
                 final_logit_softcap=30.0, embed_normalizer=True,
                 rope_scaling=(8.0, 1.0, 4.0, 64))
    jcfg, tcfg = _cfgs(**knobs)
    jp = jl.init_llama_params(jcfg, seed=3)
    tp = params_from_numpy(_tree(jp), tcfg, device="cpu")
    _prefill_decode(jp, tp, jcfg, tcfg, B=1, P=4, N=6)


@pytest.mark.parametrize("B", [1, 2])
def test_greedy_generate_tokens_match_jax(models, B):
    jp, tp = models[True]
    jcfg, tcfg = _cfgs()
    ids = _ids(2, B, 6)
    jgen = j_make_gen(jcfg, JServeConfig(max_seq_len=MAX_SEQ,
                                         max_new_tokens=8,
                                         donate_cache=False))
    jt, _ = jgen(jp, jnp.asarray(ids), jl.KVCache.create(jcfg, B, MAX_SEQ),
                 jax.random.PRNGKey(0))
    tgen = make_generate_fn(tcfg, ServeConfig(max_seq_len=MAX_SEQ,
                                              max_new_tokens=8))
    tt, _ = tgen(tp, torch.from_numpy(ids),
                 tl.KVCache.create(tcfg, B, MAX_SEQ, device="cpu"), None)
    assert tt.dtype == torch.int32 and tt.shape == (B, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_fused_logits_equal_unfused(models):
    ids = torch.from_numpy(_ids(4, 1, 6))
    _, tcfg = _cfgs()
    outs = [tl.prefill(models[f][1], ids,
                       tl.KVCache.create(tcfg, 1, MAX_SEQ, device="cpu"),
                       tcfg)[0] for f in (False, True)]
    np.testing.assert_array_equal(outs[0].numpy(), outs[1].numpy())


def test_fuse_projections_matches_jax(models):
    jp, tp = models[False]
    got = tl.fuse_projections(tp)
    ref = _tree(jl.fuse_projections(jp))
    names = dict(tl.named_tensors(got))
    assert set(names) == set(ref)
    for k, v in ref.items():
        t = names[k]
        arr = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
               else t.numpy())
        np.testing.assert_array_equal(arr, v.view(arr.dtype), err_msg=k)


@pytest.mark.parametrize("layout", ["pair", "planar"])
@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scales_dtype", ["fp32", "bf16", "bf16x2"])
def test_quantize_linear_and_embed_lookup_bit_exact(rng, layout, quant_type,
                                                    scales_dtype):
    W = (rng.standard_normal((64, 256)) * 0.02).astype(np.float32)
    jsd = {"fp32": jnp.float32, "bf16": jnp.bfloat16}.get(scales_dtype,
                                                          scales_dtype)
    tsd = {"fp32": torch.float32, "bf16": torch.bfloat16}.get(scales_dtype,
                                                              scales_dtype)
    jq = jl.quantize_linear(jnp.asarray(W), quant_type=quant_type,
                            scales_dtype=jsd, layout=layout)
    tq = tl.quantize_linear(torch.from_numpy(W), quant_type=quant_type,
                            scales_dtype=tsd, layout=layout)
    assert tq.layout == jq.layout and tq.scales.dtype == {
        "fp32": torch.float32, "bf16": torch.bfloat16,
        "bf16x2": torch.int32 if layout == "pair" else torch.float32}[
            scales_dtype]
    np.testing.assert_array_equal(tq.wp.numpy(), np.asarray(jq.wp))
    # The resolved fp32 scales may differ by up to two ulps, for two
    # reasons. (1) The double-quant offset is the fp32 mean of the
    # absmax; torch and XLA sum in different orders, and at this shape
    # (256 blocks) the two means differ in their last bit. (2) JAX's
    # quantize_linear runs under jit, where XLA fuses the double-quant's
    # ``code * absmax2 + offset`` into one fused multiply-add; the port
    # (like the JAX package's eager dequantize_absmax) rounds twice.
    # A bf16 storage rounds that away or moves by one bf16 ulp. The
    # packed codes are compared exactly above.
    ts, js = tq.scales, np.asarray(jq.scales)
    if ts.dtype == torch.float32:
        np.testing.assert_array_max_ulp(ts.numpy(), js, maxulp=2)
    else:
        bits = ts.view(torch.int16).numpy().astype(np.int32)
        ref = js.view(np.int16).astype(np.int32)
        if ts.dtype == torch.int32:         # bf16x2: two bf16 per word
            bits, ref = ts.numpy(), js
            lo = lambda a: (a & 0xFFFF).astype(np.int32)
            hi = lambda a: ((a >> 16) & 0xFFFF).astype(np.int32)
            assert np.abs(lo(bits) - lo(ref)).max() <= 1
            assert np.abs(hi(bits) - hi(ref)).max() <= 1
        else:
            assert np.abs(bits - ref).max() <= 1
    if scales_dtype != "bf16x2":
        # the same stored scales on both sides: the lookup is bit-exact
        tok = np.array([[0, 5, 63, 10]], np.int32)
        ref = jl.embed_lookup(jq, jnp.asarray(tok), quant_type)
        tq = dataclasses.replace(tq, scales=torch.from_numpy(js.view(
            np.int16)).view(torch.bfloat16) if js.dtype.name == "bfloat16"
            else torch.from_numpy(js))
        got = tl.embed_lookup(tq, torch.from_numpy(tok), quant_type)
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))


def test_rope_and_norm_match_jax(rng):
    pos = np.arange(12, dtype=np.int32).reshape(2, 6) * 37
    for scaling in (None, (8.0, 1.0, 4.0, 8192)):
        jc, js = jl.rope_cos_sin(jnp.asarray(pos), 128, 500000.0, scaling)
        tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 128, 500000.0,
                                 scaling)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)
    for i in range(4):
        for knobs in (dict(sliding_window=6),
                      dict(sliding_window=6, sliding_layers="even"),
                      dict(sliding_window=6, sliding_layers="odd"), {}):
            use_j, win_j = jl.layer_window(
                dataclasses.replace(jl.TINY_LLAMA, **knobs), i)
            use_t, win_t = tl.layer_window(
                dataclasses.replace(tl.TINY_LLAMA, **knobs), i)
            assert (use_t is None) == (use_j is None)
            if use_t is not None:
                assert use_t == bool(use_j) and win_t == int(win_j)


def test_port_init_and_generate_on_cpu():
    """The port's own model build (functional quantize on the CPU) and
    its generate, fused and with bf16x2 scales: finite logits, tokens
    in range, the same tokens twice."""
    cfg = dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(
        quantize_embedding=True, scales_dtype="bf16x2"))
    p = tl.fuse_projections(tl.init_llama_params(cfg, seed=0, device="cpu"))
    assert p.layers.qkv.scales.dtype == torch.int32
    assert p.embed.scales.dtype == torch.bfloat16
    gen = make_generate_fn(cfg, ServeConfig(max_seq_len=MAX_SEQ,
                                            max_new_tokens=4))
    ids = torch.from_numpy(_ids(5, 2, 3))
    runs = [gen(p, ids, tl.KVCache.create(cfg, 2, MAX_SEQ, device="cpu"),
                None)[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size


def test_sample_logits():
    g = torch.Generator().manual_seed(0)
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32))
    assert torch.equal(sample_logits(logits), logits.argmax(-1).int())
    top3 = logits.topk(3, dim=-1).indices
    for _ in range(20):
        s = sample_logits(logits, g, temperature=0.7, top_k=3)
        assert (s[:, None] == top3).any(-1).all()
    # top-p: the single most likely token once its mass reaches top_p
    peaked = logits.clone()
    peaked[:, 7] = 40.0
    s = sample_logits(peaked, g, temperature=1.0, top_p=0.5)
    assert torch.equal(s, torch.full((4,), 7, dtype=torch.int32))
    a = sample_logits(logits, torch.Generator().manual_seed(3), 1.0)
    b = sample_logits(logits, torch.Generator().manual_seed(3), 1.0)
    assert torch.equal(a, b)


def test_eos_freezes_rows(models):
    _, tp = models[True]
    _, tcfg = _cfgs()
    ids = torch.from_numpy(_ids(2, 1, 6))
    base, _ = make_generate_fn(tcfg, ServeConfig(
        max_seq_len=MAX_SEQ, max_new_tokens=6))(
            tp, ids, tl.KVCache.create(tcfg, 1, MAX_SEQ, device="cpu"), None)
    eos = int(base[0, 2])
    toks, _ = make_generate_fn(tcfg, ServeConfig(
        max_seq_len=MAX_SEQ, max_new_tokens=6, eos_id=eos))(
            tp, ids, tl.KVCache.create(tcfg, 1, MAX_SEQ, device="cpu"), None)
    first = int((toks[0] == eos).nonzero()[0])
    assert torch.equal(toks[0, :first], base[0, :first])
    assert (toks[0, first:] == eos).all()


@pytest.mark.parametrize("knob", ["axis_name"])
def test_unported_knobs_raise(models, knob):
    _, tp = models[False]
    cache = tl.KVCache.create(tl.TINY_LLAMA, 1, MAX_SEQ, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        tl.prefill(tp, torch.zeros((1, 2), dtype=torch.int32), cache,
                   tl.TINY_LLAMA, **{knob: "tp"})
