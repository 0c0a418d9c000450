"""The port's parity metrics (``evals/parity.py``) against the JAX
package's on the CPU, on the same bridged parameters.

- ``dequantized_params`` equals the JAX package's bit for bit: FP4 and
  NF4, pair and planar words, a 4-bit embedding.
- The lazy dense forward (each layer dequantized as it is reached) gives
  logits bit-identical to the materialized twin's.
- ``_dense_forward`` against the JAX package's on the same dense bf16
  weights: both take bf16 products with fp32 sums and an fp32 einsum
  attention, and agree to 1e-7 where no activation's bf16 rounding
  flips; the flips that fp32 summation order causes move the logits by
  up to 4.6e-3 * max|logit| from its eager run (tolerance 1e-2). Its
  jitted run (what its ``logit_parity`` runs; XLA on the CPU fuses some
  of the activations' bf16 roundings away) lies 1.2e-2 from its own
  eager run, and within 2e-2 of the port.
  On ``TINY_LLAMA``, with q/k/v biases, and with Gemma-2's knobs (sliding
  window on even layers, softcaps, sandwich norms, ``1 + w`` gains, the
  embedding normalizer, GeGLU, ``query_scale``).
- ``logit_parity`` and ``perplexity`` at [2, 12] and [1, 16]: the
  quantized arm runs K1's plain version here (the bf16 class) and the JAX
  package its dense fp32-scale path on the CPU, so the quantized
  perplexity is held within 2e-2 (relative; the logits within 2e-2 *
  max|logit|, ``ROADMAP.md``'s tolerance between the two packages' CPU
  paths), and both reports' deltas to
  the same bound, the dense perplexity within 1e-2 (up to 7.3e-3
  measured, with Gemma-2's knobs; the JAX package's jitted and eager runs
  part as far); the two reports' top-1 within 3 positions and their KLs
  within a factor of 4 of each other.
- ``parity_report``, the report's arithmetic, on the JAX package's own
  quantized and dense logits gives its ``logit_parity`` fields (to 1e-7
  nats of KL, the rest exact or to 2e-6), and on seeded logits far apart
  (KL up to 10 nats) the same fields to 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.evals import parity as jp
from quantizations_tpu.models import llama as jl
from quantizations_tpu.ops.qmatmul import pair_to_planar as j_pair_to_planar
from quantizations_tpu_torch import QuantConfig
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.evals import parity as tp
from quantizations_tpu_torch.models import llama as tl

torch.set_num_threads(1)

EAGER_TOL = 1e-2    # * max|logit|, against the JAX package's eager run
JIT_TOL = 2e-2      # * max|logit|, against its jitted run
QUANT_TOL = 2e-2    # the two packages' quantized CPU paths
PPL_DENSE_TOL = 1e-2
TOP1_POSITIONS = 3  # argmaxes that may differ between the packages' reports
KL_RATIO = 4.0      # between the packages' quantized-arm KLs

KNOBS = {
    "llama": {},
    "bias": dict(attention_bias=True),
    "gemma": dict(sliding_window=4, sliding_layers="even",
                  attn_logit_softcap=50.0, final_logit_softcap=30.0,
                  post_norms=True, norm_plus_one=True, embed_normalizer=True,
                  hidden_activation="gelu_tanh", query_scale=48.0),
}


def _tree(obj):
    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _planar(jpar):
    """The JAX params with every pair QLinear's words back in planar
    order (the same codes and scales)."""
    def conv(leaf):
        if isinstance(leaf, jl.QLinear) and leaf.layout == "pair":
            return jl.QLinear(wp=j_pair_to_planar(leaf.wp),
                              scales=leaf.scales)
        return leaf
    return jax.tree.map(conv, jpar,
                        is_leaf=lambda x: isinstance(x, jl.QLinear))


def _cfgs(quant=None, **knobs):
    quant = quant or {}
    return (dataclasses.replace(jl.TINY_LLAMA, quant=JQuantConfig(**quant),
                                **knobs),
            dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(**quant),
                                **knobs))


def _pair(quant=None, layout="pair", **knobs):
    jcfg, tcfg = _cfgs(quant, **knobs)
    jpar = jl.init_llama_params(jcfg, seed=0)
    if layout == "planar":
        jpar = _planar(jpar)
    return jcfg, tcfg, jpar, params_from_numpy(_tree(jpar), tcfg,
                                               device="cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _pair(**({} if name == "llama" else knobs))
            for name, knobs in KNOBS.items()}


def _ids(shape, seed=0):
    ids = np.random.default_rng(seed).integers(0, tl.TINY_LLAMA.vocab_size,
                                               shape)
    return jnp.asarray(ids, jnp.int32), torch.as_tensor(ids,
                                                        dtype=torch.int32)


def _f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype != np.float32 else a


@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("layout", ["pair", "planar"])
def test_dequantized_params_bit_exact(quant_type, layout):
    quant = dict(quant_type=quant_type, quantize_embedding=True)
    jcfg, tcfg, jpar, tpar = _pair(quant, layout)
    jd = jp.dequantized_params(jpar, jcfg)
    td = tp.dequantized_params(tpar, tcfg)
    want = _tree(jd)
    got = {k: v.float().numpy() for k, v in tl.named_tensors(td)}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], _f32(v), err_msg=k)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        assert getattr(td.layers, name).dtype == torch.bfloat16
    assert td.embed.dtype == torch.bfloat16


@pytest.mark.parametrize("layout", ["pair", "planar"])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_lazy_dense_forward_bit_identical(layout, knob):
    quant = dict(quantize_embedding=True) if knob == "llama" else None
    _, tcfg, _, tpar = _pair(quant, layout, **KNOBS[knob])
    _, ids = _ids((2, 8), seed=2)
    want = tp._dense_forward(tp.dequantized_params(tpar, tcfg), ids, tcfg)
    got = tp._dense_forward(tpar, ids, tcfg, lazy=True)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 1024)
    assert torch.equal(got, want)


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_dense_forward_matches_jax(models, knob):
    jcfg, tcfg, jpar, tpar = models[knob]
    jids, tids = _ids((2, 12))
    jd = jp.dequantized_params(jpar, jcfg)
    got = tp._dense_forward(tp.dequantized_params(tpar, tcfg), tids,
                            tcfg).numpy()
    eager = np.asarray(jp._dense_forward(jd, jids, jcfg))
    jit = np.asarray(jax.jit(functools.partial(jp._dense_forward,
                                               cfg=jcfg))(jd, jids))
    m = np.abs(eager).max()
    assert np.abs(got - eager).max() <= EAGER_TOL * m
    assert np.abs(got - jit).max() <= JIT_TOL * m


def _reports_close(got, want, scale, n_pos):
    assert got.keys() == want.keys()
    assert abs(got["ppl_dense"] - want["ppl_dense"]) <= (
        PPL_DENSE_TOL * want["ppl_dense"])
    assert abs(got["ppl_quant"] - want["ppl_quant"]) <= (
        QUANT_TOL * want["ppl_quant"])
    # the two quantized arms differ by their rounding class: up to 2 of
    # 24 argmaxes (near-ties) and a KL 3.0x the JAX package's (1.2e-5
    # against 3.9e-6 nats) measured
    assert abs(got["top1_agreement"] - want["top1_agreement"]) <= (
        TOP1_POSITIONS / n_pos)
    assert want["mean_kl"] / KL_RATIO <= got["mean_kl"] <= (
        KL_RATIO * want["mean_kl"])
    for rep in (got, want):
        # random tiny logits have near-ties: up to 3 of 24 positions
        # change their argmax between the two arms
        assert 0.8 <= rep["top1_agreement"] <= 1.0
        assert 0.0 <= rep["mean_kl"] < 1e-3
        assert rep["max_abs_logit_delta"] <= QUANT_TOL * scale


@pytest.mark.parametrize("knob,shape", [("llama", (2, 12)),
                                        ("llama", (1, 16)),
                                        ("bias", (2, 12)),
                                        ("gemma", (2, 12))])
def test_logit_parity_matches_jax(models, knob, shape):
    jcfg, tcfg, jpar, tpar = models[knob]
    jids, tids = _ids(shape, seed=1)
    want = jp.logit_parity(jpar, jcfg, jids).to_dict()
    got = tp.logit_parity(tpar, tcfg, tids).to_dict()
    dense = tp._dense_forward(tp.dequantized_params(tpar, tcfg), tids, tcfg)
    _reports_close(got, want, float(dense.abs().max()), shape[0] * shape[1])


@pytest.mark.parametrize("knob,shape", [("llama", (2, 12)),
                                        ("llama", (1, 16)),
                                        ("bias", (2, 12)),
                                        ("gemma", (2, 12))])
def test_parity_report_equals_jax_on_its_logits(models, knob, shape):
    """The report's arithmetic on the JAX package's own quantized and
    dense logits (its jitted ``prefill`` and ``_dense_forward``, what its
    ``logit_parity`` computes): the fields of its report. The argmaxes
    and the largest delta are exact; the perplexities within 2e-6
    (relative, fp32 ``log_softmax``); the KL, a sum of cancelling terms
    near 4e-6 nats, within 1e-7 nats (4.0e-8 measured)."""
    jcfg, _, jpar, _ = models[knob]
    jids, tids = _ids(shape, seed=1)
    want = jp.logit_parity(jpar, jcfg, jids).to_dict()
    ql, _ = jax.jit(functools.partial(jl.prefill, cfg=jcfg))(
        jpar, jids, jl.KVCache.create(jcfg, *shape))
    dl = jax.jit(functools.partial(jp._dense_forward, cfg=jcfg))(
        jp.dequantized_params(jpar, jcfg), jids)
    got = tp.parity_report(torch.from_numpy(np.array(ql)),
                           torch.from_numpy(np.array(dl)), tids).to_dict()
    assert got.keys() == want.keys()
    assert got["top1_agreement"] == pytest.approx(want["top1_agreement"],
                                                  abs=1e-7)
    assert got["max_abs_logit_delta"] == want["max_abs_logit_delta"]
    for k in ("ppl_quant", "ppl_dense"):
        assert got[k] == pytest.approx(want[k], rel=2e-6), k
    assert abs(got["mean_kl"] - want["mean_kl"]) <= 1e-7


@pytest.mark.parametrize("spread", [0.3, 1.0, 4.0])
def test_parity_report_equals_jax_on_wide_logits(models, monkeypatch,
                                                 spread):
    """The same arithmetic on logits far apart (KL 0.03-10 nats, where
    KL(d || q) and KL(q || d) differ): the JAX package's ``logit_parity``
    with its two forwards replaced by the same seeded logits gives the
    port's report to 1e-5 (relative)."""
    jcfg, _, jpar, _ = models["llama"]
    B, T, V = 2, 12, jcfg.vocab_size
    rng = np.random.default_rng(7)
    dl = (rng.standard_normal((B, T, V)) * 3.0).astype(np.float32)
    ql = (dl + spread * rng.standard_normal((B, T, V))).astype(np.float32)
    jids, tids = _ids((B, T), seed=8)
    monkeypatch.setattr(jp, "prefill",
                        lambda p, t, c, cfg: (jnp.asarray(ql), c))
    monkeypatch.setattr(jp, "_dense_forward",
                        lambda d, t, cfg, lazy=False: jnp.asarray(dl))
    want = jp.logit_parity(jpar, jcfg, jids).to_dict()
    got = tp.parity_report(torch.from_numpy(ql), torch.from_numpy(dl),
                           tids).to_dict()
    assert want["mean_kl"] > 0.01
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k


def test_quantized_arm_logits_match_jax(models):
    """The quantized arm's logits, what the report's deltas are taken
    from: within 2e-2 * max|logit| of the JAX package's prefill."""
    jcfg, tcfg, jpar, tpar = models["llama"]
    jids, tids = _ids((2, 12), seed=1)
    want, _ = jax.jit(functools.partial(jl.prefill, cfg=jcfg))(
        jpar, jids, jl.KVCache.create(jcfg, 2, 12))
    got, _ = tl.prefill(tpar, tids, tl.KVCache.create(tcfg, 2, 12,
                                                      device="cpu"), tcfg)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= QUANT_TOL * np.abs(want).max()


@pytest.mark.parametrize("shape", [(2, 12), (1, 16)])
def test_perplexity_matches_jax(models, shape):
    jcfg, tcfg, jpar, tpar = models["llama"]
    jids, tids = _ids(shape, seed=3)
    want = jp.perplexity(jpar, jcfg, jids)
    got = tp.perplexity(tpar, tcfg, tids)
    assert isinstance(got, float) and got > 1.0
    assert abs(got - want) <= QUANT_TOL * want


def test_lazy_rule_gives_the_same_report(models, monkeypatch):
    """Above ``LAZY_TWIN_BYTES`` of dense-twin bytes the twin runs lazily
    (Llama3-8B's 16 GB does); the report is the materialized one's."""
    _, tcfg, _, tpar = models["llama"]
    _, tids = _ids((2, 12), seed=4)
    assert tp.dense_twin_bytes(tpar) < tp.LAZY_TWIN_BYTES
    twin = tp.logit_parity(tpar, tcfg, tids)
    calls = []
    real = tp.dequantized_params
    monkeypatch.setattr(tp, "dequantized_params",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tp, "LAZY_TWIN_BYTES", 0)
    lazy = tp.logit_parity(tpar, tcfg, tids)
    assert calls == [] and lazy == twin


def test_dense_twin_bytes_counts_every_weight(models):
    jcfg, _, _, tpar = models["llama"]
    c = jcfg
    per_layer = (c.q_size + 2 * c.kv_size + c.q_size) * c.hidden_size + \
        3 * c.intermediate_size * c.hidden_size
    want = 2 * (c.num_hidden_layers * per_layer
                + c.vocab_size * c.hidden_size)      # the 4-bit lm_head
    assert tp.dense_twin_bytes(tpar) == want


def test_parity_control_arm_uses_the_dense_twin(models):
    """With ``dense_twin`` both arms compute with the same dense weights:
    on the CPU the two forwards differ only in the cache's bf16 K/V."""
    _, tcfg, _, tpar = models["llama"]
    _, tids = _ids((2, 12), seed=5)
    twin = dataclasses.replace(tcfg, quant=dataclasses.replace(
        tcfg.quant, dense_twin=True))
    ctl = tp.logit_parity(tpar, twin, tids)
    quant = tp.logit_parity(tpar, tcfg, tids)
    assert ctl.top1_agreement == 1.0
    assert ctl.mean_kl < quant.mean_kl


def test_fused_params_refused(models):
    _, tcfg, _, tpar = models["llama"]
    fused = tl.fuse_projections(tpar)
    with pytest.raises(ValueError, match="unfused"):
        tp.dequantized_params(fused, tcfg)
