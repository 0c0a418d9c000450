"""The pair kernel's variants in the port against the JAX package: K8
(the decode-once prefill pair kernel), K9 (the manual-pipeline pair
kernel), their routing rules and dispatch, and the ``dense_twin`` path.

- K8's and K9's plain versions against the TPU kernels in interpret
  mode, within 1e-5 * max|y|: the same rounding class (bf16 scale times
  bf16 out_factor, bf16 weights, bf16 activations, fp32 sums), only the
  fp32 summation order differs. As in ``tests/test_torch_qmatmul.py``,
  the JAX side is given at least 8 token rows (zero-padded) so that XLA
  on the CPU keeps the kernel's bf16 rounding.
- The routing predicates (TPU VMEM budgets, copied into the port) equal
  the reference's at the Llama3-8B shapes.
- Spies on the wrappers show which projections take which kernel.
- ``TINY_LLAMA`` with each knob against the port's default run and the
  JAX package's CPU forward (2e-2 * max|logit|, as
  ``tests/test_torch_llama.py`` explains).
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
from quantizations_tpu.ops import qmatmul as jqm
from quantizations_tpu.serve.generate import make_generate_fn as j_make_gen
from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.bridge import (linear4bit_from_numpy,
                                            linear4bit_to_numpy,
                                            params_from_numpy)
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.nn import linear as tlin
from quantizations_tpu_torch.nn.linear import Linear4bit
from quantizations_tpu_torch.ops import qmatmul as tqm
from quantizations_tpu_torch.serve import paged as tp
from quantizations_tpu_torch.serve.generate import make_generate_fn

torch.set_num_threads(1)

M, K, L = 256, 512, 3
TOL = 1e-5
LOGIT_TOL = 2e-2
MAX_SEQ = 32
# (M, K) of every Llama3-8B projection the model runs: fused q|k|v, o,
# fused gate|up, down, the lm_head
LLAMA3_8B_SHAPES = ((6144, 4096), (4096, 4096), (28672, 4096),
                    (4096, 14336), (128256, 4096))
TOKENS = (1, 4, 8, 16, 64, 128, 256, 512)


def _operands(rng, lead=(), m=M):
    wp2 = rng.integers(-2**31, 2**31, lead + (m // 2, K // 4),
                       dtype=np.int64).astype(np.int32)
    scales = (rng.random(lead + (m, K // 64)) * 0.05 + 0.01).astype(
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
    """bf16 activations ``[T, K]`` for the port and the same rows padded
    with zeros to at least 8 for the JAX side."""
    xt = torch.from_numpy(rng.standard_normal((T, K)).astype(
        np.float32)).to(torch.bfloat16)
    pad = np.zeros((max(T, 8), K), np.float32)
    pad[:T] = xt.float().numpy()
    return xt, jnp.asarray(pad).astype(jnp.bfloat16)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# -- K8: the decode-once prefill pair kernel ----------------------------------

@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("form", ["unstacked", "stacked"])
def test_prefill_plain_matches_pallas(rng, quant_type, scale_kind, form):
    wp2, scales = _operands(rng, (L,))
    js, ts = _scales(scales, scale_kind)
    xt, xj = _x(rng, 16)
    if form == "stacked":
        ref = jqm.matmul_4bit_pair_prefill_pallas_stacked(
            jnp.asarray(wp2), js, xj, jnp.int32(1), quant_type=quant_type,
            interpret=True)
        got = tqm.matmul_4bit_pair_prefill_stacked(
            torch.from_numpy(wp2), ts, xt, 1, quant_type)
    else:
        ref = jqm.matmul_4bit_pair_prefill_pallas(
            jnp.asarray(wp2[1]), js[1], xj, quant_type=quant_type,
            interpret=True)
        got = tqm.matmul_4bit_pair_prefill(torch.from_numpy(wp2[1]), ts[1],
                                           xt, quant_type)
    assert got.dtype == torch.float32 and got.shape == (16, M)
    _close(got.numpy(), ref)
    # K1's class: the same weights as K1's plain version, other sum order
    _close(got.numpy(), tqm.matmul_4bit_pair_plain(
        torch.from_numpy(wp2[1]), ts[1], xt, quant_type).numpy())


@pytest.mark.parametrize("stacked", [False, True])
def test_pair_prefill_matmul_chunks(rng, monkeypatch, stacked):
    """T = 80 with the chunk cap patched to 32 in both packages: three
    launches' worth of chunks, equal to the per-chunk calls, within the
    gate of the reference's chunked product."""
    monkeypatch.setattr(tqm, "PREFILL_PAIR_CHUNK_T", 32)
    monkeypatch.setattr(jqm, "PREFILL_PAIR_CHUNK_T", 32)
    wp2, scales = _operands(rng, (L,))
    xt = torch.from_numpy(rng.standard_normal((80, K)).astype(
        np.float32)).to(torch.bfloat16)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    idx = 2 if stacked else None
    w, s = (wp2, scales) if stacked else (wp2[2], scales[2])
    got = tqm.pair_prefill_matmul(torch.from_numpy(w), torch.from_numpy(s),
                                  xt, "fp4", layer_idx=idx)
    parts = [tqm.matmul_4bit_pair_prefill(torch.from_numpy(wp2[2]),
                                          torch.from_numpy(scales[2]),
                                          xt[t0:t0 + 32], "fp4")
             for t0 in (0, 32, 64)]
    np.testing.assert_array_equal(got.numpy(), torch.cat(parts).numpy())
    ref = jqm.pair_prefill_matmul(
        jnp.asarray(w), jnp.asarray(s), xj, "fp4",
        layer_idx=None if idx is None else jnp.int32(idx), interpret=True)
    _close(got.numpy(), ref)


# -- K9: the manual-pipeline pair kernel --------------------------------------

@pytest.mark.parametrize("quant_type", ["fp4", "nf4"])
@pytest.mark.parametrize("scale_kind", ["fp32", "bf16", "bf16x2"])
@pytest.mark.parametrize("T", [1, 4, 16])
def test_manual_plain_matches_pallas(rng, quant_type, scale_kind, T):
    wp2, scales = _operands(rng, (L,))
    js, ts = _scales(scales, scale_kind)
    xt, xj = _x(rng, T)
    w = torch.from_numpy(wp2)
    ref = jqm.matmul_4bit_pair_manual(jnp.asarray(wp2[0]), js[0], xj,
                                      quant_type=quant_type,
                                      interpret=True)[:T]
    got = tqm.matmul_4bit_pair_manual(w[0], ts[0], xt, quant_type)
    _close(got.numpy(), ref)
    ref = jqm.matmul_4bit_pair_manual_stacked(
        jnp.asarray(wp2), js, xj, jnp.int32(1), quant_type=quant_type,
        interpret=True)[:T]
    got = tqm.matmul_4bit_pair_manual_stacked(w, ts, xt, 1, quant_type)
    _close(got.numpy(), ref)
    # K9 is K1 bit for bit
    np.testing.assert_array_equal(
        got.numpy(),
        tqm.matmul_4bit_pair_plain(w[1], ts[1], xt, quant_type).numpy())


# -- the routing rules --------------------------------------------------------

@pytest.mark.parametrize("shape", LLAMA3_8B_SHAPES, ids=str)
def test_routing_rules_equal_the_reference(shape):
    Mx, Kx = shape
    K4 = Kx // 4
    assert tqm._pick_tile_manual(Mx, K4) == jqm._pick_tile_manual(Mx, K4)
    for T in TOKENS:
        for s_item in (2, 4):
            assert (tqm._pick_tiles_pair_prefill(Mx, K4, T, 2, s_item)
                    == jqm._pick_tiles_pair_prefill(Mx, K4, T, 2, s_item))
            assert (tqm.prefill_pair_ok(Mx, K4, T, s_item)
                    == jqm.prefill_pair_ok(Mx, K4, T, s_item))
            assert (tqm.manual_vmem_ok(Mx, Kx, T, s_item)
                    == jqm.manual_vmem_ok(Mx, Kx, T, s_item))
    # the reference's model dispatch budgets bf16x2 scales at 4 bytes a
    # row (no s_itemsize), the port at 2: at these shapes both agree
    for T in (256, 512):
        assert tqm.prefill_pair_ok(Mx, K4, T, 2) == jqm.prefill_pair_ok(
            Mx, K4, T)


def test_manual_gate_at_llama3_8b():
    """Which Llama3-8B projections pass the manual gate (fp32 scales):
    qkv and o up to 128 rows, down up to 16, never gate_up or the
    lm_head; and packed scales never."""
    f32 = torch.zeros(1, dtype=torch.float32)
    packed = torch.zeros(1, dtype=torch.int32)
    got = {s: [T for T in TOKENS if tlin.manual_ok(s[0], s[1], T, f32)]
           for s in LLAMA3_8B_SHAPES}
    assert got == {(6144, 4096): [1, 4, 8, 16, 64, 128],
                   (4096, 4096): [1, 4, 8, 16, 64, 128],
                   (28672, 4096): [], (4096, 14336): [1, 4, 8, 16],
                   (128256, 4096): []}
    assert not tlin.manual_ok(4096, 4096, 1, packed)
    assert not tlin.manual_ok(4160, 4096, 1, f32)       # M % 128 != 0


# -- dispatch -----------------------------------------------------------------

class _Spy:
    """Counts the calls of a wrapper it stands in for."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _spy(monkeypatch, module, name):
    spy = _Spy(getattr(module, name))
    monkeypatch.setattr(module, name, spy)
    return spy


@pytest.mark.parametrize("case,want", [
    (dict(pipeline="manual"), "manual"),
    (dict(pipeline="grid"), "grid"),
    (dict(pipeline="manual", scale_kind="bf16x2"), "grid"),
    (dict(pipeline="manual", m=130), "grid"),
    (dict(pipeline="manual", T=300), "dense")])
def test_apply_4bit_routes(rng, monkeypatch, case, want):
    spies = {"manual": _spy(monkeypatch, tlin, "matmul_4bit_pair_manual"),
             "grid": _spy(monkeypatch, tlin, "matmul_4bit_pair"),
             "dense": _spy(monkeypatch, tlin, "dense_matmul_pair")}
    wp2, scales = _operands(rng, m=case.get("m", M))
    _, ts = _scales(scales, case.get("scale_kind", "fp32"))
    x = torch.from_numpy(rng.standard_normal((case.get("T", 4), K)).astype(
        np.float32))
    y = tlin.apply_4bit(x, torch.from_numpy(wp2), ts, "fp4",
                        pair_pipeline=case["pipeline"])
    assert {k: s.calls for k, s in spies.items()} == {
        k: int(k == want) for k in spies}
    ref = tqm.matmul_4bit_pair_plain(torch.from_numpy(wp2), ts,
                                     x.to(torch.bfloat16), "fp4")
    if want == "dense":
        _close(y.numpy(), ref.numpy(), 1e-2)
    else:
        np.testing.assert_array_equal(y.numpy(), ref.numpy())


@pytest.mark.parametrize("case,want", [
    (dict(T=4), "grid"),
    (dict(T=4, pipeline="manual"), "manual"),
    (dict(T=4, pipeline="manual", scale_kind="bf16x2"), "grid"),
    (dict(T=264), "dense"),
    (dict(T=264, prefill="1"), "prefill"),
    (dict(T=260, prefill="1"), "dense"),              # 260 % 8 != 0
    (dict(T=256, prefill="1"), "grid"),               # in the K1 band
    (dict(T=16, prefill="1", band="8"), "prefill"),
    (dict(T=16, prefill="0", band="8"), "dense")])
def test_ql_routes(rng, monkeypatch, case, want):
    spies = {"manual": _spy(monkeypatch, tl,
                            "matmul_4bit_pair_manual_stacked"),
             "grid": _spy(monkeypatch, tl, "matmul_4bit_pair_stacked"),
             "prefill": _spy(monkeypatch, tl, "pair_prefill_matmul"),
             "dense": _spy(monkeypatch, tlin, "dense_matmul_pair")}
    monkeypatch.delenv("QT_PREFILL_PAIR", raising=False)
    monkeypatch.delenv("QT_PAIR_MAX_TOKENS", raising=False)
    if "prefill" in case:
        monkeypatch.setenv("QT_PREFILL_PAIR", case["prefill"])
    if "band" in case:
        monkeypatch.setenv("QT_PAIR_MAX_TOKENS", case["band"])
    wp2, scales = _operands(rng, (L,))
    _, ts = _scales(scales, case.get("scale_kind", "fp32"))
    lin = tl.QLinear(wp=torch.from_numpy(wp2), scales=ts)
    qcfg = QuantConfig(pair_pipeline=case.get("pipeline", "grid"))
    x = torch.from_numpy(rng.standard_normal((case["T"], K)).astype(
        np.float32)).to(torch.bfloat16)
    y = tl._ql(x, lin, qcfg, 1)
    assert y.shape == (case["T"], M)
    assert {k: s.calls for k, s in spies.items()} == {
        k: int(k == want) for k in spies}


def test_prefill_pair_env_is_validated(monkeypatch):
    monkeypatch.delenv("QT_PREFILL_PAIR", raising=False)
    assert not tl.prefill_pair_enabled()
    for raw, want in (("0", False), ("1", True), ("2", True)):
        monkeypatch.setenv("QT_PREFILL_PAIR", raw)
        assert tl.prefill_pair_enabled() is want
    for bad in ("", "yes", "1.5"):
        monkeypatch.setenv("QT_PREFILL_PAIR", bad)
        with pytest.raises(ValueError, match="QT_PREFILL_PAIR"):
            tl.prefill_pair_enabled()


def test_linear4bit_pair_pipeline(rng, monkeypatch):
    """``Linear4bit`` carries ``pair_pipeline`` and ``fp4_decode``
    (validated as ``QuantConfig`` validates them, and through the
    bridge): a pair layer with ``"manual"`` takes K9's wrapper, with the
    grid layer's output bit for bit."""
    spy = _spy(monkeypatch, tlin, "matmul_4bit_pair_manual")
    W = rng.standard_normal((256, 512)).astype(np.float32) * 0.05
    grid = Linear4bit.create(W, layout="pair", device="cpu")
    tree, meta = linear4bit_to_numpy(grid)
    manual = linear4bit_from_numpy(tree, meta, pair_pipeline="manual",
                                   fp4_decode="mixg0", device="cpu")
    assert (manual.pair_pipeline, manual.fp4_decode) == ("manual", "mixg0")
    x = torch.from_numpy(rng.standard_normal((2, 3, 512)).astype(np.float32))
    np.testing.assert_array_equal(manual(x).numpy(), grid(x).numpy())
    assert spy.calls == 1
    with pytest.raises(ValueError, match="pair_pipeline"):
        Linear4bit(grid.weight, pair_pipeline="dma")
    with pytest.raises(ValueError, match="fp4_decode"):
        Linear4bit(grid.weight, fp4_decode="tree")


# -- TINY_LLAMA ---------------------------------------------------------------

def _tree(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _cfgs(**quant):
    q = dict(quantize_embedding=True, **quant)
    return (dataclasses.replace(jl.TINY_LLAMA, quant=JQuantConfig(**q)),
            dataclasses.replace(tl.TINY_LLAMA, quant=QuantConfig(**q)))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _cfgs()
    jp = jl.fuse_projections(jl.init_llama_params(jcfg, seed=0))
    return jp, params_from_numpy(_tree(jp), tcfg, device="cpu")


def _ids(B, T, seed=2):
    return np.random.default_rng(seed).integers(
        0, jl.TINY_LLAMA.vocab_size, (B, T)).astype(np.int32)


def _port_run(tp, tcfg, ids, new=6, last=False):
    """(prefill logits, of the last token only with ``last``; greedy
    tokens) of the port."""
    B, T = ids.shape
    logits, _ = tl.prefill(tp, torch.from_numpy(ids),
                           tl.KVCache.create(tcfg, B, MAX_SEQ, device="cpu"),
                           tcfg, last_token_only=last)
    gen = make_generate_fn(tcfg, ServeConfig(max_seq_len=MAX_SEQ,
                                             max_new_tokens=new))
    toks, _ = gen(tp, torch.from_numpy(ids),
                  tl.KVCache.create(tcfg, B, MAX_SEQ, device="cpu"), None)
    return logits.numpy(), toks.numpy()


def _jax_run(jp, jcfg, ids, new=6, last=False):
    B, _ = ids.shape
    logits, _ = jl.prefill(jp, jnp.asarray(ids),
                           jl.KVCache.create(jcfg, B, MAX_SEQ), jcfg,
                           last_token_only=last)
    gen = j_make_gen(jcfg, JServeConfig(max_seq_len=MAX_SEQ,
                                        max_new_tokens=new,
                                        donate_cache=False))
    toks, _ = gen(jp, jnp.asarray(ids), jl.KVCache.create(jcfg, B, MAX_SEQ),
                  jax.random.PRNGKey(0))
    return np.asarray(logits), np.asarray(toks)


def test_tiny_llama_manual_pipeline(tiny, monkeypatch):
    """Every TINY_LLAMA projection passes the manual gate: the whole
    model runs K9's wrapper, with the grid run's logits bit for bit and
    the JAX package's within 2e-2 * max|logit|, equal greedy tokens."""
    jp, tparams = tiny
    spy_stacked = _spy(monkeypatch, tl, "matmul_4bit_pair_manual_stacked")
    spy_head = _spy(monkeypatch, tlin, "matmul_4bit_pair_manual")
    grid_k1 = _spy(monkeypatch, tl, "matmul_4bit_pair_stacked")
    _, tgrid = _cfgs()
    jcfg, tcfg = _cfgs(pair_pipeline="manual")
    ids = _ids(2, 8)
    ref_logits, ref_toks = _port_run(tparams, tgrid, ids)
    grid_k1.calls = 0
    logits, toks = _port_run(tparams, tcfg, ids)
    # 7 forwards (the prefill, then the generate's prefill and 5 steps)
    assert grid_k1.calls == 0
    assert spy_stacked.calls == 7 * 4 * 2 and spy_head.calls == 7
    np.testing.assert_array_equal(logits, ref_logits)
    np.testing.assert_array_equal(toks, ref_toks)
    jlogits, jtoks = _jax_run(jp, jcfg, ids)
    _close(logits, jlogits, LOGIT_TOL)
    np.testing.assert_array_equal(toks, jtoks)


def test_tiny_llama_prefill_pair(tiny, monkeypatch):
    """``QT_PREFILL_PAIR=1`` with the K1 band lowered to 8 rows: the
    16-row prompt's projections take K8 (two layers x 4), the decode
    steps and the 2-row lm_head K1. K8 and K1 are one rounding class
    (only fp32 sums differ, 2e-7 of max|y| per projection above), but
    the model rounds its residual stream to bf16 after every projection,
    and a sum that lands on the other side of a bf16 rounding moves that
    activation by 2^-9: the last token's logits sit 4e-3 * max|logit|
    from the default run's (K1 everywhere), gated at 1e-2, and within
    2e-2 of the JAX package's; equal greedy tokens."""
    jp, tparams = tiny
    jcfg, tcfg = _cfgs()
    ids = _ids(2, 8)
    ref_logits, ref_toks = _port_run(tparams, tcfg, ids, last=True)
    spy = _spy(monkeypatch, tqm, "matmul_4bit_pair_prefill_stacked")
    monkeypatch.setenv("QT_PREFILL_PAIR", "1")
    monkeypatch.setenv("QT_PAIR_MAX_TOKENS", "8")
    logits, toks = _port_run(tparams, tcfg, ids, last=True)
    assert spy.calls == 2 * (4 * 2)         # prefill, then generate's
    _close(logits, ref_logits, 1e-2)
    np.testing.assert_array_equal(toks, ref_toks)
    jlogits, jtoks = _jax_run(jp, jcfg, ids, last=True)
    _close(logits, jlogits, LOGIT_TOL)
    np.testing.assert_array_equal(toks, jtoks)


def test_tiny_llama_dense_twin(tiny, monkeypatch):
    """``dense_twin=True``: every projection is the dense bf16 weight
    times bf16 activations with fp32 sums, the JAX package's twin. The
    weights are the same on both sides; the rest of the forward rounds as
    ``tests/test_torch_llama.py`` says (6e-3 of max|logit| here), so the
    logits are held at 2e-2, with equal greedy tokens. No 4-bit kernel
    runs."""
    jp, tparams = tiny
    spies = [_spy(monkeypatch, tl, "matmul_4bit_pair_stacked"),
             _spy(monkeypatch, tlin, "matmul_4bit_pair")]
    jcfg, tcfg = _cfgs(dense_twin=True)
    ids = _ids(2, 8)
    logits, toks = _port_run(tparams, tcfg, ids)
    assert [s.calls for s in spies] == [0, 0]
    jlogits, jtoks = _jax_run(jp, jcfg, ids)
    _close(logits, jlogits, LOGIT_TOL)
    np.testing.assert_array_equal(toks, jtoks)


def test_paged_decode_step_takes_manual(tiny, monkeypatch):
    """A ``PagedEngine`` with ``pair_pipeline="manual"``: every decode
    step over the pool (``_paged_forward``) runs its 8 projections and
    the lm_head through K9's wrappers, and the engine serves the grid
    engine's tokens."""
    _, tparams = tiny
    prompts = [[int(t) for t in _ids(1, n, seed=30 + n)[0]] for n in (5, 9)]
    kw = dict(num_pages=24, page_size=16, slots=2, max_seq=64,
              prefill_buckets=(8, 16))
    stacked = _spy(monkeypatch, tl, "matmul_4bit_pair_manual_stacked")
    head = _spy(monkeypatch, tlin, "matmul_4bit_pair_manual")
    forward, per_step = tp._paged_forward, []

    def counted(*a, **k):
        before = (stacked.calls, head.calls)
        out = forward(*a, **k)
        per_step.append((stacked.calls - before[0], head.calls - before[1]))
        return out

    monkeypatch.setattr(tp, "_paged_forward", counted)
    outs = {}
    for pipeline in ("grid", "manual"):
        _, cfg = _cfgs(pair_pipeline=pipeline)
        per_step.clear()
        eng = tp.PagedEngine(tparams, cfg, **kw)
        uids = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        outs[pipeline] = [eng.finished[u].output_ids for u in uids]
        want = (4 * 2, 1) if pipeline == "manual" else (0, 0)
        assert per_step and set(per_step) == {want}
    assert outs["manual"] == outs["grid"]
