"""The trained-distribution proxy (``init_llama_params(dist=
"trained_proxy")``) against the JAX package's on the CPU.

torch cannot give JAX's random stream, so the draws are held by
distribution: two-sample Kolmogorov-Smirnov tests (``scipy.stats.
ks_2samp``, fixed seeds, so each test is deterministic; p > 1e-3) of the
port's draws against the JAX package's at [512, 1024] and at a shape that
takes the row-slab path (the slab threshold lowered in both packages):
the Student-t draws before scaling, the log row scales and the norm
gains. The outlier columns' share is held within 5 binomial standard
deviations of 0.5%, in both packages. ``_proxy_weight`` is the product
of its parts, bit for bit, in both packages; the build is deterministic
per seed, and an unknown ``dist`` raises (the JAX package falls back to
normal weights).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from quantizations_tpu.models import llama as jl
from quantizations_tpu_torch.models import llama as tl

torch.set_num_threads(1)

KS_P = 1e-3
SHAPE = (512, 1024)
SLAB_SHAPE = (256, 512)
SLAB_ELEMS = 1 << 14        # both packages slab SLAB_SHAPE with this


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _jax_parts(key, out_f, in_f):
    """The JAX package's ``_proxy_weight`` factors for ``key``, drawn as
    its body draws them (held equal to its product below)."""
    k1, k2, k3 = jax.random.split(key, 3)
    if out_f * in_f >= jl._PROXY_SLAB_ELEMS and out_f % 16 == 0:
        keys = jax.random.split(k1, 16)
        t = jax.lax.map(lambda kk: jax.random.t(
            kk, df=5.0, shape=(out_f // 16, in_f), dtype=jnp.float32),
            keys).reshape(out_f, in_f)
    else:
        t = jax.random.t(k1, df=5.0, shape=(out_f, in_f), dtype=jnp.float32)
    row = jnp.exp(0.4 * jax.random.normal(k2, (out_f, 1), jnp.float32))
    outlier = jnp.where(jax.random.bernoulli(k3, 0.005, (1, in_f)), 8.0, 1.0)
    return t, row, outlier


def _ks(a, b):
    return ks_2samp(np.asarray(a, np.float64).ravel(),
                    np.asarray(b, np.float64).ravel()).pvalue


@pytest.fixture
def slabs(monkeypatch):
    monkeypatch.setattr(jl, "_PROXY_SLAB_ELEMS", SLAB_ELEMS)
    monkeypatch.setattr(tl, "_PROXY_SLAB_ELEMS", SLAB_ELEMS)


def test_jax_parts_are_its_proxy_weight():
    key = jax.random.PRNGKey(3)
    t, row, outlier = _jax_parts(key, 64, 128)
    want = jl._proxy_weight(key, 64, 128, 0.02)
    np.testing.assert_array_equal(
        np.asarray(t * row * outlier * jnp.float32(0.02)), np.asarray(want))


@pytest.mark.parametrize("shape", [(64, 128), SLAB_SHAPE])
def test_proxy_weight_is_the_product_of_its_parts(slabs, shape):
    t, row, outlier = tl._proxy_parts(_gen(5), *shape, torch.device("cpu"))
    w = tl._proxy_weight(_gen(5), *shape, 0.02, torch.device("cpu"))
    assert w.dtype == torch.float32 and w.shape == shape
    assert torch.equal(w, t * row * outlier * 0.02)


@pytest.mark.parametrize("shape", [SHAPE, SLAB_SHAPE], ids=["plain", "slab"])
def test_student_t_draws_match_jax(slabs, shape):
    t, _, _ = tl._proxy_parts(_gen(0), *shape, torch.device("cpu"))
    jt, _, _ = _jax_parts(jax.random.PRNGKey(0), *shape)
    assert torch.isfinite(t).all()
    assert _ks(t.numpy(), jt) > KS_P
    # against a normal sample of the same size the test sees the tails
    normal = np.random.default_rng(0).standard_normal(t.numel())
    assert _ks(t.numpy(), normal) < 1e-6


def test_slab_path_draws_sixteen_slabs(slabs, monkeypatch):
    rows = []
    real = tl._proxy_student_t
    monkeypatch.setattr(tl, "_proxy_student_t",
                        lambda g, r, c, d: rows.append(r) or real(g, r, c, d))
    tl._proxy_parts(_gen(0), *SLAB_SHAPE, torch.device("cpu"))
    assert rows == [SLAB_SHAPE[0] // 16] * 16
    rows.clear()
    tl._proxy_parts(_gen(0), 64, 128, torch.device("cpu"))
    assert rows == [64]


def test_row_scales_match_jax():
    rows = 20000
    _, row, _ = tl._proxy_parts(_gen(1), rows, 8, torch.device("cpu"))
    _, jrow, _ = _jax_parts(jax.random.PRNGKey(1), rows, 8)
    assert (row > 0).all()
    assert _ks(torch.log(row).numpy(), np.log(np.asarray(jrow))) > KS_P
    assert abs(float(torch.log(row).std()) - 0.4) < 0.01


def test_outlier_share_within_binomial_bound():
    cols = 200000
    _, _, out = tl._proxy_parts(_gen(2), 16, cols, torch.device("cpu"))
    _, _, jout = _jax_parts(jax.random.PRNGKey(2), 16, cols)
    sd = np.sqrt(cols * 0.005 * 0.995)
    for o in (out.numpy(), np.asarray(jout)):
        assert set(np.unique(o)) == {1.0, 8.0}
        assert abs(int((o == 8.0).sum()) - cols * 0.005) < 5 * sd


def test_norm_gains_match_jax():
    n = 100000
    g = tl._proxy_norm_gain(_gen(4), n, torch.device("cpu"))
    jg = jnp.abs(1.0 + 0.3 * jax.random.normal(
        jax.random.PRNGKey(4), (n,), jnp.float32)).astype(jnp.bfloat16)
    assert g.dtype == torch.bfloat16 and (g >= 0).all()
    assert _ks(g.float().numpy(), np.asarray(jg, np.float32)) > KS_P


def _gains(tree_layers, final):
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in (*tree_layers, final)])


@pytest.fixture(scope="module")
def builds():
    """``TINY_LLAMA`` proxy builds from seed 0: the JAX package's, the
    port's."""
    return (jl.init_llama_params(jl.TINY_LLAMA, seed=0, dist="trained_proxy"),
            tl.init_llama_params(tl.TINY_LLAMA, seed=0, dist="trained_proxy",
                                 device="cpu"))


def test_model_norm_gains_match_jax(builds):
    """The gains of a whole ``TINY_LLAMA`` proxy build (attention, MLP
    and final norms: 2560 values) in both packages."""
    jp, tp = builds
    want = _gains((jp.layers.attn_norm, jp.layers.mlp_norm), jp.final_norm)
    got = _gains((tp.layers.attn_norm.float(), tp.layers.mlp_norm.float()),
                 tp.final_norm.float())
    assert got.shape == want.shape == (5 * 512,)
    assert _ks(got, want) > KS_P
    assert not np.all(got == 1.0)


def test_model_weights_carry_the_proxy_statistics(builds):
    """The [1024, 512] gate weights of both layers of a ``TINY_LLAMA``
    proxy build, dequantized, against the JAX package's: the log row
    norms, centred (one draw of outlier columns per matrix shifts every
    row's norm alike), by KS, and their spread near the row scales'
    0.4."""
    from quantizations_tpu.evals.parity import dequantized_params as jdq
    from quantizations_tpu_torch.evals.parity import dequantized_params

    jp, tp = builds
    w = dequantized_params(tp, tl.TINY_LLAMA).layers.gate.float().numpy()
    jw = np.asarray(jdq(jp, jl.TINY_LLAMA).layers.gate, np.float32)
    assert w.shape == jw.shape == (2, 1024, 512)

    def centred_log_norms(x):
        ln = np.log(np.linalg.norm(x, axis=-1))
        return ln - ln.mean(axis=-1, keepdims=True)

    a, b = centred_log_norms(w), centred_log_norms(jw)
    assert _ks(a, b) > KS_P
    assert 0.35 < a.std() < 0.45 and 0.35 < b.std() < 0.45


@pytest.mark.parametrize("dist", ["normal", "trained_proxy"])
def test_build_is_deterministic_per_seed(dist):
    cfg = dataclasses.replace(tl.TINY_LLAMA, num_hidden_layers=1)
    a = tl.init_llama_params(cfg, seed=7, dist=dist, device="cpu")
    b = tl.init_llama_params(cfg, seed=7, dist=dist, device="cpu")
    c = tl.init_llama_params(cfg, seed=8, dist=dist, device="cpu")
    ta, tb, tc = (dict(tl.named_tensors(p)) for p in (a, b, c))
    assert ta.keys() == tb.keys() == tc.keys()
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    assert not torch.equal(ta["layers.q.wp"], tc["layers.q.wp"])


def test_proxy_differs_from_normal():
    cfg = dataclasses.replace(tl.TINY_LLAMA, num_hidden_layers=1)
    n = tl.init_llama_params(cfg, seed=0, device="cpu")
    p = tl.init_llama_params(cfg, seed=0, dist="trained_proxy", device="cpu")
    assert torch.equal(n.final_norm, torch.ones_like(n.final_norm))
    assert not torch.equal(p.final_norm, torch.ones_like(p.final_norm))
    # the dense proxy embedding has heavy tails: its largest |w| is far
    # past a normal table's of the same scale
    assert float(p.embed.abs().max()) > 2 * float(n.embed.abs().max())


def test_unknown_dist_raises():
    with pytest.raises(ValueError, match="dist"):
        tl.init_llama_params(tl.TINY_LLAMA, dist="uniform", device="cpu")
