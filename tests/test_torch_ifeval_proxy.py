"""The port's IFEval proxy (``evals/ifeval_proxy.py``) against the JAX
package's on the CPU.

- ``PROXY_DATASET`` (109 examples, all 25 official ids), the proxy
  tokenizer's pieces, ``detokenize`` and ``encode_prompt`` equal the JAX
  package's exactly.
- ``run_ifeval_proxy(preset="tiny", max_new_tokens=4, device="cpu")``
  with the JAX package's ``TINY_LLAMA`` proxy params carried across
  (``init_llama_params`` of the port patched to return them): the result
  has the JAX package's keys and counts; the dense-twin arm's transcripts
  equal the JAX twin arm's except where a stream parts at a near-tie (the
  port's top-2 logit margin there within 2e-2 * max|logit|, the two
  packages' rounding classes on the CPU; one stream of 109 parts, at its
  first token); the quantized arm's scores lie within 0.05 of the JAX
  package's (6 of 120 verdicts): on the CPU it runs K1's plain version
  (bf16 class) where the JAX package runs its dense fp32-scale path.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.evals import ifeval_proxy as jip
from quantizations_tpu.models import llama as jl
from quantizations_tpu.serve import engine as je
from quantizations_tpu_torch import QuantConfig
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.evals import ifeval_proxy as tip
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve import engine as te

torch.set_num_threads(1)

NEW = 4
SCORE_TOL = 0.05
TIE_TOL = 2e-2


def _tree(obj):
    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def test_dataset_and_tokenizer_equal_jax():
    assert tip.PROXY_DATASET == jip.PROXY_DATASET
    assert len(tip.PROXY_DATASET) == 109
    assert tip._PIECES == jip._PIECES and len(tip._PIECES) == 512
    assert tip._covered() == jip._covered()
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 300):
        ids = rng.integers(0, 1 << 17, n)
        assert tip.detokenize(ids) == jip.detokenize(ids)
    for ex in tip.PROXY_DATASET:
        for vocab in (1024, 128256):
            assert tip.encode_prompt(ex["prompt"], vocab) == \
                jip.encode_prompt(ex["prompt"], vocab)


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs, with every ``Engine.run``'s output ids kept
    (arm 0: quantized, arm 1: dense twin)."""
    jcfg = dataclasses.replace(jl.TINY_LLAMA, kv_cache_dtype="bf16",
                               quant=JQuantConfig())
    jpar = jl.init_llama_params(jcfg, seed=0, dist="trained_proxy")
    tpar = params_from_numpy(_tree(jpar), tl.TINY_LLAMA, device="cpu")
    streams = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    for mod, key in ((je, "jax"), (te, "port")):
        real = mod.Engine.run

        def run(self, *a, _real=real, _key=key, **kw):
            out = _real(self, *a, **kw)
            streams[_key].append({u: list(r.output_ids)
                                  for u, r in out.items()})
            return out
        mp.setattr(mod.Engine, "run", run)
    mp.setattr(tl, "init_llama_params", lambda *a, **kw: tpar)
    try:
        want = jip.run_ifeval_proxy(preset="tiny", max_new_tokens=NEW)
        got = tip.run_ifeval_proxy(preset="tiny", max_new_tokens=NEW,
                                   device="cpu")
    finally:
        mp.undo()
    return want, got, streams, tpar


def test_result_keys_and_counts_equal_jax(runs):
    want, got, _, _ = runs
    assert got.keys() == want.keys()
    for k in ("n_examples", "n_instructions", "max_new_tokens"):
        assert got[k] == want[k]
    assert (got["n_examples"], got["n_instructions"]) == (109, 120)
    for arm in ("quantized", "dense_twin"):
        assert got[arm].keys() == want[arm].keys()
        for k in ("prompt_total", "instruction_total",
                  "skipped_instructions"):
            assert got[arm][k] == want[arm][k]
    assert got["deltas"].keys() == want["deltas"].keys()


def _margin_at(tpar, prompt, prefix):
    """The port's dense-twin top-2 logit margin after ``prompt + prefix``,
    over max|logit|."""
    cfg = dataclasses.replace(tl.TINY_LLAMA,
                              quant=QuantConfig(dense_twin=True))
    ids = torch.tensor([prompt + prefix], dtype=torch.int32)
    logits, _ = tl.prefill(tpar, ids, tl.KVCache.create(
        cfg, 1, ids.shape[1], device="cpu"), cfg)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1]) / float(logits[0, -1].abs().max())


def test_dense_twin_texts_equal_jax(runs):
    _, _, streams, tpar = runs
    want, got = streams["jax"][1], streams["port"][1]
    assert want.keys() == got.keys() and len(got) == 109
    prompts = [tip.encode_prompt(ex["prompt"], tl.TINY_LLAMA.vocab_size)
               for ex in tip.PROXY_DATASET]
    parted = 0
    for uid in got:
        a, b = want[uid], got[uid]
        assert len(b) == NEW
        if a == b:
            continue
        parted += 1
        first = next(i for i in range(NEW) if a[i] != b[i])
        assert _margin_at(tpar, prompts[uid - 1], b[:first]) <= TIE_TOL, uid
    assert parted <= 3
    texts = [tip.detokenize(got[u]) for u in sorted(got)]
    assert all(texts)


def test_quantized_scores_within_tolerance(runs):
    want, got, _, _ = runs
    for k in ("prompt_accuracy", "instruction_accuracy"):
        assert abs(got["quantized"][k] - want["quantized"][k]) <= SCORE_TOL
        assert abs(got["dense_twin"][k] - want["dense_twin"][k]) <= SCORE_TOL
        assert abs(got["deltas"][k] - want["deltas"][k]) <= 2 * SCORE_TOL
    assert got["verdict_agreement"] >= 0.9


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tip.run_ifeval_proxy(preset="tiny", max_new_tokens=1)
