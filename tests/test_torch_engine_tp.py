"""Both engines, the loaders and the serving CLI under a tensor-parallel
mesh, with gloo ranks on the CPU, against the JAX package's engines and
loaders on the 8-device CPU mesh and against the port's single-device
paths.

- ``Engine(mesh=...)`` and ``PagedEngine(mesh=...)``, bf16 and int8,
  plain steps, multi-step windows and speculative windows: every rank
  returns the same ``finished``, equal to the JAX package's sharded
  engine (its ``tests/test_engine_tp.py`` and ``test_int8_tp.py``
  prompts) and to the port's single-device engine on the same planar
  o/down.
- ``load_hf_llama(mesh=...)`` and ``load_checkpoint(mesh=...)``: each
  rank's shard bit for bit the slice of the single-device load
  (``shard_for_rank``), and of the JAX package's mesh load.
- ``python -m quantizations_tpu_torch.serve --tp 2``: the JAX CLI's
  ``--tp 2`` tokens, generate and the paged engine (the slot engine's
  mesh path is held above).

The module top imports only torch, numpy and the port; JAX is imported
inside the tests.
"""

import contextlib
import dataclasses
import io
import json
import sys

import numpy as np
import pytest
import torch

from quantizations_tpu_torch import ServeConfig
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import checkpoint as tckpt
from quantizations_tpu_torch.models import hf_loader as th
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.parallel import (RankPool, make_mesh,
                                              shard_for_rank,
                                              shard_llama_params)
from quantizations_tpu_torch.parallel.shard import ensure_planar
from quantizations_tpu_torch.serve import __main__ as tcli
from quantizations_tpu_torch.serve.engine import Engine
from quantizations_tpu_torch.serve.paged import PagedEngine

torch.set_num_threads(1)

PROMPTS = [[3, 1, 4], [2, 7, 1, 8, 2, 8], [9, 9]]
LENS = [5, 6, 4]
SLOT = dict(slots=2, prefill_buckets=(8,))
PAGED = dict(num_pages=17, page_size=16, slots=2, max_seq=64,
             prefill_buckets=(16,))
# the CLI's checkpoint: 4 heads over 2 kv heads, so that it splits over 2
H, INTER, LAYERS, HEADS, KV, HD, VOCAB = 128, 256, 2, 4, 2, 64, 256
CLI_PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(
    1, VOCAB, 5)] for s in (400, 404)]


def _planar(params):
    st = params.layers
    return dataclasses.replace(params, layers=dataclasses.replace(
        st, o=ensure_planar(st.o), down=ensure_planar(st.down)))


def _serve(params, cfg, kind, mesh, run_kw):
    if kind == "slot":
        eng = Engine(params, cfg, ServeConfig(max_seq_len=64), mesh=mesh,
                     **SLOT)
    else:
        eng = PagedEngine(params, cfg, mesh=mesh, **PAGED)
    uids = [eng.submit(p, n) for p, n in zip(PROMPTS, LENS)]
    done = eng.run(**run_kw)
    return [done[u].output_ids for u in uids], eng.stats()


def rank_engine(tree, cfg, tp, kind, run_kw):
    """The engine under a (tp,) mesh, then the single-device engine on
    the same planar o/down; the pool's or cache's kv heads."""
    params = params_from_numpy(tree, cfg, device="cpu")
    mesh = make_mesh((tp,), ("tp",), device="cpu")
    local = shard_llama_params(params, mesh, cfg)
    got, stats = _serve(local, cfg, kind, mesh, run_kw)
    ref, ref_stats = _serve(_planar(params), cfg, kind, None, run_kw)
    return got, ref, stats == ref_stats


def rank_engine_refuses(tree, cfg):
    params = params_from_numpy(tree, cfg, device="cpu")
    mesh = make_mesh((2,), ("dp",), device="cpu")
    out = []
    for make in (lambda m: Engine(params, cfg, ServeConfig(), mesh=m),
                 lambda m: PagedEngine(params, cfg, mesh=m, **PAGED)):
        for m in (object(), mesh):
            try:
                make(m)
                out.append(None)
            except (TypeError, ValueError) as e:
                out.append(str(e))
    return out


def _tensors(params):
    return {k: v for k, v in tl.named_tensors(params)}


def rank_load(hf_dir, ckpt_dir, tp):
    """This rank's shard from both loaders, and the slice of the
    single-device loads."""
    mesh = make_mesh((tp,), ("tp",), device="cpu")
    rank = mesh.axis("tp").rank
    cfg, local = th.load_hf_llama(hf_dir, mesh=mesh)
    _, whole = th.load_hf_llama(hf_dir, device="cpu")
    want = shard_for_rank(whole, cfg, tp, rank)
    _, ck_local = tckpt.load_checkpoint(ckpt_dir, mesh=mesh)
    _, ck_whole = tckpt.load_checkpoint(ckpt_dir, device="cpu")
    ck_want = shard_for_rank(ck_whole, cfg, tp, rank)
    return (_tensors(local), _tensors(want), _tensors(ck_local),
            _tensors(ck_want))


def _tree(obj):
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v)
            for path, v in flat}


def _cfgs(**knobs):
    from quantizations_tpu.models import llama as jl

    return (dataclasses.replace(jl.TINY_LLAMA, **knobs),
            dataclasses.replace(tl.TINY_LLAMA, **knobs))


def _jax_engine(jcfg, jp, tp, kind, run_kw):
    from quantizations_tpu.config import ServeConfig as JServeConfig
    from quantizations_tpu.parallel import make_mesh as jmesh
    from quantizations_tpu.parallel import shard_llama_params as jshard
    from quantizations_tpu.serve.engine import Engine as JEngine
    from quantizations_tpu.serve.paged import PagedEngine as JPagedEngine

    mesh = jmesh((tp,), ("tp",))
    sharded = jshard(jp, mesh, jcfg)
    if kind == "slot":
        eng = JEngine(sharded, jcfg, JServeConfig(max_seq_len=64),
                      mesh=mesh, **SLOT)
    else:
        eng = JPagedEngine(sharded, jcfg, mesh=mesh, **PAGED)
    uids = [eng.submit(p, n) for p, n in zip(PROMPTS, LENS)]
    done = eng.run(**run_kw)
    return [done[u].output_ids for u in uids]


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device="cpu", threads=1) as pool:
        yield pool


@pytest.fixture(scope="module")
def jax_params():
    from quantizations_tpu.models import llama as jl

    out = {}
    for kv in ("bf16", "int8"):
        jcfg, tcfg = _cfgs(kv_cache_dtype=kv)
        jp = jl.init_llama_params(jcfg, seed=0)
        out[kv] = (jp, _tree(jp), jcfg, tcfg)
    return out


@pytest.mark.parametrize("kind,kv,run_kw", [
    ("slot", "bf16", {}),
    ("slot", "int8", {}),
    ("slot", "bf16", {"steps_per_dispatch": 3}),
    ("slot", "bf16", {"spec_k": 4}),
    ("paged", "bf16", {}),
    ("paged", "int8", {}),
    ("paged", "int8", {"steps_per_dispatch": 3}),
    ("paged", "int8", {"spec_k": 4}),
    ("paged", "bf16", {"spec_k": 4, "steps_per_dispatch": 2}),
], ids=["slot-bf16", "slot-int8", "slot-window", "slot-spec", "paged-bf16",
        "paged-int8", "paged-int8-window", "paged-int8-spec",
        "paged-spec-multi"])
def test_engines_under_a_mesh(pool2, jax_params, kind, kv, run_kw):
    jp, tree, jcfg, tcfg = jax_params[kv]
    res = pool2.run(rank_engine, tree, tcfg, 2, kind, run_kw)
    for got, ref, same_stats in res:
        assert got == res[0][0]
        assert got == ref
        assert same_stats
    assert res[0][0] == _jax_engine(jcfg, jp, 2, kind, run_kw)


def test_engines_refuse_malformed_meshes(pool2, jax_params):
    _, tree, _, tcfg = jax_params["bf16"]
    for r in pool2.run(rank_engine_refuses, tree, tcfg):
        assert "parallel.make_mesh" in r[0] and "no axis 'tp'" in r[1]
        assert "parallel.make_mesh" in r[2] and "no axis 'tp'" in r[3]


# -- the loaders ------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("hf_tp")
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "vocab_size": VOCAB,
        "hidden_size": H, "intermediate_size": INTER,
        "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
        "num_key_value_heads": KV, "head_dim": HD, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "max_position_embeddings": 64}))
    rng = np.random.default_rng(0)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)

    t = {"model.embed_tokens.weight": w(VOCAB, H), "model.norm.weight": norm(),
         "lm_head.weight": w(VOCAB, H)}
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = norm()
        t[p + "post_attention_layernorm.weight"] = norm()
        t[p + "self_attn.q_proj.weight"] = w(HEADS * HD, H)
        t[p + "self_attn.k_proj.weight"] = w(KV * HD, H)
        t[p + "self_attn.v_proj.weight"] = w(KV * HD, H)
        t[p + "self_attn.o_proj.weight"] = w(H, HEADS * HD)
        t[p + "mlp.gate_proj.weight"] = w(INTER, H)
        t[p + "mlp.up_proj.weight"] = w(INTER, H)
        t[p + "mlp.down_proj.weight"] = w(H, INTER)
    save_file(t, str(d / "model.safetensors"))
    return str(d)


def _double_quant_close(got, ref, what):
    """The two packages' double-quantized fp32 scales (the rule of
    ``tests/test_torch_hf_loader.py``): within 4 ulps of the largest
    scale (the offset, an fp32 mean summed in another order), except
    where that last bit moves a block's nested 8-bit code across a
    midpoint of the dynamic map: at most 1% of the scales, each within
    1e-3 of the largest."""
    top = np.abs(ref).max()
    off = np.abs(got - ref) > 4 * np.spacing(top)
    assert off.mean() <= 0.01, what
    assert np.abs(got - ref).max() <= 1e-3 * top, what


def test_loaders_onto_a_mesh(pool2, hf_dir, tmp_path):
    """Each rank's shard from ``load_hf_llama(mesh=...)`` is the slice of
    the single-device load bit for bit (the weights quantized whole, o
    and down planar), and the JAX package's mesh load's shard (words and
    norms bit for bit, the double-quantized scales within the loader
    tests' rule); so is ``load_checkpoint(mesh=...)``'s of a saved
    checkpoint."""
    import jax

    from quantizations_tpu.models.hf_loader import load_hf_llama as jload
    from quantizations_tpu.parallel import make_mesh as jmesh

    cfg, whole = th.load_hf_llama(hf_dir, device="cpu")
    tckpt.save_checkpoint(whole, cfg, str(tmp_path / "ckpt"))
    res = pool2.run(rank_load, hf_dir, str(tmp_path / "ckpt"), 2)
    mesh = jmesh((2,), ("tp",))
    _, jparams = jload(hf_dir, mesh=mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    jshards = {}
    for path, leaf in flat:
        by_dev = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        jshards[".".join(k.name for k in path)] = [
            by_dev[d] for d in mesh.devices.flat]
    for rank, (local, want, ck_local, ck_want) in enumerate(res):
        assert set(local) == set(want) == set(ck_local) == set(jshards)
        assert local["layers.o.wp"].shape == (LAYERS, H, HEADS * HD // 16)
        for name, t in local.items():
            assert torch.equal(t, want[name]), name
            assert torch.equal(ck_local[name], ck_want[name]), name
            j = jshards[name][rank]
            if name.endswith(".scales"):
                _double_quant_close(t.numpy(), j, name)
                continue
            g = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                 else t.numpy())
            j = j.view(np.int16) if j.dtype.name == "bfloat16" else j
            np.testing.assert_array_equal(g, j, err_msg=name)


def test_loaders_refuse_malformed_meshes(hf_dir, tmp_path):
    with pytest.raises(TypeError, match="parallel.make_mesh"):
        th.load_hf_llama(hf_dir, mesh=object())
    with pytest.raises(TypeError, match="parallel.make_mesh"):
        tckpt.load_checkpoint(str(tmp_path), mesh=object())


# -- the CLI ------------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _run_jax(argv):
    from quantizations_tpu.serve import __main__ as jcli

    old = sys.argv
    sys.argv = ["quantizations_tpu.serve"] + argv
    try:
        return _run(lambda _: jcli.main(), argv)
    finally:
        sys.argv = old


def _outputs(rec):
    return ([r["output_ids"] for r in rec["requests"]] if "requests" in rec
            else [rec["output_ids"]])


@pytest.mark.parametrize("engine", ["generate", "paged"])
def test_cli_tp2_matches_jax(hf_dir, monkeypatch, engine):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    prompts = CLI_PROMPTS[:1] if engine == "generate" else CLI_PROMPTS
    argv = ["--model", hf_dir, "--tp", "2", "--max-seq", "64",
            "--max-new-tokens", "8", "--prompt-ids",
            ";".join(",".join(map(str, p)) for p in prompts)]
    if engine != "generate":
        argv += ["--engine", engine, "--page-size", "16"]
    got = _run(tcli.main, argv + ["--device", "cpu"])
    want = _run_jax(argv)
    assert _outputs(got) == _outputs(want)
    assert set(got) == set(want)
