"""The port's serving CLI (``python -m quantizations_tpu_torch.serve``) on
the CPU.

Against the JAX package's CLI on the same ``--model`` directory (a tiny
synthetic HF checkpoint written with numpy from a seed), once each for
``--engine generate``, ``slot``, ``paged`` and ``--speculative``: the same
``output_ids`` and the same JSON keys. The other flags run against the
port's own direct calls on the same loaded parameters: ``--fuse``,
``--kv-dtype int8``, ``--spec-k``, ``--steps-per-dispatch``,
``--prefix-cache``, ``--pipeline manual``, several prompts through the
generate path. ``--tp 2`` raises before any load, ``--demo`` runs, and
``--device`` defaults to the card, which raises without one.

The prompts are 5 tokens from seeds 400 and 404, whose greedy streams on
this checkpoint agree with the JAX package's over 12 new tokens (seeds
401, 402, 407 and 408 part within 12).
"""

import contextlib
import dataclasses
import io
import json
import sys

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from quantizations_tpu.serve import __main__ as jcli
from quantizations_tpu_torch import QuantConfig, ServeConfig
from quantizations_tpu_torch.models import hf_loader as th
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.serve import __main__ as tcli
from quantizations_tpu_torch.serve.engine import Engine
from quantizations_tpu_torch.serve.generate import make_generate_fn
from quantizations_tpu_torch.serve.paged import PagedEngine
from quantizations_tpu_torch.serve.speculative import (
    make_speculative_generate_fn)

torch.set_num_threads(1)

H, INTER, LAYERS, HEADS, KV, HD, VOCAB = 128, 256, 2, 2, 1, 64, 256
MAX_SEQ, NEW, PAGE = 64, 10, 16
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(1, VOCAB, 5)]
           for s in (400, 404)]
COMMON = ["--max-seq", str(MAX_SEQ), "--max-new-tokens", str(NEW)]


def _ids(prompts):
    return ";".join(",".join(map(str, p)) for p in prompts)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """Both CLIs try an optional tokenizer from ``transformers`` where it
    is installed: it reads the local directory only."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_cli")
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "vocab_size": VOCAB,
        "hidden_size": H, "intermediate_size": INTER,
        "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
        "num_key_value_heads": KV, "head_dim": HD, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "max_position_embeddings": 64,
        "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                         "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 64}}))
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


@pytest.fixture(scope="module")
def loaded(hf_dir):
    return th.load_hf_llama(hf_dir, quant=QuantConfig(), device="cpu")


def run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tcli.main(argv + ["--device", "cpu"])
    return json.loads(out.getvalue().strip().splitlines()[-1])


def run_jax(argv):
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["quantizations_tpu.serve"] + argv
    try:
        with contextlib.redirect_stdout(out):
            jcli.main()
    finally:
        sys.argv = old
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _outputs(rec):
    return ([r["output_ids"] for r in rec["requests"]] if "requests" in rec
            else [rec["output_ids"]])


def _keys(rec):
    return (set(rec), [set(r) for r in rec.get("requests", [])])


@pytest.mark.parametrize("mode", ["generate", "slot", "paged", "speculative"])
def test_cli_matches_jax(hf_dir, mode):
    prompts = PROMPTS[:1] if mode in ("generate", "speculative") else PROMPTS
    argv = ["--model", hf_dir, "--prompt-ids", _ids(prompts)] + COMMON
    if mode == "speculative":
        argv.append("--speculative")
    elif mode != "generate":
        argv += ["--engine", mode, "--page-size", str(PAGE)]
    got, ref = run_port(argv), run_jax(argv)
    assert _keys(got) == _keys(ref)
    assert _outputs(got) == _outputs(ref)
    assert all(len(o) == NEW for o in _outputs(got))
    if mode == "speculative":
        assert got["speculative_verify_steps"] == ref[
            "speculative_verify_steps"]


def _direct_generate(params, cfg, prompt, spec=False):
    serve = ServeConfig(max_seq_len=MAX_SEQ, max_new_tokens=NEW)
    fn = (make_speculative_generate_fn if spec else make_generate_fn)(cfg,
                                                                      serve)
    g = torch.Generator().manual_seed(serve.seed)
    out = fn(params, torch.tensor([prompt], dtype=torch.int32),
             tl.KVCache.create(cfg, 1, MAX_SEQ, device="cpu"), g)
    return out[0][0].tolist()


@pytest.mark.parametrize("flags", [["--fuse"], ["--pipeline", "manual"],
                                   ["--kv-dtype", "int8"], []],
                         ids=["fuse", "manual", "int8", "two_prompts"])
def test_cli_generate_equals_direct_call(hf_dir, loaded, flags):
    cfg, params = loaded
    prompts = PROMPTS if not flags else PROMPTS[:1]
    rec = run_port(["--model", hf_dir, "--prompt-ids", _ids(prompts)]
                   + COMMON + flags)
    if "--fuse" in flags:
        params = tl.fuse_projections(params)
    if "manual" in flags:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, pair_pipeline="manual"))
    if "int8" in flags:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    assert _outputs(rec) == [_direct_generate(params, cfg, p)
                             for p in prompts]
    if not flags:
        assert set(rec) == {"requests", "wall_s",
                            "tokens_per_s_incl_compile"}


@pytest.mark.parametrize("engine,flags", [
    ("slot", ["--spec-k", "4"]), ("slot", ["--steps-per-dispatch", "3"]),
    ("paged", ["--kv-dtype", "int8"]),
    ("paged", ["--prefix-cache", "--spec-k", "4", "--steps-per-dispatch",
               "2"]),
], ids=["slot_spec", "slot_window", "paged_int8", "paged_prefix_spec_multi"])
def test_cli_engines_equal_direct_calls(hf_dir, loaded, engine, flags):
    cfg, params = loaded
    rec = run_port(["--model", hf_dir, "--prompt-ids", _ids(PROMPTS),
                    "--engine", engine, "--page-size", str(PAGE), "--slots",
                    "2"] + COMMON + flags)
    if "int8" in flags:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if engine == "slot":
        eng = Engine(params, cfg, ServeConfig(max_seq_len=MAX_SEQ), slots=2)
    else:
        eng = PagedEngine(params, cfg, num_pages=2 * (MAX_SEQ // PAGE) + 8,
                          page_size=PAGE, slots=2, max_seq=MAX_SEQ,
                          prefix_cache="--prefix-cache" in flags)
    uids = [eng.submit(p, max_new_tokens=NEW, temperature=0.0)
            for p in PROMPTS]
    spec_k = int(flags[flags.index("--spec-k") + 1]) if "--spec-k" in \
        flags else 0
    spd = (int(flags[flags.index("--steps-per-dispatch") + 1])
           if "--steps-per-dispatch" in flags else 1)
    done = eng.run(spec_k=spec_k, steps_per_dispatch=spd)
    assert rec["engine"] == engine
    assert _outputs(rec) == [done[u].output_ids for u in uids]


def test_cli_speculative_equals_direct_call(hf_dir, loaded):
    cfg, params = loaded
    rec = run_port(["--model", hf_dir, "--prompt-ids", _ids(PROMPTS[1:]),
                    "--speculative"] + COMMON)
    assert rec["output_ids"] == _direct_generate(params, cfg, PROMPTS[1],
                                                 spec=True)
    assert rec["tokens_per_verify_step"] > 0


def test_cli_tp_raises_before_loading(tmp_path):
    with pytest.raises(SystemExit, match="not ported"):
        tcli.main(["--model", str(tmp_path / "absent"), "--tp", "2",
                   "--device", "cpu"])


def test_cli_demo_runs():
    rec = run_port(["--demo", "--max-new-tokens", "6"])
    assert rec["prompt_ids"] == [1, 2, 3, 4, 5]
    assert len(rec["output_ids"]) == 6
    assert all(0 <= t < tl.TINY_LLAMA.vocab_size for t in rec["output_ids"])
    assert rec["output_text"] is None


def test_cli_device_defaults_to_the_card(hf_dir, monkeypatch):
    from quantizations_tpu_torch import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli._parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--demo"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.main(["--model", hf_dir, "--out", "unused"])
