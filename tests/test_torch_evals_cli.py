"""The port's evals CLI (``python -m quantizations_tpu_torch.evals``) on
the CPU.

``--preset tiny --parity --parity-control`` prints one JSON line equal to
the direct calls it stands for: ``logit_parity`` over 128 ids from
``numpy.random.default_rng(0)`` on the seed-0 model, plainly and with
``dense_twin``; once as a subprocess (one torch thread, as here), once
in process with ``--proxy`` and ``--kv-dtype int8``. ``--ifeval-proxy``
equals ``run_ifeval_proxy`` with the same arguments. On a tiny HF
checkpoint written in the test, ``--model --parity`` equals the direct
calls on the loaded params, and ``--model --ifeval`` (a stand-in
tokenizer in place of ``transformers``) equals ``evaluate`` over greedy
generates, also with ``--dequantized`` (the dense twin). ``--ifeval``
without a tokenizer exits with the JAX package's message, and
``--device`` defaults to the card, which raises without one.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quantizations_tpu_torch import QuantConfig
from quantizations_tpu_torch.evals import __main__ as cli
from quantizations_tpu_torch.evals.ifeval_proxy import run_ifeval_proxy
from quantizations_tpu_torch.evals.parity import logit_parity
from quantizations_tpu_torch.models import llama as tl

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def _direct(dist="normal", kv="bf16", tokens=128):
    cfg = dataclasses.replace(tl.TINY_LLAMA, kv_cache_dtype=kv,
                              quant=QuantConfig())
    params = tl.init_llama_params(cfg, seed=0, dist=dist, device="cpu")
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, tokens)), dtype=torch.int32)
    twin = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, dense_twin=True))
    return {"parity": logit_parity(params, cfg, ids).to_dict(),
            "parity_control": logit_parity(params, twin, ids).to_dict()}


def test_parity_subprocess_equals_direct_calls():
    env = dict(os.environ, OMP_NUM_THREADS="1", HF_HUB_OFFLINE="1",
               PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "quantizations_tpu_torch.evals", "--device",
         "cpu", "--preset", "tiny", "--parity", "--parity-control"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == _direct()
    assert got["parity_control"]["top1_agreement"] == 1.0


def test_proxy_int8_parity_equals_direct_calls():
    got = _run(["--device", "cpu", "--preset", "tiny", "--proxy",
                "--kv-dtype", "int8", "--parity", "--parity-control",
                "--parity-tokens", "32"])
    assert got == _direct(dist="trained_proxy", kv="int8", tokens=32)
    for rep in got.values():
        assert all(np.isfinite(v) for v in rep.values())


def test_default_run_is_the_parity():
    got = _run(["--device", "cpu", "--parity-tokens", "16"])
    assert list(got) == ["parity"]


def test_ifeval_proxy_equals_direct_call():
    got = _run(["--device", "cpu", "--preset", "tiny", "--ifeval-proxy",
                "--max-new-tokens", "1"])
    want = run_ifeval_proxy(preset="tiny", max_new_tokens=1, device="cpu")
    assert got == json.loads(json.dumps(want))
    assert got["n_examples"] == 109


def test_ifeval_needs_a_tokenizer(tmp_path):
    data = tmp_path / "input_data.jsonl"
    data.write_text(json.dumps({"key": 1, "prompt": "p",
                                "instruction_id_list": [],
                                "kwargs": []}) + "\n")
    with pytest.raises(SystemExit,
                       match="--ifeval needs a tokenizer \\(HF checkpoint\\)"):
        cli.main(["--device", "cpu", "--ifeval", str(data)])


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--parity"])
    assert cli._parser().parse_args([]).device == "cuda"


# -- a checkpoint directory: --model with --parity and --ifeval ---------------

H, INTER, LAYERS, HEADS, KV, HD, VOCAB = 128, 256, 2, 2, 1, 64, 256


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny HF Llama checkpoint written with the port's own safetensors
    writer, from seeded numpy weights."""
    from quantizations_tpu_torch.models.safetensors_io import save_file

    d = tmp_path_factory.mktemp("hf_evals")
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "vocab_size": VOCAB,
        "hidden_size": H, "intermediate_size": INTER,
        "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
        "num_key_value_heads": KV, "head_dim": HD, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "max_position_embeddings": 64}))
    rng = np.random.default_rng(0)

    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(
            np.float32)).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": w(VOCAB, H),
         "model.norm.weight": torch.ones(H, dtype=torch.bfloat16),
         "lm_head.weight": w(VOCAB, H)}
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = torch.ones(H, dtype=torch.bfloat16)
        t[p + "post_attention_layernorm.weight"] = torch.ones(
            H, dtype=torch.bfloat16)
        for name, shape in (("self_attn.q_proj", (HEADS * HD, H)),
                            ("self_attn.k_proj", (KV * HD, H)),
                            ("self_attn.v_proj", (KV * HD, H)),
                            ("self_attn.o_proj", (H, HEADS * HD)),
                            ("mlp.gate_proj", (INTER, H)),
                            ("mlp.up_proj", (INTER, H)),
                            ("mlp.down_proj", (H, INTER))):
            t[p + name + ".weight"] = w(*shape)
    save_file(t, str(d / "model.safetensors"))
    return str(d)


class _Tokenizer:
    """A stand-in tokenizer: the proxy's word-level encoding and
    detokenizer, no chat template."""
    eos_token_id = 7

    def apply_chat_template(self, msgs, add_generation_prompt=True):
        raise ValueError("no chat template")

    def encode(self, text):
        from quantizations_tpu_torch.evals.ifeval_proxy import encode_prompt
        return encode_prompt(text, VOCAB)

    def decode(self, ids):
        from quantizations_tpu_torch.evals.ifeval_proxy import detokenize
        return detokenize(ids)


@pytest.fixture
def tokenizer(monkeypatch):
    """``transformers`` replaced by a module whose ``AutoTokenizer`` gives
    :class:`_Tokenizer` (the real import takes seconds)."""
    import types

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(
        from_pretrained=lambda path: _Tokenizer())
    monkeypatch.setitem(sys.modules, "transformers", fake)


def _loaded(hf_dir, dense_twin=False):
    from quantizations_tpu_torch.models.hf_loader import load_hf_llama

    cfg, params = load_hf_llama(hf_dir, quant=QuantConfig(), device="cpu")
    if dense_twin:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, dense_twin=True))
    return cfg, params


def test_model_parity_equals_direct_calls(hf_dir):
    got = _run(["--device", "cpu", "--model", hf_dir, "--parity",
                "--parity-control", "--parity-tokens", "16"])
    cfg, params = _loaded(hf_dir)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, VOCAB, (1, 16)), dtype=torch.int32)
    twin = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, dense_twin=True))
    assert got == {"parity": logit_parity(params, cfg, ids).to_dict(),
                   "parity_control": logit_parity(params, twin,
                                                  ids).to_dict()}


@pytest.mark.parametrize("dequantized", [False, True])
def test_model_ifeval_equals_direct_calls(hf_dir, tokenizer, tmp_path,
                                          dequantized):
    """``--ifeval`` with a tokenizer: every prompt generated greedily
    (stopping at eos) and scored; ``--dequantized`` runs the dense twin."""
    from quantizations_tpu_torch import ServeConfig
    from quantizations_tpu_torch.evals.ifeval import evaluate
    from quantizations_tpu_torch.evals.ifeval_proxy import PROXY_DATASET
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    data = PROXY_DATASET[:4]
    path = tmp_path / "input_data.jsonl"
    path.write_text("".join(json.dumps(ex) + "\n" for ex in data))
    argv = ["--device", "cpu", "--model", hf_dir, "--ifeval", str(path),
            "--max-new-tokens", "6", "--max-seq", "64"]
    got = _run(argv + (["--dequantized"] if dequantized else []))

    cfg, params = _loaded(hf_dir, dense_twin=dequantized)
    gen = make_generate_fn(cfg, ServeConfig(max_seq_len=64,
                                            max_new_tokens=6))
    tok = _Tokenizer()

    def generate_fn(prompt):
        toks, _ = gen(params, torch.tensor([tok.encode(prompt)],
                                           dtype=torch.int32),
                      tl.KVCache.create(cfg, 1, 64, device="cpu"), None)
        toks = toks[0].tolist()
        if tok.eos_token_id in toks:
            toks = toks[:toks.index(tok.eos_token_id)]
        return tok.decode(toks)

    assert got == {"ifeval": evaluate(generate_fn, data).to_dict()}
    assert got["ifeval"]["prompt_total"] == 4
