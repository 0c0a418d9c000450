"""The port's checkpoint path against the JAX package's on the CPU:
``models/hf_loader.py``, ``models/checkpoint.py`` and ``convert.py``.

Synthetic HF checkpoints are written with numpy from a seed, through the
``safetensors`` package (as ``tests/test_hf_loader.py`` does) and through
the port's own writer. On them:

- ``config_from_hf`` / ``config_to_hf`` equal the JAX results field by
  field for Llama (llama3 rope scaling), Qwen2 (bias, gated sliding
  window), Mistral, Qwen3, Gemma-2 and tied embeddings, with the bnb
  stanza's adoption rules;
- ``load_hf_llama(device="cpu")`` gives the JAX loader's codes bit for
  bit, and its scales bit for bit without double quantization; with it
  they differ by at most 4 ulps of the largest scale, or one step of the
  nested 8-bit code on at most 1% of them (the double-quant offset is an
  fp32 mean that torch and XLA sum in different orders, ``ROADMAP.md``
  C). fp32, bf16 and ``bf16x2`` scales, quantized and
  dense embedding and lm_head, NF4, the family leaves;
- the loaded tiny model's logits are the JAX model's within
  2e-2 * max|logit|;
- bnb and native checkpoints written by either package are read by the
  other: packed bytes, ``quant_state`` JSON and absmax byte-equal
  (double-quantized statistics within the rounding of their fp32 mean,
  :func:`_files_equal`);
- the native checkpoint round-trips exactly, and its config file parses
  to the JAX ``_cfg_to_json`` dict; ``convert.main`` in both formats
  writes the JAX ``convert.main``'s tensors and prints its JSON keys.
"""

import contextlib
import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

from quantizations_tpu import convert as jconvert
from quantizations_tpu.config import QuantConfig as JQuantConfig
from quantizations_tpu.models import checkpoint as jckpt
from quantizations_tpu.models import hf_loader as jh
from quantizations_tpu.models import llama as jl
from quantizations_tpu.ops import qmatmul as jqm
from quantizations_tpu.quant.functional import quantize_4bit as jquantize_4bit
from quantizations_tpu_torch import QuantConfig
from quantizations_tpu_torch import convert as tconvert
from quantizations_tpu_torch.bridge import params_from_numpy
from quantizations_tpu_torch.models import checkpoint as tckpt
from quantizations_tpu_torch.models import hf_loader as th
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.models import safetensors_io as sio
from quantizations_tpu_torch.ops import qmatmul as tqm
from quantizations_tpu_torch.quant.functional import quantize_4bit

torch.set_num_threads(1)

H, INTER, LAYERS, HEADS, KV, HD, VOCAB = 128, 256, 2, 2, 1, 64, 256

FAMILIES = {
    "llama": {"architectures": ["LlamaForCausalLM"], "rope_scaling": {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}},
    "qwen2": {"architectures": ["Qwen2ForCausalLM"],
              "sliding_window": 32768},
    "qwen2_window": {"architectures": ["Qwen2ForCausalLM"],
                     "sliding_window": 48, "use_sliding_window": True},
    "mistral": {"architectures": ["MistralForCausalLM"],
                "sliding_window": 48},
    "qwen3": {"architectures": ["Qwen3ForCausalLM"]},
    "gemma2": {"architectures": ["Gemma2ForCausalLM"],
               "attn_logit_softcapping": 50.0,
               "final_logit_softcapping": 30.0,
               "query_pre_attn_scalar": 64,
               "sliding_window": 48,
               "layer_types": ["full_attention", "sliding_attention"]},
    "gemma2_default": {"architectures": ["Gemma2ForCausalLM"],
                       "sliding_window": 48},
    "tied": {"architectures": ["LlamaForCausalLM"],
             "tie_word_embeddings": True},
}


def _hf_config(family, **extra):
    return {"vocab_size": VOCAB, "hidden_size": H, "intermediate_size": INTER,
            "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
            "num_key_value_heads": KV, "head_dim": HD, "rope_theta": 10000.0,
            "rms_norm_eps": 1e-5, "max_position_embeddings": 64,
            **FAMILIES[family], **extra}


def _tensors(hf, seed=0, dtype=np.float32):
    """The checkpoint's tensors for ``hf`` (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(dtype)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(H)).astype(dtype)

    archs = hf["architectures"][0]
    t = {"model.embed_tokens.weight": w(VOCAB, H), "model.norm.weight": norm()}
    if not hf.get("tie_word_embeddings"):
        t["lm_head.weight"] = w(VOCAB, H)
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        t[p + "input_layernorm.weight"] = norm()
        t[p + "post_attention_layernorm.weight"] = norm()
        t[a + "q_proj.weight"] = w(HEADS * HD, H)
        t[a + "k_proj.weight"] = w(KV * HD, H)
        t[a + "v_proj.weight"] = w(KV * HD, H)
        t[a + "o_proj.weight"] = w(H, HEADS * HD)
        t[p + "mlp.gate_proj.weight"] = w(INTER, H)
        t[p + "mlp.up_proj.weight"] = w(INTER, H)
        t[p + "mlp.down_proj.weight"] = w(H, INTER)
        if archs.startswith("Qwen2"):
            t[a + "q_proj.bias"] = w(HEADS * HD)
            t[a + "k_proj.bias"] = w(KV * HD)
            t[a + "v_proj.bias"] = w(KV * HD)
        if archs.startswith("Gemma2"):
            t[p + "pre_feedforward_layernorm.weight"] = norm()
            t[p + "post_feedforward_layernorm.weight"] = norm()
        if archs.startswith("Qwen3"):
            t[a + "q_norm.weight"] = (1.0 + 0.1 * rng.standard_normal(HD)
                                      ).astype(dtype)
            t[a + "k_norm.weight"] = (1.0 + 0.1 * rng.standard_normal(HD)
                                      ).astype(dtype)
    return t


def write_hf(d, family="llama", writer="safetensors", bf16=False, **extra):
    """Write a tiny HF directory: config.json and model.safetensors."""
    d.mkdir(parents=True, exist_ok=True)
    hf = _hf_config(family, **extra)
    (d / "config.json").write_text(json.dumps(hf))
    t = _tensors(hf)
    if bf16:
        t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in t.items()}
        sio.save_file(t, str(d / "model.safetensors"))
    elif writer == "safetensors":
        st_save(t, str(d / "model.safetensors"))
    else:
        sio.save_file(t, str(d / "model.safetensors"))
    return str(d)


def _tree(obj):
    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _cfg_dict(cfg):
    """A config as a plain dict, dtypes by name."""
    d = dataclasses.asdict(cfg)
    for k in ("compute_dtype", "scales_dtype"):
        v = d["quant"][k]
        d["quant"][k] = v if isinstance(v, str) else (
            str(v).rpartition(".")[2] if isinstance(v, torch.dtype)
            else jnp.dtype(v).name)
    return d


def _jq(**kw):
    if kw.get("scales_dtype") == torch.bfloat16:
        kw["scales_dtype"] = jnp.bfloat16
    return JQuantConfig(**kw)


def assert_double_quant_close(got, ref, what):
    """Double-quantized fp32 scales of the two packages: within 4 ulps of
    the largest scale (the offset, an fp32 mean summed in another order),
    except where that last bit moves a block's nested 8-bit code across
    a midpoint of the dynamic map: at most 1% of the scales, each within
    1e-3 of the largest."""
    top = np.abs(ref).max()
    off = np.abs(got - ref) > 4 * np.spacing(top)
    assert off.mean() <= 0.01, what
    assert np.abs(got - ref).max() <= 1e-3 * top, what


def assert_params_match(jparams, tparams, double_quant):
    """Codes, norms, biases and dense tables bit for bit; fp32 scales bit
    for bit, or :func:`assert_double_quant_close` with double
    quantization; bf16 scales within one bf16 ulp there."""
    jt, tt = _tree(jparams), dict(tl.named_tensors(tparams))
    assert set(jt) == set(tt)
    for k, a in jt.items():
        b = tt[k]
        if not k.endswith(".scales") or not double_quant:
            assert np.array_equal(_np(b), a.astype(np.float32)
                                  if b.dtype == torch.bfloat16 else a), k
            continue
        if b.dtype == torch.float32:
            assert_double_quant_close(b.numpy(), a, k)
        else:   # bf16 or bf16x2 words: at most one bf16 ulp apart
            bits = (b.view(torch.int16) if b.dtype == torch.bfloat16
                    else b).numpy().astype(np.int64)
            ref = a.view(np.int16 if b.dtype == torch.bfloat16 else np.int32
                         ).astype(np.int64)
            for sh in ((0,) if b.dtype == torch.bfloat16 else (0, 16)):
                lo = ((bits >> sh) & 0xFFFF) - ((ref >> sh) & 0xFFFF)
                assert np.abs(lo).max() <= 1, k


# -- configs ------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_from_and_to_hf_match_jax(tmp_path, family):
    d = tmp_path / family
    d.mkdir()
    (d / "config.json").write_text(json.dumps(_hf_config(family)))
    jcfg = jh.config_from_hf(str(d))
    tcfg = th.config_from_hf(str(d))
    assert _cfg_dict(tcfg) == _cfg_dict(jcfg)
    for compress in (True, False):
        assert th.config_to_hf(tcfg, compress) == jh.config_to_hf(jcfg,
                                                                 compress)
    # config_to_hf is config_from_hf's inverse
    (d / "config.json").write_text(json.dumps(th.config_to_hf(tcfg)))
    assert _cfg_dict(th.config_from_hf(str(d))) == _cfg_dict(jcfg)


@pytest.mark.parametrize("stanza,requested", [
    ({"quant_method": "bitsandbytes", "load_in_4bit": True,
      "bnb_4bit_quant_type": "nf4"}, None),
    ({"quant_method": "bitsandbytes", "load_in_4bit": True,
      "bnb_4bit_quant_type": "nf4"}, "fp4"),
    ({"quant_method": "bitsandbytes", "load_in_8bit": True,
      "bnb_4bit_quant_type": "fp4"}, "nf4"),
    ({"bnb_4bit_quant_type": "fp4"}, "nf4"),
], ids=["genuine", "genuine_over_request", "eightbit", "stale"])
def test_quantization_config_adoption_rules_match_jax(tmp_path, stanza,
                                                      requested):
    (tmp_path / "config.json").write_text(json.dumps(
        _hf_config("llama", quantization_config=stanza)))
    jq = None if requested is None else JQuantConfig(quant_type=requested)
    tq = None if requested is None else QuantConfig(quant_type=requested)
    assert (th.config_from_hf(str(tmp_path), tq).quant.quant_type
            == jh.config_from_hf(str(tmp_path), jq).quant.quant_type)


# -- load_hf_llama against the JAX loader --------------------------------


LOAD_CASES = {
    "fp32_scales": ("llama", dict(compress_statistics=False)),
    "double_quant": ("llama", dict()),
    "bf16_scales": ("llama", dict(scales_dtype=torch.bfloat16,
                                  compress_statistics=False)),
    "bf16x2": ("llama", dict(scales_dtype="bf16x2")),
    "q_embed_dense_head": ("llama", dict(quantize_embedding=True,
                                         quantize_lm_head=False)),
    "nf4": ("mistral", dict(quant_type="nf4", quantize_embedding=True)),
    "qwen2": ("qwen2", dict(compress_statistics=False)),
    "gemma2": ("gemma2", dict(compress_statistics=False)),
    "qwen3": ("qwen3", dict(compress_statistics=False)),
    "tied": ("tied", dict(quantize_embedding=True,
                          scales_dtype="bf16x2")),
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_hf_llama_matches_jax(tmp_path, case):
    family, kw = LOAD_CASES[case]
    d = write_hf(tmp_path / "hf", family,
                 writer="port" if case.endswith("scales") else "safetensors")
    jcfg, jparams = jh.load_hf_llama(d, quant=_jq(**kw))
    tcfg, tparams = th.load_hf_llama(d, quant=QuantConfig(**kw),
                                     device="cpu")
    assert _cfg_dict(tcfg) == _cfg_dict(jcfg)
    assert_params_match(jparams, tparams,
                        double_quant=kw.get("compress_statistics", True))


def test_load_bf16_checkpoint_matches_jax(tmp_path):
    """A bf16 checkpoint (the port's writer): quantized from bf16, equal
    to the JAX loader's."""
    d = write_hf(tmp_path / "hf", "llama", bf16=True)
    kw = dict(compress_statistics=False, quantize_embedding=True)
    _, jparams = jh.load_hf_llama(d, quant=_jq(**kw))
    _, tparams = th.load_hf_llama(d, quant=QuantConfig(**kw), device="cpu")
    assert_params_match(jparams, tparams, double_quant=False)


def test_sharded_checkpoint_loads_like_one_file(tmp_path):
    one = write_hf(tmp_path / "one", "llama")
    shard = tmp_path / "shard"
    shard.mkdir()
    (shard / "config.json").write_text((tmp_path / "one/config.json")
                                       .read_text())
    t = st_load(one + "/model.safetensors")
    names = sorted(t)
    wm = {}
    for j, part in enumerate((names[::2], names[1::2])):
        fname = f"model-0000{j + 1}-of-00002.safetensors"
        sio.save_file({n: t[n] for n in part}, str(shard / fname))
        wm.update(dict.fromkeys(part, fname))
    (shard / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": wm}))
    q = QuantConfig(compress_statistics=False)
    _, a = th.load_hf_llama(one, quant=q, device="cpu")
    _, b = th.load_hf_llama(str(shard), quant=q, device="cpu")
    for (k, x), (_, y) in zip(tl.named_tensors(a), tl.named_tensors(b)):
        assert torch.equal(x, y), k


def test_loaded_logits_match_jax(tmp_path):
    """The tiny model loaded by each package: prefill logits within
    2e-2 * max|logit| (the port's bf16-class kernels against the JAX
    package's fp32 path on the CPU)."""
    d = write_hf(tmp_path / "hf", "llama")
    q = dict(quantize_embedding=True)
    jcfg, jparams = jh.load_hf_llama(d, quant=_jq(**q))
    tcfg, tparams = th.load_hf_llama(d, quant=QuantConfig(**q), device="cpu")
    ids = np.random.default_rng(3).integers(1, VOCAB, (1, 8))
    jlog, _ = jax.jit(lambda p, i, c: jl.prefill(p, i, c, jcfg))(
        jparams, jnp.asarray(ids, jnp.int32), jl.KVCache.create(jcfg, 1, 16))
    with torch.inference_mode():
        tlog, _ = tl.prefill(tparams, torch.from_numpy(ids).to(torch.int32),
                             tl.KVCache.create(tcfg, 1, 16, device="cpu"),
                             tcfg)
    jlog = np.asarray(jlog)
    err = np.abs(tlog.float().numpy() - jlog).max()
    assert err <= 2e-2 * np.abs(jlog).max()


def test_mixed_bnb_types_raise(tmp_path):
    d = tmp_path / "mixed"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(_hf_config("llama")))
    from quantizations_tpu_torch.quant.bnb_io import bnb_flat_tensors

    t = {}
    for qt, prefix in (("fp4", "model.layers.0.self_attn.q_proj"),
                       ("nf4", "model.layers.0.self_attn.k_proj")):
        packed, state = quantize_4bit(torch.ones(64, 64), quant_type=qt)
        t.update(bnb_flat_tensors(prefix, packed, state))
    sio.save_file(t, str(d / "model.safetensors"))
    with pytest.raises(ValueError, match="mixed bnb quant types"):
        th.load_hf_llama(str(d), device="cpu")
    with pytest.raises(ValueError, match="mixed bnb quant types"):
        jh.load_hf_llama(str(d))


def test_unported_paths_raise(tmp_path):
    d = write_hf(tmp_path / "hf", "llama")
    with pytest.raises(NotImplementedError, match="not ported"):
        th.load_hf_llama(d, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        tckpt.load_checkpoint(str(tmp_path), mesh=object(), device="cpu")


def test_loader_needs_a_card_unless_asked(tmp_path, monkeypatch):
    d = write_hf(tmp_path / "hf", "llama")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.load_hf_llama(d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.load_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.load_quantized(str(tmp_path / "x"), tl.TINY_LLAMA)


# -- checkpoints across the two packages ----------------------------------


def _loaded(tmp_path, family="llama", **kw):
    d = write_hf(tmp_path / "hf", family)
    jcfg, jparams = jh.load_hf_llama(d, quant=_jq(**kw))
    tcfg = th.config_from_hf(d, QuantConfig(**kw))
    return jcfg, jparams, tcfg, params_from_numpy(_tree(jparams), tcfg,
                                                  device="cpu")


def _quant_state(tensors, prefix):
    k = next(k for k in tensors
             if k.startswith(prefix + ".quant_state.bitsandbytes__"))
    return json.loads(bytes(tensors[k]).decode())


def _files_equal(a, b, nested=False):
    """Two safetensors files hold the same names, dtypes and bytes. With
    ``nested`` (double-quantized statistics) the offset is an fp32 mean
    that the two packages sum in other orders: each ``quant_state``'s
    ``nested_offset`` within one ulp (the rest of it equal), each
    ``nested_absmax`` within two ulps of the offset, and the 8-bit
    absmax codes at most one step apart on at most 1% of the blocks."""
    A, B = st_load(a), st_load(b)
    assert set(A) == set(B)
    for k in A:
        if nested and "quant_state" in k:
            qa, qb = _quant_state(A, k.split(".quant_state")[0]), \
                _quant_state(B, k.split(".quant_state")[0])
            oa, ob = (np.float32(q.pop("nested_offset")) for q in (qa, qb))
            assert qa == qb and abs(oa - ob) <= np.spacing(oa), k
            continue
        assert A[k].dtype == B[k].dtype and A[k].shape == B[k].shape, k
        if nested and k.endswith(".nested_absmax"):
            off = _quant_state(A, k[:-len(".nested_absmax")])["nested_offset"]
            np.testing.assert_allclose(B[k], A[k], rtol=0, atol=2 * np.spacing(
                np.float32(off)), err_msg=k)
        elif nested and k.endswith(".weight.absmax"):
            step = np.abs(B[k].astype(int) - A[k].astype(int))
            assert step.max() <= 1 and (step > 0).mean() <= 0.01, k
        else:
            assert np.array_equal(A[k], B[k]), k


@pytest.mark.parametrize("compress", [False, True], ids=["fp32", "nested"])
@pytest.mark.parametrize("knobs", ["fp32", "embed_bf16x2"])
def test_bnb_checkpoints_cross_packages(tmp_path, compress, knobs):
    """``save_bnb_checkpoint`` of the same params by both packages: the
    same config.json and tensors (packed bytes, quant_state JSON and
    absmax byte-equal, the dense embedding and lm_head through K10's
    plain version; under double quantization the statistics as
    :func:`_files_equal` says). Both loaders read each directory to the
    same words and scales, and the port's directory to the JAX one's
    words."""
    kw = (dict(quantize_embedding=True, scales_dtype="bf16x2")
          if knobs == "embed_bf16x2" else {})
    jcfg, jparams, tcfg, tparams = _loaded(tmp_path, **kw)
    ja, tb = tmp_path / "jax_bnb", tmp_path / "port_bnb"
    jh.save_bnb_checkpoint(jparams, jcfg, str(ja), compress)
    th.save_bnb_checkpoint(tparams, tcfg, str(tb), compress)
    assert (json.loads((ja / "config.json").read_text())
            == json.loads((tb / "config.json").read_text()))
    _files_equal(str(ja / "model.safetensors"), str(tb / "model.safetensors"),
                 nested=compress)
    # the port reads the JAX directory and the JAX loader the port's
    load_kw = dict(compress_statistics=False)
    _, jj = jh.load_hf_llama(str(ja), quant=_jq(**load_kw))
    _, jt = jh.load_hf_llama(str(tb), quant=_jq(**load_kw))
    _, tj = th.load_hf_llama(str(ja), quant=QuantConfig(**load_kw),
                             device="cpu")
    _, tt = th.load_hf_llama(str(tb), quant=QuantConfig(**load_kw),
                             device="cpu")
    for name in ("q", "down"):
        for ref, got in ((jj, tj), (jt, tt)):     # one directory, two loaders
            r, g = getattr(ref.layers, name), getattr(got.layers, name)
            np.testing.assert_array_equal(g.wp.numpy(), np.asarray(r.wp))
            np.testing.assert_array_equal(g.scales.numpy(),
                                          np.asarray(r.scales))
        np.testing.assert_array_equal(getattr(tt.layers, name).wp.numpy(),
                                      np.asarray(getattr(jj.layers, name).wp))
    # the packed bytes are the loaded words: no re-quantization
    np.testing.assert_array_equal(tj.layers.q.wp.numpy(),
                                  np.asarray(jparams.layers.q.wp))


def test_bnb_round_trip_keeps_words_and_scales(tmp_path):
    """Export without double quantization and reload: every projection's
    words and scales equal the loaded model's; with it, the words equal
    and the scales move by at most the re-double-quantization's error:
    half the dynamic map's widest gap (0.0141) times a block's largest
    |scale - mean|, under 1e-2 of the largest scale."""
    d = write_hf(tmp_path / "hf", "llama")
    tcfg, tparams = th.load_hf_llama(d, device="cpu")
    for compress, tol in ((False, 0.0), (True, 1e-2)):
        out = tmp_path / f"bnb_{compress}"
        th.save_bnb_checkpoint(tparams, tcfg, str(out), compress)
        _, back = th.load_hf_llama(str(out), device="cpu",
                                   quant=QuantConfig(
                                       compress_statistics=False))
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            a, b = getattr(tparams.layers, name), getattr(back.layers, name)
            assert torch.equal(a.wp, b.wp), name
            assert (b.scales - a.scales).abs().max() <= tol * a.scales.abs(
            ).max(), name


@pytest.mark.parametrize("knobs", ["fp32", "bf16", "bf16x2_embed"])
def test_native_checkpoints_cross_packages(tmp_path, knobs):
    """``save_quantized`` by both packages writes the same tensors; each
    ``load_quantized`` reads the other's file exactly."""
    kw = {"fp32": {}, "bf16": dict(scales_dtype=torch.bfloat16),
          "bf16x2_embed": dict(scales_dtype="bf16x2",
                               quantize_embedding=True)}[knobs]
    jcfg, jparams, tcfg, tparams = _loaded(tmp_path, "qwen3", **kw)
    ja, tb = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jh.save_quantized(jparams, ja)
    th.save_quantized(tparams, tb)
    _files_equal(ja, tb)
    from_jax = th.load_quantized(ja, tcfg, device="cpu")
    for (k, x), (_, y) in zip(tl.named_tensors(from_jax),
                              tl.named_tensors(tparams)):
        assert x.dtype == y.dtype and torch.equal(x, y), k
    from_port = jh.load_quantized(tb, jcfg)
    jt, ft = _tree(jparams), _tree(from_port)
    assert set(jt) == set(ft)
    for k in jt:
        assert ft[k].dtype == jt[k].dtype, k
        np.testing.assert_array_equal(ft[k], jt[k], err_msg=k)


def test_fused_params_refused(tmp_path):
    _, _, tcfg, tparams = _loaded(tmp_path)
    fused = tl.fuse_projections(tparams)
    with pytest.raises(ValueError, match="fused"):
        th.save_quantized(fused, str(tmp_path / "q.safetensors"))
    with pytest.raises(ValueError, match="fused"):
        th.save_bnb_checkpoint(fused, tcfg, str(tmp_path / "bnb"))


@pytest.mark.parametrize("knobs", ["plain", "bf16x2_fused"])
def test_checkpoint_round_trip(tmp_path, knobs):
    """``save_checkpoint`` / ``load_checkpoint``: every tensor equal in
    its dtype, the same config, and a ``llama_config.json`` that parses
    to the JAX ``_cfg_to_json`` dict of the same config."""
    kw = (dict(scales_dtype="bf16x2", quantize_embedding=True)
          if knobs == "bf16x2_fused" else dict(scales_dtype=torch.bfloat16))
    jcfg, _, tcfg, tparams = _loaded(tmp_path, "gemma2", **kw)
    if knobs == "bf16x2_fused":
        tparams = tl.fuse_projections(tparams)
    path = tmp_path / "ckpt"
    tckpt.save_checkpoint(tparams, tcfg, str(path))
    assert (json.loads((path / "llama_config.json").read_text())
            == json.loads(jckpt._cfg_to_json(jcfg)))
    cfg, back = tckpt.load_checkpoint(str(path), device="cpu")
    assert cfg == tcfg
    a, b = dict(tl.named_tensors(tparams)), dict(tl.named_tensors(back))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # the JAX package's config file reads back to the same config
    (path / "llama_config.json").write_text(jckpt._cfg_to_json(jcfg))
    assert tckpt.load_checkpoint(str(path), device="cpu")[0] == tcfg


def _jax_convert(argv):
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["quantizations_tpu.convert"] + argv
    try:
        with contextlib.redirect_stdout(out):
            jconvert.main()
    finally:
        sys.argv = old
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _port_convert(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tconvert.main(argv + ["--device", "cpu"])
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fmt,extra", [
    ("bnb", ["--no-double-quant"]), ("bnb", ["--quant-type", "nf4"]),
    ("native", []),
], ids=["bnb", "bnb_nf4_nested", "native"])
def test_convert_matches_jax(tmp_path, fmt, extra):
    """``convert.main`` of both packages on one checkpoint: the same JSON
    keys, format and effective quant type, and files with the same
    tensors. Both quantize with double quantization, so the scales (and
    the bnb file's fp32 absmax) are as :func:`assert_double_quant_close`
    says, the dense lm_head within one bf16 rounding, and the bnb file's
    re-double-quantized statistics are not compared; packed codes,
    norms and the embedding bit for bit."""
    d = write_hf(tmp_path / "hf", "llama")
    outs = {}
    for who, run in (("jax", _jax_convert), ("port", _port_convert)):
        out = str(tmp_path / (who + (".safetensors" if fmt == "native"
                                     else "")))
        outs[who] = (out, run(["--model", d, "--out", out, "--format", fmt]
                             + extra))
    (ja, jrec), (tb, trec) = outs["jax"], outs["port"]
    assert set(trec) == set(jrec)
    assert trec["format"] == jrec["format"] == fmt
    assert trec["quant_type"] == jrec["quant_type"]
    if fmt == "native":
        A, B = st_load(ja), st_load(tb)
        assert set(A) == set(B)
        for k in A:
            assert A[k].dtype == B[k].dtype, k
            if k.endswith(".absmax"):
                assert_double_quant_close(B[k], A[k], k)
            else:
                np.testing.assert_array_equal(B[k], A[k], err_msg=k)
        return
    A = st_load(ja + "/model.safetensors")
    B = st_load(tb + "/model.safetensors")
    assert set(A) == set(B)
    nested = "--no-double-quant" not in extra
    for k in A:
        if nested and "quant_state" in k:
            continue     # its nested_offset: a mean of other scales
        assert A[k].dtype == B[k].dtype and A[k].shape == B[k].shape, k
        if k == "lm_head.weight":
            # code x scale in bf16: the scales' last bits may move one
            # bf16 rounding
            np.testing.assert_allclose(B[k], A[k], rtol=2 ** -7, atol=0)
        elif k.endswith(".weight.absmax") and not nested:
            assert_double_quant_close(B[k], A[k], k)
        elif nested and k.endswith((".weight.absmax", ".nested_absmax")):
            continue     # re-double-quantized from scales a few ulps apart
        else:
            np.testing.assert_array_equal(B[k], A[k], err_msg=k)


def test_convert_reloads_the_bnb_source(tmp_path):
    """A bnb source converts again: its stored type wins over
    ``--quant-type`` and its packed bytes are kept."""
    d = write_hf(tmp_path / "hf", "llama")
    first = str(tmp_path / "first")
    _port_convert(["--model", d, "--out", first, "--quant-type", "nf4"])
    second = str(tmp_path / "second")
    rec = _port_convert(["--model", first, "--out", second, "--quant-type",
                         "fp4"])
    assert rec["quant_type"] == "nf4"
    A = st_load(first + "/model.safetensors")
    B = st_load(second + "/model.safetensors")
    for k in A:
        if k.endswith(".weight") and A[k].dtype == np.uint8:
            np.testing.assert_array_equal(B[k], A[k], err_msg=k)


# -- the small API repairs -------------------------------------------------


def test_quant_state_as_dict_accepts_packed():
    """``as_dict(packed)`` takes the payload and leaves it out, as the JAX
    package's does."""
    W = np.random.default_rng(5).standard_normal((64, 128)).astype(np.float32)
    packed, state = quantize_4bit(torch.from_numpy(W))
    jpacked, jstate = jquantize_4bit(jnp.asarray(W))
    got = state.as_dict(packed.numpy())
    ref = jstate.as_dict(np.asarray(jpacked))
    assert got.keys() == ref.keys() == state.as_dict().keys()
    assert got["quant_state"].keys() == ref["quant_state"].keys()
    np.testing.assert_array_equal(got["absmax"], ref["absmax"])


def test_pack_pair_rows_matches_jax():
    """bnb flat bytes to the pair layout, equal to the JAX package's."""
    rng = np.random.default_rng(6)
    rows, cols = 6, 128
    u8 = rng.integers(0, 256, (rows * cols // 2, 1), dtype=np.uint8)
    got = tqm.pack_pair_rows(torch.from_numpy(u8), rows, cols)
    ref = jqm.pack_pair_rows(jnp.asarray(u8), rows, cols)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
