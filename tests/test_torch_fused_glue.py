"""The decoder layer's glue kernels K11-K13 (``ops/glue.py``,
``csrc/fused_glue.cu``).

On the CPU: the wrappers refuse what the kernels do not take, with
``ValueError`` and before any launch; a CPU forward launches none of
them; their records are in ``KERNELS``; the layer takes their plain
versions for a compute dtype they do not write; ``chip_smoke.py``'s
closed form of their launches (``_glue_forwards``) counts the wrapper
calls a generate and a paged engine run make. Marked ``cuda`` (they
skip without a card; run there with ``python3 -m pytest --noconftest -m
cuda tests/test_torch_fused_glue.py``): each kernel against its plain
version on the card at Mistral-7B's widths and 1, 256 and 1024 rows (the
residual, rope and activation bit for bit, the norm within 1 ulp of
bf16), and the slot prefill and a paged decode step with the kernels
against the same forward on the plain versions, bf16 and int8 pools,
the Gemma-2 and Qwen-3 knobs.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from quantizations_tpu_torch.config import ServeConfig
from quantizations_tpu_torch.models import llama as tl
from quantizations_tpu_torch.ops import cuda as qcuda
from quantizations_tpu_torch.ops import glue
from quantizations_tpu_torch.serve import paged as tpg
from quantizations_tpu_torch.serve.generate import make_generate_fn

torch.set_num_threads(1)

GLUE_KERNELS = (qcuda.ADD_RMS_NORM, qcuda.ROPE_QK, qcuda.GLU_ACT)
# the knobs of tests/test_torch_paged.py
GEMMA2 = dict(sliding_window=6, sliding_layers="even", post_norms=True,
              norm_plus_one=True, hidden_activation="gelu_tanh",
              embed_normalizer=True, attn_logit_softcap=50.0,
              final_logit_softcap=30.0, query_scale=24)
QWEN3 = dict(qk_norm=True)
# TINY_LLAMA with 4 query heads a kv head
TINY_GQA = dataclasses.replace(tl.TINY_LLAMA, num_key_value_heads=2)
# Mistral-7B-v0.3's widths
HIDDEN, N_Q, N_KV, HEAD_DIM, INTER = 4096, 32, 8, 128, 14336


def _launches():
    return [k.launches for k in GLUE_KERNELS]


def test_glue_kernels_are_listed():
    for k in GLUE_KERNELS:
        assert k in qcuda.KERNELS
        assert k.source == "quantizations_tpu_torch/csrc/fused_glue.cu"
        assert k.path.exists()
    # one source, one library: build() starts one nvcc for the three
    assert len({k.so_path() for k in GLUE_KERNELS}) == 1
    assert [list(k.functions) for k in GLUE_KERNELS] == [
        ["qt_add_rms_norm"], ["qt_rope_qk"], ["qt_glu_act"]]


def _refusals():
    x = torch.zeros(3, 8, dtype=torch.bfloat16)
    w = torch.ones(8)
    q = torch.zeros(1, 3, 4, 8)
    k = torch.zeros(1, 3, 2, 8)
    cs = torch.zeros(1, 3, 8)
    g = torch.zeros(3, 5)
    return {
        "norm_x_fp16": lambda: glue.add_rms_norm(x.half(), None, w, 1e-5),
        "norm_x_int": lambda: glue.add_rms_norm(x.int(), None, w, 1e-5),
        "norm_scalar": lambda: glue.add_rms_norm(x[0, 0], None, w, 1e-5),
        "norm_delta_shape": lambda: glue.add_rms_norm(
            x, torch.zeros(3, 9), w, 1e-5),
        "norm_delta_fp16": lambda: glue.add_rms_norm(
            x, torch.zeros(3, 8, dtype=torch.float16), w, 1e-5),
        "norm_w_shape": lambda: glue.add_rms_norm(x, None, torch.ones(9),
                                                  1e-5),
        "norm_out_fp16": lambda: glue.add_rms_norm(
            x, None, w, 1e-5, out_dtype=torch.float16),
        "rope_bf16": lambda: glue.rope_qk(q.bfloat16(), k, cs, cs),
        "rope_cos_bf16": lambda: glue.rope_qk(q, k, cs.bfloat16(), cs),
        "rope_3d": lambda: glue.rope_qk(q[0], k[0], cs, cs),
        "rope_rows": lambda: glue.rope_qk(q, k[:, :2], cs, cs),
        "rope_odd_d": lambda: glue.rope_qk(q[..., :7], k[..., :7],
                                           cs[..., :7], cs[..., :7]),
        "rope_table": lambda: glue.rope_qk(q, k, cs[:, :2], cs),
        "act_bf16": lambda: glue.glu_act(g.bfloat16(), g, "silu"),
        "act_shape": lambda: glue.glu_act(g, g[:, :4], "silu"),
        "act_3d": lambda: glue.glu_act(g[None], g[None], "silu"),
        "act_out_fp16": lambda: glue.glu_act(g, g, "silu", torch.float16),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrappers_refuse_before_any_launch(case):
    before = _launches()
    with pytest.raises(ValueError):
        _refusals()[case]()
    assert _launches() == before


@pytest.mark.parametrize("knobs", [{}, GEMMA2, QWEN3,
                                   dict(kv_cache_dtype="int8")],
                         ids=["llama", "gemma2", "qwen3", "int8"])
def test_cpu_forward_launches_no_glue_kernel(knobs):
    cfg = dataclasses.replace(TINY_GQA, **knobs)
    p = tl.fuse_projections(tl.init_llama_params(cfg, seed=1, device="cpu"))
    before = _launches()
    eng = tpg.PagedEngine(p, cfg, num_pages=24, page_size=16, slots=2,
                          max_seq=64, prefill_buckets=(8, 16))
    for n in (5, 11):
        eng.submit(list(range(3, 3 + n)), max_new_tokens=3)
    assert len(eng.run()) == 2
    assert _launches() == before


def test_layer_takes_the_plain_glue_for_other_compute_dtypes():
    assert tl._glue(torch.bfloat16) == (glue.add_rms_norm, glue.rope_qk,
                                        glue.glu_act)
    assert tl._glue(torch.float32)[0] is glue.add_rms_norm
    assert tl._glue(torch.float16) == (glue.add_rms_norm_plain,
                                       glue.rope_qk_plain, glue.glu_act_plain)


def test_add_residual_is_the_layers_add():
    x = torch.randn(2, 3, 8).bfloat16()
    d = torch.randn(2, 3, 8)
    assert tl.add_residual(x, None) is x
    assert torch.equal(tl.add_residual(x, d), x + d.to(torch.bfloat16))
    res, y = glue.add_rms_norm(x, d, torch.ones(8), 1e-5)
    assert torch.equal(res, tl.add_residual(x, d))
    assert torch.equal(y, tl.rms_norm(res, torch.ones(8), 1e-5))



@pytest.mark.parametrize("device,current,guarded",
                         [("cuda:0", 0, None), ("cuda", 1, None),
                          ("cuda:1", 0, 1), ("cuda:0", 2, 0)],
                         ids=["current", "no-index", "other", "other-0"])
def test_launch_takes_the_devices_stream_and_guards_only_another(
        device, current, guarded, monkeypatch):
    """``launch`` passes the raw current stream of ``device`` and enters a
    device guard only where ``device`` is not the current one."""
    active, calls = [], []

    class Guard:
        def __init__(self, idx):
            self.idx = idx

        def __enter__(self):
            active.append(self.idx)

        def __exit__(self, *exc):
            active.pop()

    class Lib:
        def qt_fake(self, *args):
            calls.append((args, list(active)))
            return 0

    k = qcuda.Kernel("fake", qcuda.ADD_RMS_NORM.source, "", {"qt_fake": []})
    monkeypatch.setitem(qcuda._libs, "fake", Lib())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 1000 + idx, raising=False)
    qcuda.launch(k, "qt_fake", torch.device(device), 7, 8)
    idx = torch.device(device).index
    idx = current if idx is None else idx
    assert calls == [((7, 8, 1000 + idx), [] if guarded is None
                      else [guarded])]
    assert active == [] and k.launches == 1

    Lib.qt_fake = lambda self, *args: 5          # a refused launch
    with pytest.raises(RuntimeError, match="error 5"):
        qcuda.launch(k, "qt_fake", torch.device(device), 7, 8)
    assert active == [] and k.launches == 1

def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("knobs", [{}, GEMMA2], ids=["llama", "gemma2"])
def test_chip_smoke_glue_counts_are_the_wrapper_calls(knobs, monkeypatch):
    smoke = _chip_smoke()
    cfg = dataclasses.replace(TINY_GQA, **knobs)
    p = tl.fuse_projections(tl.init_llama_params(cfg, seed=1, device="cpu"))
    calls = dict.fromkeys(smoke.GLUE_KERNELS, 0)

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    for name in smoke.GLUE_KERNELS:
        monkeypatch.setattr(tl, name, counted(name, getattr(glue, name)))
    norms = 4 if cfg.post_norms else 2
    L = cfg.num_hidden_layers
    gen = make_generate_fn(cfg, ServeConfig(max_seq_len=32,
                                            max_new_tokens=5))
    gen(p, torch.arange(3, 9, dtype=torch.int32)[None, :],
        tl.KVCache.create(cfg, 1, 32, "cpu"), None)
    assert calls == smoke._glue_forwards(5, L, norms=norms)
    calls.update(dict.fromkeys(calls, 0))
    eng = tpg.PagedEngine(p, cfg, num_pages=24, page_size=16, slots=2,
                          max_seq=64, prefill_buckets=(8, 16))
    rounds, rnd = [], eng._prefill_round

    def counted_round(ids, *a):
        rounds.append(ids.shape)
        return rnd(ids, *a)

    eng._prefill_round = counted_round
    for n in (5, 11, 20):
        eng.submit(list(range(3, 3 + n)), max_new_tokens=4)
    eng.run()
    assert calls == smoke._glue_forwards(len(rounds) + eng.stats()["steps"],
                                         L, norms=norms)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _randn(*shape, dev, seed=0, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


def _within_one_ulp(y, ref):
    """Each element of ``y`` within one bf16 ulp of ``ref``'s."""
    r = ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    return bool(((y.float() - r).abs() <= ulp).all())



@pytest.mark.cuda
def test_launch_stream_is_the_current_stream_on_card(cuda):
    side = torch.cuda.Stream(cuda)
    for s in (torch.cuda.current_stream(cuda), side):
        with torch.cuda.stream(s):
            assert (torch._C._cuda_getCurrentRawStream(cuda.index)
                    == torch.cuda.current_stream(cuda).cuda_stream
                    == s.cuda_stream)

@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 256, 1024])
@pytest.mark.parametrize("case", ["fp32_delta", "bf16_delta", "no_delta",
                                  "plus_one", "fp32_in_out", "strided"])
def test_k11_matches_plain_on_card(cuda, rows, case):
    x = _randn(rows, HIDDEN, dev=cuda, dtype=torch.bfloat16)
    delta = _randn(rows, HIDDEN, dev=cuda, seed=1)
    w = (1.0 + 0.1 * _randn(HIDDEN, dev=cuda, seed=2)).to(torch.bfloat16)
    plus_one, out = False, torch.bfloat16
    if case == "bf16_delta":
        delta = delta.to(torch.bfloat16)
    elif case == "no_delta":
        delta = None
    elif case == "plus_one":
        plus_one, w = True, 0.1 * _randn(HIDDEN, dev=cuda, seed=2)
    elif case == "fp32_in_out":      # Gemma's post norms: fp32 in and out
        x, delta, out = delta, None, torch.float32
    elif case == "strided":          # the last token of 3 a row
        x = _randn(rows, 3, HIDDEN, dev=cuda, dtype=torch.bfloat16)[:, -1:]
        delta = _randn(rows, 3, HIDDEN, dev=cuda, seed=1)[:, -1:]
    before = qcuda.ADD_RMS_NORM.launches
    res, y = glue.add_rms_norm(x, delta, w, 1e-5, plus_one, out)
    ref_res, ref_y = glue.add_rms_norm_plain(x, delta, w, 1e-5, plus_one, out)
    torch.cuda.synchronize()
    assert qcuda.ADD_RMS_NORM.launches == before + 1
    assert res.dtype == ref_res.dtype and torch.equal(res, ref_res)
    assert y.dtype == out and y.shape == ref_y.shape
    assert _within_one_ulp(y, ref_y)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 256, 1024])
@pytest.mark.parametrize("shape", ["mistral", "gemma2_256", "odd"])
def test_k12_bit_exact_on_card(cuda, T, shape):
    B, n_q, n_kv, D = dict(mistral=(1, N_Q, N_KV, HEAD_DIM),
                           gemma2_256=(2, 16, 8, 256),
                           odd=(3, 6, 3, 64))[shape]
    slab = _randn(B * T, (n_q + 2 * n_kv) * D, dev=cuda)   # K1's q|k|v
    q = slab[:, :n_q * D].reshape(B, T, n_q, D)
    k = slab[:, n_q * D:(n_q + n_kv) * D].reshape(B, T, n_kv, D)
    pos = torch.arange(T, device=cuda)[None, :] + torch.tensor(
        [[0], [517], [3000]], device=cuda)[:B]
    cos, sin = tl.rope_cos_sin(pos, D, 1e6)
    before = qcuda.ROPE_QK.launches
    got = glue.rope_qk(q, k, cos, sin)
    ref = glue.rope_qk_plain(q, k, cos, sin)
    torch.cuda.synchronize()
    assert qcuda.ROPE_QK.launches == before + 1
    for a, b in zip(got, ref):
        assert a.is_contiguous() and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 256, 1024])
@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_k13_bit_exact_on_card(cuda, rows, act, out):
    gu = 4.0 * _randn(rows, 2 * INTER, dev=cuda)          # K1's gate|up
    g, u = gu[:, :INTER], gu[:, INTER:]
    before = qcuda.GLU_ACT.launches
    got = glue.glu_act(g, u, act, out)
    ref = glue.glu_act_plain(g, u, act, out)
    torch.cuda.synchronize()
    assert qcuda.GLU_ACT.launches == before + 1
    assert got.dtype == out and torch.equal(got, ref)


def _plain_glue(compute_dtype):
    return glue.add_rms_norm_plain, glue.rope_qk_plain, glue.glu_act_plain


def _forwards(cfg, dev):
    """The slot prefill's logits of 2 rows of 11 tokens, then one paged
    decode step's over a pool filled by two earlier steps."""
    p = tl.fuse_projections(tl.init_llama_params(cfg, seed=1, device=dev))
    ids = torch.randint(0, cfg.vocab_size, (2, 11),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    pre, _ = tl.prefill(p, ids, tl.KVCache.create(cfg, 2, 32, dev), cfg)
    pages = tpg.PagedKVCache.create(cfg, 8, page_size=8, device=dev)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    pos = torch.tensor([5, 9], device=dev)
    for step in range(3):
        dec, _ = tpg.paged_decode_step(p, ids[:, step:step + 1], pages,
                                       table, pos + step, cfg, 2)
    return pre.reshape(-1, pre.shape[-1]), dec


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [{}, dict(kv_cache_dtype="int8"), GEMMA2,
                                   QWEN3],
                         ids=["bf16", "int8", "gemma2", "qwen3"])
def test_forward_with_glue_kernels_matches_plain_on_card(cuda, knobs,
                                                         monkeypatch):
    cfg = dataclasses.replace(TINY_GQA, **knobs)
    before = _launches()
    fused = _forwards(cfg, cuda)
    L = cfg.num_hidden_layers
    norms = 2 * L * (2 if cfg.post_norms else 1) + 1
    # the prefill and three decode steps
    assert [a - b for a, b in zip(_launches(), before)] == [
        4 * norms, 4 * L, 4 * L]
    with monkeypatch.context() as m:
        m.setattr(tl, "_glue", _plain_glue)
        before = _launches()
        plain = _forwards(cfg, cuda)
        assert _launches() == before
    for got, ref in zip(fused, plain):
        got, ref = got.float().cpu(), ref.float().cpu()
        scale = ref.abs().max()
        assert (got - ref).abs().max() <= 1e-2 * scale
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2e-2 * scale
        assert torch.equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])
