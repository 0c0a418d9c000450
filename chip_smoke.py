#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``quantizations_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

1. the device: its name, and ``nvidia-smi``'s name and power limit;
2. ``build``: compile every kernel from ``quantizations_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and time it;
3. ``k2``: the quantize kernel against its plain version, bit-exact,
   FP4 and NF4, at every shape that model build quantizes (and the fused
   gate|up's ``[28672, 4096]``), with values placed exactly on the code
   thresholds, then timed at each shape (inputs rotating so that they do
   not sit in the 50 MB L2) and summed over one model build's launches;
4. ``k1``: the pair dequant-matmul kernel against its plain version at
   every Llama3-8B main-path shape, T in {1, 4, 8, 16, 64, 128, 256},
   FP4 and NF4, fp32 and ``bf16x2`` scales, stacked at a layer other
   than 0 and unstacked. Tolerance: 1e-5 * max|y|, for the fp32
   summation order only (both sides round every operand identically);
5. ``time``: each kernel timed with CUDA events over many launches after
   a warm-up (K1 at the decode and prefill T of batch 1, 4 and 8), K1's
   weights rotating over a 32-layer stack so that they
   do not sit in the 50 MB L2, beside its bound, its plain version and
   one PyTorch library call computing the same function;
6. ``model``: the main path. Llama3-8B at full width and depth with a
   4-bit embedding and lm_head, random weights from seed 0 quantized by
   K2, fused q|k|v and gate|up, then greedy generation of 60 tokens
   after a 16-token prompt at batch 1, 4 and 8 (FP4) and batch 1 (NF4).
   Every generate must launch K1 exactly 60 * (4 * 32 + 1) = 7740 times
   and give the same tokens on every run; tok/s is new tokens over the
   whole generate call, from CUDA events, the median of 5 timed runs
   after a warm-up at every batch, printed with their min and max. A
   tiny model then checks the CUDA path against the CPU's plain path on
   the same parameters;
7. ``profile``: one FP4 batch-1 generate of 8 new tokens under
   ``torch.profiler``: device kernel time by name, kernels per forward,
   the device's busy share of the wall time, the host's enqueue time.

Then one JSON line of kernel results, the ``nvidia-smi`` line again, and
last ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Exits non-zero with no result when no
CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
L2_BYTES = 50 * 2**20

K1_SHAPES = (("qkv", 6144, 4096), ("o", 4096, 4096),
             ("gate_up", 28672, 4096), ("down", 4096, 14336),
             ("lm_head", 128256, 4096))
K1_TOKENS = (1, 4, 8, 16, 64, 128, 256)
K1_DECODE_TOKENS = (1, 4, 8)               # decode at B = 1, 4, 8
K1_TIMED_TOKENS = K1_DECODE_TOKENS + (16, 64, 128)   # and their prefill
PROMPT_LEN = 16
LAYERS = 32
# (M, K) -> K2 launches in one Llama3-8B model build: per layer q and o,
# k and v, gate and up, down; then the embedding and the lm_head. The
# fused gate|up shape is checked too but never quantized whole.
K2_SHAPES = {(4096, 4096): 2 * LAYERS, (1024, 4096): 2 * LAYERS,
             (14336, 4096): 2 * LAYERS, (4096, 14336): LAYERS,
             (128256, 4096): 2, (28672, 4096): 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, n: int, warmup: int = 3) -> float:
    """Device time of one ``fn(i)`` in ms: CUDA events around ``n`` calls,
    queued behind a sleep kernel so that host launch overhead stays out
    of the measurement."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e5 * n + 2e6))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by) on an H100 SXM."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_k2(dev, gen, results):
    from quantizations_tpu_torch.ops import (quantize_4bit_kernel,
                                             quantize_4bit_kernel_plain)
    from quantizations_tpu_torch.quant.codebooks import (NF4_CODE,
                                                         code_midpoints)

    # values exactly on every FP4 threshold and NF4 midpoint (and their
    # fp32 neighbours), in a block whose absmax is 1 so w * (1/absmax) = w
    th = [0.29166667, 0.583333, 0.8333333, 0.4166667, 0.0859375,
          0.20833333, 0.00260417] + [float(m) for m in code_midpoints(NF4_CODE)]
    t = torch.tensor(th, dtype=torch.float32)
    edge = torch.cat([t, torch.nextafter(t, torch.full_like(t, 2.0)),
                      torch.nextafter(t, torch.zeros_like(t))])
    edge = torch.cat([edge, -edge])[:63]
    edge = torch.cat([torch.ones(1), edge]).to(dev)
    shapes = []
    for (M, K), per_build in K2_SHAPES.items():
        # model build draws fp32 normal weights of scale 0.02
        R = max(2, math.ceil(4 * L2_BYTES / (M * K * 4)))
        Ws = [torch.randn(M, K, generator=gen, device=dev) * 0.02
              for _ in range(R)]
        W = Ws[0]
        W[0, :64] = edge
        W[1, :64] = 0.0                      # a zero block
        for qt in ("fp4", "nf4"):
            wp, am = quantize_4bit_kernel(W, 64, qt)
            wpp, amp = quantize_4bit_kernel_plain(W, 64, qt)
            torch.cuda.synchronize()
            if not (torch.equal(wp, wpp) and torch.equal(am, amp)):
                bad = (wp != wpp).sum().item()
                raise AssertionError(
                    f"K2 {qt} [{M},{K}]: {bad} words differ from plain")
            log(f"  K2 {qt} [{M}, {K}]: bit-exact with the plain version")
        ms = device_ms(lambda i: quantize_4bit_kernel(Ws[i % R], 64, "fp4"),
                       20)
        pms = device_ms(lambda i: quantize_4bit_kernel_plain(W, 64, "fp4"),
                        2, warmup=1)
        nbytes = M * K * 4 + M * K // 2 + M * (K // 64) * 4
        bms, by = bound(nbytes, 0)
        shapes.append(dict(M=M, K=K, launches_per_build=per_build, ms=ms,
                           plain_ms=pms, bound_ms=bms))
        log(f"  K2 fp4 [{M}, {K}] fp32 in: {ms:.4f} ms (bound {bms:.4f}, "
            f"plain {pms:.3f}), {per_build} launches per model build")
        del W, Ws, wp, am, wpp, amp
        torch.cuda.empty_cache()
    per_build = {k: sum(s["launches_per_build"] * s[k] for s in shapes)
                 for k in ("ms", "plain_ms", "bound_ms")}
    log(f"  K2 per model build ({sum(K2_SHAPES.values())} launches): "
        f"{per_build['ms']:.3f} ms, bound {per_build['bound_ms']:.3f} ms, "
        f"plain {per_build['plain_ms']:.3f} ms")
    results["k2"] = dict(max_abs_err=0.0, shapes=shapes, bound_by="bytes",
                         **per_build)


def _pair_operands(M, K, L, dev, gen):
    wp2 = torch.randint(-2**31, 2**31, (L, M // 2, K // 4), generator=gen,
                        device=dev, dtype=torch.int64).to(torch.int32)
    scales = torch.rand(L, M, K // 64, generator=gen, device=dev) * 0.05 + 0.01
    return wp2, scales


def phase_k1(dev, gen, results):
    from quantizations_tpu_torch.ops import (matmul_4bit_pair,
                                             matmul_4bit_pair_plain,
                                             matmul_4bit_pair_stacked,
                                             matmul_4bit_pair_stacked_plain,
                                             pack_scale_pairs)

    worst, worst_abs = 0.0, 0.0
    for name, M, K in K1_SHAPES:
        wp2, scales = _pair_operands(M, K, 3, dev, gen)
        packed = pack_scale_pairs(scales)
        x = torch.randn(max(K1_TOKENS), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        n = 0
        for qt in ("fp4", "nf4"):
            for skind, s in (("fp32", scales), ("bf16x2", packed)):
                cases = [("stacked", T) for T in K1_TOKENS]
                cases += [("unstacked", T) for T in (1, 16)]
                for form, T in cases:
                    if form == "stacked":
                        y = matmul_4bit_pair_stacked(wp2, s, x[:T], 2, qt)
                        yp = matmul_4bit_pair_stacked_plain(wp2, s, x[:T], 2,
                                                            qt)
                    else:
                        y = matmul_4bit_pair(wp2[0], s[0], x[:T], qt)
                        yp = matmul_4bit_pair_plain(wp2[0], s[0], x[:T], qt)
                    torch.cuda.synchronize()
                    if y.shape != (T, M) or not torch.isfinite(y).all():
                        raise AssertionError(f"K1 {name} {qt} {skind} T={T}: "
                                             f"bad output {tuple(y.shape)}")
                    err = (y - yp).abs().max().item()
                    tol = 1e-5 * yp.abs().max().item()
                    if not err <= tol:
                        raise AssertionError(
                            f"K1 {name} [{M},{K}] {qt} {skind} {form} T={T}: "
                            f"max|err| {err:.3e} > tol {tol:.3e}")
                    worst = max(worst, err / max(tol, 1e-30) * 1e-5)
                    worst_abs = max(worst_abs, err)
                    n += 1
        log(f"  K1 {name} [{M}, {K}]: {n} cases within 1e-5 * max|y| of "
            f"the plain version")
        del wp2, scales, packed, x
        torch.cuda.empty_cache()
    results["k1_err"] = dict(max_abs_err=worst_abs, max_rel_err=worst)
    log(f"  K1 worst max|err|: {worst_abs:.3e}; worst max|err| / max|y|: "
        f"{worst:.3e}")


def phase_time(dev, gen, results):
    """Per-shape K1 times at the decode T (the batch) and the prefill T
    (16 x the batch); the per-forward sums weight each shape by its
    launches in one forward (32 layers x 4 projections + the lm_head).
    Prefill computes logits for the last token only, so a prefill
    forward's lm_head launch is the one at T / 16."""
    from quantizations_tpu_torch.ops import (matmul_4bit_pair,
                                             matmul_4bit_pair_plain,
                                             matmul_4bit_pair_stacked)

    rows = []
    for name, M, K in K1_SHAPES:
        L = LAYERS
        wp2, scales = _pair_operands(M, K, L, dev, gen)
        x = torch.randn(max(K1_TIMED_TOKENS), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        dense_bytes = M * K * 2
        R = max(2, math.ceil(4 * L2_BYTES / dense_bytes))
        Wd = torch.randn(R, M, K, generator=gen, device=dev).to(torch.bfloat16)
        for T in K1_TIMED_TOKENS:
            xt = x[:T].contiguous()
            if name == "lm_head":
                ms = device_ms(lambda i: matmul_4bit_pair(
                    wp2[i % L], scales[i % L], xt, "fp4"), 64)
            else:
                ms = device_ms(lambda i: matmul_4bit_pair_stacked(
                    wp2, scales, xt, i % L, "fp4"), 64)
            pms = device_ms(lambda i: matmul_4bit_pair_plain(
                wp2[0], scales[0], xt, "fp4"), 3, warmup=1)
            lms = device_ms(lambda i: torch.matmul(xt, Wd[i % R].T), 64)
            nbytes = M * K // 2 + M * (K // 64) * 4 + T * K * 2 + T * M * 4
            bms, by = bound(nbytes, 2 * T * M * K)
            rows.append(dict(shape=name, M=M, K=K, T=T, ms=ms, plain_ms=pms,
                             library_ms=lms, bound_ms=bms, bound_by=by))
            log(f"  K1 {name:8s} T={T}: {ms * 1e3:9.2f} us  bound "
                f"{bms * 1e3:8.2f} us ({by})  plain {pms * 1e3:10.1f} us  "
                f"torch.matmul bf16 {lms * 1e3:8.2f} us")
        del wp2, scales, x, Wd
        torch.cuda.empty_cache()
    per_t = {}
    for T in K1_TIMED_TOKENS:
        head_t = T if T in K1_DECODE_TOKENS else T // PROMPT_LEN
        sel = [r for r in rows if (r["T"] == head_t if r["shape"] == "lm_head"
                                   else r["T"] == T)]
        per_t[T] = {k: sum((1 if r["shape"] == "lm_head" else LAYERS) * r[k]
                           for r in sel)
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"  K1 per forward at T={T}, lm_head at T={head_t} "
            f"({4 * LAYERS + 1} launches): {per_t[T]['ms']:.3f} ms, bound "
            f"{per_t[T]['bound_ms']:.3f} ms, torch.matmul bf16 "
            f"{per_t[T]['library_ms']:.3f} ms")
    results["k1_time"] = dict(rows=rows, per_forward=per_t)


def phase_model(dev, results):
    from quantizations_tpu_torch.config import QuantConfig, ServeConfig
    from quantizations_tpu_torch.models.llama import (
        LLAMA3_8B, TINY_LLAMA, KVCache, fuse_projections, init_llama_params,
        map_tensors, named_tensors, prefill)
    from quantizations_tpu_torch.ops import KERNELS, PAIR_MATMUL
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    serve = ServeConfig(max_seq_len=128, max_new_tokens=60, temperature=0.0)
    layers = LLAMA3_8B.num_hidden_layers
    per_generate = serve.max_new_tokens * (4 * layers + 1)
    runs = []
    for k in KERNELS:
        k.launches = 0
    for qt, batches in (("fp4", (1, 4, 8)), ("nf4", (1,))):
        cfg = dataclasses.replace(
            LLAMA3_8B,
            quant=QuantConfig(quant_type=qt, quantize_embedding=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = fuse_projections(init_llama_params(cfg, seed=0, device=dev))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        wbytes = sum(t.numel() * t.element_size()
                     for _, t in named_tensors(params))
        log(f"  {qt} Llama3-8B ({layers} layers) built in {build_s:.2f} s, "
            f"{wbytes / 1e9:.3f} GB of weights")
        ids = ((torch.arange(16, device=dev) * 7 + 11) % cfg.vocab_size
               ).to(torch.int32)[None, :]
        logits, _ = prefill(params, ids, KVCache.create(cfg, 1, 128, dev), cfg)
        torch.cuda.synchronize()
        if logits.shape != (1, 16, cfg.vocab_size) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"{qt} prefill logits bad: {logits.shape}")
        gen = make_generate_fn(cfg, serve)
        for B in batches:
            idsb = ids.repeat(B, 1)
            times, first = [], None
            for it in range(5 + 1):
                cache = KVCache.create(cfg, B, serve.max_seq_len, dev)
                before = PAIR_MATMUL.launches
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                toks, _ = gen(params, idsb, cache, None)
                end.record()
                end.synchronize()
                got = PAIR_MATMUL.launches - before
                if got != per_generate:
                    raise AssertionError(f"K1 launched {got} times in one "
                                         f"generate, expected {per_generate}")
                if toks.shape != (B, serve.max_new_tokens) or int(
                        toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
                    raise AssertionError(f"tokens out of range: {toks.shape}")
                if first is None:
                    first = toks.cpu()
                elif not torch.equal(first, toks.cpu()):
                    raise AssertionError(f"{qt} B={B}: tokens differ between "
                                         "runs")
                if it:                       # the first run is the warm-up
                    times.append(start.elapsed_time(end) / 1e3)
            t = statistics.median(times)
            tps = serve.max_new_tokens * B / t
            lo, hi = (serve.max_new_tokens * B / max(times),
                      serve.max_new_tokens * B / min(times))
            runs.append(dict(quant_type=qt, batch=B, tok_per_s=tps,
                             tok_per_s_min=lo, tok_per_s_max=hi,
                             generate_s=t, generate_s_all=times,
                             k1_launches_per_generate=per_generate,
                             first_tokens=first[0, :8].tolist()))
            log(f"  {qt} B={B}: {tps:.2f} tok/s, median of {len(times)} "
                f"(min {lo:.2f}, max {hi:.2f}; {t:.4f} s per generate, "
                f"K1 launches {per_generate} each)")
        del params, logits
        torch.cuda.empty_cache()
    results["launches"] = {k.name: k.launches for k in KERNELS}
    results["generate"] = runs
    for k in KERNELS:
        if k.launches == 0:
            raise AssertionError(f"{k.name} was never launched on the main "
                                 "path")

    # the CUDA path against the CPU's plain path on the same parameters
    cfg = dataclasses.replace(TINY_LLAMA, quant=QuantConfig(
        quantize_embedding=True))
    p_gpu = fuse_projections(init_llama_params(cfg, seed=1, device=dev))
    p_cpu = map_tensors(lambda t: t.cpu(), p_gpu)
    ids = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(0)).to(
                            torch.int32)
    lg, _ = prefill(p_gpu, ids.to(dev), KVCache.create(cfg, 2, 32, dev), cfg)
    lc, _ = prefill(p_cpu, ids, KVCache.create(cfg, 2, 32, "cpu"), cfg)
    err = (lg.cpu() - lc).abs().max().item()
    scale = lc.abs().max().item()
    top1 = (lg.cpu().argmax(-1) == lc.argmax(-1)).float().mean().item()
    log(f"  TINY_LLAMA CUDA vs CPU plain prefill logits: max|err| {err:.3e} "
        f"(max|logit| {scale:.3f}), top-1 agreement {top1:.3f}")
    # bf16 attention operands on the card, fp32 on the CPU
    if not err <= 2e-2 * scale:
        raise AssertionError("TINY_LLAMA CUDA logits disagree with the CPU")
    results["tiny_check"] = dict(max_abs_err=err, max_abs_logit=scale,
                                 top1=top1)


def phase_profile(dev, results):
    """Where one FP4 batch-1 generate spends its time: ``torch.profiler``
    over one warm generate of 8 new tokens (few, to keep the trace
    small), the device kernels summed by name, the device's busy share
    of the generate's wall time (CUDA events) and the host's enqueue time
    (the generate call returning before the device finishes). The
    profiler slows the host, so the busy share here is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    from quantizations_tpu_torch.config import QuantConfig, ServeConfig
    from quantizations_tpu_torch.models.llama import (LLAMA3_8B, KVCache,
                                                      fuse_projections,
                                                      init_llama_params)
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    serve = ServeConfig(max_seq_len=128, max_new_tokens=8, temperature=0.0)
    cfg = dataclasses.replace(LLAMA3_8B,
                              quant=QuantConfig(quantize_embedding=True))
    params = fuse_projections(init_llama_params(cfg, seed=0, device=dev))
    ids = ((torch.arange(16, device=dev) * 7 + 11) % cfg.vocab_size
           ).to(torch.int32)[None, :]
    gen = make_generate_fn(cfg, serve)
    gen(params, ids, KVCache.create(cfg, 1, serve.max_seq_len, dev), None)
    torch.cuda.synchronize()
    cache = KVCache.create(cfg, 1, serve.max_seq_len, dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        gen(params, ids, cache, None)
        end.record()
        host_s = time.perf_counter() - t0
        end.synchronize()
    wall_s = start.elapsed_time(end) / 1e3
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e6
    busy_s = sum(by_name.values())
    if busy_s == 0.0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    steps = serve.max_new_tokens
    results["profile"] = dict(
        wall_s=wall_s, host_enqueue_s=host_s, device_busy_s=busy_s,
        device_busy_share=busy_s / wall_s, kernels=n_kernels,
        kernels_per_forward=n_kernels / steps,
        top=[dict(name=n[:120], s=s, share=s / busy_s) for n, s in top])
    log(f"  fp4 B=1 generate: wall {wall_s:.4f} s (CUDA events), host "
        f"enqueue {host_s:.4f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / wall_s:.1f}% of wall), {n_kernels} device "
        f"kernels ({n_kernels / steps:.0f} per forward)")
    for n, s in top:
        log(f"    {s * 1e3:9.2f} ms  {100 * s / busy_s:5.1f}%  {n[:90]}")
    del params


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from quantizations_tpu_torch.ops import KERNELS
    from quantizations_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    results = {"device": kind, "nvidia_smi": smi}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    build(KERNELS)
    results["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(KERNELS)} kernels built and loaded in "
        f"{results['build_s']:.2f} s")
    for ph, fn in (("k2", lambda: phase_k2(dev, gen, results)),
                   ("k1", lambda: phase_k1(dev, gen, results)),
                   ("time", lambda: phase_time(dev, gen, results)),
                   ("model", lambda: phase_model(dev, results)),
                   ("profile", lambda: phase_profile(dev, results))):
        t0 = time.perf_counter()
        log(f"[{ph}]")
        fn()
        log(f"[{ph}] done in {time.perf_counter() - t0:.1f} s")

    kernels = []
    launches = results.get("launches", {})
    for k in KERNELS:
        entry = dict(name=k.name, route="cuda", source=k.source,
                     replaces=k.replaces, launches=launches.get(k.name, 0))
        if k.name == "pair_matmul":
            f1 = results.get("k1_time", {}).get("per_forward", {}).get(1, {})
            entry.update(
                max_abs_err=results.get("k1_err", {}).get("max_abs_err"),
                max_err_over_max_y=results.get("k1_err", {}).get(
                    "max_rel_err"),
                ms=f1.get("ms"), plain_ms=f1.get("plain_ms"),
                bound_ms=f1.get("bound_ms"), bound_by="bytes",
                library_ms=f1.get("library_ms"),
                unit="one decode forward at T=1: the K1 launches of "
                     f"{LAYERS} layers x 4 projections + the lm_head",
                by_shape=results.get("k1_time", {}).get("rows"))
        else:
            k2 = results.get("k2", {})
            entry.update(max_abs_err=k2.get("max_abs_err"), ms=k2.get("ms"),
                         plain_ms=k2.get("plain_ms"),
                         bound_ms=k2.get("bound_ms"), bound_by="bytes",
                         library_ms=None,
                         unit="one Llama3-8B model build: "
                              f"{sum(K2_SHAPES.values())} fp32 quantizes",
                         by_shape=k2.get("shapes"))
        kernels.append(entry)
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_all
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    log(f"total {results['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
