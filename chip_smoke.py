#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``quantizations_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

1. the device: its name, and ``nvidia-smi``'s name and power limit;
2. ``build``: compile every kernel from ``quantizations_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and time it; beside it
   ``nvcc -Xptxas -v`` on ``flash_decode.cu``, ``pair_matmul.cu``,
   ``planar_matmul.cu`` and ``quantize.cu`` logs the registers and
   spills of every K3/K4 instantiation, of K1/K9's body at each token
   tile, of K5's two bodies and K6 at each of theirs and of K2's two
   bodies by lanes a block, input type and code, and a spill or a
   missing instantiation fails the run;
3. ``k2``: the quantize kernel against its plain version, bit-exact
   (absmax NaN-aware), FP4 and NF4, at every shape that model build
   quantizes (and the fused gate|up's ``[28672, 4096]``; bf16 input at
   ``[4096, 4096]``), with the blocks of ``k2_special_blocks``: values
   exactly on the code thresholds, a zero block, NaN, inf, -0.0 and a
   subnormal absmax; then timed at each shape (inputs rotating so that
   they do not sit in the 50 MB L2) with its TB/s and share of the
   bound, and summed over one model build's launches;
4. ``k1``: the pair dequant-matmul kernel against its plain version at
   every Llama3-8B main-path shape, T in {1, 4, 8, 16, 64, 128, 256}
   (its CUDA-core body up to 128 rows, its tensor-core body above),
   FP4 and NF4, fp32 and ``bf16x2`` scales, stacked at a layer other
   than 0 and unstacked. Tolerance: 1e-5 * max|y|, for the fp32
   summation order only (both sides round every operand identically);
5. ``attn``: the flash-decode kernels K3 (bf16 cache) and K4 (int8
   codes with bf16 steps) against their plain versions at the main
   path's shapes (8 kv heads, 4 query heads each, D 128, B 1/4/8): the
   slot cache (S 2048, attend_len 128 and 2048, unstacked and stacked at
   layer 1) and the paged pool (page 256 and 128, shuffled block tables
   with page 0 in the unused entries, pages_per_step 1 and 2, q_span 1,
   4 and 8, the last 32 query rows), lengths {1, 17, 255, 256, 257, 1900,
   2047}, window none / 100 / 2**30, softcap none / 50; the pool's 2048
   positions split across blocks (16 x 128 at B = 1, boundaries inside
   the pages), and every pool case launched twice gives the same bits.
   Tolerance 1e-5 * max|out| (the same values on both sides; fp32
   summation order only);
6. ``time``: each kernel timed with CUDA events over many launches after
   a warm-up (K1 at the decode and prefill T of batch 1, 4 and 8 and at
   the paged engine's 256-token admission chunk), K1's weights rotating
   over a 32-layer stack so that they do not sit in the 50 MB L2, beside
   its bound, its plain version and one PyTorch library call computing
   the same function; then K3 and K4 per launch at B 1/4/8 and a live
   context of 128, 512 and 1900 tokens, slot and paged, the cache
   rotating over enough layers to exceed the L2 four times, beside the
   bound (the live K/V and step bytes plus q and out over 3.35 TB/s, or
   the fp32 operations over 67 TFLOP/s where longer), its share, the
   split the wrapper chose and the blocks launched, the plain version
   and, for K3, ``scaled_dot_product_attention(..., enable_gqa=True)``
   over the same keys laid out contiguously; 32 query rows over the
   pool; and the pool cases again with each chunk of
   ``ATTN_SWEEP_CHUNKS`` forced (the split sweep);
7. ``model``: first one FP4 model build under ``torch.profiler``: the
   host and device time of K2, ``torch.randn``, the plain double
   quantization, ``planar_to_pair`` and ``fuse_projections``, and the
   device kernels that took the most. Then Llama3-8B at full width and
   depth with a 4-bit embedding and lm_head, random weights from seed 0
   quantized by K2 (exactly 226 launches a build), fused q|k|v and
   gate|up, then greedy generation of 60 tokens after a 16-token
   prompt at batch 1, 4 and 8: FP4 on the einsum path, with
   ``use_flash_attention`` (K3) and with flash and an int8 KV cache
   (K4); NF4 at batch 1. Every generate must launch K1 exactly
   60 * (4 * 32 + 1) = 7740 times (and K3 or K4 exactly 59 * 32 = 1888
   times, K10 never) and give the same tokens on every run; tok/s is new tokens
   over the whole generate call, from CUDA events, the median of 5
   timed runs after a warm-up, printed with their min and max. A tiny
   model then checks the CUDA path against the CPU's plain path on the
   same parameters (prefill, and a flash decode step, bf16 and int8);
8. ``planar``: the planar layout. K5 (planar dequant-matmul: each of
   its two bodies launched directly, and the dispatch, which must give
   the bits of the body ``planar_body`` names; the tensor-core body
   bit-identical across two launches) and K6 (planar fp32 GEMV,
   bit-identical across two launches) within
   1e-5 * max|y| of their plain versions and K7 (dequantize) bit-exact
   at every planar Llama3-8B shape and an odd row count, FP4 and NF4,
   fp32 and bf16 scales, K5 at T in {1, 2, 4, 8, 16, 48, 64}, K6 at T in
   {1, 3, 5, 6, 7, 8}. Then the planar twin of the model phase's FP4
   model (every pair weight repacked to planar words, the same codes and
   scales) generates 60 tokens at B = 1, 3, 8 with exact launch counts
   (B = 1: 7740 K5; B = 3: 128 K5 on the 48-row prefill and 7612 K6; B =
   8: 128 K7 on the 128-row prefill's dense band and 7612 K5; no K1; K5's
   split by body as ``planar_body`` says), the same tokens on every run,
   tok/s the median of 5; each projection of the twin against K1 on the
   pair words it came
   from (K5 within 1e-5 * max|y|: one rounding class; K6 within 1e-2:
   fp32 class against bf16), one decode step's logits against the pair
   model's on the same cache (a layout check, 0.25 * max|logit|: 32
   random layers amplify rounding differences) and where the greedy
   streams part. ``Linear4bit.create`` on a [14336, 4096]
   weight runs T = 1, 3, 64, 256 against the plain path and round-trips
   through the bnb flat tensors bit-identically. Last the kernels' times
   against their bounds (K5's two bodies at T in {1, 2, 4, 8, 16, 32, 48,
   64} per shape and per forward, with the crossover; K6 per T = 3
   forward; K7 at [14336, 4096] and the lm_head), the plain versions and
   dense bf16 ``torch.matmul``;
9. ``pair_variants``: the pair kernel's variants. The tensor-core body
   (``csrc/pair_prefill.cu``: K8, and K1 above 128 rows) within K8_GATE
   * max|y| of its plain versions and of K1's CUDA-core body, with K1
   above 128 rows bit-identical to K8, and K9 (the manual-pipeline pair
   kernel) bit-identical to K1, at every Llama3-8B pair shape (the
   tensor-core body also at M = 6142, a row tail), FP4 and NF4, fp32,
   bf16 and ``bf16x2`` scales, stacked at layer 1 and unstacked: K8 at T
   in {8, 129, 200, 256, 512}, K1 through its tensor-core body at {129,
   200, 256, 512}, K9 at T in {1, 4, 8, 16, 64, 128}. The dense pair band
   (the default route above the K1 band): K10 (pair-layout dequantize)
   bit-exact against ``dense_weight`` and its plain version at every pair
   shape, FP4 and NF4, fp32, bf16 and ``bf16x2`` scales, layer 1 of a
   stack, bf16 and fp32 output; the band (K10, then bf16 tensor-core
   products with fp32 output, ``nn/linear.py dense_product``) within
   1e-5 * max|y| of
   ``dense_matmul_pair_plain`` (fp32 products of the same bf16 values) at
   T in {264, 512, 1024} on the four layer shapes, and the planar dense
   band (K7, the same product) within 1e-5 * max|y| of its fp32 product;
   the band per forward at T = 256, 512 and 1024 beside its bound, K10
   alone, bf16 ``torch.matmul``, K8's route and (512, 1024) the plain
   band. Their times: K9 per
   T = 1 decode forward over the projections it takes (qkv, o, down x
   32), K8 per 512-row prefill forward (all 128 projections), beside
   K1's CUDA-core body, the plain versions, dense bf16 ``torch.matmul``
   and (K8) the dense pair path; K1's two bodies, each launched
   directly, at T in {16, 64, 128, 256, 512} on the four layer shapes
   beside the bound and ``torch.matmul``, where the tensor-core body
   starts to win, and the body with each of its row tiles at T = 128, 256
   and 512 (the tile rule's data). Then the knobs end to
   end on the model phase's parameters: ``pair_pipeline="manual"``
   generates at B = 1, 4, 8 with exact K9/K1 counts (MANUAL_LAUNCHES) and
   the model phase's tokens; ``QT_PREFILL_PAIR=1`` generates after a
   1024-token prompt with exactly 256 K8 and 7612 K1 launches (no K10),
   and its prefill forward is timed on three routes in turns: K8, the
   dense pair band (exactly 128 K10 launches) and the plain band, with
   the band's last-token logits within 0.25 * max|logit| of the K8 and
   the plain routes'; a ``PagedEngine`` run without and with
   ``QT_PREFILL_PAIR`` (K8 launched 128 x ceil(rows / 512) times per
   admission forward above the K1 band with a row count divisible by 8,
   K10 128 times per other admission forward above the band);
10. ``paged``: the paged engine. ``PagedEngine(slots=4, max_seq=2048,
   prefill_buckets=(64, 256), admit_width=4, prefix_cache=True,
   num_pages=40)`` (page 256) over the FP4 model serves 8 greedy
   requests of 32 new tokens: prompts of 16, 100, 300, 700, 1100, 1500
   and 1900 tokens from seed 0, and an eighth that shares the 700-token
   prompt's first 512 tokens (it must hit the prefix cache for two
   pages). Then again on a fresh engine (the same tokens), then with an
   int8 pool (its agreement with the bf16 tokens is printed). Each run
   must launch K3 (K4) exactly 32 * steps times, K1 at least
   129 * steps times and K1's tensor-core body exactly 128 times per
   admission forward of 129-256 rows (20 chunks of 256: 2,560) and K10
   exactly 128 times per admission forward above 256 rows (the batched
   group's 3 rounds of 1024: 384), finish
   every request with 32 in-vocabulary
   tokens and return every page but the prefix cache's pins. Printed:
   aggregate new tokens per second, steps, admission group sizes, and
   the wall time split into admission and decode;
11. ``spec``: speculative decoding and the slot ``Engine`` on the same
   FP4 model. First the paged verify window on a tiny model with 4
   query heads per kv head (windows of 4 and 8 tokens, 32 query rows at
   8) against the CPU's plain path: logits within 2e-2 * max|logit|, bf16
   and int8 pools, one row across a page boundary, the window write
   bit-equal. Then ``PagedEngine`` (the paged phase's configuration and
   requests) through ``step_spec(8)`` twice (the same tokens),
   ``step_spec_multi(8, 4)`` and ``step_spec(8)`` on an int8 pool: K3 (K4)
   exactly 32 per forward (verify windows at q_span 8 and plain
   fallback steps), K1's CUDA-core body exactly 129 per forward and per
   admission forward of at most 128 rows (one per larger one), its
   tensor-core body and K10 as in the paged phase, 32 tokens a request,
   pages returned; printed beside the paged phase's plain run, with the
   tokens that agree with it. One verify window (B = 4, T = 8) is timed
   against one plain step at 1900 tokens. The slot ``Engine(slots=4,
   max_seq=2048, prefill_buckets=(16, 64, 256))`` serves the same
   requests: ``run()`` twice (the same tokens),
   ``run(steps_per_dispatch=4)``, ``run(spec_k=8)``, and ``run()`` with
   flash (K3) and with flash and an int8 cache (K4), each with exact
   K1/K3/K4/K10 counts. Last ``make_speculative_generate_fn`` at B = 1,
   k = 8, 60 tokens after the model phase's prompt (K1 exactly 129 per
   forward, the same tokens every run; tok/s the median of 3) beside the
   model phase's generate;
12. ``load``: the checkpoint path and the command line. A synthetic HF
   checkpoint at Llama3-8B's width cut to 4 of its 32 layers (3.85 GB of
   bf16, 4 shards and an index, the port's own writer, in a temporary
   directory; it raises when the disk has less than 10 GB free) loaded
   with ``load_hf_llama``: exactly 7 K2 launches a layer and two more
   (the embedding and the lm_head), every word and scale equal to
   ``quantize_linear`` of the regenerated weight on the card. Then
   ``convert.main`` to bnb (without and with double quantization; K10 on
   the lm_head) and native, each reloaded (the layers' words equal, their
   scales equal or within the double quantization's 1e-2 of the largest)
   and deleted, and ``save_checkpoint``/``load_checkpoint`` (equal). The
   serving CLI with ``--model`` (generate, ``--fuse``, ``--engine slot``,
   ``--engine paged`` with 128-row pages, with ``--kv-dtype int8``,
   ``--speculative``), each run's tokens and launches equal to a direct
   call of the same function on the same loaded parameters, whose counts
   the formulas give. Last the ``Watchdog`` over a slot ``Engine`` that
   raises, a ``PagedEngine`` that hangs past the deadline and a healthy
   one: every request finishes, the pages return, the healthy engine's
   own requests equal an undisturbed run;
13. ``profile``: one FP4 batch-1 generate of 8 new tokens under
   ``torch.profiler``: device kernel time by name, kernels per forward,
   the device's busy share of the wall time, the host's enqueue time.

Then one JSON line of kernel results (without the per-shape detail),
the ``nvidia-smi`` line again, and last ``{"ok": true, "device":
{...}}``. Details go to
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
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32, outside the tensor cores
L2_BYTES = 50 * 2**20
FP4_THRESHOLDS = (0.29166667, 0.583333, 0.8333333, 0.4166667, 0.0859375,
                  0.20833333, 0.00260417)

K1_SHAPES = (("qkv", 6144, 4096), ("o", 4096, 4096),
             ("gate_up", 28672, 4096), ("down", 4096, 14336),
             ("lm_head", 128256, 4096))
K1_TOKENS = (1, 4, 8, 16, 64, 128, 256)
K1_DECODE_TOKENS = (1, 4, 8)               # decode at B = 1, 4, 8
K1_TIMED_TOKENS = K1_DECODE_TOKENS + (16, 64, 128)   # and their prefill
K1_CHUNK_TOKENS = 256          # one admission chunk of the paged engine
PROMPT_LEN = 16
# decode attention at Llama3-8B: 8 kv heads, 4 query heads each, D 128
KVH, GQA, HEAD_DIM = 8, 4, 128
ATTN_BATCHES = (1, 4, 8)
ATTN_LENGTHS = (1, 17, 255, 256, 257, 1900, 2047)
ATTN_KNOBS = ((None, None), (100, 50.0), (2 ** 30, None))  # window, softcap
ATTN_TIMED_CTX = (128, 512, 1900)
# query positions per row over the pool: decode, and speculative verify
# windows up to 8 positions (32 query rows, four row groups of 8)
ATTN_Q_SPANS = (1, 4, 8)
ATTN_SWEEP_CHUNKS = (64, 128, 256, 512, 1024, 2048)   # the split sweep
# the instantiations that csrc/flash_decode.cu's dispatch launches: row
# tiles R (4 up to 4 rows a group, else 8) and head dims D, per type
FD_ROW_TILES, FD_HEAD_DIMS = (4, 8), (64, 128)
# the token tiles TT of csrc/pair_matmul.cu's body (K1 up to 128 rows, K9)
PAIR_TILES = (1, 2, 4, 8, 16)
# csrc/planar_matmul.cu: the CUDA-core body's token tiles (K5, K6; above 8
# tokens K5 loops over 8-token tiles) and the tensor-core body's (NT n8
# tiles, MT 16-row tiles) that its dispatch launches
K5_TILES, K6_TILES = (1, 2, 4, 8), (1, 2, 3, 4, 8)
PLANAR_MMA_TILES = ((1, 1), (1, 2), (2, 2), (4, 2), (6, 2), (8, 2))
# the paged phase: 7 prompt lengths, and an eighth request that shares
# the 700-token prompt's first 512 tokens (two 256-token pages)
PAGED_LENS = (16, 100, 300, 700, 1100, 1500, 1900)
PAGED_NEW = 32
LAYERS = 32
# the planar phase: every planar Llama3-8B shape and one odd row count
PLANAR_SHAPES = K1_SHAPES + (("odd", 6143, 4096),)
K5_TOKENS = (1, 2, 4, 8, 16, 48, 64)
# K5's two bodies are timed at these rows (its band's decode rows and the
# prefill rows of B = 1 to 4), the plain version at the main path's three
PLANAR_BODY_T = (1, 2, 4, 8, 16, 32, 48, 64)
PLANAR_PLAIN_T = (1, 8, 48)
K6_TOKENS = (1, 3, 5, 6, 7, 8)
PLANAR_BATCHES = (1, 3, 8)
PLANAR_NEW = 60
MODULE_SHAPE = (14336, 4096)   # the Linear4bit of the planar phase
# the pair_variants phase: K8 (prefill pair) and K9 (manual pair), and
# K1's tensor-core body (K8's, K1 from PAIR_MMA_MIN_TOKENS rows on)
K8_TOKENS = (8, 129, 200, 256, 512)
MMA_TOKENS = (129, 200, 256, 512)         # K1 through its tensor-core body
MMA_SHAPES = K1_SHAPES + (("odd", 6142, 4096),)   # 3071 row pairs
BODY_TIMED_T = (16, 64, 128, 256, 512)    # both K1 bodies, the crossover
K9_TOKENS = (1, 4, 8, 16, 64, 128)
K8_TIMED_T = 512               # one chunk of a prefill forward
K8_GATE = 1e-5                 # max|K8 - plain| / max|plain|, and to K1
K9_SHAPES = ("qkv", "o", "down")   # the decode projections K9 takes
# the dense pair band (K10 and the bf16 product): its gate's row counts,
# its timed row counts and those of the plain band (today's CPU route)
BAND_TOKENS = (264, 512, 1024)
BAND_TIMED_T = (256, 512, 1024)
PLAIN_BAND_T = (512, 1024)
BAND_GATE = 1e-5               # max|band - plain| / max|plain|
PV_BATCHES = (1, 4, 8)
# (K9, K1) launches per manual generate (60 tokens, a 16-token prompt):
# K9 takes qkv and o up to 128 rows and down up to 16 (manual_vmem_ok),
# K1 gate_up and the lm_head. B = 1: 60 forwards x (96 K9 + 33 K1); at
# B = 4 and 8 the 64- and 128-row prefill's down goes to K1.
MANUAL_LAUNCHES = {1: (5760, 1980), 4: (5728, 2012), 8: (5728, 2012)}
LONG_PROMPT = 1024             # the QT_PREFILL_PAIR generate
# (M, K) -> K2 launches in one Llama3-8B model build: per layer q and o,
# k and v, gate and up, down; then the embedding and the lm_head. The
# fused gate|up shape is checked too but never quantized whole.
K2_SHAPES = {(4096, 4096): 2 * LAYERS, (1024, 4096): 2 * LAYERS,
             (14336, 4096): 2 * LAYERS, (4096, 14336): LAYERS,
             (128256, 4096): 2, (28672, 4096): 0}
# csrc/quantize.cu: lanes a quant block of its group body (blocksize / 8,
# every power of two from blocksize 8 to 256); other blocksizes take its
# one-warp-a-block body
K2_GROUP_LANES = (1, 2, 4, 8, 16, 32)


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
    of the measurement. If the sleep ran out before the host had queued
    every call (the start event already complete), the device may have
    waited for the host: measure again behind a sleep four times longer
    (at most twice)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    cycles = 2e5 * n + 2e6
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles))
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        starved = start.query()
        end.synchronize()
        if not starved:
            break
        cycles *= 4
    return start.elapsed_time(end) / n


def bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    """(bound_ms, bound_by) on an H100 SXM: bytes over 3.35 TB/s or
    operations over ``flop_rate`` (bf16 tensor cores by default),
    whichever is longer."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def start_ptxas_report():
    """Start ``nvcc -Xptxas -v`` with the build's flags on
    ``csrc/flash_decode.cu``, ``csrc/pair_matmul.cu``,
    ``csrc/planar_matmul.cu`` and ``csrc/quantize.cu`` (beside the build,
    which it does not replace), all at once, and return ``{source stem:
    process}``."""
    from quantizations_tpu_torch.ops.cuda import (BUILD, FLASH_DECODE,
                                                  NVCC_FLAGS, PAIR_MATMUL,
                                                  PLANAR_MATMUL,
                                                  QUANTIZE_4BIT, nvcc_path)

    BUILD.mkdir(parents=True, exist_ok=True)
    return {k.path.stem: subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(BUILD / f"{k.path.stem}_ptxas.so"), str(k.path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in (FLASH_DECODE, PAIR_MATMUL, PLANAR_MATMUL, QUANTIZE_4BIT)}


def _ptxas_label(stem, fn):
    """The instantiation a mangled kernel name stands for: K3/K4 by type,
    row tile and head dim (and the combine) in ``flash_decode``; K1/K9's
    token tile TT in ``pair_matmul``; in ``planar_matmul`` the CUDA-core
    body's class (K5 or K6) and token tile, or K5's tensor-core body by
    its n8 tiles NT and 16-row tiles MT (K6 on fp32 activations is its
    own instantiation, "fp32 x"); in ``quantize`` K2's group body by its
    lanes a quant block L, or its one-warp-a-block body, by input type
    and code."""
    import re

    if stem == "quantize":
        m = re.search(r"quantize_(group|block)_kernelI(f|13__nv_bfloat16)"
                      r"(?:Li(\d+)E)?Lb([01])E", fn)
        body = f"L={m.group(3)}" if m.group(1) == "group" else "warp"
        return (f"{body} {'fp32' if m.group(2) == 'f' else 'bf16'} "
                f"{'nf4' if m.group(4) == '1' else 'fp4'}")
    if stem == "pair_matmul":
        tile = re.search(r"pair_matmul_kernelILi(\d+)E", fn).group(1)
        return f"TT={tile}"
    if stem == "planar_matmul":
        m = re.search(r"planar_mma_kernelILi(\d+)ELi(\d+)E", fn)
        if m:
            return f"K5 mma NT={m.group(1)} MT={m.group(2)}"
        m = re.search(r"planar_kernelILi(\d+)ELb([01])E(?:Li(\d)E)?", fn)
        return (f"{'K5' if m.group(2) == '1' else 'K6'} TT={m.group(1)}"
                + (" fp32 x" if m.group(3) == "4" else ""))
    if "combine" in fn:
        return "combine"
    m = re.search(r"(Ia|I13__nv_bfloat16)Li(\d+)ELi(\d+)E", fn)
    return (f"{'K4 int8' if m.group(1) == 'Ia' else 'K3 bf16'} "
            f"R={m.group(2)} D={m.group(3)}")


def parse_ptxas(out, stem="flash_decode"):
    """[{kernel, registers, spill_stores, spill_loads, smem}] of every
    kernel instantiation in a ``ptxas -v`` log of ``csrc/<stem>.cu``
    (``smem``: the static shared memory in bytes)."""
    import re

    entries = []
    for block in out.split("Compiling entry function")[1:]:
        fn = block.split("'")[1]
        regs = int(re.search(r"Used (\d+) registers", block).group(1))
        st, ld = (int(x) for x in re.search(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            block).groups())
        smem = re.search(r"(\d+) bytes smem", block)
        entries.append(dict(kernel=_ptxas_label(stem, fn), registers=regs,
                            spill_stores=st, spill_loads=ld,
                            smem=int(smem.group(1)) if smem else 0))
    return entries


def read_ptxas_report(procs, results):
    """Log the registers and spills of every instantiation in each
    source's ``ptxas -v`` log; raise on a spill, or unless it holds exactly
    the instantiations that the source's dispatch launches: K3 and K4 at
    each row tile and head dim of FD_ROW_TILES x FD_HEAD_DIMS and the
    combine (``results["ptxas"]``), K1/K9's body at each token tile of
    PAIR_TILES (``results["ptxas_pair_matmul"]``; both entry points
    launch the same instantiations), and in ``planar_matmul`` K5's and
    K6's CUDA-core body at K5_TILES and K6_TILES (K6 on bf16 and on fp32
    activations) and K5's tensor-core body
    at PLANAR_MMA_TILES (``results["ptxas_planar_matmul"]``), and K2's
    group body at each K2_GROUP_LANES and its one-warp body, each for fp32
    and bf16 input and FP4 and NF4 (``results["ptxas_quantize"]``)."""
    want = {"flash_decode": {f"{t} R={r} D={d}" for t in ("K3 bf16", "K4 int8")
                             for r in FD_ROW_TILES for d in FD_HEAD_DIMS}
            | {"combine"},
            "pair_matmul": {f"TT={t}" for t in PAIR_TILES},
            "planar_matmul": {f"K5 TT={t}" for t in K5_TILES}
            | {f"K6 TT={t}{x}" for t in K6_TILES for x in ("", " fp32 x")}
            | {f"K5 mma NT={n} MT={m}" for n, m in PLANAR_MMA_TILES},
            "quantize": {f"{b} {t} {q}"
                         for b in [f"L={n}" for n in K2_GROUP_LANES] + ["warp"]
                         for t in ("fp32", "bf16") for q in ("fp4", "nf4")}}
    outs = {stem: proc.communicate(timeout=600)[0]
            for stem, proc in procs.items()}
    for stem, out in outs.items():
        if procs[stem].returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed on {stem}.cu:\n"
                               + out)
        entries = parse_ptxas(out, stem)
        results["ptxas" if stem == "flash_decode" else f"ptxas_{stem}"] = (
            entries)
        log(f"  ptxas -v, csrc/{stem}.cu: " + "; ".join(
            f"{e['kernel']} {e['registers']} registers, spills "
            f"{e['spill_stores']}/{e['spill_loads']} bytes"
            + (f", {e['smem']} bytes static smem" if stem != "flash_decode"
               else "") for e in entries))
        got = [e["kernel"] for e in entries]
        if sorted(got) != sorted(want[stem]):
            raise AssertionError(f"{stem}.cu: ptxas -v lists {got}, the "
                                 f"dispatch launches {sorted(want[stem])}")
        spills = [e["kernel"] for e in entries
                  if e["spill_stores"] or e["spill_loads"]]
        if spills:
            raise AssertionError(f"{stem}.cu: spills in {spills}")


def k2_special_blocks(blocksize: int = 64):
    """fp32 ``[n, blocksize]`` quant blocks for K2's bit checks (numpy,
    normal values of scale 0.02 from seed 0 around the cases): values
    exactly on every FP4 threshold and NF4 midpoint and their fp32
    neighbours, in blocks whose absmax is 1 (so w * (1/absmax) = w); a
    zero block; then the non-finite and tiny cases: a NaN among normal
    values, an all-zero block with one NaN, +inf, -inf, both infinities,
    a NaN beside an inf, -0.0 among normal values, an all -0.0 block, and
    a block whose absmax is subnormal (1/absmax overflows to inf)."""
    import numpy as np

    from quantizations_tpu_torch.quant.codebooks import (NF4_CODE,
                                                         code_midpoints)

    th = np.array(FP4_THRESHOLDS + tuple(code_midpoints(NF4_CODE).tolist()),
                  np.float32)
    edge = np.concatenate([th, np.nextafter(th, np.float32(2)),
                           np.nextafter(th, np.float32(0))])
    edge = np.concatenate([edge, -edge])
    per = blocksize - 1
    n_edge = -(-len(edge) // per)
    B = (np.random.default_rng(0).standard_normal((n_edge + 10, blocksize))
         * 0.02).astype(np.float32)
    for i in range(n_edge):
        chunk = edge[i * per:(i + 1) * per]
        B[i, 0] = 1.0
        B[i, 1:1 + len(chunk)] = chunk
    r = n_edge
    B[r] = 0.0
    B[r + 1, blocksize // 3] = np.nan
    B[r + 2] = 0.0
    B[r + 2, -1] = np.nan
    B[r + 3, 0] = np.inf
    B[r + 4, blocksize // 2] = -np.inf
    B[r + 5, 1], B[r + 5, -2] = np.inf, -np.inf
    B[r + 6, 2], B[r + 6, 3] = np.nan, np.inf
    B[r + 7, ::3] = -0.0
    B[r + 8] = -0.0
    # absmax exactly 2**-129, subnormal in fp32 and bf16: 1/absmax = inf
    B[r + 9] = B[r + 9] / np.abs(B[r + 9]).max() * np.float32(2.0 ** -129)
    return B


def nan_equal(a, b) -> bool:
    """The same bits where neither holds a NaN, and NaN at the same
    places (a NaN's payload is not compared)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32))


def k2_bytes(M: int, K: int, in_bytes: int = 4) -> int:
    """K2's bytes: W read once, the words and the fp32 absmax written."""
    return M * K * in_bytes + M * K // 2 + M * (K // 64) * 4


def k2_inputs(M, K, dev, gen):
    """fp32 ``[M, K]`` weights for K2: normal values of scale 0.02, as
    model build draws them, in enough copies to exceed the 50 MB L2 four
    times (at least 2), the first starting with ``k2_special_blocks``."""
    R = max(2, math.ceil(4 * L2_BYTES / (M * K * 4)))
    Ws = [torch.randn(M, K, generator=gen, device=dev) * 0.02
          for _ in range(R)]
    special = torch.from_numpy(k2_special_blocks()).to(dev)
    Ws[0].view(-1, 64)[:special.shape[0]] = special
    return Ws


def phase_k2(dev, gen, results):
    from quantizations_tpu_torch.ops import (quantize_4bit_kernel,
                                             quantize_4bit_kernel_plain)

    shapes = []
    for (M, K), per_build in K2_SHAPES.items():
        Ws = k2_inputs(M, K, dev, gen)
        R, W = len(Ws), Ws[0]
        ins = [W] + ([W.to(torch.bfloat16)] if (M, K) == (4096, 4096)
                     else [])
        for Wi in ins:
            for qt in ("fp4", "nf4"):
                wp, am = quantize_4bit_kernel(Wi, 64, qt)
                wpp, amp = quantize_4bit_kernel_plain(Wi, 64, qt)
                torch.cuda.synchronize()
                if not (torch.equal(wp, wpp) and nan_equal(am, amp)):
                    bad = (wp != wpp).sum().item()
                    raise AssertionError(
                        f"K2 {qt} {Wi.dtype} [{M},{K}]: {bad} words differ "
                        "from plain, or the absmax does")
                log(f"  K2 {qt} {Wi.dtype} [{M}, {K}]: bit-exact with the "
                    "plain version (NaN, inf, -0.0 and subnormal blocks)")
        ms = device_ms(lambda i: quantize_4bit_kernel(Ws[i % R], 64, "fp4"),
                       20)
        pms = device_ms(lambda i: quantize_4bit_kernel_plain(W, 64, "fp4"),
                        2, warmup=1)
        nbytes = k2_bytes(M, K)
        bms, by = bound(nbytes, 0)
        tbs = nbytes / ms / 1e9
        shapes.append(dict(M=M, K=K, launches_per_build=per_build, ms=ms,
                           plain_ms=pms, bound_ms=bms, tb_per_s=tbs,
                           share_of_bound=bms / ms))
        log(f"  K2 fp4 [{M}, {K}] fp32 in: {ms * 1e3:.2f} us (bound "
            f"{bms * 1e3:.2f} us, {tbs:.3f} TB/s, {100 * bms / ms:.1f}% of "
            f"the bound; plain {pms:.3f} ms), {per_build} launches per "
            "model build")
        del W, Ws, ins, wp, am, wpp, amp
        torch.cuda.empty_cache()
    per_build = {k: sum(s["launches_per_build"] * s[k] for s in shapes)
                 for k in ("ms", "plain_ms", "bound_ms")}
    log(f"  K2 per model build ({sum(K2_SHAPES.values())} launches): "
        f"{per_build['ms']:.3f} ms, bound {per_build['bound_ms']:.3f} ms "
        f"({100 * per_build['bound_ms'] / per_build['ms']:.1f}%), plain "
        f"{per_build['plain_ms']:.3f} ms")
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
    """Per-shape K1 times at the decode T (the batch), the prefill T
    (16 x the batch) and the paged engine's 256-token admission chunk;
    the per-forward sums weight each shape by its launches in one forward
    (32 layers x 4 projections + the lm_head). Prefill computes logits
    for the last token only, so a prefill forward's lm_head launch is the
    one at T / 16, and an admission chunk's the one at T = 1."""
    from quantizations_tpu_torch.ops import (matmul_4bit_pair,
                                             matmul_4bit_pair_plain,
                                             matmul_4bit_pair_stacked)

    timed = K1_TIMED_TOKENS + (K1_CHUNK_TOKENS,)
    rows = []
    for name, M, K in K1_SHAPES:
        L = LAYERS
        wp2, scales = _pair_operands(M, K, L, dev, gen)
        x = torch.randn(max(timed), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        dense_bytes = M * K * 2
        R = max(2, math.ceil(4 * L2_BYTES / dense_bytes))
        Wd = torch.randn(R, M, K, generator=gen, device=dev).to(torch.bfloat16)
        for T in timed:
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
    for T in timed:
        # an admission chunk samples one row: its lm_head runs at T = 1
        head_t = (T if T in K1_DECODE_TOKENS else
                  1 if T == K1_CHUNK_TOKENS else T // PROMPT_LEN)
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


def _attn_pool(B, lengths, page, n_pages, q_span, dev, gen, int8, L=3):
    """A pool [L, P, KVH, page, D] and a shuffled block table [B, n_pages]
    holding each row's pages for lengths[b] + q_span - 1 positions (at
    most n_pages), page 0 in the unused entries."""
    need = [min(n_pages, -(-(int(n) + q_span - 1) // page))
            for n in lengths]
    P = 1 + sum(need) + 3
    perm = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        B * 1000 + page)) + 1).to(torch.int32)
    table = torch.zeros((B, n_pages), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[at:at + n]
        at += n
    return _attn_cache((L, P, KVH, page, HEAD_DIM), dev, gen, int8) + (
        table.to(dev),)


def _attn_cache(shape, dev, gen, int8):
    """(k, v, k_step, v_step) of ``shape``: bf16 normal values, or int8
    codes with bf16 steps (None for bf16)."""
    if int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.03
              + 0.002).to(torch.bfloat16)
        vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.03
              + 0.002).to(torch.bfloat16)
        return k, v, ks, vs
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return k, v, None, None


def phase_attn(dev, gen, results):
    """K3 and K4 against their plain versions at the main path's shapes
    (KVH 8, G 4, D 128, B 1/4/8): the slot cache (S 2048, attend_len 128
    and 2048, unstacked and stacked at layer 1) and the paged pool (page
    256 and 128, shuffled tables, pages_per_step 1 and 2, q_span 1, 4 and
    8: up to 32 query rows), over lengths, window and softcap. The pool's
    2048 positions split across blocks (16 chunks of 128 at B = 1, split
    boundaries inside the pages); each pool case is launched twice and
    must give the same bits. Tolerance 1e-5 * max|out|: both sides read
    the same bf16 or int8 values and differ only in the fp32 summation
    order."""
    from quantizations_tpu_torch.ops import attention as at
    from quantizations_tpu_torch.ops import paged_attention as pa
    from quantizations_tpu_torch.ops.cuda import (FLASH_DECODE,
                                                  FLASH_DECODE_I8)

    worst = {"flash_decode": [0.0, 0.0, 0], "flash_decode_i8": [0.0, 0.0, 0]}
    identical = {"flash_decode": 0, "flash_decode_i8": 0}
    splits = set()      # (B, page, q_span, n_split, chunk) of the pool cases

    def check(name, what, got, ref):
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {what}: bad output")
        err = (got - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} {what}: max|err| {err:.3e} > tol "
                                 f"{tol:.3e}")
        w = worst[name]
        w[0] = max(w[0], err)
        w[1] = max(w[1], err / max(ref.abs().max().item(), 1e-30))
        w[2] += 1

    S = 2048
    for B in ATTN_BATCHES:
        lens = [ATTN_LENGTHS[b % len(ATTN_LENGTHS)] for b in range(B)]
        for int8 in (False, True):
            name = "flash_decode_i8" if int8 else "flash_decode"
            k, v, ks, vs = _attn_cache((3, B, KVH, S, HEAD_DIM), dev, gen,
                                       int8)
            q = torch.randn(B, KVH, GQA, HEAD_DIM, generator=gen, device=dev)
            for attend in (128, S):
                ln = torch.tensor([min(n, attend) for n in lens],
                                  dtype=torch.int32, device=dev)
                for win, cap in ATTN_KNOBS:
                    kw = dict(attend_len=attend, softcap=cap, window=win)
                    what = f"slot B={B} attend={attend} win={win} cap={cap}"
                    if int8:
                        check(name, what, at.flash_decode_attention_stacked_i8(
                            q, k, v, ks, vs, 1, ln, **kw),
                            at.flash_decode_attention_stacked_i8_plain(
                                q, k, v, ks, vs, 1, ln, **kw))
                        continue
                    check(name, what + " stacked",
                          at.flash_decode_attention_stacked(q, k, v, 1, ln,
                                                            **kw),
                          at.flash_decode_attention_stacked_plain(
                              q, k, v, 1, ln, **kw))
                    if attend == S:
                        qb = q.to(torch.bfloat16)
                        check(name, what + " unstacked",
                              at.flash_decode_attention(
                                  qb, k[0], v[0], ln, softcap=cap,
                                  window=win),
                              at.flash_decode_attention_plain(
                                  qb, k[0], v[0], ln, softcap=cap,
                                  window=win))
            del k, v, ks, vs
            for page in (256, 128):
                for q_span in ATTN_Q_SPANS:
                    k, v, ks, vs, table = _attn_pool(
                        B, lens, page, S // page, q_span, dev, gen, int8)
                    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                    q = torch.randn(B, KVH, q_span * GQA, HEAD_DIM,
                                    generator=gen, device=dev)
                    for pps in (1, 2):
                        for win, cap in ATTN_KNOBS:
                            kw = dict(softcap=cap, window=win, q_span=q_span,
                                      pages_per_step=pps)
                            what = (f"paged B={B} page={page} "
                                    f"q_span={q_span} pps={pps} win={win} "
                                    f"cap={cap}")
                            if int8:
                                got = pa.paged_flash_decode_attention_i8(
                                    q, k, v, ks, vs, table, 2, ln, **kw)
                                ref = pa.paged_flash_decode_attention_i8_plain(
                                    q, k, v, ks, vs, table, 2, ln, **kw)
                            else:
                                got = pa.paged_flash_decode_attention(
                                    q, k, v, table, 2, ln, **kw)
                                ref = pa.paged_flash_decode_attention_plain(
                                    q, k, v, table, 2, ln, **kw)
                            check(name, what, got, ref)
                    splits.add((B, page, q_span) + (
                        FLASH_DECODE_I8 if int8 else FLASH_DECODE
                    ).last_grid[:2])
                    # the splits fold in a fixed order: the same bits
                    again = (pa.paged_flash_decode_attention_i8(
                        q, k, v, ks, vs, table, 2, ln, **kw) if int8 else
                        pa.paged_flash_decode_attention(
                            q, k, v, table, 2, ln, **kw))
                    if not torch.equal(again, got):
                        raise AssertionError(f"{name} {what}: two launches "
                                             "differ")
                    identical[name] += 1
                    del k, v, ks, vs
        log(f"  B={B}: K3 {worst['flash_decode'][2]} and K4 "
            f"{worst['flash_decode_i8'][2]} cases so far within 1e-5 * "
            "max|out| of the plain versions")
        torch.cuda.empty_cache()
    results["attn_err"] = {n: dict(max_abs_err=w[0], max_err_over_max_out=w[1],
                                   cases=w[2], bit_identical_reruns=identical[n])
                           for n, w in worst.items()}
    results["attn_splits"] = sorted(splits)
    for n, w in worst.items():
        log(f"  {n}: {w[2]} cases, worst max|err| {w[0]:.3e}, worst "
            f"max|err| / max|out| {w[1]:.3e}; {identical[n]} pool cases "
            "launched twice, bit-identical")
    log("  pool splits (B, page, q_span: n_split x chunk): " + ", ".join(
        f"{b},{pg},{qs}: {n}x{c}" for b, pg, qs, n, c in sorted(splits)))


def _attn_bytes(B, ctx, int8, q_span=1):
    """Bytes a decode attention launch must move: the K/V (and step)
    rows of the live positions, q (fp32) and out (fp32)."""
    row = HEAD_DIM + 2 if int8 else 2 * HEAD_DIM
    return (2 * B * KVH * ctx * row
            + 2 * B * KVH * q_span * GQA * HEAD_DIM * 4)


def phase_attn_time(dev, gen, results):
    """K3/K4 per launch at B 1/4/8 and a live context of 128, 512 and 1900
    tokens, slot and paged (page 256), with the cache rotating over enough
    layers that the read set exceeds the 50 MB L2 four times; beside the
    bound, the plain version and, for K3, one
    ``scaled_dot_product_attention(..., enable_gqa=True)`` over the same
    keys laid out contiguously (the port never calls it). Each row prints
    the split the wrapper chose (n_split x chunk), the blocks launched and
    the share of the bound. Then 32 query rows (q_span 8) over the pool
    at 1900 tokens, and the split sweep: paged K3 and K4 at every B and
    context with each chunk of ATTN_SWEEP_CHUNKS forced."""
    from quantizations_tpu_torch.ops import attention as at
    from quantizations_tpu_torch.ops import paged_attention as pa
    from quantizations_tpu_torch.ops.cuda import (FLASH_DECODE,
                                                  FLASH_DECODE_I8)

    F = torch.nn.functional
    rows, sweep = [], []

    def paged_case(B, ctx, int8, q_span):
        """A pool rotating over L layers for rows of ctx live tokens and
        q_span query positions: (operands, launch, plain version, launch
        with a forced split, n_pos)."""
        page = 256
        n_pages = -(-ctx // page)
        nbytes = _attn_bytes(B, ctx, int8, q_span)
        L = max(2, min(256, math.ceil(4 * L2_BYTES / nbytes)))
        k, v, ks, vs, table = _attn_pool(B, [ctx - q_span + 1] * B, page,
                                         n_pages, q_span, dev, gen, int8, L=L)
        ln = torch.full((B,), ctx - q_span + 1, dtype=torch.int32,
                        device=dev)
        q = torch.randn(B, KVH, q_span * GQA, HEAD_DIM, generator=gen,
                        device=dev)
        if int8:
            run = lambda i: pa.paged_flash_decode_attention_i8(
                q, k, v, ks, vs, table, i % L, ln, q_span=q_span)
            plain = lambda i: pa.paged_flash_decode_attention_i8_plain(
                q, k, v, ks, vs, table, i % L, ln, q_span=q_span)
        else:
            run = lambda i: pa.paged_flash_decode_attention(
                q, k, v, table, i % L, ln, q_span=q_span)
            plain = lambda i: pa.paged_flash_decode_attention_plain(
                q, k, v, table, i % L, ln, q_span=q_span)

        def forced(split):
            return lambda i: at.launch_decode(
                q, k[i % L], v[i % L], ln, page=page, n_pos=0,
                scale=HEAD_DIM ** -0.5, softcap=None, window=None,
                q_span=q_span, table=table,
                k_step=None if ks is None else ks[i % L],
                v_step=None if vs is None else vs[i % L], split=split)
        return (k, v, ks, vs, table, q), run, plain, forced, n_pages * page

    def timed(name, fn):
        """(ms per launch, the (n_split, chunk, blocks) it launched)."""
        ms = device_ms(fn, 200)
        return ms, (FLASH_DECODE_I8 if "i8" in name else FLASH_DECODE
                    ).last_grid

    def record(name, form, B, ctx, q_span, timing, pms, lib, L):
        ms, (n_split, chunk, blocks) = timing
        nbytes = _attn_bytes(B, ctx, "i8" in name, q_span)
        flops = 4 * B * KVH * q_span * GQA * ctx * HEAD_DIM
        bms, by = bound(nbytes, flops, FP32_FLOP_PER_S)
        row = dict(kernel=name, form=form, B=B, ctx=ctx, q_span=q_span,
                   ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                   library_ms=lib, bytes=nbytes, layers_rotated=L,
                   n_split=n_split, chunk=chunk, blocks=blocks,
                   share_of_bound=bms / ms)
        rows.append(row)
        libs = ("none" if lib is None else f"{lib * 1e3:8.2f} us" + (
            " (contiguous keys)" if form == "paged" else ""))
        log(f"  {name:15s} {form:5s} B={B} ctx={ctx:4d} rows={q_span * GQA:2d}"
            f": {ms * 1e3:8.2f} us  bound {bms * 1e3:7.2f} us ({by}, "
            f"{100 * bms / ms:5.1f}%)  split {n_split}x{chunk} "
            f"{blocks} blocks  plain {pms * 1e3:8.1f} us  sdpa {libs}")

    for int8 in (False, True):
        name = "flash_decode_i8" if int8 else "flash_decode"
        for B in ATTN_BATCHES:
            for ctx in ATTN_TIMED_CTX:
                nbytes = _attn_bytes(B, ctx, int8)
                L = max(2, min(256, math.ceil(4 * L2_BYTES / nbytes)))
                ln = torch.full((B,), ctx, dtype=torch.int32, device=dev)
                q = torch.randn(B, KVH, GQA, HEAD_DIM, generator=gen,
                                device=dev)
                # slot: a cache of exactly ctx positions per layer
                k, v, ks, vs = _attn_cache((L, B, KVH, ctx, HEAD_DIM), dev,
                                           gen, int8)
                if int8:
                    slot = lambda i: at.flash_decode_attention_stacked_i8(
                        q, k, v, ks, vs, i % L, ln)
                    slot_plain = lambda i: (
                        at.flash_decode_attention_stacked_i8_plain(
                            q, k, v, ks, vs, i % L, ln))
                else:
                    slot = lambda i: at.flash_decode_attention_stacked(
                        q, k, v, i % L, ln)
                    slot_plain = lambda i: (
                        at.flash_decode_attention_stacked_plain(
                            q, k, v, i % L, ln))
                t_slot = timed(name, slot)
                plain_slot = device_ms(slot_plain, 20)
                lib = None
                if not int8:
                    qs = q.to(torch.bfloat16).reshape(B, KVH * GQA, 1,
                                                      HEAD_DIM)
                    lib = device_ms(lambda i: F.scaled_dot_product_attention(
                        qs, k[i % L], v[i % L], enable_gqa=True), 200)
                del k, v, ks, vs
                record(name, "slot", B, ctx, 1, t_slot, plain_slot, lib, L)
                # paged: page 256, each row's pages shuffled over the pool
                held, run, plain, forced, n_pos = paged_case(B, ctx, int8, 1)
                record(name, "paged", B, ctx, 1, timed(name, run),
                       device_ms(plain, 20), lib, held[0].shape[0])
                for chunk in ATTN_SWEEP_CHUNKS:
                    n = -(-n_pos // chunk)
                    if chunk > n_pos:
                        continue
                    sweep.append(dict(kernel=name, B=B, ctx=ctx,
                                      n_split=n, chunk=chunk,
                                      ms=device_ms(forced((n, chunk)), 200)))
                log(f"  {name:15s} sweep B={B} ctx={ctx:4d}: " + ", ".join(
                    f"{r['n_split']}x{r['chunk']} {r['ms'] * 1e3:.2f} us"
                    for r in sweep if r["kernel"] == name and r["B"] == B
                    and r["ctx"] == ctx))
                del held, run, plain, forced
                torch.cuda.empty_cache()
        # 32 query rows over the pool (speculative verify of 8 positions)
        for B in ATTN_BATCHES:
            held, run, plain, _, _ = paged_case(B, 1900, int8, 8)
            record(name, "paged", B, 1900, 8, timed(name, run),
                   device_ms(plain, 20), None, held[0].shape[0])
            del held, run, plain
            torch.cuda.empty_cache()
    results["attn_time"] = rows
    results["attn_sweep"] = sweep


def phase_model(dev, results):
    """Greedy generation at full Llama3-8B: FP4 at B = 1, 4, 8 on the
    einsum path, with ``use_flash_attention`` (K3), and with flash and an
    int8 KV cache (K4); NF4 at B = 1. Returns the FP4 parameters for the
    paged phase."""
    from quantizations_tpu_torch.config import QuantConfig, ServeConfig
    from quantizations_tpu_torch.models.llama import (
        LLAMA3_8B, TINY_LLAMA, KVCache, decode_step, fuse_projections,
        init_llama_params, map_tensors, named_tensors, prefill)
    from quantizations_tpu_torch.ops import (FLASH_DECODE, FLASH_DECODE_I8,
                                             KERNELS, PAIR_MATMUL,
                                             QUANTIZE_4BIT)
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    serve = ServeConfig(max_seq_len=128, max_new_tokens=60, temperature=0.0)
    layers = LLAMA3_8B.num_hidden_layers
    per_generate = serve.max_new_tokens * (4 * layers + 1)
    per_generate_attn = (serve.max_new_tokens - 1) * layers
    variants = (("fp4", "einsum", {}, (1, 4, 8)),
                ("fp4", "flash", dict(use_flash_attention=True), (1, 4, 8)),
                ("fp4", "flash+int8", dict(use_flash_attention=True,
                                           kv_cache_dtype="int8"), (1, 4, 8)),
                ("nf4", "einsum", {}, (1,)))
    runs = []
    fp4_params = params = None
    per_build_k2 = sum(K2_SHAPES.values())
    results["build_profile"] = _profile_build(dataclasses.replace(
        LLAMA3_8B, quant=QuantConfig(quantize_embedding=True)), dev)
    for k in KERNELS:
        k.launches = 0
    for qt, attn, knobs, batches in variants:
        cfg = dataclasses.replace(
            LLAMA3_8B,
            quant=QuantConfig(quant_type=qt, quantize_embedding=True),
            **knobs)
        if qt == "fp4" and fp4_params is not None:
            params = fp4_params
        else:
            params = None
            torch.cuda.synchronize()
            before = QUANTIZE_4BIT.launches
            t0 = time.perf_counter()
            params = fuse_projections(init_llama_params(cfg, seed=0,
                                                        device=dev))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            if QUANTIZE_4BIT.launches - before != per_build_k2:
                raise AssertionError(
                    f"{qt} build: K2 launched "
                    f"{QUANTIZE_4BIT.launches - before} times, expected "
                    f"{per_build_k2}")
            wbytes = sum(t.numel() * t.element_size()
                         for _, t in named_tensors(params))
            log(f"  {qt} Llama3-8B ({layers} layers) built in {build_s:.2f} "
                f"s, {wbytes / 1e9:.3f} GB of weights")
            ids = ((torch.arange(16, device=dev) * 7 + 11) % cfg.vocab_size
                   ).to(torch.int32)[None, :]
            logits, _ = prefill(params, ids, KVCache.create(cfg, 1, 128, dev),
                                cfg)
            torch.cuda.synchronize()
            if logits.shape != (1, 16, cfg.vocab_size) or not torch.isfinite(
                    logits).all():
                raise AssertionError(f"{qt} prefill logits bad: "
                                     f"{logits.shape}")
            del logits
            if qt == "fp4":
                fp4_params = params
        attn_kernel = (FLASH_DECODE_I8 if knobs.get("kv_cache_dtype")
                       else FLASH_DECODE if knobs else None)
        gen = make_generate_fn(cfg, serve)
        ids = ((torch.arange(16, device=dev) * 7 + 11) % cfg.vocab_size
               ).to(torch.int32)[None, :]
        for B in batches:
            idsb = ids.repeat(B, 1)
            times, first = [], None
            for it in range(5 + 1):
                cache = KVCache.create(cfg, B, serve.max_seq_len, dev)
                before = PAIR_MATMUL.launches
                before_attn = (0 if attn_kernel is None
                               else attn_kernel.launches)
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
                if attn_kernel is not None:
                    got = attn_kernel.launches - before_attn
                    if got != per_generate_attn:
                        raise AssertionError(
                            f"{attn_kernel.name} launched {got} times in one "
                            f"generate, expected {per_generate_attn}")
                if toks.shape != (B, serve.max_new_tokens) or int(
                        toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
                    raise AssertionError(f"tokens out of range: {toks.shape}")
                if first is None:
                    first = toks.cpu()
                elif not torch.equal(first, toks.cpu()):
                    raise AssertionError(f"{qt} {attn} B={B}: tokens differ "
                                         "between runs")
                if it:                       # the first run is the warm-up
                    times.append(start.elapsed_time(end) / 1e3)
                del cache
            t = statistics.median(times)
            tps = serve.max_new_tokens * B / t
            lo, hi = (serve.max_new_tokens * B / max(times),
                      serve.max_new_tokens * B / min(times))
            runs.append(dict(quant_type=qt, attention=attn, batch=B,
                             tok_per_s=tps, tok_per_s_min=lo,
                             tok_per_s_max=hi, generate_s=t,
                             generate_s_all=times,
                             k1_launches_per_generate=per_generate,
                             attn_launches_per_generate=(
                                 0 if attn_kernel is None
                                 else per_generate_attn),
                             first_tokens=first[0, :8].tolist(),
                             tokens=first.tolist()))
            log(f"  {qt} {attn} B={B}: {tps:.2f} tok/s, median of "
                f"{len(times)} (min {lo:.2f}, max {hi:.2f}; {t:.4f} s per "
                f"generate, K1 launches {per_generate} each"
                + ("" if attn_kernel is None else
                   f", {attn_kernel.name} {per_generate_attn}") + ")")
        if qt == "nf4":
            del params
            params = None
        torch.cuda.empty_cache()
    by = {(r["attention"], r["quant_type"], r["batch"]): r for r in runs}
    for B in (1, 4, 8):
        same = by[("flash", "fp4", B)]["tokens"] == by[("einsum", "fp4",
                                                        B)]["tokens"]
        n = sum(a == b for x, y in zip(by[("flash+int8", "fp4", B)]["tokens"],
                                       by[("einsum", "fp4", B)]["tokens"])
                for a, b in zip(x, y))
        log(f"  B={B}: flash tokens {'equal' if same else 'differ from'} "
            f"the einsum path's; flash+int8 agrees on {n} of "
            f"{B * serve.max_new_tokens}")
    results["launches"] = {k.name: k.launches for k in KERNELS}
    results["generate"] = runs
    if results["launches"]["dequantize_4bit_pair"] != 0:
        raise AssertionError("K10 launched by a generate: no projection of "
                             "a 16-token prompt is above the K1 band")
    results["decode_logits"] = _decode_logit_check(fp4_params, dev)
    for k in (PAIR_MATMUL, QUANTIZE_4BIT, FLASH_DECODE, FLASH_DECODE_I8):
        if k.launches == 0:
            raise AssertionError(f"{k.name} was never launched on the "
                                 "generate path")

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
    # one decode step through K3 / K4 against the CPU's plain attention
    for knobs in (dict(use_flash_attention=True),
                  dict(use_flash_attention=True, kv_cache_dtype="int8")):
        c = dataclasses.replace(cfg, **knobs)
        outs = []
        for p_, d in ((p_gpu, dev), (p_cpu, "cpu")):
            cache = KVCache.create(c, 2, 32, d)
            prefill(p_, ids.to(d)[:, :11], cache, c)
            lg, _ = decode_step(p_, ids.to(d)[:, 11:], cache, 11, c)
            outs.append(lg.cpu())
        err = (outs[0] - outs[1]).abs().max().item()
        scale = outs[1].abs().max().item()
        log(f"  TINY_LLAMA {c.kv_cache_dtype} flash decode step, CUDA vs CPU "
            f"plain: max|err| {err:.3e} (max|logit| {scale:.3f})")
        if not err <= 2e-2 * scale:
            raise AssertionError("TINY_LLAMA flash decode disagrees with the "
                                 "CPU")
    return fp4_params


def _profile_build(cfg, dev):
    """Where one FP4 model build (``init_llama_params`` then
    ``fuse_projections``) spends its time: ``torch.profiler`` over one
    build, with ``record_function`` spans around K2
    (``quantize_4bit_kernel``), ``torch.randn``, the plain double
    quantization of the absmax (``quantize_blockwise`` and
    ``dequantize_blockwise``), ``planar_to_pair`` and
    ``fuse_projections``, put in for this pass only. Per span: the host
    time inside it and the device time of the kernels it launched; beside
    them the build's wall (host clock to a synchronize; the profiler
    slows the host), the device's busy time, the device time outside the
    spans (the scale multiply, the copies into the stacks), the host's
    waits in stream and device synchronizes, and the device kernels that
    took the most time overall."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from quantizations_tpu_torch.models import llama
    from quantizations_tpu_torch.ops import QUANTIZE_4BIT

    spans = {(llama, "quantize_4bit_kernel"): "K2",
             (torch, "randn"): "randn",
             (llama, "quantize_blockwise"): "double quantization",
             (llama, "dequantize_blockwise"): "double quantization",
             (llama, "planar_to_pair"): "planar_to_pair"}
    saved = {key: getattr(*key) for key in spans}

    def in_span(label, fn):
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    torch.cuda.synchronize()
    before = QUANTIZE_4BIT.launches
    try:
        for (mod, name), label in spans.items():
            setattr(mod, name, in_span(label, saved[(mod, name)]))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params = llama.init_llama_params(cfg, seed=0, device=dev)
            with record_function("fuse_projections"):
                params = llama.fuse_projections(params)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    del params
    torch.cuda.empty_cache()
    if QUANTIZE_4BIT.launches - before != sum(K2_SHAPES.values()):
        raise AssertionError(f"profiled build: K2 launched "
                             f"{QUANTIZE_4BIT.launches - before} times")
    labels = sorted(set(spans.values())) + ["fuse_projections"]
    by_span = {lb: dict(host_s=0.0, device_s=0.0, calls=0) for lb in labels}
    kernels, syncs = {}, [0, 0.0]
    for e in prof.events():
        if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            syncs[0] += 1
            syncs[1] += e.cpu_time_total / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a span's own device-side annotation is no kernel
            if not (e.is_user_annotation or e.name in by_span):
                kernels[e.name] = kernels.get(e.name, 0.0) + \
                    e.time_range.elapsed_us() / 1e6
        elif e.name in by_span:
            by_span[e.name]["host_s"] += e.cpu_time_total / 1e6
            by_span[e.name]["device_s"] += e.device_time_total / 1e6
            by_span[e.name]["calls"] += 1
    busy_s = sum(kernels.values())
    if busy_s == 0.0:
        raise AssertionError("the profiler saw no device time in the build")
    # K2 launches through ctypes, which the profiler links to no span: its
    # device time is its kernels' by name
    by_span["K2"]["device_s"] = sum(t for n, t in kernels.items()
                                    if "quantize_group_kernel" in n
                                    or "quantize_block_kernel" in n)
    # a renamed kernel or a function that llama reaches another way would
    # read 0 here, not fail
    empty = [lb for lb, d in by_span.items()
             if d["calls"] == 0 or d["device_s"] == 0.0]
    if empty:
        raise AssertionError(f"profiled build: no calls or no device time "
                             f"in the spans {empty}")
    outside_s = busy_s - sum(d["device_s"] for d in by_span.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"  fp4 build under torch.profiler: wall {wall_s:.4f} s, device "
        f"busy {busy_s:.4f} s ({100 * busy_s / wall_s:.1f}% of wall)")
    for lb, d in by_span.items():
        log(f"    {lb:>20}: {d['calls']:4d} calls, host {d['host_s']:.4f} s "
            f"({100 * d['host_s'] / wall_s:.1f}% of wall), device "
            f"{d['device_s'] * 1e3:.3f} ms")
    log(f"    {'outside the spans':>20}: device {outside_s * 1e3:.3f} ms")
    log(f"    the host waited in {syncs[0]} stream or device synchronizes, "
        f"{syncs[1]:.4f} s")
    for n, t in top:
        log(f"    device {t * 1e3:9.3f} ms  {n[:90]}")
    return dict(wall_s=wall_s, device_busy_s=busy_s, spans=by_span,
                device_outside_spans_s=outside_s, synchronizes=syncs[0],
                synchronize_s=syncs[1],
                top=[dict(name=n[:120], s=t) for n, t in top])


def _decode_logit_check(params, dev):
    """One B = 8 decode step of the FP4 model after the same 16-token
    prompt, on the einsum path, with flash (K3) and with flash and an int8
    cache (K4): how far each step's logits are from the einsum path's, and
    how close the einsum path's own top two candidates sit (random weights
    give a flat distribution, so greedy streams part at near-ties)."""
    from quantizations_tpu_torch.config import QuantConfig
    from quantizations_tpu_torch.models.llama import (LLAMA3_8B, KVCache,
                                                      decode_step, prefill)

    base = dataclasses.replace(LLAMA3_8B, quant=QuantConfig(
        quantize_embedding=True))
    ids = torch.randint(0, base.vocab_size, (8, 17),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    out = {}
    with torch.inference_mode():
        for name, knobs in (("einsum", {}),
                            ("flash", dict(use_flash_attention=True)),
                            ("flash+int8", dict(use_flash_attention=True,
                                                kv_cache_dtype="int8"))):
            cfg = dataclasses.replace(base, **knobs)
            cache = KVCache.create(cfg, 8, 128, dev)
            prefill(params, ids[:, :16], cache, cfg, last_token_only=True)
            out[name], _ = decode_step(params, ids[:, 16:], cache, 16, cfg)
    ref = out["einsum"].float()
    top2 = ref.topk(2, dim=-1).values
    margin = ((top2[:, 0] - top2[:, 1]) / ref.abs().amax(-1)).median().item()
    res = dict(median_top2_margin_over_max=margin)
    for name in ("flash", "flash+int8"):
        d = (out[name].float() - ref).abs().max().item()
        rel = d / ref.abs().max().item()
        top1 = (out[name].argmax(-1) == ref.argmax(-1)).float().mean().item()
        res[name] = dict(max_abs_diff=d, max_diff_over_max=rel, top1=top1)
        log(f"  B=8 decode logits, {name} vs einsum: max|diff| {d:.3e} "
            f"({rel:.3e} of max|logit|), top-1 agreement {top1:.3f}")
    log(f"  einsum top-2 margin: median {margin:.3e} of max|logit|")
    return res


def _planar_operands(M, K, L, dev, gen):
    wp = torch.randint(-2**31, 2**31, (L, M, K // 8), generator=gen,
                       device=dev, dtype=torch.int64).to(torch.int32)
    scales = torch.rand(L, M, K // 64, generator=gen, device=dev) * 0.05 + 0.01
    return wp, scales


def phase_planar_check(dev, gen, results):
    """K5 and K6 within 1e-5 * max|y| of their plain versions, K7
    bit-exact, at every planar Llama3-8B shape and an odd row count, FP4
    and NF4, fp32 and bf16 scales: K5 at T in K5_TOKENS, each of its two
    bodies launched directly and through the dispatch (which must give
    the bits of the body ``planar_body`` names), the tensor-core body
    launched twice (the same bits); K6 at K6_TOKENS (bf16 activations, as
    the model passes them; launched twice, the same bits), K7 to fp32
    and bf16. The layer shapes are stacked and read at layer 1."""
    from quantizations_tpu_torch.ops import gemv as gv
    from quantizations_tpu_torch.ops import qmatmul as qm
    from quantizations_tpu_torch.ops import quantize as qz

    worst = {n: [0.0, 0.0, 0] for n in (
        "planar_matmul", "planar_matmul_cuda_core", "planar_matmul_mma",
        "gemv_4bit", "dequantize_4bit")}

    def check(name, what, got, ref, exact=False):
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {what}: bad output")
        if exact:
            if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
                raise AssertionError(f"{name} {what}: not bit-exact")
            worst[name][2] += 1
            return
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= 1e-5 * scale:
            raise AssertionError(f"{name} {what}: max|err| {err:.3e} > tol "
                                 f"{1e-5 * scale:.3e}")
        w = worst[name]
        w[0], w[1], w[2] = max(w[0], err), max(w[1], err / scale), w[2] + 1

    for name, M, K in PLANAR_SHAPES:
        stacked = name not in ("lm_head", "odd")
        wp, s32 = _planar_operands(M, K, 2 if stacked else 1, dev, gen)
        x = torch.randn(max(K5_TOKENS), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        for qt in ("fp4", "nf4"):
            for sk, s in (("fp32", s32), ("bf16", s32.to(torch.bfloat16))):
                for T in K5_TOKENS:
                    xt, what = x[:T], f"{name} [{M},{K}] {qt} {sk} T={T}"
                    ref = qm.matmul_4bit_planar_plain(wp[-1], s[-1], xt, qt)
                    got = (qm.matmul_4bit_planar_stacked(wp, s, xt, 1, qt)
                           if stacked else
                           qm.matmul_4bit_planar(wp[0], s[0], xt, qt))
                    body = {b: getattr(qm, f"matmul_4bit_planar_{b}")(
                        wp[-1], s[-1], xt, qt) for b in ("cuda_core", "mma")}
                    again = qm.matmul_4bit_planar_mma(wp[-1], s[-1], xt, qt)
                    check("planar_matmul", what, got, ref)
                    for b, y in body.items():
                        check(f"planar_matmul_{b}", what, y, ref)
                    if not torch.equal(got.view(torch.int32), body[
                            qm.planar_body(T)].view(torch.int32)):
                        raise AssertionError(f"K5 {what}: the dispatch is not "
                                             f"its {qm.planar_body(T)} body")
                    if not torch.equal(again.view(torch.int32),
                                       body["mma"].view(torch.int32)):
                        raise AssertionError(f"K5 tensor-core body {what}: "
                                             "two launches differ")
                for T in K6_TOKENS:
                    xt, what = x[:T], f"{name} [{M},{K}] {qt} {sk} T={T}"
                    got, again = ((gv.gemv_4bit_stacked(wp, s, xt, 1, qt)
                                   if stacked else
                                   gv.gemv_4bit(wp[0], s[0], xt, qt))
                                  for _ in range(2))
                    check("gemv_4bit", what, got,
                          gv.gemv_4bit_plain(wp[-1], s[-1], xt, qt))
                    if not torch.equal(again.view(torch.int32),
                                       got.view(torch.int32)):
                        raise AssertionError(f"K6 {what}: two launches "
                                             "differ")
                for dt in (torch.float32, torch.bfloat16):
                    check("dequantize_4bit", f"{name} {qt} {sk} {dt}",
                          qz.dequantize_4bit_kernel(wp[-1], s[-1], qt, dt),
                          qz.dequantize_4bit_kernel_plain(wp[-1], s[-1], qt,
                                                          dt), exact=True)
        log(f"  {name} [{M}, {K}]: K5 (both bodies, the dispatch) and K6 "
            f"within 1e-5 * max|y|, K7 bit-exact, K5's tensor-core body "
            f"and K6 bit-identical across launches "
            f"({sum(w[2] for w in worst.values())} cases so far)")
        del wp, s32, x
        torch.cuda.empty_cache()
    results["planar_err"] = {n: dict(max_abs_err=w[0], max_err_over_max_y=w[1],
                                     cases=w[2]) for n, w in worst.items()}
    for n, w in worst.items():
        log(f"  {n}: {w[2]} cases, worst max|err| {w[0]:.3e}, worst "
            f"max|err| / max|y| {w[1]:.3e}")


def planar_twin(params):
    """The planar twin of pair-layout parameters: every pair QLinear
    repacked to planar words (``pair_to_planar``) with per-row scales
    (``unpack_scale_pairs`` where packed), as tensor-parallel row shards
    are: the same codes and the same scales."""
    from quantizations_tpu_torch.models.llama import QLinear
    from quantizations_tpu_torch.ops import pair_to_planar, unpack_scale_pairs

    def conv(obj):
        if isinstance(obj, QLinear):
            if obj.layout != "pair":
                return obj
            s = (unpack_scale_pairs(obj.scales) if obj.scales_packed
                 else obj.scales)
            return QLinear(wp=pair_to_planar(obj.wp), scales=s)
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{
                f.name: conv(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if getattr(obj, f.name) is not None})
        return obj

    return conv(params)


def _planar_launches(B, layers):
    """(K5, K5's tensor-core body, K6, K7) launches of one planar generate
    of PLANAR_NEW tokens after a PROMPT_LEN-token prompt at batch B (4
    projections a layer and the lm_head a forward; the prefill's lm_head
    runs at T = B). K5 counts both bodies; ``planar_body`` splits them."""
    from quantizations_tpu_torch.ops import planar_body

    per = 4 * layers
    steps = PLANAR_NEW - 1
    T = B * PROMPT_LEN
    k5 = mma = k6 = k7 = 0
    for t, n in ((T, per), (B, 1), (B, steps * (per + 1))):
        if t <= 64 and (t in (1, 2, 4) or t % 8 == 0):
            k5 += n
            mma += n * (planar_body(t) == "mma")
        elif t <= 8:
            k6 += n
        else:
            k7 += n
    return k5, mma, k6, k7


def phase_planar_model(dev, params, results):
    """The planar path end to end: the planar twin of the model phase's
    FP4 Llama3-8B generates 60 tokens greedily at B = 1, 3 and 8 (K5
    only; K5 on the 48-row prefill and K6 on every decode step; K7's
    dense band on the 128-row prefill and K5 on decode), with exact launch
    counts (K5's split by body as ``planar_body`` says), the same tokens
    on every run and tok/s the median of 5. Then
    one decode step's logits against the pair model's on the same cache,
    and where the greedy streams part."""
    from quantizations_tpu_torch.config import QuantConfig, ServeConfig
    from quantizations_tpu_torch.models.llama import (LLAMA3_8B, KVCache,
                                                      decode_step,
                                                      named_tensors, prefill)
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT,
                                             DEQUANTIZE_4BIT_PAIR, GEMV_4BIT,
                                             KERNELS, PAIR_MATMUL,
                                             PLANAR_MATMUL, PLANAR_MATMUL_MMA)
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    cfg = dataclasses.replace(LLAMA3_8B, quant=QuantConfig(
        quantize_embedding=True))
    serve = ServeConfig(max_seq_len=128, max_new_tokens=PLANAR_NEW,
                        temperature=0.0)
    layers = cfg.num_hidden_layers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planar = planar_twin(params)
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size()
                 for _, t in named_tensors(planar))
    log(f"  planar twin built in {time.perf_counter() - t0:.2f} s, "
        f"{wbytes / 1e9:.3f} GB of weights")
    if planar.layers.qkv.layout != "planar" or planar.lm_head.layout != \
            "planar":
        raise AssertionError("the twin is not planar")
    gen = make_generate_fn(cfg, serve)
    ids = ((torch.arange(PROMPT_LEN, device=dev) * 7 + 11) % cfg.vocab_size
           ).to(torch.int32)[None, :]
    pair_tokens = {r["batch"]: r["tokens"] for r in results.get("generate", [])
                   if r["quant_type"] == "fp4" and r["attention"] == "einsum"}
    for B in PLANAR_BATCHES:
        if B not in pair_tokens:                 # the pair model at B = 3
            toks, _ = gen(params, ids.repeat(B, 1),
                          KVCache.create(cfg, B, serve.max_seq_len, dev), None)
            pair_tokens[B] = toks.cpu().tolist()
    kerns = (PLANAR_MATMUL, PLANAR_MATMUL_MMA, GEMV_4BIT, DEQUANTIZE_4BIT)
    runs = []
    for k in KERNELS:
        k.launches = 0
    for B in PLANAR_BATCHES:
        want = _planar_launches(B, layers)
        idsb = ids.repeat(B, 1)
        times, first = [], None
        for it in range(5 + 1):
            cache = KVCache.create(cfg, B, serve.max_seq_len, dev)
            pair_kerns = (PAIR_MATMUL, DEQUANTIZE_4BIT_PAIR)
            before = [k.launches for k in kerns + pair_kerns]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            toks, _ = gen(planar, idsb, cache, None)
            end.record()
            end.synchronize()
            got = tuple(k.launches - b for k, b in
                        zip(kerns + pair_kerns, before))
            if got != want + (0, 0):
                raise AssertionError(f"planar B={B}: (K5, K5 tensor-core, "
                                     f"K6, K7, K1, K10) launched {got}, "
                                     f"expected {want + (0, 0)}")
            if toks.shape != (B, PLANAR_NEW) or int(toks.min()) < 0 or int(
                    toks.max()) >= cfg.vocab_size:
                raise AssertionError(f"planar tokens out of range: "
                                     f"{toks.shape}")
            if first is None:
                first = toks.cpu()
            elif not torch.equal(first, toks.cpu()):
                raise AssertionError(f"planar B={B}: tokens differ between "
                                     "runs")
            if it:
                times.append(start.elapsed_time(end) / 1e3)
            del cache
        t = statistics.median(times)
        ref = pair_tokens[B][0]
        part = next((i for i, (a, b) in enumerate(zip(first[0].tolist(), ref))
                     if a != b), None)
        runs.append(dict(batch=B, tok_per_s=PLANAR_NEW * B / t,
                         tok_per_s_min=PLANAR_NEW * B / max(times),
                         tok_per_s_max=PLANAR_NEW * B / min(times),
                         generate_s=t, generate_s_all=times,
                         launches_per_generate=dict(zip(
                             (k.name for k in kerns), want)),
                         first_part_from_pair=part, tokens=first.tolist()))
        r = runs[-1]
        log(f"  planar B={B}: {r['tok_per_s']:.2f} tok/s, median of 5 (min "
            f"{r['tok_per_s_min']:.2f}, max {r['tok_per_s_max']:.2f}); "
            f"K5 (tensor-core body) / K6 / K7 launches {want[0]} "
            f"({want[1]}) / {want[2]} / {want[3]} each; the stream "
            + ("equals the pair model's" if part is None else
               f"parts from the pair model's at token {part}"))
    results["launches_planar"] = {k.name: k.launches for k in KERNELS}
    results["planar_generate"] = runs

    # the rounding classes, one projection at a time: the twin's planar
    # words against the pair words they came from (layer 1, the lm_head)
    # under K5 and K1 (one class: the fp32 summation order only) and K6
    # (fp32 class: 2^-9 from K1's bf16 weights)
    from quantizations_tpu_torch.ops import (gemv_4bit, gemv_4bit_stacked,
                                             matmul_4bit_pair,
                                             matmul_4bit_pair_stacked,
                                             matmul_4bit_planar,
                                             matmul_4bit_planar_stacked)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    cls = {}
    for name in ("qkv", "o", "gate_up", "down", "lm_head"):
        lp = (params.lm_head if name == "lm_head"
              else getattr(params.layers, name))
        lq = (planar.lm_head if name == "lm_head"
              else getattr(planar.layers, name))
        K = lq.wp.shape[-1] * 8
        for T, kern in ((1, "planar_matmul"), (3, "gemv_4bit"),
                        (8, "planar_matmul")):
            x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
            if name == "lm_head":
                yp = matmul_4bit_pair(lp.wp, lp.scales, x)
                yq = (gemv_4bit if T == 3 else matmul_4bit_planar)(
                    lq.wp, lq.scales, x)
            else:
                yp = matmul_4bit_pair_stacked(lp.wp, lp.scales, x, 1)
                yq = (gemv_4bit_stacked if T == 3
                      else matmul_4bit_planar_stacked)(lq.wp, lq.scales, x, 1)
            rel = ((yq - yp).abs().max() / yp.abs().max()).item()
            cls[f"{name} T={T}"] = dict(kernel=kern, max_diff_over_max=rel)
            if not rel <= (1e-2 if T == 3 else 1e-5):
                raise AssertionError(f"{kern} {name} T={T}: {rel:.3e} of "
                                     "max|y| from K1 on the same codes")
    worst = {k: max(v["max_diff_over_max"] for v in cls.values()
                    if v["kernel"] == k) for k in ("planar_matmul",
                                                   "gemv_4bit")}
    log(f"  the twin's projections against K1 on the pair words: K5 within "
        f"{worst['planar_matmul']:.3e} of max|y| (gate 1e-5), K6 within "
        f"{worst['gemv_4bit']:.3e} (gate 1e-2)")
    results["planar_vs_pair_projections"] = cls

    # one decode step of the whole model on the same cache (filled by the
    # pair model's prefill): 32 random layers amplify the fp32 order and
    # rounding differences above (the flash vs einsum step of the model
    # phase differs by ~5%), so this gate only catches a wrong layout
    logit = {}
    with torch.inference_mode():
        for B in PLANAR_BATCHES:
            ids2 = torch.randint(0, cfg.vocab_size, (B, PROMPT_LEN + 1),
                                 generator=torch.Generator().manual_seed(1)
                                 ).to(dev)
            cache = KVCache.create(cfg, B, 128, dev)
            prefill(params, ids2[:, :PROMPT_LEN], cache, cfg,
                    last_token_only=True)
            twin = KVCache(k=cache.k.clone(), v=cache.v.clone())
            lp, _ = decode_step(params, ids2[:, PROMPT_LEN:], cache,
                                PROMPT_LEN, cfg)
            lq, _ = decode_step(planar, ids2[:, PROMPT_LEN:], twin,
                                PROMPT_LEN, cfg)
            rel = ((lq - lp).abs().max() / lp.abs().max()).item()
            top1 = (lq.argmax(-1) == lp.argmax(-1)).float().mean().item()
            logit[B] = dict(max_diff_over_max=rel, top1=top1)
            log(f"  B={B} decode logits, planar vs pair on one cache: "
                f"max|diff| {rel:.3e} of max|logit|, top-1 agreement "
                f"{top1:.3f}")
            if not rel <= 0.25:
                raise AssertionError(f"planar B={B} decode logits differ from "
                                     f"the pair model's by {rel:.3e}")
            del cache, twin
    results["planar_decode_logits"] = logit
    return planar


def phase_planar_module(dev, gen, results):
    """``Linear4bit.create`` on a [14336, 4096] weight on the card: its
    forward at T = 1, 3, 64 (K5, K6, K5) and 256 (K7 + matmul) against
    the band's plain version, one launch of the band's kernel each; then
    a round trip through the bnb flat tensors and ``load_bnb_linear4bit``,
    which must give bit-identical outputs."""
    from quantizations_tpu_torch.nn.linear import Linear4bit
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT, GEMV_4BIT,
                                             PLANAR_MATMUL,
                                             dequantize_4bit_kernel_plain,
                                             gemv_4bit_plain,
                                             matmul_4bit_planar_plain)
    from quantizations_tpu_torch.quant.bnb_io import (bnb_flat_tensors,
                                                      load_bnb_linear4bit)

    M, K = MODULE_SHAPE
    W = torch.randn(M, K, generator=gen, device=dev) * 0.02
    bias = torch.randn(M, generator=gen, device=dev) * 0.02
    lin = Linear4bit.create(W, bias=bias, device=dev)
    prefix = "model.layers.0.mlp.gate_proj"
    flat = bnb_flat_tensors(prefix, lin.weight.packed_u8(), lin.quant_state)
    flat[f"{prefix}.bias"] = bias.cpu().numpy()
    loaded = load_bnb_linear4bit(flat.__getitem__, set(flat), prefix,
                                 device=dev)
    wp, s = lin.weight.wp, lin.weight.scales
    out = []
    for T, kern in ((1, PLANAR_MATMUL), (3, GEMV_4BIT), (64, PLANAR_MATMUL),
                    (256, DEQUANTIZE_4BIT)):
        x = torch.randn(T, K, generator=gen, device=dev)
        before = kern.launches
        y = lin(x)
        torch.cuda.synchronize()
        if kern.launches != before + 1:
            raise AssertionError(f"Linear4bit T={T} did not launch "
                                 f"{kern.name} once")
        xb = x.to(torch.bfloat16)
        if T == 3:
            ref = gemv_4bit_plain(wp, s, xb)
        elif T == 256:
            ref = xb.float() @ dequantize_4bit_kernel_plain(
                wp, s, "fp4", torch.bfloat16).float().T
        else:
            ref = matmul_4bit_planar_plain(wp, s, xb)
        ref = ref + bias
        err = (y - ref).abs().max().item() / ref.abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"Linear4bit T={T}: {err:.3e} of max|y| "
                                 "from the plain path")
        if not torch.equal(loaded(x), y):
            raise AssertionError(f"bnb round trip T={T}: outputs differ")
        out.append(dict(T=T, kernel=kern.name, max_err_over_max_y=err))
        log(f"  Linear4bit [{M}, {K}] T={T}: {kern.name}, {err:.3e} of "
            "max|y| from the plain path; the bnb round trip bit-identical")
    results["planar_module"] = dict(cases=out, bnb_keys=sorted(flat))
    del W, lin, loaded, flat


def _forward_sum(rows, T, key, head_t):
    """A forward's sum of ``key`` over K1_SHAPES: 32 layers x the four
    projections at T, plus the lm_head at ``head_t`` (None: without it)."""
    tot = 0.0
    for r in rows:
        if r["shape"] == "lm_head" and r["T"] == head_t:
            tot += r[key]
        elif r["shape"] != "lm_head" and r["T"] == T:
            tot += LAYERS * r[key]
    return tot


def phase_planar_time(dev, gen, results):
    """K5's two bodies, each launched directly, at PLANAR_BODY_T on the
    five planar shapes, beside the bound (bf16 tensor-core rate), dense
    bf16 ``torch.matmul`` over the same shapes (the port never calls it)
    and, at PLANAR_PLAIN_T, the plain version; ``ms`` is the body that
    ``planar_body`` picks. K6 at T = 3 (decode at B = 3) beside its bound
    (fp32 rate), plain version and ``torch.matmul``; K7 at [14336, 4096]
    and the lm_head, to fp32 and bf16. Weights rotate over enough layers
    to exceed the 50 MB L2 four times. Per-forward sums: 32 layers x the
    four projections, with the lm_head at T where T <= 8 (decode; a
    prefill's lm_head runs at B rows); and the crossover: the fewest
    timed rows from which the tensor-core body is the faster per forward
    at every larger count."""
    from quantizations_tpu_torch.ops import (dequantize_4bit_kernel,
                                             dequantize_4bit_kernel_plain,
                                             gemv_4bit, gemv_4bit_plain)
    from quantizations_tpu_torch.ops import qmatmul as qm

    rows, k7 = [], []
    for name, M, K in K1_SHAPES:
        layer_bytes = M * K // 2 + M * (K // 64) * 4
        L = max(2, math.ceil(4 * L2_BYTES / layer_bytes))
        wp, s = _planar_operands(M, K, L, dev, gen)
        R = max(2, math.ceil(4 * L2_BYTES / (M * K * 2)))
        Wd = torch.randn(R, M, K, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(max(PLANAR_BODY_T), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        for T in PLANAR_BODY_T + (3,):
            xt = x[:T].contiguous()
            k6 = T == 3
            if k6:
                ms = {"ms": device_ms(lambda i: gemv_4bit(
                    wp[i % L], s[i % L], xt), 64)}
            else:
                ms = {f"{b}_ms": device_ms(lambda i: getattr(
                    qm, f"matmul_4bit_planar_{b}")(wp[i % L], s[i % L], xt),
                    64) for b in ("cuda_core", "mma")}
                ms["ms"] = ms[f"{qm.planar_body(T)}_ms"]
            pms = (device_ms(lambda i: (gemv_4bit_plain if k6 else
                                        qm.matmul_4bit_planar_plain)(
                wp[0], s[0], xt), 3, warmup=1)
                if k6 or T in PLANAR_PLAIN_T else None)
            lms = device_ms(lambda i: torch.matmul(xt, Wd[i % R].T), 64)
            rate = FP32_FLOP_PER_S if k6 else BF16_FLOP_PER_S
            nbytes = layer_bytes + T * K * 2 + T * M * 4
            bms, by = bound(nbytes, 2 * T * M * K, rate)
            rows.append(dict(kernel="gemv_4bit" if k6 else "planar_matmul",
                             shape=name, M=M, K=K, T=T, plain_ms=pms,
                             library_ms=lms, bound_ms=bms, bound_by=by,
                             bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             ops_ms=2 * T * M * K / rate * 1e3,
                             layers_rotated=L, **ms))
            log(f"  {'K6' if k6 else 'K5'} {name:8s} T={T:2d}: "
                + (f"{ms['ms'] * 1e3:9.2f} us" if k6 else
                   f"CUDA-core {ms['cuda_core_ms'] * 1e3:9.2f} us  "
                   f"tensor-core {ms['mma_ms'] * 1e3:9.2f} us")
                + f"  bound {bms * 1e3:8.2f} us ({by})  torch.matmul bf16 "
                f"{lms * 1e3:8.2f} us"
                + (f"  plain {pms * 1e3:9.1f} us" if pms else ""))
        if name in ("gate_up", "lm_head"):
            # one of the two halves of gate_up ([14336, 4096]), the head
            Mq = M // 2 if name == "gate_up" else M
            for dt in (torch.float32, torch.bfloat16):
                ms = device_ms(lambda i: dequantize_4bit_kernel(
                    wp[i % L][:Mq], s[i % L][:Mq], "fp4", dt), 20)
                pms = device_ms(lambda i: dequantize_4bit_kernel_plain(
                    wp[0][:Mq], s[0][:Mq], "fp4", dt), 3, warmup=1)
                nbytes = (Mq * K // 2 + Mq * (K // 64) * 4
                          + Mq * K * (4 if dt == torch.float32 else 2))
                bms, by = bound(nbytes, Mq * K, FP32_FLOP_PER_S)
                k7.append(dict(M=Mq, K=K, dtype=str(dt), ms=ms, plain_ms=pms,
                               bound_ms=bms, bound_by=by, library_ms=None))
                log(f"  dequantize_4bit [{Mq}, {K}] -> {dt}: {ms * 1e3:9.2f}"
                    f" us  bound {bms * 1e3:8.2f} us ({by})  plain "
                    f"{pms * 1e3:9.1f} us")
        del wp, s, Wd, x
        torch.cuda.empty_cache()
    per = {}
    for kname, T in [("planar_matmul", T) for T in PLANAR_BODY_T] + [
            ("gemv_4bit", 3)]:
        sel = [r for r in rows if r["kernel"] == kname]
        head_t = T if T <= 8 else None
        keys = ["ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms"]
        keys += ["plain_ms"] if kname == "gemv_4bit" or T in PLANAR_PLAIN_T \
            else []
        keys += ["cuda_core_ms", "mma_ms"] if kname == "planar_matmul" else []
        f = {k: _forward_sum(sel, T, k, head_t) for k in keys}
        f["bound_by"] = ("bytes" if f["bytes_ms"] >= f["ops_ms"]
                         else "operations")
        f["launches"] = 4 * LAYERS + (head_t is not None)
        per[f"{kname} T={T}"] = f
        log(f"  {'K6' if kname == 'gemv_4bit' else 'K5'} per forward at "
            f"T={T} ({f['launches']} launches): "
            + (f"{f['ms']:.3f} ms" if kname == "gemv_4bit" else
               f"CUDA-core body {f['cuda_core_ms']:.3f} ms, tensor-core "
               f"body {f['mma_ms']:.3f} ms")
            + f", bound {f['bound_ms']:.3f} ms ({f['bound_by']}), "
            f"torch.matmul bf16 {f['library_ms']:.3f} ms"
            + (f", plain {f['plain_ms']:.1f} ms" if "plain_ms" in f else ""))
    cross = None
    for T in sorted(PLANAR_BODY_T, reverse=True):
        f = per[f"planar_matmul T={T}"]
        if f["mma_ms"] >= f["cuda_core_ms"]:
            break
        cross = T
    log(f"  K5 crossover (fewest timed rows from which the tensor-core body "
        f"is the faster per forward at every larger count): {cross}; K5 "
        f"switches at {qm.PLANAR_MMA_MIN_TOKENS}")
    results["planar_time"] = dict(rows=rows, per_forward=per, k7=k7,
                                  crossover=cross)


def phase_planar(dev, gen, results, params):
    """The planar slice: kernels, model, module and bnb, times. The planar
    twin is freed at the end, before the paged phase."""
    phase_planar_check(dev, gen, results)
    planar = phase_planar_model(dev, params, results)
    del planar
    torch.cuda.empty_cache()
    phase_planar_module(dev, gen, results)
    phase_planar_time(dev, gen, results)


def _gate(rec, what, y, ref, gate=K8_GATE):
    """max|y - ref| / max|ref| within ``gate``, or raise; the worst case
    goes into ``rec``."""
    err = (y - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if not rel <= gate:
        raise AssertionError(f"{what}: {rel:.3e} of max|y| (gate "
                             f"{gate:.0e})")
    if rel > rec["max_err_over_max_y"]:
        rec["worst_case"] = what
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["max_err_over_max_y"] = max(rec["max_err_over_max_y"], rel)
    return rel


def phase_pair_variants_check(dev, gen, results):
    """The tensor-core body (K8, and K1 from PAIR_MMA_MIN_TOKENS rows on)
    within K8_GATE * max|y| of its plain versions and of K1's CUDA-core
    body at K8_TOKENS, with K1 above 128 rows bit-identical to K8 (one
    body, one tile rule); K9 equal to K1 bit for bit at K9_TOKENS (and
    within 1e-5 * max|y| of its plain version). Every Llama3-8B pair
    shape (and, for the tensor-core body, 3071 row pairs: a row tail in
    every tile), FP4 and NF4, fp32, bf16 and ``bf16x2`` scales; the layer
    shapes stacked and read at layer 1, the lm_head unstacked."""
    from quantizations_tpu_torch.ops import pack_scale_pairs
    from quantizations_tpu_torch.ops import qmatmul as qm

    def rec():
        return dict(max_abs_err=0.0, max_err_over_max_y=0.0,
                    worst_case=None, cases=0)

    k8 = dict(rec(), max_diff_from_k1_over_max=0.0, by_shape={})
    mma = dict(rec(), max_diff_from_cuda_core_over_max=0.0,
               bit_identical_to_k8=0)
    k9 = dict(max_abs_err=0.0, max_err_over_max_y=0.0, bit_identical=0)
    for name, M, K in MMA_SHAPES:
        stacked = name != "lm_head"
        lay = 1 if stacked else 0
        wp2, s32 = _pair_operands(M, K, 2 if stacked else 1, dev, gen)
        x = torch.randn(max(K8_TOKENS), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        for qt in ("fp4", "nf4"):
            for sk, s in (("fp32", s32), ("bf16", s32.to(torch.bfloat16)),
                          ("bf16x2", pack_scale_pairs(s32))):
                def run(fn, fn_stacked, xt):
                    if stacked:
                        return fn_stacked(wp2, s, xt, lay, qt)
                    return fn(wp2[0], s[0], xt, qt)

                what = f"{name} [{M},{K}] {qt} {sk}"
                plain8 = qm.matmul_4bit_pair_prefill_plain(wp2[lay], s[lay],
                                                           x, qt)
                plain1 = qm.matmul_4bit_pair_plain(wp2[lay], s[lay], x, qt)
                for T in K8_TOKENS:
                    xt = x[:T]
                    y8 = run(qm.matmul_4bit_pair_prefill,
                             qm.matmul_4bit_pair_prefill_stacked, xt)
                    ycc = qm.matmul_4bit_pair_cuda_core(wp2[lay], s[lay], xt,
                                                        qt)
                    torch.cuda.synchronize()
                    if y8.shape != (T, M) or not torch.isfinite(y8).all():
                        raise AssertionError(f"K8 {what} T={T}: bad output")
                    rel = _gate(k8, f"K8 {what} T={T}", y8, plain8[:T])
                    rel1 = _gate(rec(), f"K8 {what} T={T} against K1's "
                                 "CUDA-core body", y8, ycc)
                    k8["max_diff_from_k1_over_max"] = max(
                        k8["max_diff_from_k1_over_max"], rel1)
                    k8["by_shape"][name] = max(k8["by_shape"].get(name, 0.0),
                                               rel)
                    k8["cases"] += 1
                    if T not in MMA_TOKENS:
                        continue
                    y1 = run(qm.matmul_4bit_pair, qm.matmul_4bit_pair_stacked,
                             xt)
                    torch.cuda.synchronize()
                    if not torch.equal(y1.view(torch.int32),
                                       y8.view(torch.int32)):
                        raise AssertionError(f"K1 {what} T={T}: its "
                                             "tensor-core body differs "
                                             "from K8")
                    _gate(mma, f"K1 {what} T={T}", y1, plain1[:T])
                    rel1 = _gate(rec(), f"K1 {what} T={T} against its "
                                 "CUDA-core body", y1, ycc)
                    mma["max_diff_from_cuda_core_over_max"] = max(
                        mma["max_diff_from_cuda_core_over_max"], rel1)
                    mma["bit_identical_to_k8"] += 1
                    mma["cases"] += 1
                del plain8, plain1
                if name == "odd":
                    continue
                plain9 = qm.matmul_4bit_pair_manual_plain(
                    wp2[lay], s[lay], x[:max(K9_TOKENS)], qt)
                for T in K9_TOKENS:
                    xt = x[:T]
                    y9 = run(qm.matmul_4bit_pair_manual,
                             qm.matmul_4bit_pair_manual_stacked, xt)
                    y1 = run(qm.matmul_4bit_pair, qm.matmul_4bit_pair_stacked,
                             xt)
                    torch.cuda.synchronize()
                    if not torch.equal(y9.view(torch.int32),
                                       y1.view(torch.int32)):
                        raise AssertionError(f"K9 {what} T={T}: not "
                                             "bit-identical to K1")
                    ref = plain9[:T]
                    err = (y9 - ref).abs().max().item()
                    rel = err / ref.abs().max().item()
                    if not rel <= 1e-5:
                        raise AssertionError(f"K9 {what} T={T}: {rel:.3e} of "
                                             "max|y| from the plain version")
                    k9["max_abs_err"] = max(k9["max_abs_err"], err)
                    k9["max_err_over_max_y"] = max(k9["max_err_over_max_y"],
                                                   rel)
                    k9["bit_identical"] += 1
                del plain9
        log(f"  {name} [{M}, {K}]: K8 within {K8_GATE:.0e} * max|y| of its "
            f"plain version (worst {k8['by_shape'][name]:.3e}) and of K1's "
            f"CUDA-core body, K1 above 128 rows its own tensor-core body "
            f"bit-identical to K8, K9 bit-identical to K1 ({k8['cases']} + "
            f"{mma['cases']} + {k9['bit_identical']} cases so far)")
        del wp2, s32, x
        torch.cuda.empty_cache()
    results["pair_variants_err"] = dict(pair_prefill=k8, pair_manual=k9,
                                        pair_matmul_mma=mma)
    log(f"  K8: {k8['cases']} cases, worst max|err| {k8['max_abs_err']:.3e},"
        f" worst max|err| / max|y| {k8['max_err_over_max_y']:.3e} "
        f"({k8['worst_case']}), from K1's CUDA-core body "
        f"{k8['max_diff_from_k1_over_max']:.3e}; K1's tensor-core body: "
        f"{mma['cases']} cases at T {MMA_TOKENS}, worst "
        f"{mma['max_err_over_max_y']:.3e} of max|y| ({mma['worst_case']}), "
        f"from its CUDA-core body {mma['max_diff_from_cuda_core_over_max']:.3e}"
        f"; K9: {k9['bit_identical']} cases bit-identical to K1, "
        f"{k9['max_err_over_max_y']:.3e} of max|y| from its plain version")


def phase_dense_band_check(dev, gen, results):
    """The dense pair band (above the K1 band on the reference's default
    route). K10 bit-exact against ``dense_weight`` (bf16) and its plain
    version (bf16 and fp32 output) at every Llama3-8B pair shape, FP4 and
    NF4, fp32, bf16 and ``bf16x2`` scales, read at layer 1 of a stack of
    two; then the band (K10 and the bf16 product with fp32 output) within
    BAND_GATE * max|y| of ``dense_matmul_pair_plain`` (fp32 products of
    the same bf16 values) at BAND_TOKENS on the four layer shapes, FP4
    and NF4, and the planar dense band (K7, the same product) within
    BAND_GATE * max|y| of the fp32 product of K7's weight."""
    from quantizations_tpu_torch.nn.linear import (dense_matmul_pair,
                                                   dense_matmul_pair_plain,
                                                   dense_product,
                                                   dense_weight)
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             dequantize_4bit_kernel,
                                             dequantize_4bit_pair,
                                             dequantize_4bit_pair_plain,
                                             pack_scale_pairs)

    k10 = dict(cases=0, max_abs_err=0.0)
    for name, M, K in K1_SHAPES:
        wp2, s32 = _pair_operands(M, K, 2, dev, gen)
        for qt in ("fp4", "nf4"):
            for sk, s in (("fp32", s32), ("bf16", s32.to(torch.bfloat16)),
                          ("bf16x2", pack_scale_pairs(s32))):
                twin = dense_weight(wp2[1], s[1], qt, "pair")
                for dt in (torch.bfloat16, torch.float32):
                    before = DEQUANTIZE_4BIT_PAIR.launches
                    got = dequantize_4bit_pair(wp2, s, qt, dt, layer_idx=1)
                    ref = dequantize_4bit_pair_plain(wp2, s, qt, dt, 1)
                    torch.cuda.synchronize()
                    what = f"K10 {name} [{M}, {K}] {qt} {sk} -> {dt}"
                    if DEQUANTIZE_4BIT_PAIR.launches != before + 1:
                        raise AssertionError(f"{what}: not launched once")
                    if got.shape != (M, K) or not torch.equal(
                            got.view(torch.uint8), ref.view(torch.uint8)):
                        raise AssertionError(f"{what}: not bit-exact with "
                                             "its plain version")
                    if dt == torch.bfloat16 and not torch.equal(
                            got.view(torch.int16), twin.view(torch.int16)):
                        raise AssertionError(f"{what}: not bit-exact with "
                                             "dense_weight")
                    k10["cases"] += 1
                    del got, ref
                del twin
        del wp2, s32
        torch.cuda.empty_cache()
    log(f"  K10: {k10['cases']} cases bit-exact with its plain version "
        "(and, to bf16, with dense_weight) at every pair shape")

    band = dict(max_abs_err=0.0, max_err_over_max_y=0.0, worst_case=None,
                cases=0)
    planar = dict(band)
    # why dense_product sums 2048-column chunks: one torch.mm over the whole
    # K against the same plain version (recorded, not gated), by shape
    one_mm = {}
    for name, M, K in K1_SHAPES:
        if name == "lm_head":
            continue
        wp2, s = _pair_operands(M, K, 1, dev, gen)
        wp, sp = _planar_operands(M, K, 1, dev, gen)
        x = torch.randn(max(BAND_TOKENS), K, generator=gen, device=dev)
        for qt in ("fp4", "nf4"):
            Wp = dequantize_4bit_kernel(wp[0], sp[0], qt, torch.bfloat16)
            for T in BAND_TOKENS:
                xt = x[:T]
                y = dense_matmul_pair(xt, wp2[0], s[0], qt)
                ref = dense_matmul_pair_plain(xt, wp2[0], s[0], qt)
                torch.cuda.synchronize()
                if y.shape != (T, M) or not torch.isfinite(y).all():
                    raise AssertionError(f"band {name} T={T}: bad output")
                _gate(band, f"band {name} [{M},{K}] {qt} T={T}", y, ref,
                      BAND_GATE)
                band["cases"] += 1
                W = dequantize_4bit_pair(wp2[0], s[0], qt, torch.bfloat16)
                flag = torch.backends.cuda.matmul
                for reduced in (True, False):
                    was = flag.allow_bf16_reduced_precision_reduction
                    flag.allow_bf16_reduced_precision_reduction = reduced
                    try:
                        y1 = torch.mm(xt.to(torch.bfloat16), W.T,
                                      out_dtype=torch.float32)
                    finally:
                        flag.allow_bf16_reduced_precision_reduction = was
                    key = f"{name} flag {'on' if reduced else 'off'}"
                    one_mm[key] = max(one_mm.get(key, 0.0), (
                        (y1 - ref).abs().max() / ref.abs().max()).item())
                del W, y1
                xb = xt.to(torch.bfloat16)
                _gate(planar, f"planar band {name} [{M},{K}] {qt} T={T}",
                      dense_product(xb, Wp), xb.float() @ Wp.float().T,
                      BAND_GATE)
                planar["cases"] += 1
            del Wp
        del wp2, s, wp, sp, x
        torch.cuda.empty_cache()
    results["dense_band_err"] = dict(dequantize_4bit_pair=k10, pair=band,
                                     planar=planar, one_mm_over_max_y=one_mm)
    log(f"  dense pair band: {band['cases']} cases at T {BAND_TOKENS}, "
        f"worst {band['max_err_over_max_y']:.3e} of max|y| "
        f"({band['worst_case']}) from its fp32 plain version; planar dense "
        f"band: {planar['cases']} cases, worst "
        f"{planar['max_err_over_max_y']:.3e} ({planar['worst_case']}); one "
        "torch.mm over the whole K instead (no gate; flag: torch.backends."
        "cuda.matmul.allow_bf16_reduced_precision_reduction): " + ", ".join(
            f"{n} {e:.3e}" for n, e in one_mm.items()))


def phase_pair_variants_time(dev, gen, results):
    """K9 at T = 1 on the projections that take it at decode (qkv, o,
    down) beside K1 and dense bf16 ``torch.matmul``; K8 at T = 512 on the
    four layer projections beside K1's CUDA-core body (``k1_ms``: above
    128 rows K1 itself runs K8's body), the dense pair band
    (``dense_pair_ms``: the route there without ``QT_PREFILL_PAIR``), the
    plain band (``plain_band_ms``: the fp32 route before K10), dense bf16
    ``torch.matmul`` and the plain version. Then the dense pair band at
    BAND_TIMED_T beside its bound, K10 alone (its bound and plain
    version), bf16 ``torch.matmul`` on a ready weight, K8's route
    (``pair_prefill_matmul``, 512-row chunks) and, at PLAIN_BAND_T, the
    plain band. Weights rotate over a 32-layer stack; per-forward sums
    weight each shape by its 32 launches."""
    from quantizations_tpu_torch.nn.linear import (dense_matmul_pair,
                                                   dense_matmul_pair_plain)
    from quantizations_tpu_torch.ops import (dequantize_4bit_pair,
                                             dequantize_4bit_pair_plain)
    from quantizations_tpu_torch.ops import qmatmul as qm

    rows, band = [], []
    for name, M, K in K1_SHAPES:
        if name == "lm_head":
            continue
        L = LAYERS
        wp2, scales = _pair_operands(M, K, L, dev, gen)
        R = max(2, math.ceil(4 * L2_BYTES / (M * K * 2)))
        Wd = torch.randn(R, M, K, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(max(BAND_TIMED_T), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        # the dense pair band and K10 alone (K10's work does not depend on T)
        k10 = device_ms(lambda i: dequantize_4bit_pair(
            wp2, scales, "fp4", torch.bfloat16, layer_idx=i % L), 32)
        k10_plain = device_ms(lambda i: dequantize_4bit_pair_plain(
            wp2, scales, "fp4", torch.bfloat16, 0), 1, warmup=1)
        k10_bytes = M * K // 2 + M * (K // 64) * 4 + M * K * 2
        k10_bound = bound(k10_bytes, M * K, FP32_FLOP_PER_S)[0]
        band_at = {}
        for T in BAND_TIMED_T:
            xt = x[:T].contiguous()
            ms = device_ms(lambda i: dense_matmul_pair(
                xt, wp2[i % L], scales[i % L], "fp4"), 16, warmup=2)
            lms = device_ms(lambda i: torch.matmul(xt, Wd[i % R].T), 32)
            k8 = device_ms(lambda i: qm.pair_prefill_matmul(
                wp2, scales, xt, "fp4", layer_idx=i % L), 16, warmup=2)
            plain_band = (device_ms(lambda i: dense_matmul_pair_plain(
                xt, wp2[i % L], scales[i % L], "fp4"), 2, warmup=1)
                if T in PLAIN_BAND_T else None)
            nbytes = M * K // 2 + M * (K // 64) * 4 + T * K * 2 + T * M * 4
            bms, by = bound(nbytes, 2 * T * M * K)
            band_at[T] = dict(
                shape=name, M=M, K=K, T=T, ms=ms, library_ms=lms, k8_ms=k8,
                plain_ms=plain_band, bound_ms=bms, bound_by=by, k10_ms=k10,
                k10_plain_ms=k10_plain, k10_bound_ms=k10_bound,
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=2 * T * M * K / BF16_FLOP_PER_S * 1e3)
            band.append(band_at[T])
            log(f"  dense pair band {name:8s} T={T:4d}: {ms * 1e3:9.2f} us  "
                f"bound {bms * 1e3:8.2f} us ({by})  K10 {k10 * 1e3:8.2f} us "
                f"(bound {k10_bound * 1e3:8.2f}, plain {k10_plain * 1e3:9.1f})"
                f"  torch.matmul bf16 {lms * 1e3:8.2f} us  K8 route "
                f"{k8 * 1e3:9.2f} us"
                + ("" if plain_band is None else
                   f"  plain band {plain_band * 1e3:9.2f} us"))
        cases = [("pair_prefill", K8_TIMED_T, qm.matmul_4bit_pair_prefill,
                  qm.matmul_4bit_pair_prefill_plain)]
        if name in K9_SHAPES:
            cases.insert(0, ("pair_manual", 1, qm.matmul_4bit_pair_manual,
                             qm.matmul_4bit_pair_manual_plain))
        for kname, T, fn, plain in cases:
            xt = x[:T].contiguous()
            slow = T > 256                  # K1 and the dense band at 512
            ms = device_ms(lambda i: fn(wp2[i % L], scales[i % L], xt,
                                        "fp4"), 64)
            k1 = device_ms(lambda i: qm.matmul_4bit_pair_cuda_core(
                wp2[i % L], scales[i % L], xt, "fp4"), 8 if slow else 64)
            pms = device_ms(lambda i: plain(wp2[0], scales[0], xt, "fp4"),
                            2, warmup=1)
            lms = device_ms(lambda i: torch.matmul(xt, Wd[i % R].T), 64)
            # the band's times at this T (timed above; 512 is in both)
            dense = band_at[T]["ms"] if slow else None
            plain_band = band_at[T]["plain_ms"] if slow else None
            nbytes = M * K // 2 + M * (K // 64) * 4 + T * K * 2 + T * M * 4
            bms, by = bound(nbytes, 2 * T * M * K)
            rows.append(dict(kernel=kname, shape=name, M=M, K=K, T=T, ms=ms,
                             k1_ms=k1, plain_ms=pms, library_ms=lms,
                             dense_pair_ms=dense, plain_band_ms=plain_band,
                             bound_ms=bms, bound_by=by,
                             bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             ops_ms=2 * T * M * K / BF16_FLOP_PER_S * 1e3))
            log(f"  {kname:12s} {name:8s} T={T:3d}: {ms * 1e3:9.2f} us  "
                f"bound {bms * 1e3:8.2f} us ({by})  K1 {k1 * 1e3:9.2f} us  "
                f"plain {pms * 1e3:9.1f} us  torch.matmul bf16 "
                f"{lms * 1e3:8.2f} us"
                + ("" if dense is None else
                   f"  dense pair band {dense * 1e3:9.2f} us, plain band "
                   f"{plain_band * 1e3:9.2f} us"))
        del wp2, scales, Wd, x
        torch.cuda.empty_cache()
    per = {}
    for kname in ("pair_manual", "pair_prefill"):
        sel = [r for r in rows if r["kernel"] == kname]
        f = {k: LAYERS * sum(r[k] for r in sel)
             for k in ("ms", "k1_ms", "plain_ms", "library_ms", "bound_ms",
                       "bytes_ms", "ops_ms")}
        if kname == "pair_prefill":
            f["dense_pair_ms"] = LAYERS * sum(r["dense_pair_ms"] for r in sel)
            f["plain_band_ms"] = LAYERS * sum(r["plain_band_ms"] for r in sel)
        f["bound_by"] = ("bytes" if f["bytes_ms"] >= f["ops_ms"]
                         else "operations")
        f["launches"] = LAYERS * len(sel)
        f["T"] = sel[0]["T"]
        per[kname] = f
        log(f"  {kname} per forward at T={f['T']} ({f['launches']} "
            f"launches: {', '.join(r['shape'] for r in sel)} x {LAYERS}): "
            f"{f['ms']:.3f} ms, bound {f['bound_ms']:.3f} ms "
            f"({f['bound_by']}; bytes {f['bytes_ms']:.3f}, operations "
            f"{f['ops_ms']:.3f}), K1 {f['k1_ms']:.3f} ms, plain "
            f"{f['plain_ms']:.1f} ms, torch.matmul bf16 "
            f"{f['library_ms']:.3f} ms"
            + (f", dense pair band {f['dense_pair_ms']:.3f} ms, plain band "
               f"{f['plain_band_ms']:.3f} ms" if "dense_pair_ms" in f
               else ""))
    band_per = {}
    for T in BAND_TIMED_T:
        sel = [r for r in band if r["T"] == T]
        f = {k: LAYERS * sum(r[k] for r in sel)
             for k in ("ms", "library_ms", "k8_ms", "bound_ms", "bytes_ms",
                       "ops_ms", "k10_ms", "k10_plain_ms", "k10_bound_ms")}
        f["plain_ms"] = (LAYERS * sum(r["plain_ms"] for r in sel)
                         if T in PLAIN_BAND_T else None)
        f["bound_by"] = ("bytes" if f["bytes_ms"] >= f["ops_ms"]
                         else "operations")
        f["launches"] = LAYERS * len(sel)
        band_per[T] = f
        log(f"  dense pair band per forward at T={T} ({f['launches']} K10 "
            f"launches): {f['ms']:.3f} ms, bound {f['bound_ms']:.3f} ms "
            f"({f['bound_by']}); K10 {f['k10_ms']:.3f} ms (bound "
            f"{f['k10_bound_ms']:.3f}, plain {f['k10_plain_ms']:.1f}); "
            f"torch.matmul bf16 {f['library_ms']:.3f} ms; K8 route "
            f"{f['k8_ms']:.3f} ms"
            + ("" if f["plain_ms"] is None else
               f"; plain band {f['plain_ms']:.1f} ms"))
    results["pair_variants_time"] = dict(rows=rows, per_forward=per,
                                         band=band, band_per_forward=band_per)


def phase_body_time(dev, gen, results):
    """K1's two bodies, each launched directly, at BODY_TIMED_T on the four
    layer shapes, beside the bound, dense bf16 ``torch.matmul`` and (from
    256 rows) the plain version; weights rotating over a 32-layer stack.
    Per-forward sums (32 x the four shapes, no lm_head: an admission
    chunk's runs at T = 1) at every T, and the crossover: the fewest
    timed rows at which the tensor-core body is the faster."""
    from quantizations_tpu_torch.ops import qmatmul as qm

    rows = []
    for name, M, K in K1_SHAPES:
        if name == "lm_head":
            continue
        L = LAYERS
        wp2, scales = _pair_operands(M, K, L, dev, gen)
        R = max(2, math.ceil(4 * L2_BYTES / (M * K * 2)))
        Wd = torch.randn(R, M, K, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(max(BODY_TIMED_T), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        for T in BODY_TIMED_T:
            xt = x[:T].contiguous()
            cc = device_ms(lambda i: qm.matmul_4bit_pair_cuda_core(
                wp2[i % L], scales[i % L], xt, "fp4"), 8 if T > 128 else 64)
            mm = device_ms(lambda i: qm.matmul_4bit_pair_mma(
                wp2[i % L], scales[i % L], xt, "fp4"), 64)
            lms = device_ms(lambda i: torch.matmul(xt, Wd[i % R].T), 64)
            pms = (device_ms(lambda i: qm.matmul_4bit_pair_plain(
                wp2[0], scales[0], xt, "fp4"), 2, warmup=1)
                if T >= 256 else None)
            nbytes = M * K // 2 + M * (K // 64) * 4 + T * K * 2 + T * M * 4
            bms, by = bound(nbytes, 2 * T * M * K)
            rows.append(dict(shape=name, M=M, K=K, T=T, cuda_core_ms=cc,
                             mma_ms=mm, plain_ms=pms, library_ms=lms,
                             bound_ms=bms, bound_by=by,
                             tiles=qm.pair_mma_tiles(T),
                             bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             ops_ms=2 * T * M * K / BF16_FLOP_PER_S * 1e3))
            log(f"  K1 bodies {name:8s} T={T:3d}: CUDA-core {cc * 1e3:9.2f} us"
                f"  tensor-core {mm * 1e3:8.2f} us (tiles "
                f"{qm.pair_mma_tiles(T)})  bound {bms * 1e3:8.2f} us "
                f"({by})  torch.matmul bf16 {lms * 1e3:8.2f} us")
        del wp2, scales, Wd, x
        torch.cuda.empty_cache()
    per = {}
    for T in BODY_TIMED_T:
        sel = [r for r in rows if r["T"] == T]
        f = {k: LAYERS * sum(r[k] for r in sel)
             for k in ("cuda_core_ms", "mma_ms", "library_ms", "bound_ms",
                       "bytes_ms", "ops_ms")}
        if T >= 256:
            f["plain_ms"] = LAYERS * sum(r["plain_ms"] for r in sel)
        f["bound_by"] = ("bytes" if f["bytes_ms"] >= f["ops_ms"]
                         else "operations")
        f["launches"] = LAYERS * len(sel)
        f["mma_tflops"] = (2 * T * LAYERS * sum(r["M"] * r["K"] for r in sel)
                           / (f["mma_ms"] * 1e-3) / 1e12)
        per[T] = f
        log(f"  K1 per forward at T={T} ({f['launches']} launches): "
            f"CUDA-core body {f['cuda_core_ms']:.3f} ms, tensor-core body "
            f"{f['mma_ms']:.3f} ms ({f['mma_tflops']:.0f} TFLOP/s), bound "
            f"{f['bound_ms']:.3f} ms ({f['bound_by']}), torch.matmul bf16 "
            f"{f['library_ms']:.3f} ms"
            + (f", plain {f['plain_ms']:.1f} ms" if T >= 256 else ""))
    cross = {}
    for name, _, _ in K1_SHAPES[:4]:
        faster = [r["T"] for r in rows
                  if r["shape"] == name and r["mma_ms"] < r["cuda_core_ms"]]
        cross[name] = min(faster) if faster else None
    log(f"  crossover (fewest timed rows where the tensor-core body is "
        f"faster): {cross}; K1 switches at {qm.PAIR_MMA_MIN_TOKENS}")
    results["body_time"] = dict(rows=rows, per_forward=per, crossover=cross,
                                tiles=_tile_sweep(dev, gen))


def _tile_sweep(dev, gen):
    """The tensor-core body at T = 128, 256 and 512 on the four layer
    shapes with every row tile (bn = 128), beside the tile rule's choice:
    the data for the rule (``ops/qmatmul.py pair_mma_tiles``)."""
    from quantizations_tpu_torch.ops import PAIR_MATMUL_MMA
    from quantizations_tpu_torch.ops import qmatmul as qm

    out = []
    for name, M, K in K1_SHAPES[:4]:
        wp2, scales = _pair_operands(M, K, LAYERS, dev, gen)
        x = torch.randn(512, K, generator=gen, device=dev).to(torch.bfloat16)
        for T in (128, 256, 512):
            xt = x[:T].contiguous()
            ms = {bm: device_ms(lambda i: qm._launch_pair(
                wp2[i % LAYERS], scales[i % LAYERS], xt, "fp4",
                PAIR_MATMUL_MMA, "qt_pair_mma", (bm, 128)), 32)
                for bm in (32, 64, 128)}
            rule = qm.pair_mma_tiles(T)
            out.append(dict(shape=name, T=T, rule=rule, ms=ms))
            log(f"  tiles {name:8s} T={T}: " + "  ".join(
                f"bm {bm}: {v * 1e3:8.2f} us" for bm, v in ms.items())
                + f"  (rule {rule})")
        del wp2, scales, x
        torch.cuda.empty_cache()
    return out


def _generate_runs(gen, params, ids, cfg, serve, dev, kernels, want, what):
    """Six greedy generates (a warm-up and 5 timed) that must launch each
    of ``kernels`` exactly ``want`` times and give the same tokens every
    time. Returns (tokens, times in s)."""
    from quantizations_tpu_torch.models.llama import KVCache

    times, first = [], None
    B = ids.shape[0]
    for it in range(5 + 1):
        cache = KVCache.create(cfg, B, serve.max_seq_len, dev)
        before = [k.launches for k in kernels]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        toks, _ = gen(params, ids, cache, None)
        end.record()
        end.synchronize()
        got = tuple(k.launches - b for k, b in zip(kernels, before))
        if got != tuple(want):
            names = ", ".join(k.name for k in kernels)
            raise AssertionError(f"{what}: ({names}) launched {got}, "
                                 f"expected {tuple(want)}")
        if toks.shape != (B, serve.max_new_tokens) or int(
                toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"{what}: tokens out of range")
        if first is None:
            first = toks.cpu()
        elif not torch.equal(first, toks.cpu()):
            raise AssertionError(f"{what}: tokens differ between runs")
        if it:
            times.append(start.elapsed_time(end) / 1e3)
        del cache
    return first, times


def phase_pair_variants_model(dev, params, results):
    """The knobs end to end on the model phase's FP4 Llama3-8B:
    ``pair_pipeline="manual"`` generates at B = 1, 4, 8 with exact K9/K1
    counts and the model phase's grid tokens; ``QT_PREFILL_PAIR=1``
    generates after a 1024-token prompt with exactly 256 K8 and 7612 K1
    launches, and its prefill forward is timed beside the dense pair
    path's."""
    from quantizations_tpu_torch.config import QuantConfig, ServeConfig
    from quantizations_tpu_torch.models.llama import (LLAMA3_8B, KVCache,
                                                      prefill)
    from quantizations_tpu_torch.nn import linear as tlin
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR, KERNELS,
                                             PAIR_MANUAL, PAIR_MATMUL,
                                             PAIR_PREFILL)
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    base = dataclasses.replace(LLAMA3_8B, quant=QuantConfig(
        quantize_embedding=True))
    manual = dataclasses.replace(LLAMA3_8B, quant=QuantConfig(
        quantize_embedding=True, pair_pipeline="manual"))
    serve = ServeConfig(max_seq_len=128, max_new_tokens=60, temperature=0.0)
    grid_tokens = {r["batch"]: r["tokens"] for r in results["generate"]
                   if r["quant_type"] == "fp4" and r["attention"] == "einsum"}
    ids = ((torch.arange(PROMPT_LEN, device=dev) * 7 + 11) % base.vocab_size
           ).to(torch.int32)[None, :]
    gen = make_generate_fn(manual, serve)
    runs = []
    for k in KERNELS:
        k.launches = 0
    for B in PV_BATCHES:
        want = MANUAL_LAUNCHES[B]
        toks, times = _generate_runs(gen, params, ids.repeat(B, 1), manual,
                                     serve, dev, (PAIR_MANUAL, PAIR_MATMUL,
                                                  DEQUANTIZE_4BIT_PAIR),
                                     want + (0,), f"manual B={B}")
        if toks.tolist() != grid_tokens[B]:
            raise AssertionError(f"manual B={B}: tokens differ from the grid "
                                 "run's")
        t = statistics.median(times)
        n = serve.max_new_tokens * B
        runs.append(dict(batch=B, tok_per_s=n / t, tok_per_s_min=n / max(times),
                         tok_per_s_max=n / min(times), generate_s=t,
                         generate_s_all=times, launches_per_generate=dict(
                             pair_manual=want[0], pair_matmul=want[1])))
        log(f"  manual B={B}: {n / t:.2f} tok/s, median of 5 (min "
            f"{n / max(times):.2f}, max {n / min(times):.2f}); K9/K1 "
            f"launches {want} each; the grid run's tokens")
    results["launches_pair_manual"] = {k.name: k.launches for k in KERNELS}
    results["pair_manual_generate"] = runs

    # QT_PREFILL_PAIR: a 1024-token prompt, one 1024-row prefill forward
    long_serve = ServeConfig(max_seq_len=LONG_PROMPT + 128,
                             max_new_tokens=60, temperature=0.0)
    long_ids = torch.randint(1, base.vocab_size, (1, LONG_PROMPT),
                             generator=torch.Generator().manual_seed(3)
                             ).to(dev)
    gen = make_generate_fn(base, long_serve)
    layers = base.num_hidden_layers
    want = (4 * layers * math.ceil(LONG_PROMPT / 512),     # K8: 2 chunks
            60 * (4 * layers + 1) - 4 * layers)            # K1: the rest
    os.environ["QT_PREFILL_PAIR"] = "1"
    try:
        for k in KERNELS:
            k.launches = 0
        toks, times = _generate_runs(gen, params, long_ids, base, long_serve,
                                     dev, (PAIR_PREFILL, PAIR_MATMUL,
                                           DEQUANTIZE_4BIT_PAIR), want + (0,),
                                     "QT_PREFILL_PAIR generate")
        results["launches_pair_prefill"] = {k.name: k.launches
                                            for k in KERNELS}
    finally:
        del os.environ["QT_PREFILL_PAIR"]
    t = statistics.median(times)
    log(f"  QT_PREFILL_PAIR B=1, {LONG_PROMPT}-token prompt: "
        f"{60 / t:.2f} tok/s, median of 5 (min {60 / max(times):.2f}, max "
        f"{60 / min(times):.2f}); K8/K1 launches {want} each; the same "
        "tokens every run")

    # the prefill forward alone on three routes, in turns: with the knob
    # (K8), without it (the dense pair band: K10 and the bf16 product) and
    # the plain band (the fp32 route before K10, patched in here only)
    band_fn = tlin.dense_matmul_pair
    ms = {"k8": [], "band": [], "plain": []}
    want_k10 = {"k8": 0, "band": 4 * layers, "plain": 0}
    first = {}
    with torch.inference_mode():
        for route in ("k8", "band", "plain", "plain", "band", "k8") * 2:
            if route == "k8":
                os.environ["QT_PREFILL_PAIR"] = "1"
            elif route == "plain":
                tlin.dense_matmul_pair = tlin.dense_matmul_pair_plain
            try:
                cache = KVCache.create(base, 1, LONG_PROMPT + 128, dev)
                before = DEQUANTIZE_4BIT_PAIR.launches
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                logits, _ = prefill(params, long_ids, cache, base,
                                    last_token_only=True)
                end.record()
                end.synchronize()
            finally:
                os.environ.pop("QT_PREFILL_PAIR", None)
                tlin.dense_matmul_pair = band_fn
            got = DEQUANTIZE_4BIT_PAIR.launches - before
            if got != want_k10[route]:
                raise AssertionError(f"{route} prefill forward: K10 launched "
                                     f"{got} times, expected "
                                     f"{want_k10[route]}")
            ms[route].append(start.elapsed_time(end))
            first.setdefault(route, logits.float().cpu())
            del cache

    def apart(a, b):
        return ((first[a] - first[b]).abs().max()
                / first[b].abs().max()).item()

    rel, rel_plain = apart("k8", "band"), apart("band", "plain")
    if not rel <= 0.25:
        raise AssertionError(f"K8 prefill logits {rel:.3e} of max|logit| "
                             "from the dense pair band's")
    if not rel_plain <= 0.25:
        raise AssertionError(f"dense pair band prefill logits "
                             f"{rel_plain:.3e} of max|logit| from the plain "
                             "band's")
    pf = {r: dict(median_ms=statistics.median(v), all_ms=v)
          for r, v in ms.items()}
    log(f"  prefill forward of {LONG_PROMPT} rows: K8 route "
        f"{pf['k8']['median_ms']:.2f} ms, dense pair band "
        f"{pf['band']['median_ms']:.2f} ms ({4 * layers} K10 launches), plain"
        f" band {pf['plain']['median_ms']:.2f} ms (medians of 4, in turns);"
        f" last-token logits: K8 {rel:.3e} of max|logit| from the band (a "
        f"layout check: the band rounds fp32 scales), the band {rel_plain:.3e}"
        " from the plain band (the same bf16 values, fp32 sums in another "
        "order)")
    results["pair_prefill_generate"] = dict(
        prompt=LONG_PROMPT, tok_per_s=60 / t, generate_s_all=times,
        launches_per_generate=dict(pair_prefill=want[0],
                                   pair_matmul=want[1]),
        prefill_forward=pf, k10_per_forward=want_k10,
        logits_k8_vs_band=rel, logits_band_vs_plain=rel_plain,
        tokens=toks.tolist())


def phase_pair_variants_paged(dev, params, results):
    """One ``PagedEngine`` run with the paged phase's configuration and
    requests (bf16 pool) without ``QT_PREFILL_PAIR``, then one with it.
    K8 must launch 128 x ceil(rows / 512) times for every admission
    forward of more than ``pair_max_tokens()`` rows that are a multiple
    of 8, and never without the knob."""
    from quantizations_tpu_torch.config import QuantConfig
    from quantizations_tpu_torch.models.llama import LLAMA3_8B
    from quantizations_tpu_torch.nn.linear import pair_max_tokens

    base = dataclasses.replace(LLAMA3_8B, quant=QuantConfig(
        quantize_embedding=True))
    prompts = _paged_prompts(base.vocab_size)
    default = _serve_paged(params, base, prompts, "bf16")
    os.environ["QT_PREFILL_PAIR"] = "1"
    try:
        knob = _serve_paged(params, base, prompts, "bf16")
    finally:
        del os.environ["QT_PREFILL_PAIR"]
    proj = 4 * base.num_hidden_layers
    band = pair_max_tokens()
    want = sum(proj * math.ceil(r / 512) for r in knob["admission_rows"]
               if r > band and r % 8 == 0)
    got = knob["launches"]["pair_prefill"]
    if got != want or default["launches"]["pair_prefill"] != 0:
        raise AssertionError(f"K8 launched {got} times in the paged run with "
                             f"QT_PREFILL_PAIR, expected {want} (admission "
                             f"rows {knob['admission_rows']}); "
                             f"{default['launches']['pair_prefill']} without")
    agree = sum(a == b for x, y in zip(knob["tokens"], default["tokens"])
                for a, b in zip(x, y))
    log(f"  QT_PREFILL_PAIR paged run: K8 launched {got} times (admission "
        f"forwards of {knob['admission_rows']} rows); admission "
        f"{knob['admit_s']:.3f} s, decode {knob['decode_s']:.3f} s, against "
        f"{default['admit_s']:.3f} s and {default['decode_s']:.3f} s "
        f"without it; {agree} of {PAGED_NEW * len(prompts)} tokens agree")
    results["pair_prefill_paged"] = dict(default=default, knob=knob,
                                         k8_launches=got, tokens_agree=agree)


def phase_pair_variants(dev, gen, results, params):
    """The fourth slice: K8 and K9 against their plain versions and K1,
    their times, the knobs end to end, and the paged engine with
    ``QT_PREFILL_PAIR``."""
    phase_pair_variants_check(dev, gen, results)
    phase_dense_band_check(dev, gen, results)
    phase_pair_variants_time(dev, gen, results)
    phase_body_time(dev, gen, results)
    phase_pair_variants_model(dev, params, results)
    phase_pair_variants_paged(dev, params, results)


def _paged_prompts(vocab_size):
    """The paged phase's 8 prompts: PAGED_LENS from seed 0 and one that
    shares the 700-token prompt's first 512 tokens."""
    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, vocab_size, (n,), generator=g).tolist()
               for n in PAGED_LENS]
    prompts.append(prompts[3][:512] + torch.randint(
        1, vocab_size, (188,), generator=g).tolist())
    return prompts


def _k1_cuda_core_launches(admission_rows, forwards, layers, proj=4):
    """K1's CUDA-core launches (``PAIR_MATMUL`` less ``PAIR_MATMUL_MMA``)
    in a serving run: ``proj * layers + 1`` per decode forward (a plain
    step or a verify window of at most ``PAIR_MMA_MIN_TOKENS - 1`` rows;
    ``proj`` 4 with fused projections, 7 without), as many per admission
    forward of that many rows, and one per larger admission forward (its
    lm_head samples one row per request)."""
    from quantizations_tpu_torch.ops import PAIR_MMA_MIN_TOKENS

    per = proj * layers + 1
    return per * forwards + sum(per if r < PAIR_MMA_MIN_TOKENS else 1
                                for r in admission_rows)


def _serve_paged(params, base, prompts, kv, spec_k=0, steps_per_dispatch=1):
    """One ``PagedEngine`` run over ``prompts`` (the paged phase's
    configuration) with a ``kv`` pool, driven by ``step`` or, with
    ``spec_k``, by ``step_spec`` (``step_spec_multi`` with
    ``steps_per_dispatch`` > 1). Counts are zeroed just before the run and
    read just after it. Returns the run's record: wall time split into
    admission and decode, steps, admission group sizes, the rows of every
    admission forward, launches, stats and tokens."""
    from quantizations_tpu_torch.models.llama import prefill_pair_enabled
    from quantizations_tpu_torch.nn.linear import pair_max_tokens
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             FLASH_DECODE, FLASH_DECODE_I8,
                                             KERNELS, PAIR_MATMUL,
                                             PAIR_MATMUL_MMA,
                                             PAIR_MMA_MIN_TOKENS)
    from quantizations_tpu_torch.serve.paged import PagedEngine

    cfg = dataclasses.replace(base, kv_cache_dtype=kv)
    eng = PagedEngine(params, cfg, slots=4, max_seq=2048,
                      prefill_buckets=(64, 256), admit_width=4,
                      prefix_cache=True, num_pages=40)
    if eng.page_size != 256:
        raise AssertionError(f"page size {eng.page_size}, expected 256")
    # instrumentation: admission wall time, group sizes, forward rows,
    # prefix hits
    spent = {"admit_s": 0.0, "groups": [], "hits": {}, "rows": []}
    admit, group, one, lookup, rnd = (eng._admit, eng._admit_group,
                                      eng._admit_one, eng._prefix_lookup,
                                      eng._prefill_round)

    def timed_admit():
        torch.cuda.synchronize()
        t = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        spent["admit_s"] += time.perf_counter() - t

    def counted_group(grp):
        spent["groups"].append(len(grp))
        return group(grp)

    def counted_one(slot, r):
        spent["groups"].append(1)
        return one(slot, r)

    def seen_lookup(r):
        cov, shared = lookup(r)
        spent["hits"][r.uid] = max(spent["hits"].get(r.uid, 0), cov)
        return cov, shared

    def counted_round(ids, *a):
        spent["rows"].append(int(ids.shape[0] * ids.shape[1]))
        return rnd(ids, *a)

    eng._admit, eng._admit_group = timed_admit, counted_group
    eng._admit_one, eng._prefix_lookup = counted_one, seen_lookup
    eng._prefill_round = counted_round
    uids = [eng.submit(p, max_new_tokens=PAGED_NEW) for p in prompts]
    if spec_k and steps_per_dispatch > 1:
        step = lambda: eng.step_spec_multi(spec_k, steps_per_dispatch)  # noqa
    elif spec_k:
        step = lambda: eng.step_spec(spec_k)                          # noqa
    else:
        step = eng.step
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work():
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    st = eng.stats()
    toks = [eng.finished[u].output_ids for u in uids]
    for u, t in zip(uids, toks):
        if len(t) != PAGED_NEW or min(t) < 0 or max(t) >= base.vocab_size:
            raise AssertionError(f"request {u}: {len(t)} tokens, range "
                                 f"{min(t)}..{max(t)}")
    attn = FLASH_DECODE_I8 if kv == "int8" else FLASH_DECODE
    other = FLASH_DECODE if kv == "int8" else FLASH_DECODE_I8
    layers = base.num_hidden_layers
    if launches[attn.name] != layers * st["steps"]:
        raise AssertionError(f"{attn.name} launched "
                             f"{launches[attn.name]} times in "
                             f"{st['steps']} steps")
    if launches[other.name] != 0:
        raise AssertionError(f"{other.name} launched on a {kv} pool")
    # K1's tensor-core body: every projection of an admission forward of
    # PAIR_MMA_MIN_TOKENS .. pair_max_tokens() rows (4 per layer; its
    # lm_head samples one row)
    mma = launches[PAIR_MATMUL_MMA.name]
    core = launches[PAIR_MATMUL.name] - mma
    want_core = _k1_cuda_core_launches(spent["rows"], st["steps"], layers)
    if core != want_core:
        raise AssertionError(f"K1's CUDA-core body launched {core} times in "
                             f"{st['steps']} forwards, expected {want_core} "
                             f"(admission rows {spent['rows']})")
    want_mma = 4 * layers * sum(
        1 for r in spent["rows"]
        if PAIR_MMA_MIN_TOKENS <= r <= pair_max_tokens())
    if mma != want_mma or want_mma == 0:
        raise AssertionError(f"K1's tensor-core body launched {mma} times, "
                             f"expected {want_mma} (admission rows "
                             f"{spent['rows']})")
    # K10: every projection of an admission forward above the K1 band (4
    # per layer), unless QT_PREFILL_PAIR sends it to K8 (rows % 8 == 0)
    knob = prefill_pair_enabled()
    k10 = launches[DEQUANTIZE_4BIT_PAIR.name]
    want_k10 = 4 * layers * sum(
        1 for r in spent["rows"]
        if r > pair_max_tokens() and not (knob and r % 8 == 0))
    if k10 != want_k10 or (want_k10 == 0 and not knob):
        raise AssertionError(f"K10 launched {k10} times, expected "
                             f"{want_k10} (admission rows {spent['rows']}"
                             f"{', QT_PREFILL_PAIR' if knob else ''})")
    usable = eng.alloc.num_usable
    if (st["pages_free"] != usable - st["prefix_cache_pages"]
            or st["live_tokens"] != 0 or st["finished"] != len(prompts)):
        raise AssertionError(f"pool not returned: {st}")
    if spent["hits"].get(uids[-1], 0) != 512:
        raise AssertionError(f"the eighth request hit "
                             f"{spent['hits'].get(uids[-1])} prefix "
                             "positions, expected 512")
    new = PAGED_NEW * len(prompts)
    run = dict(kv_cache_dtype=kv, spec_k=spec_k,
               steps_per_dispatch=steps_per_dispatch, wall_s=wall,
               new_tokens=new, tok_per_s=new / wall, admit_s=spent["admit_s"],
               decode_s=wall - spent["admit_s"], steps=st["steps"],
               admissions=spent["groups"], admission_rows=spent["rows"],
               mma_launches=mma, k1_cuda_core_launches=core,
               k10_launches=k10, launches=launches, stats=st, tokens=toks)
    how = (f"spec_k={spec_k} x {steps_per_dispatch}: {st['spec_windows']} "
           f"windows, accept rate {st['spec_accept_rate']:.3f}, "
           if spec_k else "")
    log(f"  {kv} pool, {how}{new} new tokens in {wall:.3f} s = "
        f"{new / wall:.2f} tok/s aggregate; {st['steps']} forwards; "
        f"admission {spent['admit_s']:.3f} s (groups {spent['groups']}),"
        f" decode {wall - spent['admit_s']:.3f} s; K1's CUDA-core body "
        f"{core} launches, its tensor-core body {mma}, K10 {k10} (as "
        f"reckoned); launches {launches}; "
        f"pages free {st['pages_free']} of {usable} "
        f"({st['prefix_cache_pages']} pinned by the prefix cache)")
    return run


def phase_paged(dev, params, results):
    """The slice's path: ``PagedEngine`` serving 8 greedy requests of 32
    new tokens on full Llama3-8B FP4 (the model phase's parameters) with
    a bf16 pool, again on a fresh engine, then with an int8 pool. Counts
    are zeroed just before each run and read just after it."""
    from quantizations_tpu_torch.config import QuantConfig
    from quantizations_tpu_torch.models.llama import LLAMA3_8B

    base = dataclasses.replace(LLAMA3_8B, quant=QuantConfig(
        quantize_embedding=True))
    prompts = _paged_prompts(base.vocab_size)
    runs = [_serve_paged(params, base, prompts, "bf16"),
            _serve_paged(params, base, prompts, "bf16")]
    if runs[1]["tokens"] != runs[0]["tokens"]:
        raise AssertionError("a fresh engine gave other tokens")
    runs.append(_serve_paged(params, base, prompts, "int8"))
    agree = sum(a == b for x, y in zip(runs[2]["tokens"], runs[0]["tokens"])
                for a, b in zip(x, y))
    log(f"  int8 pool agrees with the bf16 pool on {agree} of "
        f"{PAGED_NEW * len(prompts)} tokens")
    results["paged"] = dict(runs=runs, int8_agree=agree)
    results["launches_paged"] = runs[0]["launches"]
    results["launches_paged_int8"] = runs[2]["launches"]


def _spec_window_tiny(dev, results):
    """The paged verify window on a tiny GQA model (TINY_LLAMA with 2 kv
    heads: 4 query heads each, Llama3-8B's ratio) on the card against
    the CPU's plain path on the same parameters and pool: bf16 and int8
    pools of random pages, windows of 4 and 8 tokens (8 x 4 = 32 query
    rows, K3/K4's most), row 0's across a page boundary. Logits within
    2e-2 * max|logit| (the model phase's tiny check); the positions
    outside the windows untouched; ``write_window`` on the same rows
    bit-equal to the CPU's; K3/K4 launched once per layer."""
    from quantizations_tpu_torch.config import QuantConfig
    from quantizations_tpu_torch.models.llama import (
        TINY_LLAMA, fuse_projections, init_llama_params, map_tensors)
    from quantizations_tpu_torch.ops import FLASH_DECODE, FLASH_DECODE_I8
    from quantizations_tpu_torch.serve.paged import (PagedKVCache,
                                                     paged_verify_step,
                                                     write_window)

    out = []
    base = dataclasses.replace(TINY_LLAMA, num_key_value_heads=2,
                               quant=QuantConfig(quantize_embedding=True))
    p_gpu = fuse_projections(init_llama_params(base, seed=1, device=dev))
    p_cpu = map_tensors(lambda t: t.cpu(), p_gpu)
    page = 16
    table = torch.tensor([[3, 6, 0, 0], [5, 0, 0, 0]], dtype=torch.int32)
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(base, kv_cache_dtype=kv)
        kern = FLASH_DECODE_I8 if kv == "int8" else FLASH_DECODE
        for k in (4, 8):
            g = torch.Generator().manual_seed(k)
            pool_c = PagedKVCache.create(cfg, 8, page, device="cpu")
            for t in pool_c.tensors():
                t.copy_(torch.randint(-127, 128, t.shape, generator=g)
                        if t.dtype == torch.int8 else
                        torch.rand(t.shape, generator=g)
                        * (0.02 if t.dim() == 4 else 1.0))
            before = [t.clone() for t in pool_c.tensors()]
            pool_g = PagedKVCache(*[t.to(dev) for t in pool_c.tensors()])
            pos = torch.tensor([page - k // 2, 3])   # row 0 crosses a page
            feed = torch.randint(1, cfg.vocab_size, (2, k), generator=g)
            n0 = kern.launches
            lg, pool_g = paged_verify_step(p_gpu, feed.to(dev), pool_g,
                                           table.to(dev), pos.to(dev), cfg, 2)
            torch.cuda.synchronize()
            n = kern.launches - n0
            lc, pool_c = paged_verify_step(p_cpu, feed, pool_c, table, pos,
                                           cfg, 2)
            err = (lg.cpu() - lc).abs().max().item()
            scale = lc.abs().max().item()
            if n != cfg.num_hidden_layers or not err <= 2e-2 * scale:
                raise AssertionError(
                    f"tiny {kv} window of {k}: {kern.name} launched {n} "
                    f"times, max|err| {err:.3e} of max|logit| {scale:.3f}")
            written = torch.zeros((8, page), dtype=torch.bool)
            for b in range(2):
                for q in range(int(pos[b]), int(pos[b]) + k):
                    written[table[b, q // page], q % page] = True
            for tg, tc, tb in zip(pool_g.tensors(), pool_c.tensors(),
                                  before):
                keep = ~written[None, :, None, :].expand(tb.shape[:4])
                if not (torch.equal(tg.cpu()[keep], tb[keep])
                        and torch.equal(tc[keep], tb[keep])):
                    raise AssertionError(f"tiny {kv} window of {k} wrote "
                                         "outside its positions")
            kk = torch.randn((2, k, 2, 64), generator=g)
            vv = torch.randn((2, k, 2, 64), generator=g)
            qpos = pos[:, None] + torch.arange(k)[None]
            page_of = table.long().gather(1, qpos // page)
            for pool, d in ((pool_g, dev), (pool_c, "cpu")):
                write_window(pool, 0, page_of.to(d), (qpos % page).to(d),
                             kk.to(d), vv.to(d))
            torch.cuda.synchronize()
            if not all(torch.equal(tg[0].cpu(), tc[0]) for tg, tc in zip(
                    pool_g.tensors(), pool_c.tensors())):
                raise AssertionError(f"tiny {kv} window write of {k} rows "
                                     "differs from the CPU's")
            out.append(dict(kv=kv, k=k, launches=n, max_abs_err=err,
                            max_abs_logit=scale))
            log(f"  TINY_LLAMA (G = 4) {kv} window of {k} ({4 * k} query "
                f"rows), CUDA vs CPU plain: max|err| {err:.3e} (max|logit| "
                f"{scale:.3f}); {kern.name} {n} launches; the window write "
                "bit-equal")
    results["spec_tiny"] = out


def _forward_ms(fn, reps=5):
    """Median wall of ``fn()`` in ms, from CUDA events (the host's
    enqueue included), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _window_times(params, base, dev):
    """One verify window (B = 4, T = 8) against one plain step (T = 1)
    over the paged phase's pool at 1900 live tokens a row: ms per
    forward, the median of 5 (CUDA events; the host included). The
    window's logits at its first position must be within 2e-2 *
    max|logit| of the step's on the same token and pool (the tiny check's
    tolerance): the same position through K3/K4 at q_span 8 and 1."""
    from quantizations_tpu_torch.serve.paged import (PagedKVCache,
                                                     paged_decode_step,
                                                     paged_verify_step)

    out = {}
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(base, kv_cache_dtype=kv)
        pages = PagedKVCache.create(cfg, 40, 256, device=dev)
        table = (torch.arange(32, dtype=torch.int32).reshape(4, 8) + 1).to(dev)
        pos = torch.full((4,), 1900, dtype=torch.int64, device=dev)
        feed = ((torch.arange(32, device=dev) * 7 + 11) % cfg.vocab_size
                ).reshape(4, 8).to(torch.int32)
        win = _forward_ms(lambda: paged_verify_step(
            params, feed, pages, table, pos, cfg, 8))
        one = _forward_ms(lambda: paged_decode_step(
            params, feed[:, :1], pages, table, pos, cfg, 8))
        lw, _ = paged_verify_step(params, feed, pages, table, pos, cfg, 8)
        ls, _ = paged_decode_step(params, feed[:, :1], pages, table, pos, cfg,
                                  8)
        err = (lw[:, 0] - ls).abs().max().item()
        scale = ls.abs().max().item()
        if not err <= 2e-2 * scale:
            raise AssertionError(f"{kv} window's first position: max|err| "
                                 f"{err:.3e} against the step's, max|logit| "
                                 f"{scale:.3f}")
        out[kv] = dict(window_ms=win, step_ms=one, ratio=win / one,
                       logits_max_err=err, max_logit=scale)
        log(f"  {kv} pool, B=4 at 1900 tokens: one verify window (T=8) "
            f"{win:.3f} ms, one plain step {one:.3f} ms ({win / one:.2f}x; "
            "CUDA events, the host included); the window's first position "
            f"against the step: max|err| {err:.3e} (max|logit| {scale:.3f})")
        del pages
    return out


def _serve_slot(params, base, prompts, knobs, run):
    """One slot ``Engine(slots=4, max_seq=2048, prefill_buckets=(16, 64,
    256))`` run over ``prompts`` with config ``knobs`` and ``run``'s
    arguments. Counts are zeroed just before the run and read just after
    it: K1's CUDA-core body, its tensor-core body, K10 and K3/K4 exactly as
    the admission forwards' rows and the counted forwards say. Returns the
    run's record."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.nn.linear import pair_max_tokens
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             FLASH_DECODE, FLASH_DECODE_I8,
                                             KERNELS, PAIR_MATMUL,
                                             PAIR_MATMUL_MMA,
                                             PAIR_MMA_MIN_TOKENS)
    from quantizations_tpu_torch.serve.engine import Engine

    cfg = dataclasses.replace(base, **knobs)
    eng = Engine(params, cfg, ServeConfig(max_seq_len=2048), slots=4,
                 prefill_buckets=(16, 64, 256))
    rows, spent = [], {"admit_s": 0.0}
    rnd, admit = eng._prefill_round, eng._admit

    def counted_round(ids, *a):
        rows.append(int(ids.shape[0] * ids.shape[1]))
        return rnd(ids, *a)

    def timed_admit():
        torch.cuda.synchronize()
        t = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        spent["admit_s"] += time.perf_counter() - t

    eng._prefill_round, eng._admit = counted_round, timed_admit
    uids = [eng.submit(p, max_new_tokens=PAGED_NEW) for p in prompts]
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(**run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    st = eng.stats()
    toks = [eng.finished[u].output_ids for u in uids]
    for u, t in zip(uids, toks):
        if len(t) != PAGED_NEW or min(t) < 0 or max(t) >= base.vocab_size:
            raise AssertionError(f"slot engine, request {u}: {len(t)} "
                                 f"tokens, range {min(t)}..{max(t)}")
    layers = base.num_hidden_layers
    band = pair_max_tokens()
    mma = launches[PAIR_MATMUL_MMA.name]
    want = dict(
        core=_k1_cuda_core_launches(rows, st["steps"], layers),
        mma=4 * layers * sum(1 for r in rows
                             if PAIR_MMA_MIN_TOKENS <= r <= band),
        k10=4 * layers * sum(1 for r in rows if r > band))
    got = dict(core=launches[PAIR_MATMUL.name] - mma, mma=mma,
               k10=launches[DEQUANTIZE_4BIT_PAIR.name])
    # K3/K4 in every plain decode step with the flash knob (a verify
    # window stays on the einsum path)
    flash = FLASH_DECODE_I8 if knobs.get("kv_cache_dtype") else FLASH_DECODE
    want_attn = {FLASH_DECODE.name: 0, FLASH_DECODE_I8.name: 0}
    if knobs.get("use_flash_attention"):
        want_attn[flash.name] = layers * (st["steps"] - st["spec_windows"])
    got_attn = {n: launches[n] for n in want_attn}
    if got != want or got_attn != want_attn or st["finished"] != len(
            prompts):
        raise AssertionError(f"slot engine {knobs} {run}: launches {got} "
                             f"{got_attn}, expected {want} {want_attn} "
                             f"(admission rows {rows}); {st}")
    new = PAGED_NEW * len(prompts)
    rec = dict(knobs=knobs, run=run, wall_s=wall, new_tokens=new,
               tok_per_s=new / wall, admit_s=spent["admit_s"],
               decode_s=wall - spent["admit_s"], admission_rows=rows,
               launches=launches, stats=st, tokens=toks)
    log(f"  slot Engine {knobs or 'einsum'} run({run}): {new / wall:.2f} "
        f"tok/s ({wall:.3f} s; admission {spent['admit_s']:.3f} s, decode "
        f"{wall - spent['admit_s']:.3f} s); {st['steps']} forwards"
        + (f", {st['spec_windows']} windows, accept rate "
           f"{st['spec_accept_rate']:.3f}" if st["spec_windows"] else "")
        + f"; K1 CUDA-core {got['core']}, tensor-core {got['mma']}, K10 "
        f"{got['k10']}, K3/K4 {got_attn} (as reckoned; admission rows "
        f"{rows})")
    return rec


def _agree(a, b):
    return sum(x == y for r, q in zip(a, b) for x, y in zip(r, q))


def phase_spec(dev, params, results):
    """Speculative decoding and the slot ``Engine`` at full Llama3-8B
    (the model phase's FP4 parameters): (a) the verify window on a tiny
    model against the CPU; (b) ``PagedEngine`` with the paged phase's
    configuration and 8 prompts through ``step_spec(8)`` (twice, fresh
    engines: the same tokens), ``step_spec_multi(8, 4)`` and
    ``step_spec(8)`` on an int8 pool, beside the paged phase's plain
    runs, and one verify window against one plain step; (c) the slot
    ``Engine(slots=4, max_seq=2048, prefill_buckets=(16, 64, 256))`` on
    the same prompts: ``run()`` twice (the same tokens),
    ``run(steps_per_dispatch=4)`` and ``run(spec_k=8)`` on the einsum
    path, ``run()`` with flash (K3) and with flash and an int8 cache
    (K4); (d) ``make_speculative_generate_fn`` at B = 1, k = 8, 60 new
    tokens after the model phase's prompt. Exact launch counts
    throughout; agreement with the plain streams is printed, not gated
    (bf16 near-ties flip between a T = 8 and a T = 1 forward)."""
    from quantizations_tpu_torch.config import QuantConfig, ServeConfig
    from quantizations_tpu_torch.models.llama import LLAMA3_8B, KVCache
    from quantizations_tpu_torch.ops import KERNELS, PAIR_MATMUL
    from quantizations_tpu_torch.serve.speculative import (
        make_speculative_generate_fn)

    _spec_window_tiny(dev, results)

    base = dataclasses.replace(LLAMA3_8B, quant=QuantConfig(
        quantize_embedding=True))
    prompts = _paged_prompts(base.vocab_size)
    plain = results["paged"]["runs"][1]            # the warm bf16 run
    paged = [_serve_paged(params, base, prompts, "bf16", spec_k=8),
             _serve_paged(params, base, prompts, "bf16", spec_k=8),
             _serve_paged(params, base, prompts, "bf16", spec_k=8,
                          steps_per_dispatch=4),
             _serve_paged(params, base, prompts, "int8", spec_k=8)]
    if paged[1]["tokens"] != paged[0]["tokens"]:
        raise AssertionError("a fresh speculative engine gave other tokens")
    for r in paged:
        r["plain_agree"] = _agree(r["tokens"], (
            results["paged"]["runs"][2] if r["kv_cache_dtype"] == "int8"
            else plain)["tokens"])
        log(f"  paged spec_k={r['spec_k']} x {r['steps_per_dispatch']} "
            f"{r['kv_cache_dtype']}: {r['tok_per_s']:.2f} tok/s against the "
            f"plain run's {plain['tok_per_s']:.2f}; {r['plain_agree']} of "
            f"{r['new_tokens']} tokens agree with the plain stream")
    window = _window_times(params, base, dev)

    slot = [_serve_slot(params, base, prompts, {}, {}),
            _serve_slot(params, base, prompts, {}, {}),
            _serve_slot(params, base, prompts, {}, dict(
                steps_per_dispatch=4)),
            _serve_slot(params, base, prompts, {}, dict(spec_k=8)),
            _serve_slot(params, base, prompts,
                        dict(use_flash_attention=True), {}),
            _serve_slot(params, base, prompts,
                        dict(use_flash_attention=True,
                             kv_cache_dtype="int8"), {})]
    if slot[1]["tokens"] != slot[0]["tokens"]:
        raise AssertionError("a fresh slot engine gave other tokens")
    for r in slot[2:]:
        r["plain_agree"] = _agree(r["tokens"], slot[0]["tokens"])
    log("  slot Engine tokens agreeing with its plain run: "
        + ", ".join(f"{r['knobs'] or 'einsum'} {r['run'] or 'run()'} "
                    f"{r['plain_agree']}" for r in slot[2:])
        + f" of {slot[0]['new_tokens']}; with the paged engine's plain "
        f"run: {_agree(slot[0]['tokens'], plain['tokens'])}")

    serve = ServeConfig(max_seq_len=128, max_new_tokens=60)
    fn = make_speculative_generate_fn(base, serve, draft_k=8)
    ids = ((torch.arange(16, device=dev) * 7 + 11) % base.vocab_size
           ).to(torch.int32)[None, :]
    times, first = [], None
    for it in range(4):
        cache = KVCache.create(base, 1, serve.max_seq_len, dev)
        for k in KERNELS:
            k.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        toks, steps, _ = fn(params, ids, cache, None)
        end.record()
        end.synchronize()
        n = PAIR_MATMUL.launches
        if n != (4 * base.num_hidden_layers + 1) * (1 + steps):
            raise AssertionError(f"speculative generate: K1 launched {n} "
                                 f"times for {steps} windows")
        if toks.shape != (1, 60) or int(toks.min()) < 0 or int(
                toks.max()) >= base.vocab_size:
            raise AssertionError(f"speculative generate tokens bad: "
                                 f"{toks.shape}")
        if first is None:
            first = toks.cpu()
        elif not torch.equal(first, toks.cpu()):
            raise AssertionError("speculative generate: tokens differ "
                                 "between runs")
        if it:
            times.append(start.elapsed_time(end) / 1e3)
        del cache
    t = statistics.median(times)
    ref = next(r for r in results["generate"] if r["quant_type"] == "fp4"
               and r["attention"] == "einsum" and r["batch"] == 1)
    agree = _agree(first.tolist(), ref["tokens"])
    log(f"  speculative generate B=1, k=8: {steps} verify windows for 60 "
        f"tokens, {60 / t:.2f} tok/s (median of {len(times)}, {t:.4f} s) "
        f"against the plain generate's {ref['tok_per_s']:.2f}; {agree} of 60 "
        "tokens agree with it; K1 "
        f"{(4 * base.num_hidden_layers + 1) * (1 + steps)} launches a run")
    results["spec"] = dict(
        paged=paged, paged_plain=dict(tok_per_s=plain["tok_per_s"],
                                      admit_s=plain["admit_s"],
                                      decode_s=plain["decode_s"],
                                      steps=plain["steps"]),
        window_vs_step=window, slot=slot,
        generate=dict(windows=steps, tok_per_s=60 / t, generate_s=t,
                      generate_s_all=times, plain_tok_per_s=ref["tok_per_s"],
                      plain_agree=agree, tokens=first.tolist()))
    results["launches_spec"] = paged[0]["launches"]
    results["launches_spec_int8"] = paged[3]["launches"]


# the load phase: a synthetic HF checkpoint at Llama3-8B's width cut to 4
# of its 32 layers, written in 4 shards with an index (the per-layer code
# is the same at any depth; 32 layers would be 16.06 GB of bf16)
LOAD_LAYERS = 4
LOAD_SHARDS = 4
LOAD_SEED = 1000
LOAD_DISK_BYTES = 10 * 10 ** 9   # the source and one bnb export at a time
LOAD_NEW = 60
LOAD_PROMPT_LENS = (16, 37, 64, 150)     # the engines' 4 requests
WATCHDOG_NEW = 32
WATCHDOG_TIMEOUT_S = 5.0
# re-double-quantized scales move by at most half the dynamic map's widest
# gap times a block's largest |scale - mean|: under 1e-2 of the largest
# scale (tests/test_torch_hf_loader.py)
REDQ_TOL = 1e-2
LOAD_PROJ = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
             ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
             ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
             ("down", "mlp.down_proj"))


def _load_specs(base, layers=LOAD_LAYERS):
    """(name, shape, shard) of every tensor of the synthetic checkpoint,
    in write order: the embedding, the layers (two shards), the final
    norm and the lm_head."""
    H, V = base.hidden_size, base.vocab_size
    shapes = {"q": (base.q_size, H), "k": (base.kv_size, H),
              "v": (base.kv_size, H), "o": (H, base.q_size),
              "gate": (base.intermediate_size, H),
              "up": (base.intermediate_size, H),
              "down": (H, base.intermediate_size)}
    specs = [("model.embed_tokens.weight", (V, H), 1)]
    for i in range(layers):
        p, shard = f"model.layers.{i}.", 2 if i < layers // 2 else 3
        specs += [(p + "input_layernorm.weight", (H,), shard),
                  (p + "post_attention_layernorm.weight", (H,), shard)]
        specs += [(f"{p}{hf}.weight", shapes[a], shard) for a, hf in LOAD_PROJ]
    return specs + [("model.norm.weight", (H,), 4),
                    ("lm_head.weight", (V, H), 4)]


def _load_tensor(idx, name, shape, dev):
    """Tensor ``idx`` of the checkpoint: a norm is ones, a weight bf16
    normal of scale 0.02 from a generator seeded ``LOAD_SEED + idx`` (so
    the check regenerates it bit for bit)."""
    if name.endswith("norm.weight"):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(LOAD_SEED + idx)
    return (torch.randn(shape, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)


def _write_checkpoint(base, src, dev):
    """Write the HF directory: config.json, the shards through the port's
    own writer, model.safetensors.index.json. Returns the tensor bytes."""
    from quantizations_tpu_torch.models.safetensors_io import save_file

    specs = _load_specs(base)
    weight_map, total = {}, 0
    for shard in range(1, LOAD_SHARDS + 1):
        fname = f"model-{shard:05d}-of-{LOAD_SHARDS:05d}.safetensors"
        tensors = {name: _load_tensor(i, name, shape, dev).cpu()
                   for i, (name, shape, s) in enumerate(specs) if s == shard}
        save_file(tensors, os.path.join(src, fname),
                  metadata={"format": "pt"})
        for name, t in tensors.items():
            weight_map[name] = fname
            total += t.numel() * t.element_size()
        del tensors
    with open(os.path.join(src, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    with open(os.path.join(src, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"],
                   "model_type": "llama", "vocab_size": base.vocab_size,
                   "hidden_size": base.hidden_size,
                   "intermediate_size": base.intermediate_size,
                   "num_hidden_layers": LOAD_LAYERS,
                   "num_attention_heads": base.num_attention_heads,
                   "num_key_value_heads": base.num_key_value_heads,
                   "head_dim": base.head_dim, "rope_theta": base.rope_theta,
                   "rms_norm_eps": base.rms_norm_eps,
                   "max_position_embeddings":
                       base.max_position_embeddings,
                   "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"}, f, indent=1)
    return total


def _loaded_qlinears(params):
    """The checkpoint name of every 4-bit tensor of loaded params, with
    its (words, scales)."""
    lay = params.layers
    for i in range(LOAD_LAYERS):
        for attr, hf in LOAD_PROJ:
            ql = getattr(lay, attr)
            yield f"model.layers.{i}.{hf}.weight", ql.wp[i], ql.scales[i]
    for name, ql in (("model.embed_tokens.weight", params.embed),
                     ("lm_head.weight", params.lm_head)):
        yield name, ql.wp, ql.scales


def _counted(fn):
    """``(fn(), wall s, {kernel: launches})``: the counts zeroed just
    before the call and read just after it, the card synchronized around
    it."""
    from quantizations_tpu_torch.ops import KERNELS

    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k.name: k.launches for k in KERNELS if k.launches}


def _main_json(main, argv):
    """Run a CLI ``main(argv)`` in process; its last JSON line, captured so
    that this script's own last line stays last."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _expect(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _same_layers(a, b, what, scale_tol=0.0):
    """Every projection's words equal; scales equal, or within
    ``scale_tol`` of the largest scale."""
    for attr, _ in LOAD_PROJ:
        x, y = getattr(a.layers, attr), getattr(b.layers, attr)
        if not torch.equal(x.wp, y.wp):
            raise AssertionError(f"{what}: layers.{attr} words differ")
        err = (x.scales - y.scales).abs().max().item()
        if err > scale_tol * x.scales.abs().max().item():
            raise AssertionError(f"{what}: layers.{attr} scales {err:.3e} "
                                 "apart")


def _requantized_close(a, b, what):
    """A 4-bit table exported dense (bf16 code x scale) and quantized
    again: the same codes, but for a negative zero's code (8) that comes
    back positive (0), and scales within ``REDQ_TOL`` of the largest (a
    bf16 rounding and the double quantization again). Returns the scales'
    largest difference over the largest scale."""
    def canon(wp):
        planes = [(wp >> (4 * j)) & 15 for j in range(8)]
        return torch.stack([torch.where(p == 8, torch.zeros_like(p), p)
                            for p in planes])

    if not torch.equal(canon(a.wp), canon(b.wp)):
        raise AssertionError(f"{what}: codes differ beyond the sign of zero")
    rel = ((a.scales - b.scales).abs().max()
           / a.scales.abs().max()).item()
    if rel > REDQ_TOL:
        raise AssertionError(f"{what}: scales {rel:.3e} of the largest apart")
    return rel


def _cli_direct(kind, params, cfg, prompts, dev, rows):
    """The CLI run's direct counterpart on the same loaded params: the
    same function, arguments and seed. Engines record the rows of their
    admission forwards into ``rows``. Returns (tokens per request,
    forwards or windows run)."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.models.llama import KVCache
    from quantizations_tpu_torch.serve.engine import Engine
    from quantizations_tpu_torch.serve.generate import make_generate_fn
    from quantizations_tpu_torch.serve.paged import PagedEngine
    from quantizations_tpu_torch.serve.speculative import (
        make_speculative_generate_fn)

    serve = ServeConfig(max_seq_len=2048, max_new_tokens=LOAD_NEW)
    if kind in ("generate", "speculative"):
        fn = (make_speculative_generate_fn if kind == "speculative"
              else make_generate_fn)(cfg, serve)
        g = torch.Generator(device=dev)
        g.manual_seed(serve.seed)
        out = fn(params, torch.tensor(prompts, dtype=torch.int32,
                                      device=dev),
                 KVCache.create(cfg, 1, serve.max_seq_len, dev), g)
        return [out[0][0].tolist()], (out[1] if kind == "speculative"
                                      else LOAD_NEW)
    if kind == "slot":
        eng = Engine(params, cfg, serve, slots=4)
    else:
        eng = PagedEngine(params, cfg, num_pages=4 * (2048 // 128) + 8,
                          page_size=128, slots=4, max_seq=2048)
    rnd = eng._prefill_round

    def counted_round(ids, *a):
        rows.append(int(ids.shape[0] * ids.shape[1]))
        return rnd(ids, *a)

    eng._prefill_round = counted_round
    uids = [eng.submit(p, max_new_tokens=LOAD_NEW, temperature=0.0)
            for p in prompts]
    done = eng.run()
    return [done[u].output_ids for u in uids], eng.stats()["steps"]


def _cli_want(kind, flags, rows, forwards, L):
    """The direct run's launches by formula: K1's CUDA-core body per
    forward (and per admission forward up to 128 rows), its tensor-core
    body and K10 per larger admission forward, K3 or K4 per paged decode
    step."""
    from quantizations_tpu_torch.nn.linear import pair_max_tokens
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             FLASH_DECODE, FLASH_DECODE_I8,
                                             PAIR_MATMUL, PAIR_MATMUL_MMA,
                                             PAIR_MMA_MIN_TOKENS)

    proj = 4 if "--fuse" in flags else 7
    if kind in ("generate", "speculative"):
        windows = forwards if kind == "generate" else 1 + forwards
        return {PAIR_MATMUL.name: (proj * L + 1) * windows}
    band = pair_max_tokens()
    mma = proj * L * sum(1 for r in rows if PAIR_MMA_MIN_TOKENS <= r <= band)
    want = {PAIR_MATMUL.name: mma + _k1_cuda_core_launches(
                rows, forwards, L, proj),
            PAIR_MATMUL_MMA.name: mma,
            DEQUANTIZE_4BIT_PAIR.name: proj * L * sum(
                1 for r in rows if r > band)}
    if kind == "paged":
        attn = FLASH_DECODE_I8 if "int8" in flags else FLASH_DECODE
        want[attn.name] = L * forwards
    return {k: v for k, v in want.items() if v}


def _watchdog_run(params, cfg, prompts, dev):
    """The watchdog over a mixed pool on the loaded params: a slot
    ``Engine`` that raises at its fourth step (4 requests), a
    ``PagedEngine`` whose second step hangs past the deadline (2), a
    healthy ``PagedEngine`` (2). Checks that every request finishes with
    its length, the failures in order, the healthy pool's pages returned,
    and the healthy engine's own requests equal to an undisturbed run;
    prints the resumed requests' agreement with one."""
    import threading

    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.serve.engine import Engine
    from quantizations_tpu_torch.serve.paged import PagedEngine
    from quantizations_tpu_torch.serve.watchdog import Watchdog

    release = threading.Event()
    pool = dict(num_pages=4 * (2048 // 128) + 8, page_size=128, slots=4,
                max_seq=2048)

    class Failing(Engine):
        def step(self):
            if self._steps >= 3:
                raise RuntimeError("injected device failure")
            return super().step()

    class Hanging(PagedEngine):
        def step(self):
            if self._steps >= 1:
                release.wait(600)
                return 0              # abandoned: does no work
            return super().step()

    def undisturbed(ps):
        eng = PagedEngine(params, cfg, **pool)
        uids = [eng.submit(p, max_new_tokens=WATCHDOG_NEW) for p in ps]
        done = eng.run()
        return [done[u].output_ids for u in uids]

    engines = [Failing(params, cfg, ServeConfig(max_seq_len=2048), slots=4),
               Hanging(params, cfg, **pool), PagedEngine(params, cfg, **pool)]
    owner = [0, 0, 0, 0, 1, 1, 2, 2]
    reqs = []
    for e, p in zip(owner, prompts):
        engines[e].submit(p, max_new_tokens=WATCHDOG_NEW)
        reqs.append(engines[e].queue[-1])
    wd = Watchdog(engines, step_timeout_s=WATCHDOG_TIMEOUT_S)
    before = set(threading.enumerate())
    t0 = time.perf_counter()
    try:
        done = wd.run()
        torch.cuda.synchronize()
    finally:
        release.set()
    wall = time.perf_counter() - t0
    for t in set(threading.enumerate()) - before:    # the abandoned step
        t.join(60)
        if t.is_alive():
            raise AssertionError("watchdog: the hung step's thread lives on")
    if wd.dead != [True, True, False] or wd.failures != [1, 0]:
        raise AssertionError(f"watchdog: dead {wd.dead}, failures "
                             f"{wd.failures}")
    if len(done) != len(reqs) or any(
            not r.done or len(r.output_ids) != WATCHDOG_NEW for r in reqs):
        raise AssertionError("watchdog: a request did not finish with its "
                             "length")
    st = engines[2].stats()
    if (st["pages_free"] != engines[2].alloc.num_usable
            or st["live_tokens"] != 0):
        raise AssertionError(f"watchdog: the pool's pages did not return: "
                             f"{st}")
    if [r.output_ids for r in reqs[6:]] != undisturbed(prompts[6:]):
        raise AssertionError("watchdog: the healthy engine's own requests "
                             "differ from an undisturbed run")
    agree = _agree([r.output_ids for r in reqs[:6]], undisturbed(prompts[:6]))
    resumed = sum(len(r.prompt_ids) > len(p) for r, p in zip(reqs, prompts))
    log(f"  watchdog: dead {wd.dead}, failures {wd.failures} (a step hung "
        f"past {WATCHDOG_TIMEOUT_S} s, a step raised); {len(reqs)} requests "
        f"of {WATCHDOG_NEW} tokens in {wall:.3f} s; the healthy engine's own "
        f"2 equal to an undisturbed run; {resumed} resumed with their "
        f"tokens; the 6 moved agree with an undisturbed run on {agree} of "
        f"{6 * WATCHDOG_NEW} tokens; pages free {st['pages_free']}")
    return dict(wall_s=wall, dead=wd.dead, failures=wd.failures,
                resumed=resumed, moved_agree=agree,
                moved_tokens=6 * WATCHDOG_NEW, stats=wd.stats())


def phase_load(dev, results):
    """The checkpoint path and the command line at Llama3-8B's width
    (``LOAD_LAYERS`` of its 32 layers): write a sharded bf16 HF checkpoint
    with the port's own writer; load it with K2 on every weight (exact
    counts, every word and scale equal to ``quantize_linear`` of the
    regenerated weight on the card; wall, bytes read, K2's device ms);
    export and reload it in turns (bnb without and with double
    quantization through ``convert.main``, native, ``save_checkpoint``);
    serve it through the CLI (``generate`` with and without ``--fuse``,
    ``slot``, ``paged`` with page 128, ``paged --kv-dtype int8``,
    ``--speculative``), each run's tokens and launches equal to a direct
    call's; and run the watchdog over a mixed pool."""
    import importlib.util
    import shutil
    import tempfile

    from quantizations_tpu_torch import convert
    from quantizations_tpu_torch.config import QuantConfig
    from quantizations_tpu_torch.models.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
    from quantizations_tpu_torch.models.hf_loader import (load_hf_llama,
                                                          load_quantized)
    from quantizations_tpu_torch.models.llama import (LLAMA3_8B,
                                                      fuse_projections,
                                                      named_tensors,
                                                      quantize_linear)
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             QUANTIZE_4BIT,
                                             quantize_4bit_kernel)
    from quantizations_tpu_torch.serve.__main__ import main as serve_main

    L = LOAD_LAYERS
    base = LLAMA3_8B
    specs = _load_specs(base)
    full = sum(math.prod(s) * 2 for _, s, _ in _load_specs(
        base, base.num_hidden_layers))
    cut = sum(math.prod(s) * 2 for _, s, _ in specs)
    root = tempfile.mkdtemp(prefix="qt_load_")
    free = shutil.disk_usage(root).free
    log(f"  checkpoint: Llama3-8B width, {L} of {base.num_hidden_layers} "
        f"layers ({cut / 1e9:.2f} GB of bf16; all {base.num_hidden_layers} "
        f"would be {full / 1e9:.2f} GB, and twice that again in exports); "
        f"{free / 1e9:.1f} GB free under {root}")
    rec = dict(layers=L, bytes=cut, full_bytes=full, disk_free=free)
    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    try:
        if free < LOAD_DISK_BYTES:
            raise AssertionError(f"{free / 1e9:.1f} GB free, the phase needs "
                                 f"{LOAD_DISK_BYTES / 1e9:.0f}")
        src = os.path.join(root, "hf")
        os.makedirs(src)
        t0 = time.perf_counter()
        _write_checkpoint(base, src, dev)
        rec["write_s"] = time.perf_counter() - t0

        # -- load, with K2 on every weight --
        q_main = QuantConfig(quantize_embedding=True)
        (cfg, params), load_s, n = _counted(
            lambda: load_hf_llama(src, quant=q_main, device=dev))
        _expect("load", n, {QUANTIZE_4BIT.name: 7 * L + 2})
        add(n)
        regen = {name: (i, shape) for i, (name, shape, _) in enumerate(specs)}
        k2_ms = k2_bound = 0.0
        for name, wp, scales in _loaded_qlinears(params):
            W = _load_tensor(regen[name][0], name, regen[name][1], dev)
            want = quantize_linear(W, quant_type="fp4")
            if not (torch.equal(wp, want.wp)
                    and torch.equal(scales, want.scales)):
                raise AssertionError(f"load: {name} differs from "
                                     "quantize_linear on the card")
            k2_ms += device_ms(lambda _: quantize_4bit_kernel(W, 64, "fp4"),
                               3, warmup=1)
            k2_bound += bound(k2_bytes(*W.shape, 2), 0)[0]
            del W, want
        for _, t in named_tensors(params):
            if t.dtype == torch.bfloat16 and not torch.equal(
                    t, torch.ones_like(t)):
                raise AssertionError("load: a norm is not ones")
        rec.update(load_s=load_s, load_gb_per_s=cut / load_s / 1e9,
                   k2_ms=k2_ms, k2_bound_ms=k2_bound, k2_launches=n)
        log(f"  load: {load_s:.3f} s for {cut / 1e9:.2f} GB "
            f"({cut / load_s / 1e9:.2f} GB/s); K2 {n[QUANTIZE_4BIT.name]} "
            f"launches, {k2_ms:.3f} ms of device time (bound {k2_bound:.3f}"
            f"), every word and scale equal to quantize_linear on the card")

        # -- exports, each reloaded and deleted --
        exports = []
        for fmt, flags in (("bnb", ["--no-double-quant"]), ("bnb", []),
                           ("native", [])):
            out = os.path.join(root, "export" + (".safetensors"
                                                 if fmt == "native" else ""))
            crec, conv_s, n = _counted(lambda: _main_json(
                convert.main, ["--model", src, "--out", out, "--format", fmt,
                               "--device", dev.type] + flags))
            want = {QUANTIZE_4BIT.name: 7 * L + 1}   # its embedding stays dense
            if fmt == "bnb":
                want[DEQUANTIZE_4BIT_PAIR.name] = 1  # the lm_head, by K10
            _expect(f"convert {fmt} {flags}", n, want)
            add(n)
            what = f"{fmt}{' ' + flags[0] if flags else ''}"
            if fmt == "bnb":
                back, reload_s, n2 = _counted(lambda: load_hf_llama(
                    out, quant=q_main, device=dev)[1])
                _expect(f"reload {what}", n2, {QUANTIZE_4BIT.name: 2})
                add(n2)
                _same_layers(params, back, what,
                             0.0 if flags else REDQ_TOL)
                if not (torch.equal(params.embed.wp, back.embed.wp) and
                        torch.equal(params.embed.scales, back.embed.scales)):
                    raise AssertionError(f"{what}: the embedding differs")
                rel = _requantized_close(params.lm_head, back.lm_head,
                                         what + " lm_head")
            else:
                back, reload_s, n2 = _counted(lambda: load_quantized(
                    out, cfg, device=dev))
                _expect("reload native", n2, {})
                _same_layers(params, back, what)
                emb = _load_tensor(0, *specs[0][:2], dev)
                if not (torch.equal(back.embed, emb) and torch.equal(
                        back.lm_head.wp, params.lm_head.wp) and torch.equal(
                        back.lm_head.scales, params.lm_head.scales)):
                    raise AssertionError("native: embedding or lm_head "
                                         "differs")
                del emb
                rel = 0.0
            size = (os.path.getsize(out) if fmt == "native" else sum(
                os.path.getsize(os.path.join(out, f)) for f in os.listdir(
                    out)))
            exports.append(dict(format=what, convert_s=conv_s,
                                convert_json=crec, reload_s=reload_s,
                                bytes=size, lm_head_scale_rel=rel,
                                launches=n, reload_launches=n2))
            log(f"  {what}: convert {conv_s:.3f} s (its json {crec}), "
                f"{size / 1e9:.3f} GB, reload {reload_s:.3f} s; launches {n}"
                f", reload {n2}; words equal, lm_head scales within "
                f"{rel:.2e} of the largest")
            del back
            if fmt == "native":
                os.remove(out)
            else:
                shutil.rmtree(out)
        ck = os.path.join(root, "ckpt")
        _, save_s, _ = _counted(lambda: save_checkpoint(params, cfg, ck))
        (cfg2, back), reload_s, _ = _counted(lambda: load_checkpoint(
            ck, device=dev))
        if cfg2 != cfg or any(not torch.equal(a, b) for (_, a), (_, b) in zip(
                named_tensors(params), named_tensors(back))):
            raise AssertionError("save_checkpoint/load_checkpoint differ")
        exports.append(dict(format="checkpoint", save_s=save_s,
                            reload_s=reload_s))
        log(f"  checkpoint: saved {save_s:.3f} s, loaded {reload_s:.3f} s, "
            "every tensor equal")
        del back
        shutil.rmtree(ck)
        rec["exports"] = exports

        # -- the serving CLI, each run against a direct call --
        g = torch.Generator().manual_seed(LOAD_SEED)
        prompts = [torch.randint(1, base.vocab_size, (n,), generator=g
                                 ).tolist() for n in LOAD_PROMPT_LENS]
        one = [((torch.arange(16) * 7 + 11) % base.vocab_size).tolist()]
        cli_cfg, cli_params = load_hf_llama(src, quant=QuantConfig(),
                                            device=dev)
        # the CLI tries an optional tokenizer from transformers: where it
        # is installed, it stays offline (the directory holds none)
        rec["transformers"] = importlib.util.find_spec(
            "transformers") is not None
        os.environ["HF_HUB_OFFLINE"] = "1"
        os.environ["TRANSFORMERS_OFFLINE"] = "1"
        log(f"  transformers importable: {rec['transformers']}")
        cli = []
        for kind, flags in (("generate", []), ("generate", ["--fuse"]),
                            ("slot", ["--engine", "slot"]),
                            ("paged", ["--engine", "paged"]),
                            ("paged", ["--engine", "paged", "--kv-dtype",
                                       "int8"]),
                            ("speculative", ["--speculative"])):
            ps = prompts if kind in ("slot", "paged") else one
            ids = ";".join(",".join(map(str, p)) for p in ps)
            out, wall, n = _counted(lambda: _main_json(serve_main, [
                "--model", src, "--prompt-ids", ids, "--max-new-tokens",
                str(LOAD_NEW), "--device", dev.type] + flags))
            got = ([r["output_ids"] for r in out["requests"]]
                   if "requests" in out else [out["output_ids"]])
            cfg_d = (dataclasses.replace(cli_cfg, kv_cache_dtype="int8")
                     if "int8" in flags else cli_cfg)
            params_d = (fuse_projections(cli_params) if "--fuse" in flags
                        else cli_params)
            rows = []
            (toks, forwards), dwall, dn = _counted(lambda: _cli_direct(
                kind, params_d, cfg_d, ps, dev, rows))
            del params_d
            what = f"serve {' '.join(flags) or kind}"
            if got != toks or any(len(t) != LOAD_NEW for t in got):
                raise AssertionError(f"{what}: tokens differ from the "
                                     "direct call")
            _expect(what + " (direct)", dn, _cli_want(kind, flags, rows,
                                                      forwards, L))
            n_load = n.pop(QUANTIZE_4BIT.name, 0)
            _expect(what + " (CLI, its load aside)", n, dn)
            if n_load != 7 * L + 1:
                raise AssertionError(f"{what}: its load launched K2 "
                                     f"{n_load} times")
            add(n)
            add({QUANTIZE_4BIT.name: n_load})
            new = LOAD_NEW * len(ps)
            cli.append(dict(flags=flags, wall_s=wall, direct_s=dwall,
                            tok_per_s=new / dwall,
                            cli_tok_per_s=out["tokens_per_s_incl_compile"],
                            forwards=forwards, admission_rows=rows,
                            launches=n, k2_in_load=n_load, tokens=got))
            log(f"  {what}: CLI {wall:.3f} s with its load, the direct call "
                f"{dwall:.3f} s = {new / dwall:.2f} tok/s; tokens equal; "
                f"launches {n} (+ K2 {n_load} in its load), "
                f"{forwards} {'windows' if kind == 'speculative' else 'forwards'}"
                f"{', admission rows ' + str(rows) if rows else ''}")
        rec["cli"] = cli
        del cli_params

        # -- the watchdog --
        wprompts = [torch.randint(1, base.vocab_size, (n,), generator=g
                                  ).tolist()
                    for n in (16, 37, 64, 150, 20, 90, 30, 70)]
        rec["watchdog"] = _watchdog_run(params, cfg, wprompts, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["launches"] = totals
    results["load"] = rec
    results["launches_load"] = totals


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


def kernel_entries(results, kernels_seq):
    """The ``kernels`` line: one entry per kernel record with its
    launches on the main path, its error against the plain version, and
    its time, bound, plain and library times from this run."""
    kernels = []
    launches = results.get("launches", {})
    paged_launches = results.get("launches_paged", {})
    from quantizations_tpu_torch.ops import (PAIR_MMA_MIN_TOKENS,
                                             PLANAR_MMA_MIN_TOKENS)
    planar_launches = results.get("launches_planar", {})
    for k in kernels_seq:
        entry = dict(name=k.name, route="cuda", source=k.source,
                     replaces=k.replaces)
        if k.name == "pair_matmul":
            f1 = results.get("k1_time", {}).get("per_forward", {}).get(1, {})
            entry.update(
                launches=launches.get(k.name, 0),
                max_abs_err=results.get("k1_err", {}).get("max_abs_err"),
                max_err_over_max_y=results.get("k1_err", {}).get(
                    "max_rel_err"),
                ms=f1.get("ms"), plain_ms=f1.get("plain_ms"),
                bound_ms=f1.get("bound_ms"), bound_by="bytes",
                library_ms=f1.get("library_ms"),
                unit="one decode forward at T=1: the K1 launches of "
                     f"{LAYERS} layers x 4 projections + the lm_head; "
                     "launches: the generate path",
                by_shape=results.get("k1_time", {}).get("rows"))
        elif k.name == "pair_matmul_mma":
            f = results.get("body_time", {}).get("per_forward", {}).get(
                K1_CHUNK_TOKENS, {})
            err = results.get("pair_variants_err", {}).get(k.name, {})
            entry.update(
                launches=paged_launches.get(k.name, 0),
                max_abs_err=err.get("max_abs_err"),
                max_err_over_max_y=err.get("max_err_over_max_y"),
                ms=f.get("mma_ms"), plain_ms=f.get("plain_ms"),
                bound_ms=f.get("bound_ms"), bound_by=f.get("bound_by"),
                library_ms=f.get("library_ms"),
                cuda_core_ms=f.get("cuda_core_ms"),
                unit=f"K1 above {PAIR_MMA_MIN_TOKENS - 1} rows: one "
                     f"{K1_CHUNK_TOKENS}-row admission forward, {LAYERS} "
                     "layers x 4 projections (its lm_head samples one row "
                     "on the CUDA-core body); cuda_core_ms: K1's CUDA-core "
                     "body there; library_ms: dense bf16 torch.matmul; "
                     "launches: the paged engine's first bf16 run",
                per_forward=results.get("body_time", {}).get("per_forward"),
                crossover=results.get("body_time", {}).get("crossover"))
        elif k.name == "quantize_4bit":
            k2 = results.get("k2", {})
            entry.update(launches=launches.get(k.name, 0),
                         max_abs_err=k2.get("max_abs_err"), ms=k2.get("ms"),
                         plain_ms=k2.get("plain_ms"),
                         bound_ms=k2.get("bound_ms"), bound_by="bytes",
                         library_ms=None,
                         unit="one Llama3-8B model build: "
                              f"{sum(K2_SHAPES.values())} fp32 quantizes",
                         by_shape=k2.get("shapes"))
        elif k.name in ("planar_matmul", "gemv_4bit"):
            pt = results.get("planar_time", {}).get("per_forward", {})
            f = pt.get("planar_matmul T=1" if k.name == "planar_matmul"
                       else "gemv_4bit T=3", {})
            err = results.get("planar_err", {}).get(k.name, {})
            entry.update(
                launches=planar_launches.get(k.name, 0),
                max_abs_err=err.get("max_abs_err"),
                max_err_over_max_y=err.get("max_err_over_max_y"),
                ms=f.get("ms"), plain_ms=f.get("plain_ms"),
                bound_ms=f.get("bound_ms"), bound_by=f.get("bound_by"),
                library_ms=f.get("library_ms"),
                unit=("one decode forward at T=" + (
                    "1" if k.name == "planar_matmul" else "3")
                      + f": {LAYERS} layers x 4 projections + the lm_head "
                      "(K5: the body planar_body picks, both bodies' "
                      "launches); library_ms: dense bf16 torch.matmul over "
                      "the same shapes; launches: the planar generates (B = "
                      "1, 3, 8, 6 runs each)"),
                per_forward=pt,
                by_shape=[r for r in results.get("planar_time", {}).get(
                    "rows", []) if r["kernel"] == k.name])
        elif k.name == "planar_matmul_mma":
            pt = results.get("planar_time", {})
            f = pt.get("per_forward", {}).get("planar_matmul T=48", {})
            err = results.get("planar_err", {}).get(k.name, {})
            entry.update(
                launches=planar_launches.get(k.name, 0),
                max_abs_err=err.get("max_abs_err"),
                max_err_over_max_y=err.get("max_err_over_max_y"),
                ms=f.get("mma_ms"), plain_ms=f.get("plain_ms"),
                bound_ms=f.get("bound_ms"), bound_by=f.get("bound_by"),
                library_ms=f.get("library_ms"),
                cuda_core_ms=f.get("cuda_core_ms"),
                crossover=pt.get("crossover"),
                unit=f"K5 from {PLANAR_MMA_MIN_TOKENS} rows on: the B = 3 "
                     f"prefill forward, T=48, {LAYERS} layers x 4 "
                     "projections; cuda_core_ms: K5's CUDA-core body there; "
                     "library_ms: dense bf16 torch.matmul over the same "
                     "shapes; launches: the planar generates (B = 1, 3, 8, "
                     "6 runs each)",
                per_forward={k2: v for k2, v in pt.get(
                    "per_forward", {}).items() if k2.startswith("planar")})
        elif k.name in ("pair_prefill", "pair_manual"):
            pv = results.get("pair_variants_time", {}).get("per_forward", {})
            f = pv.get(k.name, {})
            err = results.get("pair_variants_err", {}).get(k.name, {})
            n = results.get("launches_" + k.name, {}).get(k.name, 0)
            entry.update(
                launches=n, max_abs_err=err.get("max_abs_err"),
                max_err_over_max_y=err.get("max_err_over_max_y"),
                ms=f.get("ms"), plain_ms=f.get("plain_ms"),
                bound_ms=f.get("bound_ms"), bound_by=f.get("bound_by"),
                library_ms=f.get("library_ms"), k1_ms=f.get("k1_ms"),
                unit=(("one prefill forward at T=512: 32 layers x qkv, o, "
                       "gate_up, down; dense_pair_ms: the dense pair path "
                       "there; launches: the QT_PREFILL_PAIR generates (1024-"
                       "token prompt, 6 runs)") if k.name == "pair_prefill"
                      else ("one decode forward at T=1 over the projections "
                            "K9 takes: 32 layers x qkv, o, down; launches: "
                            "the manual generates (B = 1, 4, 8, 6 runs "
                            "each)"))
                + "; library_ms: dense bf16 torch.matmul over the same "
                  "shapes",
                per_forward=f,
                by_shape=[r for r in results.get("pair_variants_time", {})
                          .get("rows", []) if r["kernel"] == k.name])
            if k.name == "pair_prefill":
                entry["dense_pair_ms"] = f.get("dense_pair_ms")
        elif k.name == "dequantize_4bit_pair":
            pv = results.get("pair_variants_time", {})
            f = pv.get("band_per_forward", {}).get(max(BAND_TIMED_T), {})
            err = results.get("dense_band_err", {})
            entry.update(
                launches=paged_launches.get(k.name, 0),
                max_abs_err=err.get(k.name, {}).get("max_abs_err"),
                band_max_err_over_max_y=err.get("pair", {}).get(
                    "max_err_over_max_y"),
                ms=f.get("ms"), plain_ms=f.get("plain_ms"),
                bound_ms=f.get("bound_ms"), bound_by=f.get("bound_by"),
                library_ms=f.get("library_ms"), k10_ms=f.get("k10_ms"),
                k10_bound_ms=f.get("k10_bound_ms"),
                k10_plain_ms=f.get("k10_plain_ms"), k8_route_ms=f.get("k8_ms"),
                unit=f"the dense pair band per {max(BAND_TIMED_T)}-row "
                     f"forward: {LAYERS} layers x 4 projections, each one K10 "
                     "launch and dense_product (bf16 torch.mm/addmm with "
                     "fp32 output, 2048 columns of K each); "
                     "max_abs_err: K10 against its plain version (bit-exact); "
                     "plain_ms: the plain band (fp32 products, the route "
                     "before K10); library_ms: dense bf16 torch.matmul on "
                     "ready weights; k10_*: K10 alone; k8_route_ms: the "
                     "QT_PREFILL_PAIR route; launches: the paged engine's "
                     "first bf16 run",
                per_forward=pv.get("band_per_forward"),
                by_shape=pv.get("band"))
        elif k.name == "dequantize_4bit":
            rows = results.get("planar_time", {}).get("k7", [])
            main = next((r for r in rows if r["M"] == 14336
                         and "float32" in r["dtype"]), {})
            err = results.get("planar_err", {}).get(k.name, {})
            entry.update(
                launches=planar_launches.get(k.name, 0),
                max_abs_err=err.get("max_abs_err"), ms=main.get("ms"),
                plain_ms=main.get("plain_ms"), bound_ms=main.get("bound_ms"),
                bound_by=main.get("bound_by", "bytes"), library_ms=None,
                unit="one launch at [14336, 4096] to fp32; launches: the "
                     "planar generates (the dense band of the B = 8 "
                     "prefill)",
                by_shape=rows)
        else:
            n = (results.get("launches_paged_int8", {}) if "i8" in k.name
                 else paged_launches).get(k.name, 0)
            rows = [r for r in results.get("attn_time", [])
                    if r["kernel"] == k.name]
            main = next((r for r in rows if r["form"] == "paged"
                         and r["B"] == 4 and r["ctx"] == 1900
                         and r["q_span"] == 1), {})
            err = results.get("attn_err", {}).get(k.name, {})
            entry.update(launches=n, max_abs_err=err.get("max_abs_err"),
                         max_err_over_max_out=err.get(
                             "max_err_over_max_out"),
                         ms=main.get("ms"), plain_ms=main.get("plain_ms"),
                         bound_ms=main.get("bound_ms"),
                         bound_by=main.get("bound_by", "bytes"),
                         library_ms=main.get("library_ms"),
                         unit="one launch over the paged pool (page 256) at "
                              "B=4, 1900 live tokens per row; library_ms: "
                              "scaled_dot_product_attention(enable_gqa) "
                              "over the same keys laid out contiguously"
                              + (" (none for int8)" if "i8" in k.name
                                 else "")
                              + "; launches: the paged engine's "
                              + ("int8" if "i8" in k.name else "first bf16")
                              + " run",
                         by_shape=rows)
        # the load phase: K2 in every load, K10/K7 in the exports, every
        # kernel of the CLI runs
        entry["load_launches"] = results.get("launches_load", {}).get(
            k.name, 0)
        # the speculative path's first bf16 run (the int8 run for K4)
        entry["spec_launches"] = results.get(
            "launches_spec_int8" if "i8" in k.name else "launches_spec",
            {}).get(k.name, 0)
        kernels.append(entry)
    return kernels


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
    ptxas = start_ptxas_report()
    try:
        build(KERNELS)
    except BaseException:
        for proc in ptxas.values():
            proc.kill()
            proc.wait()
        raise
    results["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(KERNELS)} kernels built and loaded in "
        f"{results['build_s']:.2f} s")
    read_ptxas_report(ptxas, results)
    held = {}
    for ph, fn in (("k2", lambda: phase_k2(dev, gen, results)),
                   ("k1", lambda: phase_k1(dev, gen, results)),
                   ("attn", lambda: phase_attn(dev, gen, results)),
                   ("time", lambda: (phase_time(dev, gen, results),
                                     phase_attn_time(dev, gen, results))),
                   ("model", lambda: held.update(
                       params=phase_model(dev, results))),
                   ("planar", lambda: phase_planar(dev, gen, results,
                                                   held["params"])),
                   ("pair_variants", lambda: phase_pair_variants(
                       dev, gen, results, held["params"])),
                   ("paged", lambda: phase_paged(dev, held["params"],
                                                 results)),
                   ("spec", lambda: phase_spec(dev, held.pop("params"),
                                               results)),
                   ("load", lambda: phase_load(dev, results)),
                   ("profile", lambda: phase_profile(dev, results))):
        t0 = time.perf_counter()
        log(f"[{ph}]")
        fn()
        torch.cuda.empty_cache()
        results.setdefault("phase_s", {})[ph] = time.perf_counter() - t0
        log(f"[{ph}] done in {results['phase_s'][ph]:.1f} s")

    kernels = kernel_entries(results, KERNELS)
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_all
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    log(f"total {results['total_s']:.1f} s")
    # the per-shape detail stays in the file: the line stays short
    print(json.dumps({"kernels": [
        {k: v for k, v in e.items() if k not in ("by_shape", "per_forward")}
        for e in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
