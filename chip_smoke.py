#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``quantizations_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:

1. the device: its name, and ``nvidia-smi``'s name and power limit;
2. ``build``: compile every kernel from ``quantizations_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and time it; beside it
   ``nvcc -Xptxas -v`` on ``flash_decode.cu``, ``pair_matmul.cu``,
   ``pair_splitk.cu``, ``planar_matmul.cu`` and ``quantize.cu`` logs the
   registers and spills of every K3/K4 instantiation, of K1/K9's
   CUDA-core body at each token tile and their split-K body at each
   block shape, of K5's two bodies and K6 at each of theirs and of K2's
   two bodies by lanes a block, input type and code, and a spill or a
   missing instantiation fails the run;
3. ``k2``: the quantize kernel against its plain version, bit-exact
   (absmax NaN-aware), FP4 and NF4, at every shape that model build
   quantizes (and the fused gate|up's ``[28672, 4096]``; bf16 input at
   ``[4096, 4096]``), with the blocks of ``k2_special_blocks``: values
   exactly on the code thresholds, a zero block, NaN, inf, -0.0 and a
   subnormal absmax; then timed at each shape (inputs rotating so that
   they do not sit in the 50 MB L2) with its TB/s and share of the
   bound, and summed over one model build's launches;
4. ``k1``: the pair dequant-matmul kernel's three bodies (CUDA-core
   below ``PAIR_SPLITK_MIN_TOKENS`` rows, split-K tensor-core up to 128,
   K8's tensor-core body above), each launched directly, against its
   plain version and launched twice with the same bits, and the dispatch
   (stacked at a layer other than 0, and unstacked) bit for bit the body
   ``pair_body`` names, at every Llama3-8B main-path shape and 3071 row
   pairs, T in {1, 2, 3, 4, 8, 16, 32, 64, 100, 128, 256}, FP4 and NF4,
   fp32 and ``bf16x2`` scales. Tolerance: 1e-5 * max|y|, for the fp32
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
   summation order only). Then the same at Gemma2-9B's shapes (8 kv
   heads, 2 query heads each, D 256): the slot cache of 4352 positions
   and the pool (page 256, 17 pages a row), q_span 1, 4 and 16, B 1 and
   4 with lengths up to 4300, past the 4096 window, softcap 50 with the
   window 4096 and 2**30, and neither;
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
   pool (SDPA there with the verify window's causal mask); the pool
   cases again with each chunk of ``ATTN_SWEEP_CHUNKS`` forced (the split
   sweep); and K3/K4 at Gemma2-9B's shape (B = 4, 1900 tokens, D 256,
   softcap 50, window 4096): slot, paged, and paged at q_span 16, beside
   the bound, the plain version and SDPA on contiguous bf16 keys, with
   the paged cases' split sweep;
7. ``glue``: K11-K13 at Mistral-7B's widths (hidden 4096, 32 query and
   8 kv heads of 128, intermediate 14336) at 1, 7, 256 and 1024 rows in
   every form the layer calls them (K11 with an fp32 delta into bf16,
   with ``1 + w``, and without a delta into fp32 as a post norm; K12 on
   views of the q|k|v slab, decode and 256-token prefill rows; K13 silu
   and tanh-gelu into bf16, silu into fp32), one launch a call, against
   their plain versions: the residual, rope and activation bit for bit,
   the norm within one bf16 ulp; then timed at 1, 256 and 1024 rows
   (operands rotating past the L2) beside the bound, the plain version
   and, for K11, ``torch.nn.functional.rms_norm`` (the norm alone);
8. ``model``: first one FP4 model build under ``torch.profiler``: the
   host and device time of K2, ``torch.randn``, the plain double
   quantization, ``planar_to_pair`` and ``fuse_projections``, and the
   device kernels that took the most. Then Llama3-8B at full width and
   depth with a 4-bit embedding and lm_head, random weights from seed 0
   quantized by K2 (exactly 226 launches a build), fused q|k|v and
   gate|up, then greedy generation of 60 tokens after a 16-token
   prompt at batch 1, 4 and 8: FP4 on the einsum path, with
   ``use_flash_attention`` (K3) and with flash and an int8 KV cache
   (K4); NF4 at batch 1. Every generate must launch K1 exactly
   60 * (4 * 32 + 1) = 7740 times, each on the body ``pair_body`` names
   for its rows (the split-K body's count exact: the 16B-row prefill and,
   from B = 4, every launch), K3 or K4 exactly 59 * 32 = 1888
   times, K10 never, the glue kernels K11-K13 exactly as
   ``_glue_forwards`` reckons for 60 forwards (60 * (2 * 32 + 1) K11,
   60 * 32 K12 and K13), and give the same tokens on every run; tok/s is new tokens
   over the whole generate call, from CUDA events, the median of
   TIMED_RUNS (2)
   timed runs after a warm-up, printed with their min and max. A tiny
   model then checks the CUDA path against the CPU's plain path on the
   same parameters (prefill, and a flash decode step, bf16 and int8);
9. ``planar``: the planar layout. K5 (planar dequant-matmul: each of
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
   tok/s the median of TIMED_RUNS; each projection of the twin against K1
   on the pair words it came from (K5 within 1e-5 * max|y|: one rounding
   class; K6 within 1e-2: fp32 class against bf16), one decode step's
   logits against the pair
   model's on the same cache (a layout check, 0.25 * max|logit|: 32
   random layers amplify rounding differences) and where the greedy
   streams part. ``Linear4bit.create`` on a [14336, 4096]
   weight runs T = 1, 3, 64, 256 against the plain path and round-trips
   through the bnb flat tensors bit-identically. Last the kernels' times
   against their bounds (K5's two bodies at T in {1, 2, 4, 8, 16, 32, 48,
   64} per shape and per forward, with the crossover; K6 per T = 3
   forward; K7 at [14336, 4096] and the lm_head), the plain versions and
   dense bf16 ``torch.matmul``;
10. ``pair_variants``: the pair kernel's variants. The tensor-core body
   (``csrc/pair_prefill.cu``: K8, and K1 above 128 rows) within K8_GATE
   * max|y| of its plain versions and of K1's CUDA-core body, with K1
   above 128 rows bit-identical to K8, and K9 (the manual-pipeline pair
   kernel) bit-identical to K1, at every Llama3-8B pair shape (the
   tensor-core body also at M = 6142, a row tail), FP4 and NF4, fp32,
   bf16 and ``bf16x2`` scales, stacked at layer 1 and unstacked: K8 at T
   in {8, 129, 200, 256, 512} (against K1, whichever body it runs), K1
   through its tensor-core body at {129, 200, 256, 512}, K9 at T in {1,
   2, 3, 4, 8, 16, 64, 128} (on either side of K1's switch to its split-K
   body, which K9 follows). The dense pair band
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
   and (K8) the dense pair path; K1's three bodies, each launched
   directly, at T in {1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 512} on the
   four layer shapes and (up to 128 rows) the lm_head, per shape and
   per forward beside the bound and ``torch.matmul`` (the plain version
   at 8 and 256), with both crossovers (CUDA-core to split-K, split-K to
   tensor-core), and the tensor-core body with each of its row tiles at T
   = 128, 256 and 512 (the tile rule's data). Then the knobs end to
   end on the model phase's parameters: ``pair_pipeline="manual"``
   generates at B = 1, 4, 8 with exact K9/K1 counts (MANUAL_LAUNCHES, and
   the split-K body's launches by K1's and K9's rows) and
   the model phase's tokens; ``QT_PREFILL_PAIR=1`` generates after a
   1024-token prompt with exactly 256 K8 and 7612 K1 launches (no K10),
   and its prefill forward is timed on three routes in turns: K8, the
   dense pair band (exactly 128 K10 launches) and the plain band, with
   the band's last-token logits within 0.25 * max|logit| of the K8 and
   the plain routes'; a ``PagedEngine`` run without and with
   ``QT_PREFILL_PAIR`` (K8 launched 128 x ceil(rows / 512) times per
   admission forward above the K1 band with a row count divisible by 8,
   K10 128 times per other admission forward above the band);
11. ``paged``: the paged engine. ``PagedEngine(slots=4, max_seq=2048,
   prefill_buckets=(64, 256), admit_width=4, prefix_cache=True,
   num_pages=40)`` (page 256) over the FP4 model serves 8 greedy
   requests of 32 new tokens: prompts of 16, 100, 300, 700, 1100, 1500
   and 1900 tokens from seed 0, and an eighth that shares the 700-token
   prompt's first 512 tokens (it must hit the prefix cache for two
   pages). Then again on a fresh engine (the same tokens), then with an
   int8 pool (its agreement with the bf16 tokens is printed). Each run
   must launch K3 (K4) exactly 32 * steps times, K1 exactly 129 times
   per decode forward (4 rows: the split-K body) and 129 per admission
   forward up to 256 rows (the lm_head at one row a sequence), each on
   the body ``pair_body`` names (the tensor-core body 128 times per
   admission forward of 129-256 rows: 20 chunks of 256, 2,560) and K10
   exactly 128 times per admission forward above 256 rows (the batched
   group's 3 rounds of 1024: 384), K11-K13 in every forward as
   ``_glue_forwards`` reckons, finish
   every request with 32 in-vocabulary
   tokens and return every page but the prefix cache's pins. Printed:
   aggregate new tokens per second, steps, admission group sizes, and
   the wall time split into admission and decode;
12. ``spec``: speculative decoding and the slot ``Engine`` on the same
   FP4 model. First the paged verify window on a tiny model with 4
   query heads per kv head (windows of 4 and 8 tokens, 32 query rows at
   8) against the CPU's plain path: logits within 2e-2 * max|logit|, bf16
   and int8 pools, one row across a page boundary, the window write
   bit-equal. Then ``PagedEngine`` (the paged phase's configuration and
   requests) through ``step_spec(8)`` twice (the same tokens),
   ``step_spec_multi(8, 4)`` and ``step_spec(8)`` on an int8 pool: K3 (K4)
   exactly 32 per forward (verify windows at q_span 8 and plain
   fallback steps), K1 by body as in the paged phase (a verify window's
   32 rows on the split-K body) and K10 as there, 32 tokens a request,
   pages returned; printed beside the paged phase's plain run, with the
   tokens that agree with it. One verify window (B = 4, T = 8) is timed
   against one plain step at 1900 tokens. The slot ``Engine(slots=4,
   max_seq=2048, prefill_buckets=(16, 64, 256))`` serves the same
   requests: ``run()`` twice (the same tokens),
   ``run(steps_per_dispatch=4)``, ``run(spec_k=8)``, and ``run()`` with
   flash (K3) and with flash and an int8 cache (K4), each with exact
   K1 (by body)/K3/K4/K10 counts. Last ``make_speculative_generate_fn``
   at B = 1, k = 8, 60 tokens after the model phase's prompt (K1 exactly
   129 per forward by body, the same tokens every run; tok/s the median
   of 3) beside the
   model phase's generate;
13. ``gemma2``: Gemma2-9B at full width and depth (42 layers, hidden
   3584, 16 query and 8 kv heads of 256, GeGLU, sandwich norms, softcaps
   50 and 30, the 4096 window on the even layers), FP4, random normal
   weights from seed 0, the 4-bit embedding tied to the lm_head, fused
   q|k|v and gate|up. K2 bit-exact at the build's weight shapes, K1
   within 1e-5 * max|y| at its five projection shapes at T = 1, 8, 64,
   256 (each body), K8 within 1e-5 * max|y| there at 256, 512 and 1024
   rows and K10 bit-exact there (bf16 and fp32 out); the build (exactly
   296 K2 launches); greedy generates of 60 tokens after 16 at B = 1,
   4, 8 on the einsum arm, with flash (K3) and with flash and an int8
   cache (K4), each run twice (the same tokens), K1 exact by body, K3/K4
   exactly 59 x 42 a flash generate, K11 four a layer (the post norms)
   and K12/K13 one; one B = 4 decode step's flash
   logits within ``G2_LOGIT_BOUND`` (0.25) of max|logit| of the einsum
   arm's on the same cache, bf16 and int8, each K3/K4 call of that step
   within 1e-5 * max|out| of its plain version on the same inputs, and
   K3 with the newest position planted away outside the bound (read
   beside them: each arm against the flash arm's fp32 plain version and
   that version with 1e-6 noise a call, at 2, 8 and 42 layers of the
   same weights, K3 with the softcap dropped, and one step after 4,200
   tokens with the window dropped); a B = 1 generate after a 4,200-token
   prompt
   (the window masks positions; K10 on the prefill) on einsum and flash,
   twice each; ``PagedEngine`` with the paged cell's settings under
   ``QT_PREFILL_PAIR=1`` at max_seq 4352, the paged phase's 8 requests
   and one of 4,200 tokens, through ``step`` and ``step_spec(16)`` (32
   query rows a kv head), bf16 and int8 pools, each twice (the same
   tokens), K3/K4 exactly 42 a forward and K8 168 x ceil(rows / 512) a
   forward above the K1 band. tok/s, admission and decode walls and
   peak memory printed;
14. ``load``: the checkpoint path and the command line. A synthetic HF
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
15. ``evals``: the accuracy path at Llama3-8B's full width and depth,
   FP4 with the evals CLI's ``QuantConfig`` (a dense embedding),
   ``dist="trained_proxy"`` from seed 0. The proxy sampler's statistics
   at three shapes (the Student-t draws' excess kurtosis and variance,
   the log row norms' spread, the outlier columns' share, each in a
   stated band) and the built model's dequantized q, down and lm_head;
   the build's K2 launches (7 a layer and one for the lm_head).
   ``logit_parity`` over 128 ids from ``default_rng(0)`` with bf16 KV,
   int8 KV and the dense-twin control: every field finite, exactly 225
   K1 and 225 K10 launches a quantized run (450 K10 for the control),
   the control's KL below the quantized arm's. The materialized twin's
   logits (15 GB of bf16 weights) against the lazy twin's, bit for bit.
   ``run_ifeval_proxy`` over the 109 examples (8 slots, 32 new tokens):
   each arm's launches exact (the quantized arm K1 only, the twin arm
   K10 only), every transcript 32 tokens; scores, deltas, verdict
   agreement, each arm's wall and the sentence splitter printed. Last
   ``python -m quantizations_tpu_torch.evals --preset 8b --proxy
   --parity --parity-control`` as a subprocess, its JSON equal to the
   direct calls field for field;
16. ``parallel``: the parallel path at Llama3-8B's full width, 8 of its
   32 layers (FP4, random normal weights from seed 0, 4-bit embedding and
   lm_head)
   on ranks that share this one card under gloo (``parallel.launch``;
   NCCL refuses two ranks on one GPU): TP at tp = 4 and 2 (B = 1 and 4,
   flash attention; the manual pipeline; a ``QT_PREFILL_PAIR`` prefill of
   512 tokens), DP x TP 2 x 2, PP 2 and PP x TP 2 x 2 (B = 2), SP 2 over a
   1024-token prompt then 8 decode steps, ``PagedEngine(mesh)`` at tp = 2
   with the paged phase's traffic (bf16, int8, ``step_spec(8)``),
   ``Engine(mesh)`` with 3 slots over 6 requests of 16-token prompts,
   ``load_hf_llama(mesh)`` of the load
   phase's checkpoint (each rank's shard the slice of the single-card
   load, bit for bit) and the serving CLI with ``--tp 2`` (the direct
   call's tokens). Every kernel call of every path, at each shard shape
   it runs, against its plain version on the same inputs (1e-5 *
   max|y|; K2, K7, K10, K12 and K13 bit for bit, K11's residual bit
   for bit and its norm within one bf16 ulp); every rank's tokens equal; each
   path's first logits within ``PAR_LOGIT_BOUND`` of the single card's
   (the engines' against the single-card engine's), its greedy tokens
   the single card's or parting only where the single card's top-2
   margin lies within that bound; every rank's launches their closed
   form (the path's forwards and their rows; an engine's from its own
   counts). Printed per path: the wall and tok/s (N ranks sharing one
   card: no TP speed), the collectives' share of the wall, the staged
   collectives, the shard shapes each kernel ran, each rank's peak
   memory;
17. ``profile``: one FP4 batch-1 generate of 8 new tokens under
   ``torch.profiler``: device kernel time by name, kernels per forward
   (K11-K13's launches among them, exactly as ``_glue_forwards``
   reckons), the device's busy share of the wall time, the host's
   enqueue time.

Then one JSON line of kernel results (without the per-shape detail),
the ``nvidia-smi`` line again, and last ``{"ok": true, "device":
{...}}``. Details go to
``chiprun_out/chip_smoke.json``. Exits non-zero with no result when no
CUDA device is present.
"""

from __future__ import annotations

import contextlib
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
K1_TOKENS = (1, 2, 3, 4, 8, 16, 32, 64, 100, 128, 256)
K1_DECODE_TOKENS = (1, 4, 8)               # decode at B = 1, 4, 8
K1_TIMED_TOKENS = K1_DECODE_TOKENS + (16, 64, 128)   # and their prefill
K1_CHUNK_TOKENS = 256          # one admission chunk of the paged engine
PROMPT_LEN = 16
# timed generates after a warm-up, their tok/s the median (the model,
# planar and pair_variants phases); two leave the run room for the
# gemma2 phase
TIMED_RUNS = 2
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
FD_ROW_TILES, FD_HEAD_DIMS = (4, 8), (64, 128, 256)
# the token tiles TT of csrc/pair_matmul.cu's body (K1's and K9's CUDA-core
# body)
PAIR_TILES = (1, 2, 4, 8, 16)
# the shapes (NT n8 tiles, MT m16 tiles, KS K slices, ST stages) of
# csrc/pair_splitk.cu's body (K1 and K9 from PAIR_SPLITK_MIN_TOKENS up to
# 128 rows) that its entry launches
PAIR_SPLITK_SHAPES = ((1, 1, 8, 2), (2, 2, 8, 2), (4, 2, 8, 2), (8, 2, 4, 2))
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
# K1's three bodies are timed at these rows (the crossovers), with the
# lm_head up to 128; the plain versions at BODY_PLAIN_T
BODY_TIMED_T = (1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 512)
BODY_PLAIN_T = (8, 256)
K9_TOKENS = (1, 2, 3, 4, 8, 16, 64, 128)
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
# the glue phase: K11-K13 at Mistral-7B's widths (Llama3-8B's too):
# hidden, query and kv heads (D = HEAD_DIM), intermediate, rope theta;
# checked at GLUE_ROWS (7 an odd count), timed at GLUE_TIMED_ROWS, their
# kernel entries read at GLUE_MAIN_ROWS (a decode step of 256 rows)
GLUE_H, GLUE_NQ, GLUE_NKV, GLUE_I, GLUE_THETA = 4096, 32, 8, 14336, 1e6
GLUE_ROWS = (1, 7, 256, 1024)
GLUE_TIMED_ROWS = (1, 256, 1024)
GLUE_MAIN_ROWS = 256
GLUE_EPS = 1e-5
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
    ``csrc/pair_splitk.cu``, ``csrc/planar_matmul.cu`` and
    ``csrc/quantize.cu`` (beside the build, which it does not replace),
    all at once, and return ``{source stem: process}``."""
    from quantizations_tpu_torch.ops.cuda import (BUILD, FLASH_DECODE,
                                                  NVCC_FLAGS, PAIR_MATMUL,
                                                  PAIR_MATMUL_SPLITK,
                                                  PLANAR_MATMUL,
                                                  QUANTIZE_4BIT, nvcc_path)

    BUILD.mkdir(parents=True, exist_ok=True)
    return {k.path.stem: subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(BUILD / f"{k.path.stem}_ptxas.so"), str(k.path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in (FLASH_DECODE, PAIR_MATMUL, PAIR_MATMUL_SPLITK,
                  PLANAR_MATMUL, QUANTIZE_4BIT)}


def _ptxas_label(stem, fn):
    """The instantiation a mangled kernel name stands for: K3/K4 by type,
    row tile and head dim (and the combine) in ``flash_decode``; K1/K9's
    token tile TT in ``pair_matmul``; the split-K body's NT, MT, KS and
    ST in ``pair_splitk``; in ``planar_matmul`` the CUDA-core
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
    if stem == "pair_splitk":
        m = re.search(r"pair_splitk_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                      fn)
        return "NT={} MT={} KS={} ST={}".format(*m.groups())
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
    combine (``results["ptxas"]``), K1/K9's CUDA-core body at each token
    tile of PAIR_TILES (``results["ptxas_pair_matmul"]``; both entry
    points launch the same instantiations), their split-K body at each
    shape of PAIR_SPLITK_SHAPES (``results["ptxas_pair_splitk"]``), and
    in ``planar_matmul`` K5's and
    K6's CUDA-core body at K5_TILES and K6_TILES (K6 on bf16 and on fp32
    activations) and K5's tensor-core body
    at PLANAR_MMA_TILES (``results["ptxas_planar_matmul"]``), and K2's
    group body at each K2_GROUP_LANES and its one-warp body, each for fp32
    and bf16 input and FP4 and NF4 (``results["ptxas_quantize"]``)."""
    want = {"flash_decode": {f"{t} R={r} D={d}" for t in ("K3 bf16", "K4 int8")
                             for r in FD_ROW_TILES for d in FD_HEAD_DIMS}
            | {"combine"},
            "pair_matmul": {f"TT={t}" for t in PAIR_TILES},
            "pair_splitk": {"NT={} MT={} KS={} ST={}".format(*sh)
                            for sh in PAIR_SPLITK_SHAPES},
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


# K1's bodies: (its wrapper, its plain version) by ops/qmatmul.py
# pair_body's name. The split-K and the tensor-core body take K8's plain
# version (original column order), the CUDA-core body K1's
K1_BODIES = ("cuda_core", "splitk", "mma")
K1_ODD = ("odd", 6142, 4096)       # 3071 row pairs: a row tail in a block


def _k1_body_fns():
    from quantizations_tpu_torch.ops import qmatmul as qm

    return {"cuda_core": (qm.matmul_4bit_pair_cuda_core,
                          qm.matmul_4bit_pair_plain),
            "splitk": (qm.matmul_4bit_pair_splitk,
                       qm.matmul_4bit_pair_prefill_plain),
            "mma": (qm.matmul_4bit_pair_mma,
                    qm.matmul_4bit_pair_prefill_plain)}


def phase_k1(dev, gen, results):
    """Each of K1's three bodies, launched directly, against its plain
    version, and launched twice with the same bits; the dispatch
    (stacked, layer 2 of 3) bit for bit the body ``pair_body`` names, and
    the unstacked form at T = 1 and 16 likewise: at every K1_SHAPES shape
    and 3071 row pairs, FP4 and NF4, fp32 and ``bf16x2`` scales, T in
    K1_TOKENS."""
    from quantizations_tpu_torch.ops import pack_scale_pairs
    from quantizations_tpu_torch.ops import qmatmul as qm

    fns = _k1_body_fns()
    by_body = {b: dict(max_abs_err=0.0, max_err_over_max_y=0.0, cases=0)
               for b in K1_BODIES}
    for name, M, K in K1_SHAPES + (K1_ODD,):
        wp2, scales = _pair_operands(M, K, 3, dev, gen)
        packed = pack_scale_pairs(scales)
        x = torch.randn(max(K1_TOKENS), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        n = 0
        for qt in ("fp4", "nf4"):
            for skind, s in (("fp32", scales), ("bf16x2", packed)):
                plains = {p: p(wp2[2], s[2], x, qt)
                          for p in {p for _, p in fns.values()}}
                for T in K1_TOKENS:
                    xt = x[:T]
                    what = f"K1 {name} [{M},{K}] {qt} {skind} T={T}"
                    y_disp = qm.matmul_4bit_pair_stacked(wp2, s, xt, 2, qt)
                    y_flat = (qm.matmul_4bit_pair(wp2[2], s[2], xt, qt)
                              if T in (1, 16) else y_disp)
                    for body, (fn, plain) in fns.items():
                        y = fn(wp2[2], s[2], xt, qt)
                        again = fn(wp2[2], s[2], xt, qt)
                        torch.cuda.synchronize()
                        if y.shape != (T, M) or not torch.isfinite(y).all():
                            raise AssertionError(f"{what} {body} body: bad "
                                                 f"output {tuple(y.shape)}")
                        ref = plains[plain][:T]
                        err = (y - ref).abs().max().item()
                        rel = err / ref.abs().max().item()
                        if not rel <= 1e-5:
                            raise AssertionError(
                                f"{what} {body} body: max|err| {err:.3e} = "
                                f"{rel:.3e} of max|y| > 1e-5")
                        if not torch.equal(y.view(torch.int32),
                                           again.view(torch.int32)):
                            raise AssertionError(f"{what} {body} body: two "
                                                 "launches differ")
                        if qm.pair_body(T) == body and not (
                                torch.equal(y.view(torch.int32),
                                            y_disp.view(torch.int32))
                                and torch.equal(y.view(torch.int32),
                                                y_flat.view(torch.int32))):
                            raise AssertionError(f"{what}: the dispatch is "
                                                 f"not its {body} body")
                        rec = by_body[body]
                        rec["max_abs_err"] = max(rec["max_abs_err"], err)
                        rec["max_err_over_max_y"] = max(
                            rec["max_err_over_max_y"], rel)
                        rec["cases"] += 1
                        n += 1
                del plains
        log(f"  K1 {name} [{M}, {K}]: {n} cases, each body within 1e-5 * "
            "max|y| of its plain version, the same bits twice; the dispatch "
            "the body pair_body names, bit for bit")
        del wp2, scales, packed, x
        torch.cuda.empty_cache()
    run = {b: by_body[b] for b in K1_BODIES}
    results["k1_err"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in run.values()),
        max_rel_err=max(r["max_err_over_max_y"] for r in run.values()),
        by_body=run)
    log("  K1 worst max|err| / max|y| by body: " + ", ".join(
        f"{b} {r['max_err_over_max_y']:.3e} ({r['cases']} cases)"
        for b, r in run.items()))


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


def _attn_pool(B, lengths, page, n_pages, q_span, dev, gen, int8, L=3,
               kvh=KVH, D=HEAD_DIM):
    """A pool [L, P, kvh, page, D] and a shuffled block table [B, n_pages]
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
    return _attn_cache((L, P, kvh, page, D), dev, gen, int8) + (
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


def _attn_check_cases(dev, gen, *, kvh, gqa, D, S, batches, knobs, pages,
                      q_spans, pps, tag=""):
    """K3 and K4 against their plain versions over a slot cache of S
    positions (attend_len 128 and S, stacked at layer 1; bf16 also
    unstacked) and pools of S positions a row at each page size
    (shuffled tables, pages_per_step ``pps``, each q_span), for each
    ``(B, lengths)`` of ``batches`` and each (window, softcap) of
    ``knobs``. The pool's splits fold in a fixed order: each (page,
    q_span) case is launched again and must give the same bits.
    Tolerance 1e-5 * max|out|: both sides read the same bf16 or int8
    values and differ only in the fp32 summation order. Returns (worst
    [max|err|, max|err| / max|out|, cases] by kernel, bit-identical
    reruns by kernel, the pool's splits as (B, page, q_span, n_split,
    chunk))."""
    from quantizations_tpu_torch.ops import attention as at
    from quantizations_tpu_torch.ops import paged_attention as pa
    from quantizations_tpu_torch.ops.cuda import (FLASH_DECODE,
                                                  FLASH_DECODE_I8)

    worst = {"flash_decode": [0.0, 0.0, 0], "flash_decode_i8": [0.0, 0.0, 0]}
    identical = {"flash_decode": 0, "flash_decode_i8": 0}
    splits = set()

    def check(name, what, got, ref):
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name}{tag} {what}: bad output")
        err = (got - ref).abs().max().item()
        top = ref.abs().max().item()
        if not err <= 1e-5 * top:
            raise AssertionError(f"{name}{tag} {what}: max|err| {err:.3e} > "
                                 f"tol {1e-5 * top:.3e}")
        w = worst[name]
        w[0], w[1], w[2] = max(w[0], err), max(w[1], err / max(top, 1e-30)), \
            w[2] + 1

    for B, lens in batches:
        for int8 in (False, True):
            name = "flash_decode_i8" if int8 else "flash_decode"
            k, v, ks, vs = _attn_cache((3, B, kvh, S, D), dev, gen, int8)
            q = torch.randn(B, kvh, gqa, D, generator=gen, device=dev)
            for attend in (128, S):
                ln = torch.tensor([min(n, attend) for n in lens],
                                  dtype=torch.int32, device=dev)
                for win, cap in knobs:
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
            for page in pages:
                for q_span in q_spans:
                    k, v, ks, vs, table = _attn_pool(
                        B, lens, page, S // page, q_span, dev, gen, int8,
                        kvh=kvh, D=D)
                    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                    q = torch.randn(B, kvh, q_span * gqa, D, generator=gen,
                                    device=dev)
                    for p_ in pps:
                        for win, cap in knobs:
                            kw = dict(softcap=cap, window=win, q_span=q_span,
                                      pages_per_step=p_)
                            what = (f"paged B={B} page={page} "
                                    f"q_span={q_span} pps={p_} win={win} "
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
                        raise AssertionError(f"{name}{tag} {what}: two "
                                             "launches differ")
                    identical[name] += 1
                    del k, v, ks, vs
        log(f"  {tag.strip() or 'D=' + str(D)} B={B}: K3 "
            f"{worst['flash_decode'][2]} and K4 "
            f"{worst['flash_decode_i8'][2]} cases so far within 1e-5 * "
            "max|out| of the plain versions")
        torch.cuda.empty_cache()
    for n, w in worst.items():
        log(f"  {n}{tag}: {w[2]} cases, worst max|err| {w[0]:.3e}, worst "
            f"max|err| / max|out| {w[1]:.3e}; {identical[n]} pool cases "
            "launched twice, bit-identical")
    log(f"  {tag.strip() or 'pool'} splits (B, page, q_span: n_split x "
        "chunk): " + ", ".join(f"{b},{pg},{qs}: {n}x{c}"
                               for b, pg, qs, n, c in sorted(splits)))
    return ({n: dict(max_abs_err=w[0], max_err_over_max_out=w[1], cases=w[2],
                     bit_identical_reruns=identical[n])
             for n, w in worst.items()}, sorted(splits))


def phase_attn(dev, gen, results):
    """K3 and K4 against their plain versions at the main path's shapes
    (KVH 8, G 4, D 128, B 1/4/8): the slot cache (S 2048, attend_len 128
    and 2048, unstacked and stacked at layer 1) and the paged pool (page
    256 and 128, shuffled tables, pages_per_step 1 and 2, q_span 1, 4 and
    8: up to 32 query rows), over lengths, window and softcap
    (:func:`_attn_check_cases`). The pool's 2048 positions split across
    blocks (16 chunks of 128 at B = 1, split boundaries inside the
    pages)."""
    results["attn_err"], results["attn_splits"] = _attn_check_cases(
        dev, gen, kvh=KVH, gqa=GQA, D=HEAD_DIM, S=2048,
        batches=[(B, [ATTN_LENGTHS[b % len(ATTN_LENGTHS)] for b in range(B)])
                 for B in ATTN_BATCHES],
        knobs=ATTN_KNOBS, pages=(256, 128), q_spans=ATTN_Q_SPANS, pps=(1, 2))


def _attn_bytes(B, ctx, int8, q_span=1, kvh=KVH, gqa=GQA, D=HEAD_DIM):
    """Bytes a decode attention launch must move: the K/V (and step)
    rows of the live positions, q (fp32) and out (fp32)."""
    row = D + 2 if int8 else 2 * D
    return 2 * B * kvh * ctx * row + 2 * B * kvh * q_span * gqa * D * 4


def _sdpa_ms(B, ctx, q_span, dev, gen, kvh=KVH, gqa=GQA, D=HEAD_DIM,
             window=None):
    """The library figure of a decode attention launch: one
    ``scaled_dot_product_attention(..., enable_gqa=True)`` of B rows of
    ``q_span`` positions over ``ctx`` contiguous bf16 keys (the last
    position at ctx - 1), the keys rotating over enough layers to exceed
    the L2 four times; above one position with the mask the kernel
    applies (causal inside the window, and ``window``). It has no
    softcap. The port never calls it."""
    F = torch.nn.functional
    L = max(2, min(256, math.ceil(4 * L2_BYTES / _attn_bytes(
        B, ctx, False, q_span, kvh, gqa, D))))
    k = torch.randn(L, B, kvh, ctx, D, generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn(L, B, kvh, ctx, D, generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn(B, kvh * gqa, q_span, D, generator=gen, device=dev).to(
        torch.bfloat16)
    mask = None
    if q_span > 1:
        t = torch.arange(ctx, device=dev)[None, :]
        last = (ctx - q_span + torch.arange(q_span, device=dev))[:, None]
        mask = t <= last
        if window is not None:
            mask = mask & (t > last - window)
    ms = device_ms(lambda i: F.scaled_dot_product_attention(
        q, k[i % L], v[i % L], attn_mask=mask, enable_gqa=True), 200)
    del k, v
    return ms


def phase_attn_time(dev, gen, results):
    """K3/K4 per launch at B 1/4/8 and a live context of 128, 512 and 1900
    tokens, slot and paged (page 256), with the cache rotating over enough
    layers that the read set exceeds the 50 MB L2 four times; beside the
    bound, the plain version and, for K3, one
    ``scaled_dot_product_attention(..., enable_gqa=True)`` over the same
    keys laid out contiguously (the port never calls it). Each row prints
    the split the wrapper chose (n_split x chunk), the blocks launched and
    the share of the bound. Then 32 query rows (q_span 8) over the pool
    at 1900 tokens (SDPA, for K3, with the verify window's causal mask),
    the split sweep: paged K3 and K4 at every B and context with each
    chunk of ATTN_SWEEP_CHUNKS forced, and Gemma2-9B's shape: B = 4 rows
    of 1900 positions, KVH 8, G 2, D 256, softcap 50 and the 4096 window,
    slot at q_span 1 and paged at q_span 1 and 16, beside SDPA over
    contiguous bf16 keys (at q_span 16 with the window's mask; for K4
    too; it has no softcap), and the paged cases' split sweep."""
    from quantizations_tpu_torch.ops import attention as at
    from quantizations_tpu_torch.ops import paged_attention as pa
    from quantizations_tpu_torch.ops.cuda import (FLASH_DECODE,
                                                  FLASH_DECODE_I8)

    F = torch.nn.functional
    llama = (KVH, GQA, HEAD_DIM)
    rows, sweep, rows_d256, sweep_d256 = [], [], [], []

    def layers(B, ctx, int8, q_span, shape):
        return max(2, min(256, math.ceil(
            4 * L2_BYTES / _attn_bytes(B, ctx, int8, q_span, *shape))))

    def slot_case(B, ctx, int8, shape=llama, knobs={}):
        """A slot cache of exactly ctx positions a layer over L layers:
        (operands, launch, plain version, L)."""
        kvh, gqa, D = shape
        L = layers(B, ctx, int8, 1, shape)
        ln = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        q = torch.randn(B, kvh, gqa, D, generator=gen, device=dev)
        k, v, ks, vs = _attn_cache((L, B, kvh, ctx, D), dev, gen, int8)
        if int8:
            run = lambda i: at.flash_decode_attention_stacked_i8(
                q, k, v, ks, vs, i % L, ln, **knobs)
            plain = lambda i: at.flash_decode_attention_stacked_i8_plain(
                q, k, v, ks, vs, i % L, ln, **knobs)
        else:
            run = lambda i: at.flash_decode_attention_stacked(
                q, k, v, i % L, ln, **knobs)
            plain = lambda i: at.flash_decode_attention_stacked_plain(
                q, k, v, i % L, ln, **knobs)
        return (q, k, v), run, plain, L

    def paged_case(B, ctx, int8, q_span, shape=llama, knobs={}):
        """A pool rotating over L layers for rows of ctx live tokens and
        q_span query positions: (operands, launch, plain version, launch
        with a forced split, n_pos, L)."""
        kvh, gqa, D = shape
        page = 256
        n_pages = -(-ctx // page)
        L = layers(B, ctx, int8, q_span, shape)
        k, v, ks, vs, table = _attn_pool(B, [ctx - q_span + 1] * B, page,
                                         n_pages, q_span, dev, gen, int8,
                                         L=L, kvh=kvh, D=D)
        ln = torch.full((B,), ctx - q_span + 1, dtype=torch.int32,
                        device=dev)
        q = torch.randn(B, kvh, q_span * gqa, D, generator=gen, device=dev)
        kw = dict(q_span=q_span, **knobs)
        if int8:
            run = lambda i: pa.paged_flash_decode_attention_i8(
                q, k, v, ks, vs, table, i % L, ln, **kw)
            plain = lambda i: pa.paged_flash_decode_attention_i8_plain(
                q, k, v, ks, vs, table, i % L, ln, **kw)
        else:
            run = lambda i: pa.paged_flash_decode_attention(
                q, k, v, table, i % L, ln, **kw)
            plain = lambda i: pa.paged_flash_decode_attention_plain(
                q, k, v, table, i % L, ln, **kw)

        def forced(split):
            return lambda i: at.launch_decode(
                q, k[i % L], v[i % L], ln, page=page, n_pos=0,
                scale=D ** -0.5, softcap=knobs.get("softcap"),
                window=knobs.get("window"), q_span=q_span, table=table,
                k_step=None if ks is None else ks[i % L],
                v_step=None if vs is None else vs[i % L], split=split)
        return (k, v, ks, vs, table, q), run, plain, forced, n_pages * page, L

    def timed(name, fn):
        """(ms per launch, the (n_split, chunk, blocks) it launched)."""
        ms = device_ms(fn, 200)
        return ms, (FLASH_DECODE_I8 if "i8" in name else FLASH_DECODE
                    ).last_grid

    def record(name, form, B, ctx, q_span, timing, pms, lib, L, shape=llama,
               out=rows, extra={}):
        kvh, gqa, D = shape
        ms, (n_split, chunk, blocks) = timing
        nbytes = _attn_bytes(B, ctx, "i8" in name, q_span, *shape)
        flops = 4 * B * kvh * q_span * gqa * ctx * D
        bms, by = bound(nbytes, flops, FP32_FLOP_PER_S)
        out.append(dict(kernel=name, form=form, B=B, ctx=ctx, q_span=q_span,
                        **extra, ms=ms, plain_ms=pms, bound_ms=bms,
                        bound_by=by, library_ms=lib, bytes=nbytes,
                        layers_rotated=L, n_split=n_split, chunk=chunk,
                        blocks=blocks, share_of_bound=bms / ms))
        libs = ("none" if lib is None else f"{lib * 1e3:8.2f} us" + (
            " (contiguous keys)" if form == "paged" or extra else ""))
        log(f"  {name:15s} {'D=256 ' if extra else ''}{form:5s} B={B} "
            f"ctx={ctx:4d} rows={q_span * gqa:2d}: {ms * 1e3:8.2f} us  bound "
            f"{bms * 1e3:7.2f} us ({by}, {100 * bms / ms:5.1f}%)  split "
            f"{n_split}x{chunk} {blocks} blocks  plain {pms * 1e3:8.1f} us  "
            f"sdpa {libs}")

    for int8 in (False, True):
        name = "flash_decode_i8" if int8 else "flash_decode"
        for B in ATTN_BATCHES:
            for ctx in ATTN_TIMED_CTX:
                held, slot, slot_plain, L = slot_case(B, ctx, int8)
                t_slot = timed(name, slot)
                plain_slot = device_ms(slot_plain, 20)
                lib = None
                if not int8:
                    q, k, v = held
                    qs = q.to(torch.bfloat16).reshape(B, KVH * GQA, 1,
                                                      HEAD_DIM)
                    lib = device_ms(lambda i: F.scaled_dot_product_attention(
                        qs, k[i % L], v[i % L], enable_gqa=True), 200)
                del held, slot, slot_plain
                record(name, "slot", B, ctx, 1, t_slot, plain_slot, lib, L)
                # paged: page 256, each row's pages shuffled over the pool
                held, run, plain, forced, n_pos, L = paged_case(B, ctx, int8,
                                                                1)
                record(name, "paged", B, ctx, 1, timed(name, run),
                       device_ms(plain, 20), lib, L)
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
        # 32 query rows over the pool (speculative verify of 8 positions);
        # SDPA (for K3) with the verify window's causal mask
        for B in ATTN_BATCHES:
            held, run, plain, _, _, L = paged_case(B, 1900, int8, 8)
            lib = None if int8 else _sdpa_ms(B, 1900, 8, dev, gen)
            record(name, "paged", B, 1900, 8, timed(name, run),
                   device_ms(plain, 20), lib, L)
            del held, run, plain
            torch.cuda.empty_cache()

    # Gemma2-9B's shape
    g2 = (G2_KVH, G2_GQA, G2_HEAD_DIM)
    knobs = dict(softcap=G2_CAP, window=G2_WINDOW)
    extra = dict(head_dim=G2_HEAD_DIM, kvh=G2_KVH, gqa=G2_GQA, **knobs)
    B, ctx = G2_TIMED_B, G2_TIMED_CTX
    lib = {qs: _sdpa_ms(B, ctx, qs, dev, gen, *g2, window=G2_WINDOW)
           for qs in (1, 16)}
    for int8 in (False, True):
        name = "flash_decode_i8" if int8 else "flash_decode"
        held, run, plain, L = slot_case(B, ctx, int8, g2, knobs)
        record(name, "slot", B, ctx, 1, timed(name, run),
               device_ms(plain, 20), lib[1], L, g2, rows_d256, extra)
        del held, run, plain
        for q_span in (1, 16):
            held, run, plain, forced, n_pos, L = paged_case(
                B, ctx, int8, q_span, g2, knobs)
            record(name, "paged", B, ctx, q_span, timed(name, run),
                   device_ms(plain, 20), lib[q_span], L, g2, rows_d256, extra)
            for chunk in ATTN_SWEEP_CHUNKS:
                if chunk <= n_pos:
                    n = -(-n_pos // chunk)
                    sweep_d256.append(dict(
                        kernel=name, q_span=q_span, n_split=n, chunk=chunk,
                        ms=device_ms(forced((n, chunk)), 200)))
            log(f"  {name:15s} D=256 sweep q_span={q_span:2d}: " + ", ".join(
                f"{r['n_split']}x{r['chunk']} {r['ms'] * 1e3:.2f} us"
                for r in sweep_d256 if r["kernel"] == name
                and r["q_span"] == q_span))
            del held, run, plain, forced
        torch.cuda.empty_cache()
    results["attn_time"] = rows
    results["attn_sweep"] = sweep
    results["attn_time_d256"] = rows_d256
    results["attn_sweep_d256"] = sweep_d256


# decode attention at Gemma2-9B: 8 kv heads, 2 query heads each, head_dim
# 256, softcap 50, the 4096-position window of the even layers (the odd
# layers' 2**30 is global)
G2_KVH, G2_GQA, G2_HEAD_DIM = 8, 2, 256
G2_WINDOW, G2_CAP = 4096, 50.0
# 17 pages of 256 a row: the attention checks' caches, the long
# generate's cache and the engine's max_seq, past the window
G2_SEQ = 4352
G2_ATTN_LENS = {1: (4300,), 4: (1, 1900, 4097, 4300)}
G2_ATTN_KNOBS = ((None, None), (G2_WINDOW, G2_CAP), (2 ** 30, G2_CAP))
G2_Q_SPANS = (1, 4, 16)        # 16 positions: 32 query rows at G = 2
G2_TIMED_B, G2_TIMED_CTX = 4, 1900


def phase_attn_gemma2(dev, gen, results):
    """K3 and K4 at Gemma2-9B's attention shapes (KVH 8, G 2, D 256)
    against their plain versions (:func:`_attn_check_cases`): the slot
    cache of 4352 positions and the paged pool (page 256, 17 pages a
    row), q_span 1, 4 and 16 (32 query rows in four groups), B 1 and 4
    with lengths up to 4300, past the 4096 window; no window or softcap,
    the even layers' window 4096 with softcap 50, and the odd layers'
    2**30 with softcap 50. Tolerance 1e-5 * max|out|, as at head_dim
    128."""
    results["attn_err_d256"], results["attn_splits_d256"] = (
        _attn_check_cases(dev, gen, kvh=G2_KVH, gqa=G2_GQA, D=G2_HEAD_DIM,
                          S=G2_SEQ, batches=G2_ATTN_LENS.items(),
                          knobs=G2_ATTN_KNOBS, pages=(256,),
                          q_spans=G2_Q_SPANS, pps=(2,), tag=" at D=256"))


def _glue_operands(N, dev, gen):
    """One set of K11-K13's operands at ``N`` rows in the layer's forms:
    the bf16 residual ``x``, an fp32 delta ``d`` (an o or down output),
    the bf16 gain ``w``; ``q`` and ``k`` as views of an fp32 q|k|v slab
    at one position a row (decode) with their tables at positions below
    32,768; ``g`` and ``u`` as views of an fp32 gate|up slab."""
    from quantizations_tpu_torch.models.llama import rope_cos_sin

    H, I, D, nq, nkv = GLUE_H, GLUE_I, HEAD_DIM, GLUE_NQ, GLUE_NKV
    slab = torch.randn(N, (nq + 2 * nkv) * D, generator=gen, device=dev)
    gu = 2 * torch.randn(N, 2 * I, generator=gen, device=dev)
    pos = torch.randint(0, 32768, (N, 1), generator=gen, device=dev)
    cos, sin = rope_cos_sin(pos, D, GLUE_THETA)
    return dict(
        x=torch.randn(N, H, generator=gen, device=dev).to(torch.bfloat16),
        d=0.5 * torch.randn(N, H, generator=gen, device=dev),
        w=(1 + 0.1 * torch.randn(H, generator=gen, device=dev)).to(
            torch.bfloat16),
        q=slab[:, :nq * D].reshape(N, 1, nq, D),
        k=slab[:, nq * D:(nq + nkv) * D].reshape(N, 1, nkv, D),
        cos=cos, sin=sin, g=gu[:, :I], u=gu[:, I:])


def _glue_calls(o):
    """(kernel, form, call, gate) for every form the layer calls K11-K13
    in; ``call(fn)`` runs the wrapper or its plain version on ``o``."""
    bf, f32, eps = torch.bfloat16, torch.float32, GLUE_EPS
    N, D = o["x"].shape[0], HEAD_DIM
    out = [
        ("add_rms_norm", "x + fp32 delta -> bf16",
         lambda f: f(o["x"], o["d"], o["w"], eps, False, bf), "norm"),
        ("add_rms_norm", "1 + w, x + fp32 delta -> bf16",
         lambda f: f(o["x"], o["d"], o["w"], eps, True, bf), "norm"),
        ("add_rms_norm", "fp32, no delta -> fp32 (post norm)",
         lambda f: f(o["d"], None, o["w"], eps, True, f32), "norm"),
        ("rope_qk", "decode, views of q|k|v",
         lambda f: f(o["q"], o["k"], o["cos"], o["sin"]), "bits"),
        ("glu_act", "silu -> bf16",
         lambda f: f(o["g"], o["u"], "silu", bf), "bits"),
        ("glu_act", "gelu_tanh -> bf16",
         lambda f: f(o["g"], o["u"], "gelu_tanh", bf), "bits"),
        ("glu_act", "silu -> fp32",
         lambda f: f(o["g"], o["u"], "silu", f32), "bits")]
    if N % 256 == 0:                  # prefill: 256-token rows a sequence
        B = N // 256
        out.append(("rope_qk", f"prefill B={B} T=256, views of q|k|v",
                    lambda f: f(o["q"].reshape(B, 256, GLUE_NQ, D),
                                o["k"].reshape(B, 256, GLUE_NKV, D),
                                o["cos"].reshape(B, 256, D),
                                o["sin"].reshape(B, 256, D)), "bits"))
    return out


def phase_glue(dev, gen, results):
    """K11-K13 at Mistral-7B's widths: each wrapper in every form of
    ``_glue_calls`` at GLUE_ROWS, one launch a call, against its plain
    version on the same inputs (the residual, rope and activation bit for
    bit, the norm within one bf16 ulp: ``_kernel_err``'s gates); then
    timed at GLUE_TIMED_ROWS in the decode layer's form (bf16 out, silu),
    the operands rotating over enough copies to exceed the L2 four times,
    beside the bound (bytes over 3.35 TB/s), the plain version and, for
    K11, ``torch.nn.functional.rms_norm`` (the norm alone, without the
    residual add; torch has no fused rope or gated activation)."""
    from quantizations_tpu_torch.ops import glue
    from quantizations_tpu_torch.ops.cuda import KERNELS

    recs = {k.name: k for k in KERNELS if k.name in GLUE_KERNELS}
    errs = {n: dict(max_abs_err=0.0, max_err_over_max_y=0.0, forms=[])
            for n in GLUE_KERNELS}
    for N in GLUE_ROWS:
        o = _glue_operands(N, dev, gen)
        for name, form, call, gate in _glue_calls(o):
            before = recs[name].launches
            out = call(getattr(glue, name))
            if recs[name].launches != before + 1:
                raise AssertionError(f"{name} {form} N={N}: "
                                     f"{recs[name].launches - before} "
                                     "launches, expected 1")
            ref = call(getattr(glue, name + "_plain"))
            torch.cuda.synchronize()
            rel = _kernel_err(f"{name} {form} N={N}", out, ref, gate)
            y, r = (out[-1], ref[-1]) if gate == "norm" else (out, ref)
            ab = float((y.float() - r.float()).abs().max()) if \
                gate == "norm" else 0.0
            e = errs[name]
            e["max_abs_err"] = max(e["max_abs_err"], ab)
            e["max_err_over_max_y"] = max(e["max_err_over_max_y"], rel)
            e["forms"].append(f"{form} N={N}")
        del o
    for name, e in errs.items():
        log(f"  {name}: {len(e['forms'])} forms "
            + ("residual bit for bit, norm within one bf16 ulp, max|err| "
               f"{e['max_abs_err']:.3e}" if name == "add_rms_norm"
               else "bit for bit") + " against the plain version")
    H, I, D = GLUE_H, GLUE_I, HEAD_DIM
    bf, eps = torch.bfloat16, GLUE_EPS
    rows = []
    for N in GLUE_TIMED_ROWS:
        nbytes = {"add_rms_norm": N * H * (2 + 4 + 2 + 2) + 2 * H,
                  "rope_qk": N * (GLUE_NQ + GLUE_NKV) * D * 4 * 2
                  + 2 * N * D * 4,
                  "glu_act": N * I * (4 + 4 + 2)}
        R = min(32, max(2, math.ceil(4 * L2_BYTES / sum(nbytes.values()))))
        ops = [_glue_operands(N, dev, gen) for _ in range(R)]
        timed = {"add_rms_norm": lambda f, o: f(o["x"], o["d"], o["w"], eps,
                                                False, bf),
                 "rope_qk": lambda f, o: f(o["q"], o["k"], o["cos"],
                                           o["sin"]),
                 "glu_act": lambda f, o: f(o["g"], o["u"], "silu", bf)}
        for name, call in timed.items():
            fn, plain = getattr(glue, name), getattr(glue, name + "_plain")
            ms = device_ms(lambda i: call(fn, ops[i % R]), 64)
            pms = device_ms(lambda i: call(plain, ops[i % R]), 16)
            lms = (device_ms(lambda i: torch.nn.functional.rms_norm(
                ops[i % R]["x"], (H,), ops[i % R]["w"], eps), 64)
                if name == "add_rms_norm" else None)
            bms, by = bound(nbytes[name], 0)
            rows.append(dict(kernel=name, N=N, ms=ms, plain_ms=pms,
                             library_ms=lms, bound_ms=bms, bound_by=by,
                             share_of_bound=bms / ms))
            log(f"  {name:12s} N={N:5d}: {ms * 1e3:8.2f} us  bound "
                f"{bms * 1e3:7.2f} us ({100 * bms / ms:5.1f}%)  plain "
                f"{pms * 1e3:8.2f} us"
                + ("" if lms is None else
                   f"  torch rms_norm alone {lms * 1e3:7.2f} us"))
        del ops
        torch.cuda.empty_cache()
    results["glue"] = dict(err=errs, rows=rows)


def phase_model(dev, results):
    """Greedy generation at full Llama3-8B: FP4 at B = 1, 4, 8 on the
    einsum path, with ``use_flash_attention`` (K3), and with flash and an
    int8 KV cache (K4); NF4 at B = 1. Returns the FP4 parameters for the
    paged phase."""
    from quantizations_tpu_torch.config import QuantConfig, ServeConfig
    from quantizations_tpu_torch.models.llama import (
        LLAMA3_8B, TINY_LLAMA, KVCache, decode_step, fuse_projections,
        init_llama_params, map_tensors, named_tensors, prefill)
    from quantizations_tpu_torch.ops import (ADD_RMS_NORM, FLASH_DECODE,
                                             FLASH_DECODE_I8, GLU_ACT,
                                             KERNELS, PAIR_MATMUL,
                                             PAIR_MATMUL_MMA,
                                             PAIR_MATMUL_SPLITK,
                                             QUANTIZE_4BIT, ROPE_QK)
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    serve = ServeConfig(max_seq_len=128, max_new_tokens=60, temperature=0.0)
    layers = LLAMA3_8B.num_hidden_layers
    per_generate = serve.max_new_tokens * (4 * layers + 1)
    k1_recs = (PAIR_MATMUL, PAIR_MATMUL_SPLITK, PAIR_MATMUL_MMA,
               ADD_RMS_NORM, ROPE_QK, GLU_ACT)
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
            # K1 by body: the 16B-row prefill (its lm_head at B rows), then
            # 59 decode steps at B rows; the glue in each of the 60
            # forwards
            want_k1 = _generate_k1(B, PROMPT_LEN, serve.max_new_tokens,
                                   layers)
            if want_k1[PAIR_MATMUL.name] != per_generate:
                raise AssertionError(f"K1's closed form {want_k1}")
            want_k1.update(_glue_forwards(serve.max_new_tokens, layers))
            for it in range(TIMED_RUNS + 1):
                cache = KVCache.create(cfg, B, serve.max_seq_len, dev)
                before = {k.name: k.launches for k in k1_recs}
                before_attn = (0 if attn_kernel is None
                               else attn_kernel.launches)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                toks, _ = gen(params, idsb, cache, None)
                end.record()
                end.synchronize()
                got = {k.name: k.launches - before[k.name] for k in k1_recs}
                if got != want_k1:
                    raise AssertionError(f"K1 and the glue launched {got} "
                                         f"in one generate, expected "
                                         f"{want_k1}")
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
                             k1_by_body_per_generate=want_k1,
                             attn_launches_per_generate=(
                                 0 if attn_kernel is None
                                 else per_generate_attn),
                             first_tokens=first[0, :8].tolist(),
                             tokens=first.tolist()))
            log(f"  {qt} {attn} B={B}: {tps:.2f} tok/s, median of "
                f"{len(times)} (min {lo:.2f}, max {hi:.2f}; {t:.4f} s per "
                f"generate, K1 launches {per_generate} each, "
                f"{want_k1[PAIR_MATMUL_SPLITK.name]} on its split-K body"
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
    for k in (PAIR_MATMUL, QUANTIZE_4BIT, FLASH_DECODE, FLASH_DECODE_I8,
              ADD_RMS_NORM, ROPE_QK, GLU_ACT):
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
    on every run and tok/s the median of TIMED_RUNS. Then
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
        for it in range(TIMED_RUNS + 1):
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
        log(f"  planar B={B}: {r['tok_per_s']:.2f} tok/s, median of "
            f"{TIMED_RUNS} (min "
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
    within K8_GATE * max|y| of its plain versions and of K1 (whichever
    body K1 runs) at K8_TOKENS, with K1 above 128 rows bit-identical to
    K8 (one body, one tile rule) and within the gate of its CUDA-core
    body; K9 equal to K1 bit for bit at K9_TOKENS, on either side of
    K1's switch to its split-K body (and within 1e-5 * max|y| of its
    plain version). Every Llama3-8B pair
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
                    # K1 through whichever body it runs at T rows
                    yk1 = qm.matmul_4bit_pair(wp2[lay], s[lay], xt, qt)
                    torch.cuda.synchronize()
                    if y8.shape != (T, M) or not torch.isfinite(y8).all():
                        raise AssertionError(f"K8 {what} T={T}: bad output")
                    rel = _gate(k8, f"K8 {what} T={T}", y8, plain8[:T])
                    rel1 = _gate(rec(), f"K8 {what} T={T} against K1", y8,
                                 yk1)
                    k8["max_diff_from_k1_over_max"] = max(
                        k8["max_diff_from_k1_over_max"], rel1)
                    k8["by_shape"][name] = max(k8["by_shape"].get(name, 0.0),
                                               rel)
                    k8["cases"] += 1
                    if T not in MMA_TOKENS:
                        continue
                    y1 = run(qm.matmul_4bit_pair, qm.matmul_4bit_pair_stacked,
                             xt)
                    ycc = qm.matmul_4bit_pair_cuda_core(wp2[lay], s[lay], xt,
                                                        qt)
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
            f"plain version (worst {k8['by_shape'][name]:.3e}) and of K1, "
            f"K1 above 128 rows its own tensor-core body "
            f"bit-identical to K8, K9 bit-identical to K1 ({k8['cases']} + "
            f"{mma['cases']} + {k9['bit_identical']} cases so far)")
        del wp2, s32, x
        torch.cuda.empty_cache()
    results["pair_variants_err"] = dict(pair_prefill=k8, pair_manual=k9,
                                        pair_matmul_mma=mma)
    log(f"  K8: {k8['cases']} cases, worst max|err| {k8['max_abs_err']:.3e},"
        f" worst max|err| / max|y| {k8['max_err_over_max_y']:.3e} "
        f"({k8['worst_case']}), from K1 "
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
    """K1's three bodies, each launched directly, at BODY_TIMED_T on the
    four layer shapes and, up to 128 rows, the lm_head, beside the bound,
    dense bf16 ``torch.matmul`` and, at BODY_PLAIN_T, the plain version
    (K8's, in original order: the split-K and the tensor-core body's);
    weights rotating over a 32-layer stack. Per-forward sums (32 x the
    four shapes, with the lm_head at T up to 128 rows, as a decode
    forward's; without it above, as an admission chunk's, whose lm_head
    runs at one row) at every T, and the two crossovers: the fewest timed
    rows from which the split-K body is the faster per forward than the
    CUDA-core body at every larger count up to 128, and from which the
    tensor-core body is the faster than the split-K body at every larger
    count."""
    from quantizations_tpu_torch.ops import qmatmul as qm

    fns = _k1_body_fns()
    rows = []
    for name, M, K in K1_SHAPES:
        L = LAYERS
        wp2, scales = _pair_operands(M, K, L, dev, gen)
        R = max(2, math.ceil(4 * L2_BYTES / (M * K * 2)))
        Wd = torch.randn(R, M, K, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(max(BODY_TIMED_T), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        for T in BODY_TIMED_T:
            if name == "lm_head" and T > 128:
                continue
            xt = x[:T].contiguous()
            r = dict(shape=name, M=M, K=K, T=T)
            for body, (fn, _) in fns.items():
                r[body + "_ms"] = device_ms(lambda i: fn(
                    wp2[i % L], scales[i % L], xt, "fp4"),
                    8 if T > 128 and body == "cuda_core" else 32)
            r["library_ms"] = device_ms(lambda i: torch.matmul(
                xt, Wd[i % R].T), 32)
            r["plain_ms"] = (device_ms(lambda i: qm.matmul_4bit_pair_prefill_plain(
                wp2[0], scales[0], xt, "fp4"), 2, warmup=1)
                if T in BODY_PLAIN_T else None)
            nbytes = M * K // 2 + M * (K // 64) * 4 + T * K * 2 + T * M * 4
            r["bound_ms"], r["bound_by"] = bound(nbytes, 2 * T * M * K)
            r["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            r["ops_ms"] = 2 * T * M * K / BF16_FLOP_PER_S * 1e3
            r["tiles"] = qm.pair_mma_tiles(T)
            rows.append(r)
            log(f"  K1 bodies {name:8s} T={T:3d}: CUDA-core "
                f"{r['cuda_core_ms'] * 1e3:9.2f} us  split-K "
                f"{r['splitk_ms'] * 1e3:8.2f} us  tensor-core "
                f"{r['mma_ms'] * 1e3:8.2f} us  bound "
                f"{r['bound_ms'] * 1e3:8.2f} us ({r['bound_by']})  "
                f"torch.matmul bf16 {r['library_ms'] * 1e3:8.2f} us")
        del wp2, scales, Wd, x
        torch.cuda.empty_cache()
    keys = ("cuda_core_ms", "splitk_ms", "mma_ms", "library_ms", "bound_ms",
            "bytes_ms", "ops_ms")
    per = {}
    for T in BODY_TIMED_T:
        sel = [r for r in rows if r["T"] == T]
        f = {k: sum((1 if r["shape"] == "lm_head" else LAYERS) * r[k]
                    for r in sel) for k in keys}
        if T in BODY_PLAIN_T:
            f["plain_ms"] = sum((1 if r["shape"] == "lm_head" else LAYERS)
                                * r["plain_ms"] for r in sel)
        f["bound_by"] = ("bytes" if f["bytes_ms"] >= f["ops_ms"]
                         else "operations")
        f["launches"] = sum(1 if r["shape"] == "lm_head" else LAYERS
                            for r in sel)
        flops = 2 * T * sum((1 if r["shape"] == "lm_head" else LAYERS)
                            * r["M"] * r["K"] for r in sel)
        for b in K1_BODIES:
            f[b + "_tflops"] = flops / (f[b + "_ms"] * 1e-3) / 1e12
        f["body"] = qm.pair_body(T)
        f["ms"] = f[f["body"] + "_ms"]
        per[T] = f
        log(f"  K1 per forward at T={T} ({f['launches']} launches"
            + (", with the lm_head" if T <= 128 else "") + "): CUDA-core "
            f"body {f['cuda_core_ms']:.3f} ms, split-K body "
            f"{f['splitk_ms']:.3f} ms ({f['splitk_tflops']:.0f} TFLOP/s), "
            f"tensor-core body {f['mma_ms']:.3f} ms "
            f"({f['mma_tflops']:.0f} TFLOP/s); K1 runs the {f['body']} body; "
            f"bound {f['bound_ms']:.3f} ms ({f['bound_by']}), torch.matmul "
            f"bf16 {f['library_ms']:.3f} ms"
            + (f", plain {f['plain_ms']:.1f} ms" if "plain_ms" in f else ""))

    def from_on(ts, a, b):
        """The fewest of ``ts`` from which body ``b`` is the faster per
        forward than ``a`` at every larger count (None: at none)."""
        out = None
        for T in reversed(ts):
            if per[T][b + "_ms"] < per[T][a + "_ms"]:
                out = T
            else:
                break
        return out

    cross = dict(
        splitk=from_on([T for T in BODY_TIMED_T if T <= 128], "cuda_core",
                       "splitk"),
        mma=from_on(BODY_TIMED_T, "splitk", "mma"))
    log(f"  crossovers: the split-K body the faster than the CUDA-core body "
        f"from {cross['splitk']} rows on (K1 switches at "
        f"{qm.PAIR_SPLITK_MIN_TOKENS}); the tensor-core body the faster than "
        f"the split-K body from {cross['mma']} rows on (K1 switches at "
        f"{qm.PAIR_MMA_MIN_TOKENS})")
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


def _generate_runs(gen, params, ids, cfg, serve, dev, kernels, want, what,
                   runs=TIMED_RUNS + 1):
    """Greedy generates (a warm-up, then ``runs - 1`` timed) that must
    launch each of ``kernels`` exactly ``want`` times and give the same
    tokens every time. Returns (tokens, times in s)."""
    from quantizations_tpu_torch.models.llama import KVCache

    times, first = [], None
    B = ids.shape[0]
    for it in range(runs):
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
                                             PAIR_MATMUL_MMA,
                                             PAIR_MATMUL_SPLITK, PAIR_PREFILL)
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
    layers = base.num_hidden_layers
    for B in PV_BATCHES:
        want = MANUAL_LAUNCHES[B]
        # K9 launches K1's bodies by K1's rule: the split-K body's launches
        # are K1's and K9's at rows of its band
        splitk = _generate_k1(B, PROMPT_LEN, serve.max_new_tokens,
                              layers)[PAIR_MATMUL_SPLITK.name]
        toks, times = _generate_runs(gen, params, ids.repeat(B, 1), manual,
                                     serve, dev, (PAIR_MANUAL, PAIR_MATMUL,
                                                  PAIR_MATMUL_SPLITK,
                                                  PAIR_MATMUL_MMA,
                                                  DEQUANTIZE_4BIT_PAIR),
                                     want + (splitk, 0, 0), f"manual B={B}")
        if toks.tolist() != grid_tokens[B]:
            raise AssertionError(f"manual B={B}: tokens differ from the grid "
                                 "run's")
        t = statistics.median(times)
        n = serve.max_new_tokens * B
        runs.append(dict(batch=B, tok_per_s=n / t, tok_per_s_min=n / max(times),
                         tok_per_s_max=n / min(times), generate_s=t,
                         generate_s_all=times, launches_per_generate=dict(
                             pair_manual=want[0], pair_matmul=want[1],
                             pair_matmul_splitk=splitk)))
        log(f"  manual B={B}: {n / t:.2f} tok/s, median of {TIMED_RUNS} "
            f"(min "
            f"{n / max(times):.2f}, max {n / min(times):.2f}); K9/K1 "
            f"launches {want} each, {splitk} of them on the split-K body; "
            "the grid run's tokens")
    results["launches_pair_manual"] = {k.name: k.launches for k in KERNELS}
    results["pair_manual_generate"] = runs

    # QT_PREFILL_PAIR: a 1024-token prompt, one 1024-row prefill forward
    long_serve = ServeConfig(max_seq_len=LONG_PROMPT + 128,
                             max_new_tokens=60, temperature=0.0)
    long_ids = torch.randint(1, base.vocab_size, (1, LONG_PROMPT),
                             generator=torch.Generator().manual_seed(3)
                             ).to(dev)
    gen = make_generate_fn(base, long_serve)
    # K8: 2 chunks a projection; K1: the prefill's lm_head and the decode
    k1 = _k1_forwards([(1, LONG_PROMPT, 1), (59, 1, 1)], layers)
    want = (4 * layers * math.ceil(LONG_PROMPT / 512),
            60 * (4 * layers + 1) - 4 * layers)
    if k1[PAIR_MATMUL.name] != want[1] or k1[PAIR_MATMUL_MMA.name]:
        raise AssertionError(f"K1's closed form {k1}")
    os.environ["QT_PREFILL_PAIR"] = "1"
    try:
        for k in KERNELS:
            k.launches = 0
        toks, times = _generate_runs(gen, params, long_ids, base, long_serve,
                                     dev, (PAIR_PREFILL, PAIR_MATMUL,
                                           PAIR_MATMUL_SPLITK,
                                           DEQUANTIZE_4BIT_PAIR),
                                     want + (k1[PAIR_MATMUL_SPLITK.name], 0),
                                     "QT_PREFILL_PAIR generate")
        results["launches_pair_prefill"] = {k.name: k.launches
                                            for k in KERNELS}
    finally:
        del os.environ["QT_PREFILL_PAIR"]
    t = statistics.median(times)
    log(f"  QT_PREFILL_PAIR B=1, {LONG_PROMPT}-token prompt: "
        f"{60 / t:.2f} tok/s, median of {TIMED_RUNS} (min "
        f"{60 / max(times):.2f}, max "
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


def _k1_by_body(launches):
    """K1's launches by record for ``launches``, a list of ``(rows, n)``:
    ``n`` K1 launches at ``rows`` token rows. Every one counts in
    ``pair_matmul``; those that ``pair_body`` sends to the split-K body
    also in ``pair_matmul_splitk``, to the tensor-core body in
    ``pair_matmul_mma``."""
    from quantizations_tpu_torch.ops import pair_body

    out = dict(pair_matmul=0, pair_matmul_splitk=0, pair_matmul_mma=0)
    for rows, n in launches:
        out["pair_matmul"] += n
        body = pair_body(rows)
        if body != "cuda_core":
            out["pair_matmul_" + body] += n
    return out


def _k1_forwards(forwards, layers, proj=4):
    """K1's launches by record (:func:`_k1_by_body`) over ``forwards``, a
    list of ``(n, rows, heads)``: ``n`` forwards of ``rows`` token rows,
    each ``proj`` pair projections a layer (4 fused, 7 unfused) through K1
    where ``rows`` lie in its band (up to ``pair_max_tokens()``; above,
    the dense band or K8) and the lm_head through K1 at ``heads`` rows (a
    decode step or verify window: all its rows; a prefill or admission
    forward: one a sequence)."""
    from quantizations_tpu_torch.nn.linear import pair_max_tokens

    launches = []
    for n, rows, heads in forwards:
        if rows <= pair_max_tokens():
            launches.append((rows, n * proj * layers))
        launches.append((heads, n))
    return _k1_by_body(launches)


def _k1_serving(rows, heads, decode, layers, proj=4):
    """K1's launches by record in a serving run: one admission forward
    per entry of ``rows`` (its token rows) and ``heads`` (its sequences),
    and ``decode``, a list of ``(forwards, rows)`` of decode steps and
    verify windows."""
    return _k1_forwards([(1, r, h) for r, h in zip(rows, heads)]
                        + [(n, r, r) for n, r in decode if n], layers, proj)


def _generate_k1(B, prompt, new, layers, proj=4):
    """K1's launches by record in one generate: a prefill of ``B`` rows
    of ``prompt`` tokens (its lm_head at ``B`` rows), then ``new - 1``
    decode steps at ``B`` rows."""
    return _k1_forwards([(1, B * prompt, B), (new - 1, B, B)], layers, proj)


# the glue kernels' records (ops/glue.py), in _glue_forwards' order
GLUE_KERNELS = ("add_rms_norm", "rope_qk", "glu_act")


def _glue_forwards(n, layers, heads=None, norms=2):
    """K11-K13's launches in ``n`` forwards of ``layers`` layers through
    ``models/llama.py _layer_forward``: ``norms`` K11 a layer (each norm
    with the residual add before it; 4 with Gemma-2's post norms), one
    K12 and one K13, and one K11 for the final norm of each of the
    ``heads`` forwards (all ``n`` by default) that run the lm_head."""
    heads = n if heads is None else heads
    return {"add_rms_norm": n * norms * layers + heads,
            "rope_qk": n * layers, "glu_act": n * layers}


def _serve_paged(params, base, prompts, kv, spec_k=0, steps_per_dispatch=1,
                 max_seq=2048, prefix_req=7):
    """One ``PagedEngine`` run over ``prompts`` (the paged phase's
    configuration, ``max_seq`` positions a sequence) with a ``kv`` pool,
    driven by ``step`` or, with ``spec_k``, by ``step_spec``
    (``step_spec_multi`` with ``steps_per_dispatch`` > 1); request
    ``prefix_req`` must hit the prefix cache for two pages. Counts are
    zeroed just before the run and read just after it. Returns the run's
    record: wall time split into admission and decode, steps, admission
    group sizes, the rows of every admission forward, launches, stats and
    tokens."""
    from quantizations_tpu_torch.models.llama import prefill_pair_enabled
    from quantizations_tpu_torch.nn.linear import pair_max_tokens
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             FLASH_DECODE, FLASH_DECODE_I8,
                                             KERNELS, PAIR_MATMUL,
                                             PAIR_MATMUL_MMA,
                                             PAIR_MATMUL_SPLITK)
    from quantizations_tpu_torch.serve.paged import PagedEngine

    cfg = dataclasses.replace(base, kv_cache_dtype=kv)
    eng = PagedEngine(params, cfg, slots=4, max_seq=max_seq,
                      prefill_buckets=(64, 256), admit_width=4,
                      prefix_cache=True, num_pages=40)
    if eng.page_size != 256:
        raise AssertionError(f"page size {eng.page_size}, expected 256")
    # instrumentation: admission wall time, group sizes, forward rows,
    # prefix hits
    spent = {"admit_s": 0.0, "groups": [], "hits": {}, "rows": [],
             "heads": []}
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
        spent["heads"].append(int(ids.shape[0]))
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
    # K1 by body: every projection of an admission forward up to
    # pair_max_tokens() rows (4 per layer) and its lm_head at one row a
    # sequence; every decode step at the slots' rows, every verify window
    # at slots x spec_k rows, the lm_head at all of them
    win = st["spec_windows"]
    want_k1 = _k1_serving(spent["rows"], spent["heads"],
                          [(st["steps"] - win, eng.slots),
                           (win, eng.slots * spec_k)], layers)
    got_k1 = {n: launches[n] for n in want_k1}
    if got_k1 != want_k1 or want_k1[PAIR_MATMUL_MMA.name] == 0:
        raise AssertionError(f"K1 launched {got_k1} in {st['steps']} "
                             f"forwards ({win} windows), expected {want_k1} "
                             f"(admission rows {spent['rows']}, sequences "
                             f"{spent['heads']})")
    # the glue in every admission forward and every decode step or window
    want_glue = _glue_forwards(len(spent["rows"]) + st["steps"], layers,
                               norms=4 if base.post_norms else 2)
    got_glue = {n: launches[n] for n in GLUE_KERNELS}
    if got_glue != want_glue:
        raise AssertionError(f"K11-K13 launched {got_glue}, expected "
                             f"{want_glue}")
    mma = launches[PAIR_MATMUL_MMA.name]
    splitk = launches[PAIR_MATMUL_SPLITK.name]
    core = launches[PAIR_MATMUL.name] - mma - splitk
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
    if spent["hits"].get(uids[prefix_req], 0) != 512:
        raise AssertionError(f"request {prefix_req} hit "
                             f"{spent['hits'].get(uids[prefix_req])} prefix "
                             "positions, expected 512")
    new = PAGED_NEW * len(prompts)
    run = dict(kv_cache_dtype=kv, spec_k=spec_k,
               steps_per_dispatch=steps_per_dispatch, wall_s=wall,
               new_tokens=new, tok_per_s=new / wall, admit_s=spent["admit_s"],
               decode_s=wall - spent["admit_s"], steps=st["steps"],
               admissions=spent["groups"], admission_rows=spent["rows"],
               admission_sequences=spent["heads"], mma_launches=mma,
               splitk_launches=splitk, k1_cuda_core_launches=core,
               k10_launches=k10, launches=launches, stats=st, tokens=toks)
    how = (f"spec_k={spec_k} x {steps_per_dispatch}: {st['spec_windows']} "
           f"windows, accept rate {st['spec_accept_rate']:.3f}, "
           if spec_k else "")
    log(f"  {kv} pool, {how}{new} new tokens in {wall:.3f} s = "
        f"{new / wall:.2f} tok/s aggregate; {st['steps']} forwards; "
        f"admission {spent['admit_s']:.3f} s (groups {spent['groups']}),"
        f" decode {wall - spent['admit_s']:.3f} s; K1's CUDA-core body "
        f"{core} launches, its split-K body {splitk}, its tensor-core body "
        f"{mma}, K10 {k10} (as reckoned); launches {launches}; "
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
    it: K1 by body, K10 and K3/K4 exactly as the admission forwards' rows
    and the counted forwards say. Returns the run's record."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.nn.linear import pair_max_tokens
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             FLASH_DECODE, FLASH_DECODE_I8,
                                             KERNELS)
    from quantizations_tpu_torch.serve.engine import Engine

    cfg = dataclasses.replace(base, **knobs)
    eng = Engine(params, cfg, ServeConfig(max_seq_len=2048), slots=4,
                 prefill_buckets=(16, 64, 256))
    rows, heads, spent = [], [], {"admit_s": 0.0}
    rnd, admit = eng._prefill_round, eng._admit

    def counted_round(ids, *a):
        rows.append(int(ids.shape[0] * ids.shape[1]))
        heads.append(int(ids.shape[0]))
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
    win = st["spec_windows"]
    want = _k1_serving(rows, heads, [(st["steps"] - win, eng.slots),
                                     (win, eng.slots * run.get("spec_k", 0))],
                       layers)
    want["k10"] = 4 * layers * sum(1 for r in rows if r > band)
    got = {n: launches[n] for n in want if n != "k10"}
    got["k10"] = launches[DEQUANTIZE_4BIT_PAIR.name]
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
        + f"; K1 {got['pair_matmul']} (split-K body "
        f"{got['pair_matmul_splitk']}, tensor-core body "
        f"{got['pair_matmul_mma']}), K10 {got['k10']}, K3/K4 {got_attn} (as "
        f"reckoned; admission rows {rows})")
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
    from quantizations_tpu_torch.ops import KERNELS
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
        # the 16-row prefill (its lm_head at one row), then windows of 8
        # rows (the lm_head at all of them)
        n = {k.name: k.launches for k in KERNELS}
        want = _k1_forwards([(1, 16, 1), (steps, 8, 8)],
                            base.num_hidden_layers)
        if {k: n[k] for k in want} != want:
            raise AssertionError(f"speculative generate: K1 launched "
                                 f"{ {k: n[k] for k in want} } for {steps} "
                                 f"windows, expected {want}")
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


# -- the gemma2 phase ---------------------------------------------------------

G2_NEW = 60
G2_BATCHES = (1, 4, 8)
G2_LONG_PROMPT = 4200          # past the 4096 window of the even layers
# K1 at one row count per body: CUDA-core (1), split-K (8, 64), tensor-core
# (256)
G2_K1_TOKENS = (1, 8, 64, 256)
# K8 at the paged arm's admission rows (256 and 1024) and one 512-row
# launch
G2_K8_TOKENS = (256, 512, 1024)
# max|flash - einsum| / max|einsum| of one decode step's logits after the
# same prefix and cache (B = 4; K3 on a bf16 cache, K4 on an int8 one):
# the planar phase's layout bound. The einsum arm rounds q and the
# probabilities to bf16 and the flash arm does not; random deep models
# amplify that (32 Llama3-8B layers moved them 0.049, PERF.md). A planted
# fault (the newest position dropped) must land above the bound. The
# per-shape checks (1e-5) hold the kernels.
G2_LOGIT_BOUND = 0.25
# the same weights cut to these depths for the logit gap's reading
G2_LOGIT_DEPTHS = (2, 8)
G2_ARMS = (("einsum", {}), ("flash", dict(use_flash_attention=True)),
           ("flash+int8", dict(use_flash_attention=True,
                               kv_cache_dtype="int8")))


def _g2_shapes(cfg):
    """Gemma2-9B's K1 shapes (fused q|k|v and gate|up, the tied lm_head)
    and its K2 launches a build by weight shape: q, k and v, o, gate and
    up, down a layer, then the embedding and the lm_head (drawn, then
    replaced by the embedding it is tied to)."""
    h, qs, kvs, inter = (cfg.hidden_size, cfg.q_size, cfg.kv_size,
                         cfg.intermediate_size)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    k1 = (("qkv", qs + 2 * kvs, h), ("o", h, qs), ("gate_up", 2 * inter, h),
          ("down", h, inter), ("lm_head", V, h))
    k2 = {}
    for shape, n in (((qs, h), L), ((kvs, h), 2 * L), ((h, qs), L),
                     ((inter, h), 2 * L), ((h, inter), L), ((V, h), 2)):
        k2[shape] = k2.get(shape, 0) + n
    return k1, k2


def _g2_kernel_checks(cfg, dev, gen):
    """K2 bit-exact (FP4, fp32 in, the special blocks) at each weight
    shape of the build; then at each of the five K1 shapes, on layer 1 of
    a stack of two with the build's fp32 scales: K1 through the stacked
    dispatch at T = 1, 8, 64 and 256 (each body) within 1e-5 * max|y| of
    the plain version of the body that ``pair_body`` names, K8 through
    ``pair_prefill_matmul`` (the paged arm's call: 512-row launches) at
    its admission rows 256, 512 and 1024 within 1e-5 * max|y| of its
    plain version, each launched twice with the same bits, and K10 to
    bf16 and to fp32 bit-exact against its plain version."""
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             PAIR_PREFILL,
                                             dequantize_4bit_pair,
                                             dequantize_4bit_pair_plain,
                                             matmul_4bit_pair_stacked,
                                             pair_body,
                                             quantize_4bit_kernel,
                                             quantize_4bit_kernel_plain)
    from quantizations_tpu_torch.ops.qmatmul import (
        PREFILL_PAIR_CHUNK_T, pair_prefill_matmul)

    k1_shapes, k2_shapes = _g2_shapes(cfg)
    special = torch.from_numpy(k2_special_blocks()).to(dev)
    for (M, K), n in k2_shapes.items():
        W = torch.randn(M, K, generator=gen, device=dev) * 0.02
        W.view(-1, 64)[:special.shape[0]] = special
        wp, am = quantize_4bit_kernel(W, 64, "fp4")
        wpp, amp = quantize_4bit_kernel_plain(W, 64, "fp4")
        torch.cuda.synchronize()
        if not (torch.equal(wp, wpp) and nan_equal(am, amp)):
            raise AssertionError(f"Gemma2 K2 [{M}, {K}]: differs from its "
                                 "plain version")
        del W, wp, am, wpp, amp
        torch.cuda.empty_cache()
    log(f"  K2 bit-exact at the build's {len(k2_shapes)} weight shapes ("
        + ", ".join(f"[{M}, {K}] x{n}" for (M, K), n in k2_shapes.items())
        + f"; {sum(k2_shapes.values())} launches a build)")
    fns = dict(_k1_body_fns())
    worst = {b: 0.0 for b in K1_BODIES}
    k8 = dict(max_abs_err=0.0, max_err_over_max_y=0.0, worst_case=None,
              cases=0)
    k10 = 0
    for name, M, K in k1_shapes:
        wp2, scales = _pair_operands(M, K, 2, dev, gen)
        x = torch.randn(max(G2_K8_TOKENS), K, generator=gen,
                        device=dev).to(torch.bfloat16)
        # K8's plain version is also the split-K and tensor-core bodies'
        plains = {fns["splitk"][1]: fns["splitk"][1](wp2[1], scales[1], x,
                                                     "fp4")}
        for T in G2_K1_TOKENS:
            body = pair_body(T)
            plain = fns[body][1]
            if plain not in plains:
                plains[plain] = plain(wp2[1], scales[1],
                                      x[:max(G2_K1_TOKENS)], "fp4")
            ref = plains[plain][:T]
            y = matmul_4bit_pair_stacked(wp2, scales, x[:T], 1, "fp4")
            again = matmul_4bit_pair_stacked(wp2, scales, x[:T], 1, "fp4")
            torch.cuda.synchronize()
            if y.shape != (T, M) or not torch.isfinite(y).all():
                raise AssertionError(f"Gemma2 K1 {name} T={T}: bad output")
            rel = (y - ref).abs().max().item() / ref.abs().max().item()
            if not rel <= 1e-5:
                raise AssertionError(f"Gemma2 K1 {name} [{M}, {K}] T={T} "
                                     f"({body}): {rel:.3e} of max|y| > 1e-5")
            if not torch.equal(y.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"Gemma2 K1 {name} T={T}: two launches "
                                     "differ")
            worst[body] = max(worst[body], rel)
        ref8 = plains[fns["splitk"][1]]
        for T in G2_K8_TOKENS:
            before = PAIR_PREFILL.launches
            y = pair_prefill_matmul(wp2, scales, x[:T], "fp4", layer_idx=1)
            again = pair_prefill_matmul(wp2, scales, x[:T], "fp4",
                                        layer_idx=1)
            torch.cuda.synchronize()
            what = f"Gemma2 K8 {name} [{M}, {K}] T={T}"
            if PAIR_PREFILL.launches != before + 2 * math.ceil(
                    T / PREFILL_PAIR_CHUNK_T):
                raise AssertionError(f"{what}: launched "
                                     f"{PAIR_PREFILL.launches - before} times")
            if y.shape != (T, M) or not torch.isfinite(y).all():
                raise AssertionError(f"{what}: bad output")
            _gate(k8, what, y, ref8[:T], 1e-5)
            if not torch.equal(y.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"{what}: two launches differ")
            k8["cases"] += 1
        del plains, ref8, y, again
        for dt in (torch.bfloat16, torch.float32):
            before = DEQUANTIZE_4BIT_PAIR.launches
            got = dequantize_4bit_pair(wp2, scales, "fp4", dt, layer_idx=1)
            ref = dequantize_4bit_pair_plain(wp2, scales, "fp4", dt, 1)
            torch.cuda.synchronize()
            what = f"Gemma2 K10 {name} [{M}, {K}] -> {dt}"
            if DEQUANTIZE_4BIT_PAIR.launches != before + 1:
                raise AssertionError(f"{what}: not launched once")
            if got.shape != (M, K) or not torch.equal(
                    got.view(torch.uint8), ref.view(torch.uint8)):
                raise AssertionError(f"{what}: not bit-exact with its plain "
                                     "version")
            k10 += 1
            del got, ref
        del wp2, scales, x
        torch.cuda.empty_cache()
    names = ", ".join(f"{n} [{M}, {K}]" for n, M, K in k1_shapes)
    log(f"  K1 at Gemma2's shapes ({names}), T = {G2_K1_TOKENS}: worst "
        "max|err| / max|y| by body "
        + ", ".join(f"{b} {w:.3e}" for b, w in worst.items())
        + "; the same bits twice")
    log(f"  K8 at the same shapes, T = {G2_K8_TOKENS}: {k8['cases']} cases "
        f"within 1e-5, worst {k8['max_err_over_max_y']:.3e} of max|y| "
        f"({k8['worst_case']}), the same bits twice; K10 {k10} cases "
        "bit-exact (bf16 and fp32 out)")
    return dict(k2_shapes=[dict(M=M, K=K, launches_per_build=n)
                           for (M, K), n in k2_shapes.items()],
                k1_shapes=[dict(shape=n, M=M, K=K) for n, M, K in k1_shapes],
                k1_max_err_over_max_y=worst, pair_prefill=k8,
                dequantize_4bit_pair_cases=k10)


def _g2_generates(params, cfg, dev):
    """The slot generate at B = 1, 4 and 8 on each arm: 60 new tokens
    after a 16-token prompt, run twice (the same tokens; the second run
    timed), K1 exactly as ``_generate_k1`` reckons by body, K3 or K4
    exactly 59 x 42 times a flash generate and never on the einsum arm,
    K10 never."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.ops import (ADD_RMS_NORM,
                                             DEQUANTIZE_4BIT_PAIR,
                                             FLASH_DECODE, FLASH_DECODE_I8,
                                             GLU_ACT, PAIR_MATMUL,
                                             PAIR_MATMUL_MMA,
                                             PAIR_MATMUL_SPLITK, ROPE_QK)
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    serve = ServeConfig(max_seq_len=128, max_new_tokens=G2_NEW)
    L = cfg.num_hidden_layers
    recs = (PAIR_MATMUL, PAIR_MATMUL_SPLITK, PAIR_MATMUL_MMA, FLASH_DECODE,
            FLASH_DECODE_I8, DEQUANTIZE_4BIT_PAIR, ADD_RMS_NORM, ROPE_QK,
            GLU_ACT)
    ids = ((torch.arange(PROMPT_LEN, device=dev) * 7 + 11) % cfg.vocab_size
           ).to(torch.int32)[None, :]
    runs = []
    for arm, knobs in G2_ARMS:
        c = dataclasses.replace(cfg, **knobs)
        fn = make_generate_fn(c, serve)
        attn = (FLASH_DECODE_I8 if knobs.get("kv_cache_dtype") else
                FLASH_DECODE if knobs else None)
        for B in G2_BATCHES:
            want = dict(_generate_k1(B, PROMPT_LEN, G2_NEW, L))
            want.update(flash_decode=0, flash_decode_i8=0,
                        dequantize_4bit_pair=0,
                        **_glue_forwards(G2_NEW, L, norms=4))
            if attn is not None:
                want[attn.name] = (G2_NEW - 1) * L
            toks, times = _generate_runs(
                fn, params, ids.repeat(B, 1), c, serve, dev, recs,
                [want[k.name] for k in recs], f"Gemma2 {arm} B={B}", runs=2)
            tps = G2_NEW * B / times[-1]
            runs.append(dict(attention=arm, batch=B, tok_per_s=tps,
                             generate_s=times[-1], generate_s_all=times,
                             launches_per_generate=want,
                             tokens=toks.tolist()))
            log(f"  Gemma2-9B {arm} B={B}: {tps:.2f} tok/s ({times[-1]:.4f} "
                f"s a generate, the second of 2 runs; the same tokens "
                f"twice); K1 {want['pair_matmul']} launches "
                f"({want['pair_matmul_splitk']} split-K, "
                f"{want['pair_matmul_mma']} tensor-core)"
                + ("" if attn is None else f", {attn.name} "
                   f"{want[attn.name]}"))
    by = {(r["attention"], r["batch"]): r["tokens"] for r in runs}
    for B in G2_BATCHES:
        log(f"  B={B}: flash agrees with einsum on "
            f"{_agree(by[('flash', B)], by[('einsum', B)])}, flash+int8 on "
            f"{_agree(by[('flash+int8', B)], by[('einsum', B)])} of "
            f"{B * G2_NEW} tokens")
    return runs


@contextlib.contextmanager
def _g2_flash_as(kind, errs=None):
    """The model's K3/K4 calls (``models/llama.py``'s module globals) for
    the span of a ``with``. ``kind``: None, as they are; ``"tee"``, the
    kernel, with the plain version run on the same inputs and each call's
    max|kernel - plain| / max|plain| appended to ``errs``; ``"plain"``,
    the fp32 plain versions (the flash arm's function with q and the
    probabilities in fp32, which the einsum arm rounds to bf16);
    ``"jitter"``, the plain versions plus 1e-6 * max|out| of seeded
    normal noise (a kernel as exact as K3/K4 per call, in another fp32
    order); or a planted fault in K3/K4's arguments: ``"newest"`` the
    newest position dropped (lengths - 1), ``"softcap"`` the softcap
    dropped, ``"window"`` the window dropped."""
    from quantizations_tpu_torch.models import llama as lm
    from quantizations_tpu_torch.ops import attention as at

    names = ("flash_decode_attention_stacked",
             "flash_decode_attention_stacked_i8")
    saved = {n: getattr(lm, n) for n in names}
    noise = {}

    def wrap(n):
        real, plain = saved[n], getattr(at, n + "_plain")

        def call(*args, **kw):
            if kind == "tee":
                out, ref = real(*args, **kw), plain(*args, **kw)
                errs.append(((out - ref).abs().max()
                             / ref.abs().max()).item())
                return out
            if kind == "jitter":
                out = plain(*args, **kw)
                if out.device not in noise:
                    noise[out.device] = torch.Generator(
                        device=out.device).manual_seed(6)
                return out + 1e-6 * out.abs().max() * torch.randn(
                    out.shape, generator=noise[out.device],
                    device=out.device)
            args = list(args)
            if kind == "newest":
                args[-1] = args[-1] - 1
            else:
                kw[kind] = None
            return real(*args, **kw)
        return call

    for n in names:
        if kind == "plain":
            setattr(lm, n, getattr(at, n + "_plain"))
        elif kind is not None:
            setattr(lm, n, wrap(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(lm, n, f)


def _g2_gap(got, ref):
    """max|got - ref| / max|ref| of two logit blocks."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def _g2_decode_arms(params, cfg, ids, dev, arms, max_seq=128):
    """One decode step's logits after the same prefill of ``ids[:, :-1]``,
    on each arm of ``arms`` ((name, use_flash_attention, _g2_flash_as
    kind)): the prefill once (its attention is the einsum path's on every
    arm), each arm's step rewriting the same position of every layer
    before it attends to it. Returns the logits by arm and the "tee"
    arms' per-call errors."""
    from quantizations_tpu_torch.models.llama import (KVCache, decode_step,
                                                      prefill)

    P = ids.shape[1] - 1
    cache = KVCache.create(cfg, ids.shape[0], max_seq, dev)
    out, errs = {}, []
    with torch.inference_mode():
        prefill(params, ids[:, :P], cache, cfg, last_token_only=True)
        for name, flash, kind in arms:
            c = dataclasses.replace(cfg, use_flash_attention=flash)
            with _g2_flash_as(kind, errs):
                out[name], _ = decode_step(params, ids[:, P:], cache, P, c)
    del cache
    return out, errs


def _g2_per_call(what, errs, n_layers):
    """K3/K4 in the model's own decode step: one call a layer, each
    within 1e-5 * max|out| of its plain version on the same inputs."""
    if len(errs) != n_layers or not max(errs) <= 1e-5:
        raise AssertionError(f"Gemma2 {what}: K3/K4 in the model, "
                             f"{len(errs)} calls, worst {max(errs):.3e} of "
                             "max|out| from the plain version")
    return max(errs)


def _g2_logit_check(params, cfg, dev):
    """One B = 4 decode step after the same 16-token prefill: flash (K3)
    against the einsum path on a bf16 cache, flash (K4) against einsum on
    an int8 cache, each within G2_LOGIT_BOUND * max|logit|; the einsum
    path's top-2 margin printed beside them. In that step each K3/K4 call
    within 1e-5 * max|out| of its plain version on the same inputs.
    Beside them, read with no gate, on the same weights cut to each of
    G2_LOGIT_DEPTHS layers and at full depth: each arm against the flash
    arm's fp32 plain version (the einsum arm's function with q and the
    probabilities in fp32), and that plain version with 1e-6 * max|out|
    of noise a call against itself. Then planted faults in K3's arguments
    at full depth on the bf16 cache: the newest position dropped must
    land above G2_LOGIT_BOUND (the bound sees it); the softcap dropped is
    read. Last, past the window: B = 1 after G2_LONG_PROMPT tokens, each
    arm and K3 with the window dropped against einsum (read)."""
    from quantizations_tpu_torch.models.llama import map_tensors

    ids = torch.randint(1, cfg.vocab_size, (4, PROMPT_LEN + 1),
                        generator=torch.Generator().manual_seed(3)).to(
                            torch.int32).to(dev)
    L = cfg.num_hidden_layers
    arms = (("einsum", False, None), ("flash", True, "tee"),
            ("plain", True, "plain"), ("jitter", True, "jitter"))

    def gaps(out):
        return dict(flash_vs_einsum=_g2_gap(out["flash"], out["einsum"]),
                    plain_vs_einsum=_g2_gap(out["plain"], out["einsum"]),
                    flash_vs_plain=_g2_gap(out["flash"], out["plain"]),
                    jitter_vs_plain=_g2_gap(out["jitter"], out["plain"]))

    res = dict(depth={})
    for depth in [d for d in G2_LOGIT_DEPTHS if d < L] + [L]:
        p = params if depth == L else dataclasses.replace(
            params, layers=map_tensors(lambda t: t[:depth], params.layers))
        for kv in ("bf16", "int8"):
            c = dataclasses.replace(cfg, num_hidden_layers=depth,
                                    kv_cache_dtype=kv)
            faults = (("newest", True, "newest"),
                      ("softcap", True, "softcap")) if (
                          depth == L and kv == "bf16") else ()
            out, errs = _g2_decode_arms(p, c, ids, dev, arms + faults)
            row = gaps(out)
            row["per_call"] = _g2_per_call(f"{depth} layers {kv}", errs,
                                           depth)
            log(f"  B=4 decode logits at {depth} layers, {kv} cache: "
                + ", ".join(f"{k} {v:.3e}" for k, v in row.items())
                + " of max|logit| (per_call: K3/K4 against the plain "
                "version, of max|out|)")
            res["depth"][f"{depth} {kv}"] = row
            if depth < L:
                continue
            ref = out["einsum"].float()
            top2 = ref.topk(2, dim=-1).values
            margin = ((top2[:, 0] - top2[:, 1])
                      / ref.abs().amax(-1)).min().item()
            rel = row["flash_vs_einsum"]
            top1 = (out["flash"].argmax(-1) == ref.argmax(-1)).float().mean()
            res[kv] = dict(max_diff_over_max=rel, top1=top1.item(),
                           min_top2_margin_over_max=margin,
                           max_abs_logit=ref.abs().max().item())
            log(f"  B=4 decode logits, {'K4' if kv == 'int8' else 'K3'} "
                f"against einsum on the {kv} cache: {rel:.3e} of max|logit| "
                f"({ref.abs().max().item():.3f}; bound {G2_LOGIT_BOUND}), "
                f"top-1 agreement {top1.item():.3f}, einsum's smallest top-2 "
                f"margin {margin:.3e}")
            if not rel <= G2_LOGIT_BOUND:
                raise AssertionError(f"Gemma2 {kv}: flash decode logits "
                                     f"{rel:.3e} of max|logit| from einsum's")
            if faults:
                res["faults"] = {n: _g2_gap(out[n], out["einsum"])
                                 for n, _, _ in faults}
                log("  planted faults in K3's arguments, against einsum: "
                    + ", ".join(f"{n} {v:.3e}"
                                for n, v in res["faults"].items())
                    + f" of max|logit| (bound {G2_LOGIT_BOUND})")
                if not res["faults"]["newest"] > G2_LOGIT_BOUND:
                    raise AssertionError(
                        "Gemma2: dropping the newest position moved the "
                        f"logits {res['faults']['newest']:.3e} of max|logit|"
                        f", inside the bound {G2_LOGIT_BOUND}")
            del out
    ids = torch.randint(1, cfg.vocab_size, (1, G2_LONG_PROMPT + 1),
                        generator=torch.Generator().manual_seed(4)).to(
                            torch.int32).to(dev)
    out, errs = _g2_decode_arms(params, cfg, ids, dev, arms + (
        ("window", True, "window"),), max_seq=G2_SEQ)
    res["long"] = gaps(out)
    res["long"]["window_vs_einsum"] = _g2_gap(out["window"], out["einsum"])
    res["long"]["per_call"] = _g2_per_call("long", errs, L)
    log(f"  B=1 decode logits after {G2_LONG_PROMPT} tokens: "
        + ", ".join(f"{k} {v:.3e}" for k, v in res["long"].items())
        + " of max|logit| (window: K3 with the window planted away)")
    return res


def _g2_long(params, cfg, dev):
    """B = 1 after a 4,200-token prompt (past the even layers' 4096
    window), 60 new tokens, on einsum and on flash (K3), each twice (the
    same tokens): the prefill through the dense band (K10 exactly 4 x 42,
    K1 only on its one lm_head row), every decode step as the generates'."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.ops import (ADD_RMS_NORM,
                                             DEQUANTIZE_4BIT_PAIR,
                                             FLASH_DECODE, FLASH_DECODE_I8,
                                             GLU_ACT, PAIR_MATMUL,
                                             PAIR_MATMUL_MMA,
                                             PAIR_MATMUL_SPLITK, ROPE_QK)
    from quantizations_tpu_torch.serve.generate import make_generate_fn

    serve = ServeConfig(max_seq_len=G2_SEQ, max_new_tokens=G2_NEW)
    L = cfg.num_hidden_layers
    ids = torch.randint(1, cfg.vocab_size, (1, G2_LONG_PROMPT),
                        generator=torch.Generator().manual_seed(4)).to(
                            torch.int32).to(dev)
    recs = (PAIR_MATMUL, PAIR_MATMUL_SPLITK, PAIR_MATMUL_MMA, FLASH_DECODE,
            FLASH_DECODE_I8, DEQUANTIZE_4BIT_PAIR, ADD_RMS_NORM, ROPE_QK,
            GLU_ACT)
    out = {}
    for arm, knobs in G2_ARMS[:2]:
        c = dataclasses.replace(cfg, **knobs)
        want = dict(_generate_k1(1, G2_LONG_PROMPT, G2_NEW, L))
        want.update(flash_decode=(G2_NEW - 1) * L if knobs else 0,
                    flash_decode_i8=0, dequantize_4bit_pair=4 * L,
                    **_glue_forwards(G2_NEW, L, norms=4))
        toks, times = _generate_runs(
            make_generate_fn(c, serve), params, ids, c, serve, dev, recs,
            [want[k.name] for k in recs], f"Gemma2 {arm} long", runs=2)
        out[arm] = dict(tok_per_s=G2_NEW / times[-1], generate_s=times[-1],
                        generate_s_all=times, launches_per_generate=want,
                        tokens=toks.tolist())
        log(f"  Gemma2-9B {arm} B=1 after {G2_LONG_PROMPT} tokens: "
            f"{G2_NEW / times[-1]:.2f} tok/s ({times[-1]:.3f} s a generate, "
            f"the prefill's 4 x {L} K10 launches and the window masking "
            f"positions 0..{G2_LONG_PROMPT - G2_WINDOW} of the even layers "
            "from the first step); the same tokens twice")
    out["flash_agree"] = _agree(out["flash"]["tokens"],
                                out["einsum"]["tokens"])
    log(f"  after {G2_LONG_PROMPT} tokens flash agrees with einsum on "
        f"{out['flash_agree']} of {G2_NEW} tokens")
    return out


def _g2_paged(params, cfg):
    """``PagedEngine`` with the paged cell's settings (4 slots, page 256,
    40 pages, prefill_buckets (64, 256), the prefix cache) under
    ``QT_PREFILL_PAIR=1``, max_seq 4352: the paged phase's 8 requests and
    a ninth of 4,200 tokens, 32 new tokens each, through ``step`` and
    ``step_spec(16)`` (32 query rows a kv head), on a bf16 and an int8
    pool, each run twice on fresh engines (the same tokens). Counts as
    ``_serve_paged`` holds them (K3/K4 42 a forward), and K8 168 x
    ceil(rows / 512) a forward above the K1 band."""
    from quantizations_tpu_torch.nn.linear import pair_max_tokens

    g = torch.Generator().manual_seed(5)
    prompts = _paged_prompts(cfg.vocab_size) + [torch.randint(
        1, cfg.vocab_size, (G2_LONG_PROMPT,), generator=g).tolist()]
    proj = 4 * cfg.num_hidden_layers
    runs = []
    with _prefill_pair_knob():
        for kv in ("bf16", "int8"):
            for spec_k in (0, 16):
                pair = [_serve_paged(params, cfg, prompts, kv, spec_k=spec_k,
                                     max_seq=G2_SEQ, prefix_req=7)
                        for _ in range(2)]
                if pair[1]["tokens"] != pair[0]["tokens"]:
                    raise AssertionError(f"Gemma2 paged {kv} spec_k={spec_k}"
                                         ": a fresh engine gave other tokens")
                for r in pair:
                    want = sum(proj * math.ceil(n / 512)
                               for n in r["admission_rows"]
                               if n > pair_max_tokens() and n % 8 == 0)
                    if r["launches"]["pair_prefill"] != want:
                        raise AssertionError(
                            f"Gemma2 paged: K8 launched "
                            f"{r['launches']['pair_prefill']} times, expected "
                            f"{want} (admission rows {r['admission_rows']})")
                runs += pair
    plain = {r["kv_cache_dtype"]: r for r in runs if not r["spec_k"]}
    for r in runs:
        if r["spec_k"]:
            r["plain_agree"] = _agree(r["tokens"],
                                      plain[r["kv_cache_dtype"]]["tokens"])
    log(f"  int8 pool agrees with the bf16 pool on "
        f"{_agree(plain['int8']['tokens'], plain['bf16']['tokens'])} of "
        f"{PAGED_NEW * len(prompts)} tokens; spec_k=16 agrees with its "
        "plain run on " + ", ".join(
            f"{r['kv_cache_dtype']} {r['plain_agree']}" for r in runs
            if r["spec_k"]))
    return runs


def phase_gemma2(dev, gen, results):
    """Gemma2-9B at full width and depth (42 layers, hidden 3584, 16 query
    and 8 kv heads of 256, GeGLU, sandwich norms, softcaps 50 and 30, the
    4096 window on the even layers), FP4, random normal weights (scale
    0.02, seed 0), the 4-bit embedding tied to the lm_head, fused q|k|v
    and gate|up, greedy: K2 and K1 at its shapes; the build (exactly 296
    K2 launches); the slot generate on three arms; one decode step's
    flash logits against einsum's; a generate past the window; the
    ``PagedEngine`` with plain and speculative steps on both pools. Peak
    memory printed."""
    from quantizations_tpu_torch.config import QuantConfig
    from quantizations_tpu_torch.models.llama import (GEMMA2_9B,
                                                      fuse_projections,
                                                      init_llama_params,
                                                      named_tensors)
    from quantizations_tpu_torch.ops import KERNELS, QUANTIZE_4BIT

    cfg = dataclasses.replace(GEMMA2_9B, quant=QuantConfig(
        quantize_embedding=True))
    rec = dict(checks=_g2_kernel_checks(cfg, dev, gen))
    for k in KERNELS:
        k.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = fuse_projections(init_llama_params(cfg, seed=0, device=dev))
    params = dataclasses.replace(params, lm_head=params.embed)
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    want_k2 = sum(_g2_shapes(cfg)[1].values())
    if QUANTIZE_4BIT.launches != want_k2:
        raise AssertionError(f"Gemma2 build: K2 launched "
                             f"{QUANTIZE_4BIT.launches} times, expected "
                             f"{want_k2}")
    wbytes = sum(t.numel() * t.element_size()
                 for n, t in named_tensors(params)
                 if not n.startswith("lm_head"))
    rec["weights_gb"] = wbytes / 1e9
    log(f"  Gemma2-9B ({cfg.num_hidden_layers} layers) built in "
        f"{rec['build_s']:.2f} s, {wbytes / 1e9:.3f} GB of weights (the "
        f"lm_head the embedding's), {want_k2} K2 launches")
    rec["generate"] = _g2_generates(params, cfg, dev)
    rec["decode_logits"] = _g2_logit_check(params, cfg, dev)
    rec["long"] = _g2_long(params, cfg, dev)
    totals = {k.name: k.launches for k in KERNELS}
    rec["paged"] = _g2_paged(params, cfg)
    for r in rec["paged"]:
        for n, v in r["launches"].items():
            totals[n] += v
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for n in ("quantize_4bit", "pair_matmul", "pair_matmul_splitk",
              "pair_matmul_mma", "flash_decode", "flash_decode_i8",
              "dequantize_4bit_pair", "pair_prefill"):
        if totals[n] == 0:
            raise AssertionError(f"{n} was never launched in the gemma2 "
                                 "phase")
    log(f"  peak memory {rec['peak_gb']:.2f} GB; launches over the phase's "
        f"runs {totals}")
    results["gemma2"] = rec
    results["launches_gemma2"] = totals
    del params


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
    same function, arguments and seed. Engines record the (token rows,
    sequences) of their admission forwards into ``rows``. Returns (tokens
    per request, forwards or windows run)."""
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
        rows.append((int(ids.shape[0] * ids.shape[1]), int(ids.shape[0])))
        return rnd(ids, *a)

    eng._prefill_round = counted_round
    uids = [eng.submit(p, max_new_tokens=LOAD_NEW, temperature=0.0)
            for p in prompts]
    done = eng.run()
    return [done[u].output_ids for u in uids], eng.stats()["steps"]


def _cli_want(kind, flags, rows, forwards, L):
    """The direct run's launches by formula: K1 by body (generate: the
    16-row prefill, then decode steps at one row; speculative: the
    prefill, then windows of 8 rows; the engines: each admission forward
    of ``rows`` (token rows, sequences), then decode steps at their 4
    slots' rows), K11-K13 in each of those forwards, K10 per admission
    forward above the K1 band, K3 or K4 per paged decode step."""
    from quantizations_tpu_torch.nn.linear import pair_max_tokens
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             FLASH_DECODE, FLASH_DECODE_I8)

    proj = 4 if "--fuse" in flags else 7
    if kind == "generate":
        return {k: v for k, v in {**_generate_k1(1, 16, forwards, L, proj),
                                  **_glue_forwards(forwards, L)}.items()
                if v}
    if kind == "speculative":
        return {k: v for k, v in {**_k1_forwards(
            [(1, 16, 1), (forwards, 8, 8)], L, proj),
            **_glue_forwards(1 + forwards, L)}.items() if v}
    want = _k1_serving([r for r, _ in rows], [h for _, h in rows],
                       [(forwards, 4)], L, proj)
    want.update(_glue_forwards(len(rows) + forwards, L))
    want[DEQUANTIZE_4BIT_PAIR.name] = proj * L * sum(
        1 for r, _ in rows if r > pair_max_tokens())
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


# the evals phase: the parity ids, and the IFEval proxy's length and slots
EVALS_TOKENS = 128
EVALS_NEW = 32
EVALS_SLOTS = 8
# the proxy sampler at three Llama3-8B shapes (the lm_head's takes the
# row-slab path): bands for the Student-t draws' excess kurtosis (6 in
# theory; its estimate converges slowly, the 8th moment being infinite)
# and variance (5/3), and the log row norms' spread (the row scales' 0.4)
PROXY_SHAPES = (("q", 4096, 4096), ("down", 4096, 14336),
                ("lm_head", 128256, 4096))
KURTOSIS_BAND = (4.0, 12.0)
T_VAR_TOL = 0.01               # relative, around 5/3
LOG_ROW_STD_BAND = (0.35, 0.45)
OUTLIER_SDS = 5                # binomial standard deviations around 0.5%


def _model_path_attention(q, k, v, mask, cfg):
    """``evals/parity.py _attention`` with the roundings the model path's
    einsum branch has on the card (``models/llama.py _slot_attend``): q,
    K and V in bf16 (K and V as the bf16 cache holds them), the softmax
    weights rounded to bf16, fp32 products, sums and softmax."""
    B, T, n_q, D = q.shape
    n_kv = k.shape[2]
    bf = torch.bfloat16
    qg = q.reshape(B, T, n_kv, n_q // n_kv, D).to(bf).float()
    scores = torch.einsum("btkgd,bskd->btkgs", qg, k.to(bf).float()) * (
        (cfg.query_scale or D) ** -0.5)
    if cfg.attn_logit_softcap is not None:
        cap = cfg.attn_logit_softcap
        scores = cap * torch.tanh(scores / cap)
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    w = torch.softmax(scores, dim=-1)
    attn = torch.einsum("btkgs,bskd->btkgd", w.to(bf).float(),
                        v.to(bf).float())
    return attn.reshape(B * T, n_q * D)


def _proxy_stats(x, row, outlier):
    """(excess kurtosis and variance of the t-draws ``x``, std of the log
    row norms of ``x * row * outlier``, share of outlier columns), the
    moments summed in fp64 over row slabs (the draws' mean is 0)."""
    m2 = m4 = 0.0
    norms = []
    for i in range(0, x.shape[0], 8192):
        s = x[i:i + 8192].double()
        m2 += float((s * s).sum())
        m4 += float((s ** 4).sum())
        norms.append(torch.linalg.vector_norm(x[i:i + 8192] * outlier,
                                              dim=1) * row[i:i + 8192, 0])
        del s
    n = x.numel()
    var = m2 / n
    return dict(excess_kurtosis=m4 / n / var ** 2 - 3.0, t_var=var,
                log_row_norm_std=float(torch.log(torch.cat(norms)).std()),
                outlier_share=float((outlier == 8.0).float().mean()))


def _weight_stats(W):
    """Of a dequantized ``[M, K]`` weight: the std of its log row norms and
    the share of columns whose RMS is above 4x the median column's (the
    proxy's 8x outlier columns)."""
    Wf = W.float()
    rows = torch.log(torch.linalg.vector_norm(Wf, dim=1)).std()
    col = torch.sqrt((Wf * Wf).mean(dim=0))
    return dict(log_row_norm_std=float(rows),
                outlier_share=float((col > 4 * col.median()).float().mean()))


def _in_band(what, value, band):
    if not band[0] <= value <= band[1]:
        raise AssertionError(f"{what} = {value} outside {band}")


def _outlier_band(k):
    sd = math.sqrt(0.005 * 0.995 / k)
    return (max(0.0, 0.005 - OUTLIER_SDS * sd), 0.005 + OUTLIER_SDS * sd)


def _ifeval_arms(dev):
    """Run ``run_ifeval_proxy`` at Llama3-8B with every slot ``Engine``'s
    ``run`` and admission rounds watched: per arm (quantized, then the
    dense twin) its wall, launches (the counts zeroed just before the run
    and read just after it), admission rows, stats and transcripts."""
    from quantizations_tpu_torch.evals.ifeval_proxy import (detokenize,
                                                            run_ifeval_proxy)
    from quantizations_tpu_torch.ops import KERNELS
    from quantizations_tpu_torch.serve.engine import Engine

    arms = []                  # (engine, record), the engines kept alive
    real_run, real_round = Engine.run, Engine._prefill_round

    def arm(eng):
        for e, a in arms:
            if e is eng:
                return a
        arms.append((eng, dict(rows=[], heads=[])))
        return arms[-1][1]

    def counted_round(self, ids, *a):
        arm(self)["rows"].append(int(ids.shape[0] * ids.shape[1]))
        arm(self)["heads"].append(int(ids.shape[0]))
        return real_round(self, ids, *a)

    def counted_run(self, *a, **kw):
        for k in KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_run(self, *a, **kw)
        torch.cuda.synchronize()
        arm(self).update(
            wall_s=time.perf_counter() - t0,
            launches={k.name: k.launches for k in KERNELS if k.launches},
            stats=self.stats(),
            outputs=[out[u].output_ids for u in sorted(out)])
        return out

    Engine.run, Engine._prefill_round = counted_run, counted_round
    try:
        t0 = time.perf_counter()
        res = run_ifeval_proxy(preset="8b", max_new_tokens=EVALS_NEW,
                               slots=EVALS_SLOTS, device=dev)
        wall = time.perf_counter() - t0
    finally:
        Engine.run, Engine._prefill_round = real_run, real_round
    (_, quant), (_, twin) = arms
    arms.clear()
    for a in (quant, twin):
        outputs = a.pop("outputs")
        a["texts"] = [detokenize(o) for o in outputs]
        a["token_counts"] = sorted({len(o) for o in outputs})
    return res, wall, quant, twin


def phase_evals(dev, results):
    """The accuracy path at Llama3-8B's full width and depth (32 layers),
    FP4, the evals CLI's ``QuantConfig`` (a dense embedding: 7 K2 launches
    a layer and one for the lm_head), ``dist="trained_proxy"``, seed 0:
    the proxy sampler's statistics at three shapes and the built model's;
    ``logit_parity`` over 128 ids from ``default_rng(0)`` with bf16 KV,
    int8 KV and the dense-twin control, each with exact K1/K10 counts
    (K1 on the 128-row prefill, K10 on the lazy twin, 7 a layer and one
    for the lm_head; the control arm K10 on both sides); the bf16 and
    control runs again against a twin whose attention rounds q, K, V and
    the softmax weights to bf16 as the model path does on the card (a
    diagnostic of the control's floor, reported, not held); the lazy twin's
    logits against the materialized twin's, bit for bit; the IFEval proxy
    (109 examples, 8 slots, 32 new tokens) through the slot ``Engine``,
    each arm's counts exact (the twin arm no K1, the quantized arm no K10)
    and every transcript 32 tokens; and ``python -m
    quantizations_tpu_torch.evals --preset 8b --proxy --parity
    --parity-control`` as a subprocess, its JSON equal to the direct
    calls field for field."""
    import numpy as np

    from quantizations_tpu_torch.config import QuantConfig
    from quantizations_tpu_torch.evals import parity
    from quantizations_tpu_torch.evals.ifeval import sentence_splitter
    from quantizations_tpu_torch.models import llama as M
    from quantizations_tpu_torch.nn.linear import pair_max_tokens
    from quantizations_tpu_torch.ops import (DEQUANTIZE_4BIT_PAIR,
                                             PAIR_MATMUL, QUANTIZE_4BIT)

    cfg = dataclasses.replace(M.LLAMA3_8B, quant=QuantConfig())
    L = cfg.num_hidden_layers
    per = 7 * L + 1            # unfused projections and the lm_head
    rec, totals = {}, {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    # -- the proxy sampler's statistics at three shapes --
    stats = {}
    for name, m, k in PROXY_SHAPES:
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        x, row, outlier = M._proxy_parts(g, m, k, dev)
        s = stats[name] = _proxy_stats(x, row, outlier)
        del x, row, outlier
        _in_band(f"{name}: t excess kurtosis", s["excess_kurtosis"],
                 KURTOSIS_BAND)
        _in_band(f"{name}: t variance", s["t_var"],
                 (5 / 3 * (1 - T_VAR_TOL), 5 / 3 * (1 + T_VAR_TOL)))
        _in_band(f"{name}: log row norm std", s["log_row_norm_std"],
                 LOG_ROW_STD_BAND)
        _in_band(f"{name}: outlier share", s["outlier_share"],
                 _outlier_band(k))
        log(f"  proxy sampler {name} [{m}, {k}]: t excess kurtosis "
            f"{s['excess_kurtosis']:.3f} (band {KURTOSIS_BAND}), variance "
            f"{s['t_var']:.5f}, log row norm std {s['log_row_norm_std']:.4f}, "
            f"outlier columns {s['outlier_share']:.5f}")
    rec["sampler"] = stats
    torch.cuda.empty_cache()

    # -- the proxy model, K2 on every weight --
    params, build_s, n = _counted(lambda: M.init_llama_params(
        cfg, seed=0, dist="trained_proxy", device=dev))
    _expect("proxy build", n, {QUANTIZE_4BIT.name: per})
    add(n)
    model_stats = {}
    for name, ql in (("q", M.QLinear(wp=params.layers.q.wp[0],
                                     scales=params.layers.q.scales[0])),
                     ("down", M.QLinear(wp=params.layers.down.wp[0],
                                        scales=params.layers.down.scales[0])),
                     ("lm_head", params.lm_head)):
        W = M.dense_twin_weight(ql, "fp4")
        s = model_stats[name] = _weight_stats(W)
        del W
        _in_band(f"model {name}: log row norm std", s["log_row_norm_std"],
                 LOG_ROW_STD_BAND)
        _in_band(f"model {name}: outlier columns", s["outlier_share"],
                 _outlier_band(ql.in_features))
    gains = params.layers.attn_norm.float()
    rec.update(build_s=build_s, build_launches=n, model=model_stats,
               gain_mean=float(gains.mean()), gain_std=float(gains.std()))
    log(f"  proxy build: {build_s:.3f} s, K2 {n[QUANTIZE_4BIT.name]} "
        f"launches; dequantized q/down/lm_head {model_stats}; attention "
        f"norm gains mean {rec['gain_mean']:.4f} std {rec['gain_std']:.4f}")

    # -- logit parity: bf16 KV, int8 KV, the dense-twin control --
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, EVALS_TOKENS)), dtype=torch.int32, device=dev)
    twin = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, dense_twin=True))
    reports = {}
    # a quantized run: one forward of EVALS_TOKENS rows, the lm_head at all
    k1 = {k: v for k, v in _k1_forwards(
        [(1, EVALS_TOKENS, EVALS_TOKENS)], L, proj=7).items() if v}
    if k1[PAIR_MATMUL.name] != per:
        raise AssertionError(f"K1's closed form {k1}")
    # the port's forward (its glue: K11-K13) in every arm; the reference's
    # dense forward is plain torch
    glue = _glue_forwards(1, L)
    k1.update(glue)
    for name, c, want in (
            ("bf16", cfg, {**k1, DEQUANTIZE_4BIT_PAIR.name: per}),
            ("int8", dataclasses.replace(cfg, kv_cache_dtype="int8"),
             {**k1, DEQUANTIZE_4BIT_PAIR.name: per}),
            ("control", twin, {**glue, DEQUANTIZE_4BIT_PAIR.name: 2 * per})):
        rep, wall, n = _counted(lambda: parity.logit_parity(params, c, ids))
        _expect(f"parity {name}", n, want)
        add(n)
        rep = rep.to_dict()
        if not all(math.isfinite(v) for v in rep.values()):
            raise AssertionError(f"parity {name}: {rep}")
        reports[name] = dict(report=rep, wall_s=wall, launches=n)
        log(f"  parity {name}: {rep} in {wall:.3f} s; launches {n}")
    if not (reports["control"]["report"]["mean_kl"]
            < reports["bf16"]["report"]["mean_kl"]):
        raise AssertionError("the control arm's KL is not below the "
                             "quantized arm's")
    rec["parity"] = reports
    rec["control_kl_share"] = (reports["control"]["report"]["mean_kl"]
                               / reports["bf16"]["report"]["mean_kl"])
    log(f"  control KL / quantized KL: {rec['control_kl_share']:.4f}")

    # -- the control's floor: the same runs against a twin whose attention
    # rounds as the model path's does on the card (a diagnostic) --
    fp32_attention = parity._attention
    parity._attention = _model_path_attention
    try:
        rounded = {}
        for name, c, want in (
                ("bf16", cfg, {**k1, DEQUANTIZE_4BIT_PAIR.name: per}),
                ("control", twin,
                 {**glue, DEQUANTIZE_4BIT_PAIR.name: 2 * per})):
            rep, wall, n = _counted(
                lambda: parity.logit_parity(params, c, ids))
            _expect(f"parity {name}, rounded twin", n, want)
            add(n)
            rep = rep.to_dict()
            if not all(math.isfinite(v) for v in rep.values()):
                raise AssertionError(f"parity {name}, rounded twin: {rep}")
            rounded[name] = rep
            log(f"  parity {name} against the twin with the model path's "
                f"attention roundings: {rep}")
    finally:
        parity._attention = fp32_attention
    rec["parity_rounded_twin"] = rounded
    rec["control_kl_share_rounded"] = (
        rounded["control"]["mean_kl"] / rounded["bf16"]["mean_kl"])
    log(f"  with those roundings, control KL / quantized KL: "
        f"{rec['control_kl_share_rounded']:.4f}")

    # -- the lazy twin against the materialized one, bit for bit --
    def both():
        dense = parity.dequantized_params(params, cfg)
        mat = parity._dense_forward(dense, ids, cfg)
        del dense
        return mat, parity._dense_forward(params, ids, cfg, lazy=True)

    (mat, lazy), wall, n = _counted(both)
    _expect("materialized and lazy twins", n,
            {DEQUANTIZE_4BIT_PAIR.name: 2 * per})
    add(n)
    if not torch.equal(mat, lazy):
        raise AssertionError("the lazy twin's logits differ from the "
                             "materialized twin's")
    rec.update(twin_bytes=parity.dense_twin_bytes(params), twin_s=wall,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log(f"  materialized twin ({rec['twin_bytes'] / 1e9:.2f} GB) and lazy "
        f"twin: logits bit-identical ({wall:.3f} s for both)")
    del mat, lazy, params
    torch.cuda.empty_cache()

    # -- the IFEval proxy through the slot Engine, both arms --
    res, wall, quant, twin_arm = _ifeval_arms(dev)
    band = pair_max_tokens()
    for what, a, want in (
            ("quantized", quant, {
                **_k1_serving(quant["rows"], quant["heads"],
                              [(quant["stats"]["steps"], EVALS_SLOTS)], L,
                              proj=7),
                **_glue_forwards(quant["stats"]["steps"]
                                 + len(quant["rows"]), L),
                DEQUANTIZE_4BIT_PAIR.name: 7 * L * sum(
                    1 for r in quant["rows"] if r > band)}),
            ("dense twin", twin_arm, {
                **_glue_forwards(twin_arm["stats"]["steps"]
                                 + len(twin_arm["rows"]), L),
                DEQUANTIZE_4BIT_PAIR.name: per * (
                    twin_arm["stats"]["steps"] + len(twin_arm["rows"]))})):
        _expect(f"ifeval proxy, {what} arm", a["launches"],
                {k: v for k, v in want.items() if v})
        add(a["launches"])
        if a["token_counts"] != [EVALS_NEW] or not all(a["texts"]):
            raise AssertionError(f"{what} arm: transcripts of "
                                 f"{a['token_counts']} tokens, or empty")
    if PAIR_MATMUL.name in twin_arm["launches"] or \
            DEQUANTIZE_4BIT_PAIR.name in quant["launches"]:
        raise AssertionError("an arm launched the other arm's kernel")
    if (res["n_examples"], res["n_instructions"]) != (109, 120):
        raise AssertionError(f"ifeval proxy: {res['n_examples']} examples, "
                             f"{res['n_instructions']} instructions")
    splitter = sentence_splitter()
    rec["ifeval_proxy"] = dict(
        result=res, wall_s=wall, splitter=splitter,
        arms={k: dict(wall_s=a["wall_s"], launches=a["launches"],
                      stats=a["stats"], admission_rows=a["rows"],
                      texts=a["texts"])
              for k, a in (("quantized", quant), ("dense_twin", twin_arm))})
    log(f"  ifeval proxy (109 examples, {EVALS_SLOTS} slots, {EVALS_NEW} "
        f"new tokens, sentence splitter {splitter}): quantized "
        f"{res['quantized']}, dense twin {res['dense_twin']}, deltas "
        f"{res['deltas']}, verdict agreement {res['verdict_agreement']:.4f}"
        f"; arms {quant['wall_s']:.3f} s and {twin_arm['wall_s']:.3f} s "
        f"({quant['stats']['steps']} and {twin_arm['stats']['steps']} "
        f"steps), launches {quant['launches']} and {twin_arm['launches']}; "
        f"{wall:.3f} s with its build")

    # -- the CLI as a subprocess, against the direct calls --
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "quantizations_tpu_torch.evals", "--preset",
         "8b", "--proxy", "--parity", "--parity-control"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"evals CLI exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = {"parity": reports["bf16"]["report"],
            "parity_control": reports["control"]["report"]}
    if got != want:
        raise AssertionError(f"evals CLI {got} differs from the direct "
                             f"calls {want}")
    rec.update(cli=got, cli_s=cli_s)
    log(f"  evals CLI (subprocess, {cli_s:.2f} s): its JSON equals the "
        "direct calls field for field")
    rec["launches"] = totals
    results["evals"] = rec
    results["launches_evals"] = totals


# the profile phase's Chrome trace (tens of MB): a gitignored build folder
PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "quantizations_tpu_torch", "build", "profile")


def device_kernels(events):
    """The device kernels among a profile's events (``prof.events()``):
    their count and their seconds by name. The device timeline's copy of
    a ``record_function`` range (the program's ``qt:`` spans) is no
    kernel."""
    by_name, n = {}, 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not e.is_user_annotation:
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e6
    return n, by_name


def phase_profile(dev, results):
    """Where one FP4 batch-1 generate spends its time: ``utils/profiling
    trace()`` (``torch.profiler``, its Chrome trace written under
    :data:`PROFILE_DIR`) over one warm generate of 8 new tokens (few, to
    keep the trace small), the device kernels summed by name, the
    device's busy share of the generate's wall time (CUDA events) and the
    host's enqueue time (the generate call returning before the device
    finishes), and the glue kernels' launches (K11-K13, exactly as
    :func:`_glue_forwards` reckons). The profiler slows the host, so the
    busy share here is a lower bound."""
    from quantizations_tpu_torch.config import QuantConfig, ServeConfig
    from quantizations_tpu_torch.models.llama import (LLAMA3_8B, KVCache,
                                                      fuse_projections,
                                                      init_llama_params)
    from quantizations_tpu_torch.ops import KERNELS
    from quantizations_tpu_torch.serve.generate import make_generate_fn
    from quantizations_tpu_torch.utils.profiling import trace

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
    t_trace = time.perf_counter()
    before = {k.name: k.launches for k in KERNELS}
    with trace(PROFILE_DIR) as prof:
        t0 = time.perf_counter()
        start.record()
        gen(params, ids, cache, None)
        end.record()
        host_s = time.perf_counter() - t0
        end.synchronize()
    trace_s = time.perf_counter() - t_trace
    after = {k.name: k.launches for k in KERNELS}
    glue = {n: after[n] - before[n] for n in GLUE_KERNELS}
    want_glue = _glue_forwards(serve.max_new_tokens, cfg.num_hidden_layers)
    if glue != want_glue:
        raise AssertionError(f"profile: K11-K13 launched {glue}, expected "
                             f"{want_glue}")
    trace_mb = os.path.getsize(os.path.join(PROFILE_DIR, "trace.json")) / 1e6
    wall_s = start.elapsed_time(end) / 1e3
    n_kernels, by_name = device_kernels(prof.events())
    busy_s = sum(by_name.values())
    if busy_s == 0.0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    steps = serve.max_new_tokens
    results["profile"] = dict(
        wall_s=wall_s, host_enqueue_s=host_s, device_busy_s=busy_s,
        device_busy_share=busy_s / wall_s, kernels=n_kernels,
        kernels_per_forward=n_kernels / steps, glue_launches=glue,
        trace_s=trace_s,
        trace_mb=trace_mb,
        top=[dict(name=n[:120], s=s, share=s / busy_s) for n, s in top])
    log(f"  fp4 B=1 generate: wall {wall_s:.4f} s (CUDA events), host "
        f"enqueue {host_s:.4f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / wall_s:.1f}% of wall), {n_kernels} device "
        f"kernels ({n_kernels / steps:.0f} per forward, of them "
        f"{sum(glue.values()) / steps:.0f} K11-K13 {glue}); the traced "
        f"block and its Chrome trace ({trace_mb:.1f} MB) {trace_s:.2f} s")
    for n, s in top:
        log(f"    {s * 1e3:9.2f} ms  {100 * s / busy_s:5.1f}%  {n[:90]}")
    del params


# -- the parallel phase -------------------------------------------------------

# Llama3-8B at full width, cut to 8 of its 32 layers: room in the time
# limit for the gemma2 phase. Every gate, kernel check and closed-form
# count follows the depth.
PAR_LAYERS = 8
PAR_PROMPT = 16
PAR_NEW = 60
PAR_SEQ = 128
PAR_SP_PROMPT = 1024            # the sequence-parallel prefill
PAR_SP_DECODE = 8               # decode steps on its filled cache
PAR_SP_SEQ = PAR_SP_PROMPT + 128
PAR_SHORT_NEW = 8               # the manual-pipeline generate, the CLI
PAR_K8_PROMPT = 512             # the QT_PREFILL_PAIR prefill
PAR_SLOTS = 3                   # Engine(mesh): K6 at 3 decode rows
PAR_SLOT_REQS = 6
PAR_DEADLINE = 900.0
# max|sharded - single-card| / max|single-card| of the first forward's
# logits, and the single card's top-2 margin a parting stream may have,
# in the same unit: about twice what the fp32 order alone moves on the
# random 32-layer model (the model phase's flash against einsum decode
# logits, 0.049; PERF.md), kept at PAR_LAYERS. It cannot tell a partly
# wrong kernel from the order: the kernel checks at every shard shape
# (PAR_KERNEL_TOL) do.
PAR_LOGIT_BOUND = 0.1
# max|kernel - plain| / max|plain| of every kernel call of the parallel
# paths at each new shape: the earlier phases' tolerance (K2, K7 and K10
# bit for bit)
PAR_KERNEL_TOL = 1e-5
# max|sharded - single-card| / max|single-card| of one projection: the
# row-parallel sum over the ranks against the whole planar product, and a
# column shard's rows against the whole one's (fp32 order only)
PAR_PROJ_TOL = 1e-5

# a rank's state between the runs of one pool: its full parameters, its
# meshes (process groups are made once, by every rank, in one order)
_RANK = {}


def _par_cfg():
    from quantizations_tpu_torch.config import QuantConfig
    from quantizations_tpu_torch.models.llama import LLAMA3_8B

    return dataclasses.replace(LLAMA3_8B, num_hidden_layers=PAR_LAYERS,
                               quant=QuantConfig(quantize_embedding=True))


def _par_ids(B, n, vocab, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, vocab, (B, n), generator=g, dtype=torch.int64
                         ).to(torch.int32)


# the kernel wrappers of the parallel paths, by ``ops`` module, and the
# gate each is held to against its plain version ``<wrapper>_plain`` (the
# earlier phases' gates): "rel" within PAR_KERNEL_TOL * max|plain|,
# "bits" bit for bit, "norm" (K11) its residual bit for bit and its norm
# within one bf16 ulp of the plain version's
_PAR_WRAPPERS = (
    ("qmatmul", ("matmul_4bit_pair", "matmul_4bit_pair_stacked",
                 "matmul_4bit_pair_manual", "matmul_4bit_pair_manual_stacked",
                 "matmul_4bit_pair_prefill",
                 "matmul_4bit_pair_prefill_stacked", "matmul_4bit_planar",
                 "matmul_4bit_planar_stacked"), "rel"),
    ("gemv", ("gemv_4bit", "gemv_4bit_stacked"), "rel"),
    ("attention", ("flash_decode_attention_stacked",
                   "flash_decode_attention_stacked_i8"), "rel"),
    ("paged_attention", ("paged_flash_decode_attention",
                         "paged_flash_decode_attention_i8"), "rel"),
    ("quantize", ("quantize_4bit_kernel", "dequantize_4bit_kernel",
                  "dequantize_4bit_pair"), "bits"),
    ("glue", ("rope_qk", "glu_act"), "bits"),
    ("glue", ("add_rms_norm",), "norm"),
)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _patch(fn, new, saved):
    """Point every name of the package's modules that is bound to ``fn``
    at ``new``; ``saved`` collects what to restore."""
    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("quantizations_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            if val is fn:
                saved.append((mod, attr, fn))
                setattr(mod, attr, new)


def _unpatch(saved):
    for mod, attr, fn in reversed(saved):
        setattr(mod, attr, fn)


def _kernel_label(name, a, out):
    """A kernel call's shape as the log prints it."""
    if "x" in a:                      # [M, K] and the rows
        return f"[{out.shape[-1]}, {a['x'].shape[-1]}] x {a['x'].shape[0]}"
    if "q" in a and "k" in a:         # rope: the query and key heads
        return f"q {list(a['q'].shape)} k {list(a['k'].shape)}"
    if "q" in a:                      # the query and the cache or pool
        kv = a.get("cache_k", a.get("pages_k"))
        return f"q {list(a['q'].shape)} kv {list(kv.shape)}"
    if "W" in a:
        return f"{list(a['W'].shape)}"
    return f"{list(out.shape)}"


def _kernel_err(what, out, ref, gate):
    """max|out - ref| / max|ref| (0.0 for "bits"; the norm's for
    "norm"), or raise past the gate."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    worst = 0.0
    if gate == "norm":                # (residual, norm)
        if not torch.equal(outs[0], refs[0]):
            raise AssertionError(f"{what}: the residual is not bit for bit "
                                 "the plain version's")
        o, r = outs[1].float(), refs[1].float()
        ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
        if o.shape != r.shape or not bool(((o - r).abs() <= ulp).all()):
            raise AssertionError(f"{what}: the norm is more than one bf16 "
                                 "ulp from the plain version's")
        return (float((o - r).abs().max() / r.abs().max().clamp(min=1e-30))
                if o.numel() else 0.0)
    for o, r in zip(outs, refs):
        if o.shape != r.shape:
            raise AssertionError(f"{what}: shape {tuple(o.shape)}, plain "
                                 f"{tuple(r.shape)}")
        if gate == "bits":
            if o.dtype != r.dtype or not nan_equal(o.float(), r.float()):
                raise AssertionError(f"{what}: not bit for bit the plain "
                                     "version")
            continue
        if not torch.isfinite(o).all():
            raise AssertionError(f"{what}: non-finite output")
        err = float((o.float() - r.float()).abs().max())
        scale = float(r.float().abs().max())
        if not err <= PAR_KERNEL_TOL * scale:
            raise AssertionError(f"{what}: max|err| {err:.3e} > "
                                 f"{PAR_KERNEL_TOL} * max|y| {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


class _KernelCheck:
    """While active, the first call of each kernel wrapper
    (``_PAR_WRAPPERS``) at each shape is followed by its plain version on
    the same inputs, held to the wrapper's gate (the layer index and the
    values in the tensors are not part of the shape). ``spent`` is the
    seconds the checks took, synchronized on both sides; ``errs``
    {wrapper: {shape: error}}."""

    def __enter__(self):
        import importlib
        import inspect

        self.errs, self.spent, self._saved = {}, 0.0, []
        for short, names, gate in _PAR_WRAPPERS:
            mod = importlib.import_module(
                f"quantizations_tpu_torch.ops.{short}")
            for name in names:
                fn = getattr(mod, name)
                _patch(fn, self._wrap(name, fn, getattr(mod, name + "_plain"),
                                      gate, inspect.signature(fn)),
                       self._saved)
        return self

    def __exit__(self, *exc):
        _unpatch(self._saved)

    def _wrap(self, name, fn, plain, gate, sig):
        seen = self.errs.setdefault(name, {})

        def run(*args, **kw):
            out = fn(*args, **kw)
            a = sig.bind(*args, **kw).arguments
            key = tuple((k, tuple(v.shape), v.dtype)
                        if isinstance(v, torch.Tensor) else (k, v)
                        for k, v in a.items() if k != "layer_idx")
            label = _kernel_label(name, a, out if not isinstance(
                out, tuple) else out[0])
            if (key, label) not in seen:
                _sync()
                t0 = time.perf_counter()
                seen[(key, label)] = _kernel_err(
                    f"{name} {label}", out, plain(*args, **kw), gate)
                _sync()
                self.spent += time.perf_counter() - t0
            return out

        return run

    def report(self):
        """{wrapper: {shape label: worst error}} of the wrappers called."""
        out = {}
        for name, seen in self.errs.items():
            for (_, label), err in seen.items():
                d = out.setdefault(name, {})
                d[label] = max(d.get(label, 0.0), err)
        return out


class _LogitTap:
    """While active, every ``lm_head_logits`` call on this rank: the
    first call's logits ``[rows, vocab]`` kept whole, and each call's
    argmax and top-2 margin over its rows."""

    def __enter__(self):
        from quantizations_tpu_torch.models import llama

        orig = llama.lm_head_logits
        self.first, self.top, self.margin, self._saved = None, [], [], []

        def tap(*a, **kw):
            logits = orig(*a, **kw)
            flat = logits.reshape(-1, logits.shape[-1]).float()
            if self.first is None:
                self.first = flat.clone()
            t2 = flat.topk(2, dim=-1).values
            self.top.append(flat.argmax(-1))
            self.margin.append(t2[:, 0] - t2[:, 1])
            return logits

        _patch(orig, tap, self._saved)
        return self

    def __exit__(self, *exc):
        _unpatch(self._saved)

    def stream(self):
        return dict(first=self.first, top=self.top, margin=self.margin)


def _par_fwd(rows, layers, attn=None, col=5, planar=2,
             col_kernel="pair_matmul", head=None, glue=True):
    """Each kernel's launches in one forward of ``rows`` token rows over
    ``layers`` layers: ``col`` pair-word projections a layer (q, k, v,
    gate and up, the column shards; all seven unsharded) and ``planar``
    planar ones (o and down, the row shards), through the bands of
    ``_ql`` (pair words: K1 or ``col_kernel`` up to ``pair_max_tokens()``
    rows, each through the body ``pair_body`` names (K9 picks K1's, and
    counts in K1's body records too), above the band K8 by 512-row chunks
    under ``QT_PREFILL_PAIR`` or K10; planar words: K5, its tensor-core
    body from PLANAR_MMA_MIN_TOKENS, K6, or K7 above 64 rows); one K1
    launch for the lm_head at ``head`` rows (its sampled rows, at most
    128 here; None: ``rows``, 0: no lm_head); with ``attn`` (K3 or K4) one
    attention launch a layer; with ``glue``, K11-K13 as
    :func:`_glue_forwards` reckons (without, the layers' glue is plain
    torch, as in the ring's prefill, and only the lm_head's final norm is
    a K11)."""
    from quantizations_tpu_torch.models.llama import prefill_pair_enabled
    from quantizations_tpu_torch.nn.linear import (GEMV_MAX_TOKENS,
                                                   QMATMUL_MAX_TOKENS,
                                                   pair_max_tokens, qmm_ok)
    from quantizations_tpu_torch.ops import (PLANAR_MMA_MIN_TOKENS,
                                             PREFILL_PAIR_CHUNK_T, pair_body)

    n = {}

    def add(k, v):
        if v:
            n[k] = n.get(k, 0) + v

    def add_k1(kernel, at, v):
        add(kernel, v)
        if pair_body(at) != "cuda_core":
            add("pair_matmul_" + pair_body(at), v)

    c, p = col * layers, planar * layers
    if rows <= pair_max_tokens():
        add_k1(col_kernel, rows, c)
    elif prefill_pair_enabled() and rows % 8 == 0:
        add("pair_prefill", c * -(-rows // PREFILL_PAIR_CHUNK_T))
    else:
        add("dequantize_4bit_pair", c)
    if rows <= QMATMUL_MAX_TOKENS and qmm_ok(rows):
        add("planar_matmul", p)
        if rows >= PLANAR_MMA_MIN_TOKENS:
            add("planar_matmul_mma", p)
    elif rows <= GEMV_MAX_TOKENS:
        add("gemv_4bit", p)
    else:
        add("dequantize_4bit", p)
    head = rows if head is None else head
    if head:
        add_k1("pair_matmul", head, 1)
    if attn:
        add(attn, layers)
    for k, v in _glue_forwards(1, layers if glue else 0,
                               heads=int(bool(head))).items():
        add(k, v)
    return n


def _par_sum(*parts):
    """The sum of ``(times, counts)`` pairs, kernel by kernel."""
    out = {}
    for times, counts in parts:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + times * v
    return out


def _par_generate_launches(rows, new, layers, attn=None, lm_head=True,
                           **kw):
    """A generate's launches: the prompt's forward (``PAR_PROMPT`` tokens
    a row, ``rows`` rows; its lm_head at ``rows``), then ``new - 1``
    decode forwards (``lm_head`` False: none of them runs the lm_head)."""
    head = rows if lm_head else 0
    return _par_sum((1, _par_fwd(rows * PAR_PROMPT, layers, head=head, **kw)),
                    (new - 1, _par_fwd(rows, layers, attn, head=head, **kw)))


def _par_measure(mesh, fn):
    """``fn()`` on this rank with the kernel counts zeroed just before and
    read just after, each kernel call held to its plain version at every
    new shape (``_KernelCheck``; its time is taken out of the wall), the
    collectives counted and the wall (to a synchronize) and peak memory
    taken."""
    from quantizations_tpu_torch.ops import KERNELS

    for k in KERNELS:
        k.launches = 0
    if mesh is not None:
        mesh.stats.reset()
    dev = _RANK["dev"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with _KernelCheck() as check:
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - check.spent
    return out, dict(
        counts={k.name: k.launches for k in KERNELS if k.launches},
        wall=wall, check_s=check.spent, checked=check.report(),
        stats=mesh.stats.as_dict() if mesh is not None else None,
        mem=(torch.cuda.max_memory_allocated() if dev.type == "cuda"
             else 0))


def _planar_od(params):
    from quantizations_tpu_torch.parallel.shard import ensure_planar

    st = params.layers
    return dataclasses.replace(params, layers=dataclasses.replace(
        st, o=ensure_planar(st.o), down=ensure_planar(st.down)))


def _greedy_margins(params, cfg, ids, new, max_seq, axis_name=None,
                    cache=None):
    """Greedy generate with the top-2 margin of every step's logits:
    (tokens [B, new], margins [B, new], first logits [B, vocab])."""
    from quantizations_tpu_torch.models.llama import (KVCache, decode_step,
                                                      prefill)

    B, P = ids.shape
    if cache is None:
        cache = KVCache.create(cfg, B, max_seq, ids.device)
    toks, margins = [], []
    with torch.inference_mode():
        logits, cache = prefill(params, ids, cache, cfg,
                                axis_name=axis_name, last_token_only=True)
        lg = first = logits[:, -1]
        for step in range(new):
            top = lg.topk(2, dim=-1).values
            margins.append(top[:, 0] - top[:, 1])
            tok = lg.argmax(-1).to(torch.int32)
            toks.append(tok)
            if step + 1 < new:
                lg, cache = decode_step(params, tok[:, None], cache,
                                        P + step, cfg, axis_name=axis_name)
    return torch.stack(toks, 1), torch.stack(margins, 1), first


# the engine runs of the phase: (name, kind, kv cache, spec_k)
PAR_ENGINES = (("paged tp2 bf16", "paged", "bf16", 0),
               ("paged tp2 int8", "paged", "int8", 0),
               ("paged tp2 step_spec(8)", "paged", "bf16", 8),
               ("slot Engine tp2", "slot", "bf16", 0))


def _par_setup(cfg, device, refs, seed=0):
    """A pool's rank: the full FP4 model (random normal, scale 0.02, from
    ``seed``) on its device. With ``refs`` rank 0 also computes the
    single-card references on the same planar o and down as the row
    shards: greedy tokens, margins and first logits at B = 1, 2, 4 after
    the 16-token prompt and of the K8 path's 512-token prefill, each
    engine run's tokens and logit stream (``_LogitTap``), and on the pair
    model the SP prompt's prefill and decode steps."""
    import torch.distributed as dist

    from quantizations_tpu_torch.models.llama import init_llama_params

    dev = torch.device(device) if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    _RANK.clear()
    _RANK.update(dev=dev, cfg=cfg)
    t0 = time.perf_counter()
    _RANK["params"] = init_llama_params(cfg, seed=seed, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t0, refs=None)
    if not refs or dist.get_rank() != 0:
        return out
    planar = _planar_od(_RANK["params"])
    refs = {}
    for B in (1, 2, 4):
        ids = _par_ids(B, PAR_PROMPT, cfg.vocab_size).to(dev)
        refs[B] = _greedy_margins(planar, cfg, ids, PAR_NEW, PAR_SEQ)
    ids = _par_ids(1, PAR_K8_PROMPT, cfg.vocab_size, seed=2).to(dev)
    with _prefill_pair_knob():
        refs["k8"] = _greedy_margins(planar, cfg, ids, 1, PAR_K8_PROMPT)
    for what, kind, kv, spec_k in PAR_ENGINES:
        refs[what] = _par_engine_run(planar, kind, kv, spec_k, None)[0]
    del planar
    ids = _par_ids(1, PAR_SP_PROMPT, cfg.vocab_size, seed=1).to(dev)
    refs["sp"] = _greedy_margins(_RANK["params"], cfg, ids, PAR_SP_DECODE,
                                 PAR_SP_SEQ)
    out["refs"] = refs
    return out


def _par_mesh(shape, axes):
    from quantizations_tpu_torch.parallel import make_mesh

    key = (tuple(shape), tuple(axes))
    if key not in _RANK:
        _RANK[key] = make_mesh(shape, axes, device=_RANK["dev"].type)
    return _RANK[key]


def _par_proj_check(mesh, local, cfg):
    """Layer 1 of ``local`` against the single card's planar weights on
    16 random rows: o and down summed over the ``"tp"`` axis
    (``_ql_psum``), q and gate a column shard's rows; max|diff| /
    max|single card| each."""
    from quantizations_tpu_torch.models.llama import _ql, _ql_psum

    ax = mesh.axis("tp")
    full = _planar_od(_RANK["params"]).layers
    g = torch.Generator(device=mesh.device)
    g.manual_seed(5)
    out = {}
    with torch.inference_mode():
        for name in ("o", "down", "q", "gate"):
            whole, shard = getattr(full, name), getattr(local.layers, name)
            x = torch.randn((16, whole.in_features), generator=g,
                            device=mesh.device).to(torch.bfloat16)
            ref = _ql(x, whole, cfg.quant, 1)
            if name in ("o", "down"):
                k = whole.in_features // ax.size
                got = _ql_psum(x[:, ax.rank * k:(ax.rank + 1) * k].contiguous(),
                               shard, cfg.quant, 1, ax, 1)
            else:
                m = shard.out_features
                ref = ref[:, ax.rank * m:(ax.rank + 1) * m]
                got = _ql(x, shard, cfg.quant, 1)
            out[name] = float((got - ref).abs().max() / ref.abs().max())
    return out


def _par_tp(tp, B, new=PAR_NEW, knobs=None):
    """TP generate over a (tp,) mesh: the first forward's logits (not
    counted), then the measured generate."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.models.llama import prefill
    from quantizations_tpu_torch.parallel import (make_sharded_generate_fn,
                                                  shard_llama_params,
                                                  sharded_cache)

    cfg = _RANK["cfg"]
    if knobs:
        cfg = dataclasses.replace(cfg, **knobs)
    mesh = _par_mesh((tp,), ("tp",))
    local = shard_llama_params(_RANK["params"], mesh, cfg)
    ids = _par_ids(B, PAR_PROMPT, cfg.vocab_size).to(mesh.device)
    with torch.inference_mode():
        first = prefill(local, ids, sharded_cache(cfg, B, PAR_SEQ, mesh), cfg,
                        axis_name=mesh.axis("tp"), last_token_only=True
                        )[0][:, -1]
    proj = _par_proj_check(mesh, local, cfg) if B == 1 else None
    gen = make_sharded_generate_fn(
        cfg, ServeConfig(max_seq_len=PAR_SEQ, max_new_tokens=new), mesh)
    cache = sharded_cache(cfg, B, PAR_SEQ, mesh)
    toks, m = _par_measure(mesh, lambda: gen(local, ids, cache, None)[0])
    m["expected"] = _par_generate_launches(
        B, new, cfg.num_hidden_layers,
        "flash_decode" if cfg.use_flash_attention else None,
        col_kernel=("pair_manual" if cfg.quant.pair_pipeline == "manual"
                    else "pair_matmul"))
    return dict(tokens=toks, first=first, kv_heads=cache.k.shape[2],
                proj=proj, **m)


@contextlib.contextmanager
def _prefill_pair_knob():
    """``QT_PREFILL_PAIR=1`` inside the block, as it was after."""
    old = os.environ.get("QT_PREFILL_PAIR")
    os.environ["QT_PREFILL_PAIR"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["QT_PREFILL_PAIR"]
        else:
            os.environ["QT_PREFILL_PAIR"] = old


def _par_k8(tp):
    """A TP prefill of PAR_K8_PROMPT tokens with ``QT_PREFILL_PAIR=1``:
    the column shards through K8."""
    from quantizations_tpu_torch.models.llama import prefill
    from quantizations_tpu_torch.parallel import (shard_llama_params,
                                                  sharded_cache)

    cfg = _RANK["cfg"]
    mesh = _par_mesh((tp,), ("tp",))
    local = shard_llama_params(_RANK["params"], mesh, cfg)
    ids = _par_ids(1, PAR_K8_PROMPT, cfg.vocab_size, seed=2).to(mesh.device)

    def run():
        with torch.inference_mode():
            return prefill(local, ids, sharded_cache(
                cfg, 1, PAR_K8_PROMPT, mesh), cfg,
                axis_name=mesh.axis("tp"), last_token_only=True)[0]

    with _prefill_pair_knob():
        logits, m = _par_measure(mesh, run)
        m["expected"] = _par_fwd(PAR_K8_PROMPT, cfg.num_hidden_layers,
                                 head=1)
    first = logits[:, -1]
    return dict(tokens=first.argmax(-1, keepdim=True).to(torch.int32),
                first=first, **m)


def _par_dp_tp(B):
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.models.llama import prefill
    from quantizations_tpu_torch.parallel import (shard_llama_params,
                                                  sharded_cache)
    from quantizations_tpu_torch.parallel.multihost import (
        make_dp_tp_generate_fn)

    cfg = _RANK["cfg"]
    mesh = _par_mesh((2, 2), ("dp", "tp"))
    dp = mesh.axis("dp")
    local = shard_llama_params(_RANK["params"], mesh, cfg)
    ids = _par_ids(B, PAR_PROMPT, cfg.vocab_size).to(mesh.device)
    rows = B // dp.size
    mine = ids[dp.rank * rows:(dp.rank + 1) * rows]
    with torch.inference_mode():
        first = prefill(local, mine, sharded_cache(cfg, rows, PAR_SEQ, mesh),
                        cfg, axis_name=mesh.axis("tp"), last_token_only=True
                        )[0][:, -1]
    gen = make_dp_tp_generate_fn(
        cfg, ServeConfig(max_seq_len=PAR_SEQ, max_new_tokens=PAR_NEW), mesh)
    cache = sharded_cache(cfg, rows, PAR_SEQ, mesh)
    toks, m = _par_measure(mesh, lambda: gen(local, ids, cache, None)[0])
    m["expected"] = _par_generate_launches(rows, PAR_NEW,
                                           cfg.num_hidden_layers)
    return dict(tokens=toks, first=first, **m)


def _par_pp(pp, tp, B):
    """PP (or PP x TP) generate: each rank runs its stage's layers on
    each of the ``pp`` microbatches of every forward; the last stage
    also runs the lm_head on each."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.parallel.pipeline import (
        _pp_forward, make_pp_generate_fn, pp_cache, shard_llama_params_pp)

    cfg = _RANK["cfg"]
    shape, axes = ((pp, tp), ("pp", "tp")) if tp else ((pp,), ("pp",))
    mesh = _par_mesh(shape, axes)
    tp_axis = "tp" if tp else None
    local = shard_llama_params_pp(_RANK["params"], mesh, cfg, tp_axis)
    ids = _par_ids(B, PAR_PROMPT, cfg.vocab_size).to(mesh.device)
    with torch.inference_mode():
        first = _pp_forward(local, ids, pp_cache(cfg, B, PAR_SEQ, mesh,
                                                 tp_axis), 0, cfg,
                            mesh.axis("pp"),
                            mesh.axis("tp") if tp else None)[0]
    gen = make_pp_generate_fn(
        cfg, ServeConfig(max_seq_len=PAR_SEQ, max_new_tokens=PAR_NEW), mesh,
        tp_axis)
    cache = pp_cache(cfg, B, PAR_SEQ, mesh, tp_axis)
    toks, m = _par_measure(mesh, lambda: gen(local, ids, cache, None)[0])
    stage = mesh.axis("pp").rank
    m["expected"] = _par_sum((pp, _par_generate_launches(
        B // pp, PAR_NEW, cfg.num_hidden_layers // pp,
        lm_head=stage == pp - 1,        # the last stage runs the lm_head
        **({} if tp else dict(col=7, planar=0)))))
    return dict(tokens=toks, first=first, stage=stage, **m)


def _par_sp(sp):
    """SP prefill of the PAR_SP_PROMPT-token prompt over (sp,), then
    PAR_SP_DECODE greedy decode steps on the filled cache (every rank
    holds it whole)."""
    from quantizations_tpu_torch.models.llama import KVCache, decode_step
    from quantizations_tpu_torch.parallel.ring import make_sp_prefill_fn

    cfg = _RANK["cfg"]
    mesh = _par_mesh((sp,), ("sp",))
    params = _RANK["params"]
    ids = _par_ids(1, PAR_SP_PROMPT, cfg.vocab_size, seed=1).to(mesh.device)
    f = make_sp_prefill_fn(mesh, cfg)
    cache = KVCache.create(cfg, 1, PAR_SP_SEQ, mesh.device)

    def run():
        logits, c = f(params, ids, cache)
        toks, lg = [], logits
        with torch.inference_mode():
            for step in range(PAR_SP_DECODE):
                tok = lg.argmax(-1).to(torch.int32)
                toks.append(tok)
                if step + 1 < PAR_SP_DECODE:
                    lg, c = decode_step(params, tok[:, None], c,
                                        PAR_SP_PROMPT + step, cfg)
        return logits, torch.stack(toks, 1)

    (first, toks), m = _par_measure(mesh, run)
    # every rank: its chunk's projections (the attention and the glue are
    # the ring's torch), the last token's lm_head, then the decode steps
    # unsharded
    L = cfg.num_hidden_layers
    m["expected"] = _par_sum(
        (1, _par_fwd(PAR_SP_PROMPT // sp, L, col=7, planar=0, head=1,
                     glue=False)),
        (PAR_SP_DECODE - 1, _par_fwd(1, L, col=7, planar=0)))
    return dict(tokens=toks, first=first, **m)


def _par_engine_run(params, kind, kv, spec_k, mesh):
    """The paged phase's configuration and requests through
    ``PagedEngine``, or PAR_SLOT_REQS requests of the 16-token prompt's
    length through ``Engine`` with PAR_SLOTS slots (decode at 3 rows: K6
    on the row shards), under ``mesh`` or on one card: (tokens, logit
    stream, launches by the engine's own counts: its decode forwards and
    the rows of each admission forward), and the measurement under a
    mesh."""
    from quantizations_tpu_torch.config import ServeConfig
    from quantizations_tpu_torch.serve.engine import Engine
    from quantizations_tpu_torch.serve.paged import PagedEngine

    cfg = dataclasses.replace(_RANK["cfg"], kv_cache_dtype=kv)
    if kind == "paged":
        prompts, slots = _paged_prompts(cfg.vocab_size), 4
        eng = PagedEngine(params, cfg, slots=slots, max_seq=2048,
                          prefill_buckets=(64, 256), admit_width=4,
                          prefix_cache=True, num_pages=40, mesh=mesh)
    else:
        prompts, slots = _par_ids(PAR_SLOT_REQS, PAR_PROMPT, cfg.vocab_size,
                                  seed=3).tolist(), PAR_SLOTS
        eng = Engine(params, cfg, ServeConfig(max_seq_len=2048),
                     slots=slots, prefill_buckets=(16, 64, 256), mesh=mesh)
    rows, rnd = [], eng._prefill_round

    def counted_round(ids, *a):
        rows.append((int(ids.shape[0] * ids.shape[1]), int(ids.shape[0])))
        return rnd(ids, *a)

    eng._prefill_round = counted_round
    uids = [eng.submit(p, max_new_tokens=PAGED_NEW) for p in prompts]

    def run():
        with _LogitTap() as tap:
            done = eng.run(spec_k=spec_k)
        return [done[u].output_ids for u in uids], tap.stream()

    if mesh is None:
        (toks, stream), m = run(), {}
    else:
        (toks, stream), m = _par_measure(mesh, run)
    st = eng.stats()
    L = cfg.num_hidden_layers
    attn = (("flash_decode_i8" if kv == "int8" else "flash_decode")
            if kind == "paged" else None)
    win = st.get("spec_windows", 0)
    m["expected"] = _par_sum(
        *[(1, _par_fwd(r, L, head=h)) for r, h in rows],
        (st["steps"] - win, _par_fwd(slots, L, attn)),
        (win, _par_fwd(slots * spec_k, L, attn)))
    m["kv_heads"] = (eng.pages.pages_k if kind == "paged"
                     else eng.cache.k).shape[2]
    ref = dict(tokens=toks, **stream)
    return ref, dict(tokens=toks, stream=stream, stats_engine=st, **m)


def _par_engines(tp, kind, kv="bf16", spec_k=0):
    """An engine run under a (tp,) mesh (``_par_engine_run``)."""
    from quantizations_tpu_torch.parallel import shard_llama_params

    mesh = _par_mesh((tp,), ("tp",))
    cfg = dataclasses.replace(_RANK["cfg"], kv_cache_dtype=kv)
    local = shard_llama_params(_RANK["params"], mesh, cfg)
    return _par_engine_run(local, kind, kv, spec_k, mesh)[1]


def _par_load(src, tp, prompt, new):
    """``load_hf_llama(mesh=...)`` of the checkpoint at ``src`` (K2 on
    every weight, counted) against the slice of the single-card load, bit
    for bit; then a TP generate on the loaded shard (the CLI's
    comparison)."""
    from quantizations_tpu_torch.config import QuantConfig, ServeConfig
    from quantizations_tpu_torch.models.hf_loader import load_hf_llama
    from quantizations_tpu_torch.models.llama import named_tensors
    from quantizations_tpu_torch.parallel import (make_sharded_generate_fn,
                                                  shard_for_rank,
                                                  sharded_cache)

    mesh = _par_mesh((tp,), ("tp",))
    (cfg, local), m = _par_measure(
        mesh, lambda: load_hf_llama(src, quant=QuantConfig(), mesh=mesh))
    # K2 on every weight, whole: 7 a layer and the lm_head's (the default
    # QuantConfig keeps the embedding dense)
    m["expected"] = {"quantize_4bit": 7 * cfg.num_hidden_layers + 1}
    _, whole = load_hf_llama(src, quant=QuantConfig(), device=mesh.device)
    want = dict(named_tensors(shard_for_rank(whole, cfg, tp,
                                             mesh.axis("tp").rank)))
    got = dict(named_tensors(local))
    equal = set(got) == set(want) and all(
        torch.equal(t, want[k]) for k, t in got.items())
    del whole, want
    gen = make_sharded_generate_fn(cfg, ServeConfig(
        max_seq_len=64, max_new_tokens=new), mesh)
    ids = torch.tensor([prompt], dtype=torch.int32, device=mesh.device)
    toks, _ = gen(local, ids, sharded_cache(cfg, 1, 64, mesh), None)
    return dict(equal=equal, tokens=toks, layers=cfg.num_hidden_layers,
                o_shape=tuple(local.layers.o.wp.shape), **m)


def _par_release():
    """Drop a rank's parameters and meshes' shards before the pool
    closes."""
    _RANK.pop("params", None)
    if _RANK.get("dev", torch.device("cpu")).type == "cuda":
        torch.cuda.empty_cache()
    return True


def _par_check_counts(what, res):
    """Every rank's launches equal to its closed form, kernel by
    kernel."""
    for r, out in enumerate(res):
        if out["counts"] != out["expected"]:
            raise AssertionError(f"{what}, rank {r}: launches "
                                 f"{out['counts']}, expected "
                                 f"{out['expected']}")


def _par_same_tokens(what, res):
    first = res[0]["tokens"]
    for r, out in enumerate(res[1:], 1):
        same = (out["tokens"] == first if isinstance(first, list)
                else torch.equal(out["tokens"], first))
        if not same:
            raise AssertionError(f"{what}: rank {r}'s tokens differ from "
                                 "rank 0's")


def _par_first(what, first, ref_first):
    """max|first - ref_first| / max|ref_first| within PAR_LOGIT_BOUND, or
    raise; returns (it, max|ref_first|)."""
    if first.shape != ref_first.shape:
        raise AssertionError(f"{what}: first logits {tuple(first.shape)}, "
                             f"single card {tuple(ref_first.shape)}")
    scale = float(ref_first.abs().max())
    err = float((first.float() - ref_first.float()).abs().max()) / scale
    if not err <= PAR_LOGIT_BOUND:
        raise AssertionError(f"{what}: first logits {err:.4g} of "
                             f"max|logit| from the single card's "
                             f"(bound {PAR_LOGIT_BOUND})")
    return err, scale


def _par_parting(what, margin, scale):
    if margin > PAR_LOGIT_BOUND * scale:
        raise AssertionError(
            f"{what}: parts from the single card with its top-2 margin "
            f"{margin:.4g} above the bound {PAR_LOGIT_BOUND * scale:.4g}")


def _par_gate(what, first, ref_first, toks, ref_toks, ref_margins):
    """The first forward's logits within PAR_LOGIT_BOUND of the single
    card's (relative to its max|logit|); greedy tokens equal, or, where a
    row parts first, the single card's top-2 margin there within the same
    bound. Returns (relative error, [(row, step, margin)])."""
    err, scale = _par_first(what, first, ref_first)
    parts = []
    for b in range(toks.shape[0]):
        diff = (toks[b] != ref_toks[b]).nonzero()
        if len(diff):
            s = int(diff[0])
            parts.append((b, s, float(ref_margins[b, s])))
            _par_parting(f"{what}, row {b} step {s}", parts[-1][2], scale)
    return err, parts


def _par_stream_gate(what, got, ref):
    """An engine's gate: its first lm_head logits within PAR_LOGIT_BOUND
    of the single-card engine's; its argmax stream, lm_head call by call,
    the single card's, or, at the first call and row where it parts, the
    single card's top-2 margin within the same bound; with no parting,
    the single card's tokens. Returns (relative error, [(call, row,
    margin)])."""
    err, scale = _par_first(what, got["first"], ref["first"])
    parts = []
    for i, (a, b) in enumerate(zip(got["top"], ref["top"])):
        if a.shape != b.shape:
            raise AssertionError(f"{what}: lm_head call {i} on "
                                 f"{tuple(a.shape)} rows, the single card "
                                 f"on {tuple(b.shape)}")
        diff = (a != b).nonzero()
        if len(diff):
            j = int(diff[0])
            parts.append((j, i, float(ref["margin"][i][j])))
            _par_parting(f"{what}, lm_head call {i} row {j}", parts[-1][2],
                         scale)
            break
    if not parts and (len(got["top"]) != len(ref["top"])
                      or got["tokens"] != ref["tokens"]):
        raise AssertionError(f"{what}: the single card's argmax stream, "
                             "but not its tokens")
    return err, parts


def _par_report(what, res, new_tokens, rec):
    """Log a path's wall, tok/s, collective share, memory, the shapes each
    kernel ran and their errors against the plain versions, and keep them
    in ``rec``; returns rank 0's counts."""
    walls = [o["wall"] for o in res]
    wall = max(walls)
    coll = [o["stats"]["total_s"] if o["stats"] else 0.0 for o in res]
    mem = [o["mem"] / 2**30 for o in res]
    st = res[0]["stats"] or {}
    checked = {}
    for o in res:
        for k, shapes in o["checked"].items():
            for label, err in shapes.items():
                d = checked.setdefault(k, {})
                d[label] = max(d.get(label, 0.0), err)
    out = dict(wall_s=wall, tok_s=new_tokens / wall if new_tokens else None,
               check_s=[o["check_s"] for o in res],
               collective_share=[c / w for c, w in zip(coll, walls)],
               max_mem_gib=mem, counts=res[0]["counts"],
               calls=st.get("calls"), staged=st.get("staged"),
               kernel_checks=checked)
    rec[what] = out
    tps = f", {out['tok_s']:.2f} tok/s" if new_tokens else ""
    log(f"  {what}: {wall:.3f} s{tps}; collectives "
        f"{', '.join(f'{c:.1%}' for c in out['collective_share'])} of the "
        f"wall by rank ({st.get('calls', {})}, staged "
        f"{st.get('staged', {}) or 'none'}); max memory "
        f"{', '.join(f'{g:.2f}' for g in mem)} GiB; launches a rank "
        f"{out['counts']}")
    n = sum(len(v) for v in checked.values())
    worst = max((e for v in checked.values() for e in v.values()),
                default=0.0)
    log(f"    {n} kernel shapes against their plain versions (worst "
        f"{worst:.3g} of max|y|, {max(out['check_s']):.1f} s, out of the "
        f"wall): " + "; ".join(f"{k} {sorted(v)}"
                               for k, v in sorted(checked.items())))
    return out["counts"]


def phase_parallel(dev, results):
    """The parallel path at Llama3-8B's full width, PAR_LAYERS (8) of its
    32 layers (FP4, random normal weights from seed 0, 4-bit embedding
    and lm_head), its ranks
    spawned by ``parallel.launch.RankPool`` on this one card: gloo, since
    NCCL refuses two ranks on one GPU. Four ranks: TP at tp = 4 (B = 1,
    4), DP x TP at 2 x 2, PP x TP at 2 x 2. Two ranks: TP at tp = 2 (B =
    1, 4, the manual pipeline, a ``QT_PREFILL_PAIR`` prefill), PP at 2, SP
    at 2 over a 1024-token prompt and 8 decode steps, ``PagedEngine(mesh)``
    (the paged phase's traffic: bf16, int8, ``step_spec(8)``),
    ``Engine(mesh)`` (3 slots, 6 short requests), ``load_hf_llama(mesh)``
    of the load phase's checkpoint and the serving CLI with ``--tp 2``.
    Gates: every kernel call at every shard shape against its plain
    version (``_KernelCheck``); every rank's tokens the same; each path's
    first logits and greedy stream against the single card's
    (``_par_gate``, the engines' ``_par_stream_gate``); every rank's
    launches their closed form; the launcher's deadline. These are N ranks
    sharing one card: their times are no TP speed."""
    import shutil
    import tempfile

    from quantizations_tpu_torch.models.llama import LLAMA3_8B
    from quantizations_tpu_torch.parallel import RankPool
    from quantizations_tpu_torch.parallel.collectives import GLOO_CUDA_NATIVE
    from quantizations_tpu_torch.serve.__main__ import main as serve_main

    rec, totals = {}, {}
    cfg = _par_cfg()

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    def run(pool, what, fn, *args, new=0):
        res = pool.run(fn, *args, deadline=PAR_DEADLINE)
        _par_check_counts(what, res)
        for r, out in enumerate(res):
            if out.get("proj") is not None:
                rec.setdefault("proj_err", {})[f"{what} rank {r}"] = \
                    out["proj"]
                if not max(out["proj"].values()) <= PAR_PROJ_TOL:
                    raise AssertionError(f"{what}, rank {r}: projections "
                                         f"{out['proj']} of max|y| from the "
                                         f"single card's (tolerance "
                                         f"{PAR_PROJ_TOL})")
        if "tokens" in res[0]:
            _par_same_tokens(what, res)
        add(_par_report(what, res, new, rec))
        return res

    def kv_heads(what, res, tp):
        if res[0]["kv_heads"] != LLAMA3_8B.num_key_value_heads // tp:
            raise AssertionError(f"{what}: {res[0]['kv_heads']} kv heads")

    t0 = time.perf_counter()
    pool = RankPool(4, device=dev.type)
    log(f"  4 ranks on {dev}: backend {pool.backend} (gloo takes "
        f"{sorted(GLOO_CUDA_NATIVE)} for CUDA tensors; point-to-point is "
        f"staged through the host); up in {time.perf_counter() - t0:.1f} s")
    rec["backend"] = pool.backend
    gates = rec.setdefault("gates", {})
    try:
        t0 = time.perf_counter()
        setup = pool.run(_par_setup, cfg, dev.type, True,
                         deadline=PAR_DEADLINE)
        refs = setup[0]["refs"]
        log(f"  builds {[round(s['build_s'], 3) for s in setup]} s; the "
            f"single-card references on rank 0, in all "
            f"{time.perf_counter() - t0:.1f} s")
        for B in (1, 4):
            what = f"tp4 B={B}"
            res = run(pool, what, _par_tp, 4, B, PAR_NEW,
                      dict(use_flash_attention=True), new=B * PAR_NEW)
            kv_heads(what, res, 4)
            gates[what] = _par_gate(what, res[0]["first"], refs[B][2],
                                    res[0]["tokens"], refs[B][0], refs[B][1])
        what = "dp2xtp2 B=4"
        res = run(pool, what, _par_dp_tp, 4, new=4 * PAR_NEW)
        gates[what] = _par_gate(
            what, torch.cat([res[0]["first"], res[2]["first"]]), refs[4][2],
            res[0]["tokens"], refs[4][0], refs[4][1])
        what = "pp2xtp2 B=2"
        res = run(pool, what, _par_pp, 2, 2, 2, new=2 * PAR_NEW)
        gates[what] = _par_gate(what, res[0]["first"], refs[2][2],
                                res[0]["tokens"], refs[2][0], refs[2][1])
        pool.run(_par_release)
    finally:
        pool.close()

    t0 = time.perf_counter()
    pool = RankPool(2, device=dev.type)
    log(f"  2 ranks: backend {pool.backend}, up in "
        f"{time.perf_counter() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="qt_par_")
    try:
        pool.run(_par_setup, cfg, dev.type, False, deadline=PAR_DEADLINE)
        for B in (1, 4):
            what = f"tp2 B={B}"
            res = run(pool, what, _par_tp, 2, B, PAR_NEW,
                      dict(use_flash_attention=True), new=B * PAR_NEW)
            kv_heads(what, res, 2)
            gates[what] = _par_gate(what, res[0]["first"], refs[B][2],
                                    res[0]["tokens"], refs[B][0], refs[B][1])
        what = "tp2 manual B=1"
        res = run(pool, what, _par_tp, 2, 1, PAR_SHORT_NEW,
                  dict(quant=dataclasses.replace(cfg.quant,
                                                 pair_pipeline="manual")),
                  new=PAR_SHORT_NEW)
        gates[what] = _par_gate(what, res[0]["first"], refs[1][2],
                                res[0]["tokens"],
                                refs[1][0][:, :PAR_SHORT_NEW],
                                refs[1][1][:, :PAR_SHORT_NEW])
        what = "tp2 QT_PREFILL_PAIR prefill"
        res = run(pool, what, _par_k8, 2)
        gates[what] = _par_gate(what, res[0]["first"], refs["k8"][2],
                                res[0]["tokens"], refs["k8"][0],
                                refs["k8"][1])
        what = "pp2 B=2"
        res = run(pool, what, _par_pp, 2, None, 2, new=2 * PAR_NEW)
        gates[what] = _par_gate(what, res[0]["first"], refs[2][2],
                                res[0]["tokens"], refs[2][0], refs[2][1])
        what = "sp2"
        res = run(pool, what, _par_sp, 2, new=PAR_SP_DECODE)
        gates[what] = _par_gate(what, res[0]["first"], refs["sp"][2],
                                res[0]["tokens"], refs["sp"][0],
                                refs["sp"][1])
        for what, kind, kv, spec_k in PAR_ENGINES:
            res = run(pool, what, _par_engines, 2, kind, kv, spec_k,
                      new=(8 if kind == "paged" else PAR_SLOT_REQS)
                      * PAGED_NEW)
            kv_heads(what, res, 2)
            st = res[0]["stats_engine"]
            if kind == "paged" and st["pages_free"] != (
                    st["pages_total"] - 1 - st["prefix_cache_pages"]):
                raise AssertionError(f"{what}: pool not returned: {st}")
            for r, o in enumerate(res):
                gates[f"{what} rank {r}"] = _par_stream_gate(
                    f"{what}, rank {r}", dict(tokens=o["tokens"],
                                              **o["stream"]), refs[what])
        pool.run(_par_release)
        # the load phase's checkpoint, loaded onto the mesh, and the CLI
        free = shutil.disk_usage(root).free
        if free < LOAD_DISK_BYTES:
            raise AssertionError(f"{free / 1e9:.1f} GB free, the load needs "
                                 f"{LOAD_DISK_BYTES / 1e9:.0f}")
        src = os.path.join(root, "hf")
        os.makedirs(src)
        _write_checkpoint(LLAMA3_8B, src, dev)
        prompt = _par_ids(1, PAR_PROMPT, cfg.vocab_size)[0].tolist()
        what = "load_hf_llama tp2"
        res = run(pool, what, _par_load, src, 2, prompt, PAR_SHORT_NEW)
        for r, o in enumerate(res):
            if not o["equal"]:
                raise AssertionError(f"{what}: rank {r}'s shard is not the "
                                     "slice of the single-card load")
        t0 = time.perf_counter()
        cli = _main_json(serve_main, [
            "--model", src, "--tp", "2", "--max-seq", "64",
            "--max-new-tokens", str(PAR_SHORT_NEW), "--prompt-ids",
            ",".join(map(str, prompt)), "--device", dev.type])
        rec["cli_s"] = time.perf_counter() - t0
        if cli["output_ids"] != res[0]["tokens"][0].tolist():
            raise AssertionError(f"CLI --tp 2: {cli['output_ids']}, the "
                                 f"direct call {res[0]['tokens'][0].tolist()}")
        log(f"  CLI --tp 2: {rec['cli_s']:.1f} s with its two ranks' start "
            "and load, the direct call's tokens")
    finally:
        pool.close()
        shutil.rmtree(root, ignore_errors=True)
    for what, errs in rec.get("proj_err", {}).items():
        log(f"  {what}: layer 1's projections against the single card's, "
            "max|diff| / max|y|: " + ", ".join(
                f"{k} {v:.3g}" for k, v in errs.items()))
    for what, (err, parts) in gates.items():
        unit = "lm_head call" if "ngine" in what or "paged" in what \
            else "step"
        log(f"  {what}: first logits {err:.4g} of max|logit| from the single "
            f"card's; " + ("the single card's tokens" if not parts else
                           "parts at " + ", ".join(
                               f"row {b} {unit} {s} (margin {m:.4g})"
                               for b, s, m in parts)))
    results["parallel"] = rec
    results["launches_parallel"] = totals


def kernel_entries(results, kernels_seq):
    """The ``kernels`` line: one entry per kernel record with its
    launches on the main path, its error against the plain version, and
    its time, bound, plain and library times from this run."""
    kernels = []
    launches = results.get("launches", {})
    paged_launches = results.get("launches_paged", {})
    from quantizations_tpu_torch.ops import (PAIR_MMA_MIN_TOKENS,
                                             PAIR_SPLITK_MIN_TOKENS,
                                             PLANAR_MMA_MIN_TOKENS)
    planar_launches = results.get("launches_planar", {})
    body_time = results.get("body_time", {})
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
                     f"{LAYERS} layers x 4 projections + the lm_head (the "
                     "body pair_body picks); max_abs_err: any of its three "
                     "bodies; launches: the generate path (every body)",
                by_shape=results.get("k1_time", {}).get("rows"))
        elif k.name == "pair_matmul_splitk":
            f = body_time.get("per_forward", {}).get(8, {})
            err = results.get("k1_err", {}).get("by_body", {}).get(
                "splitk", {})
            entry.update(
                launches=launches.get(k.name, 0),
                max_abs_err=err.get("max_abs_err"),
                max_err_over_max_y=err.get("max_err_over_max_y"),
                ms=f.get("splitk_ms"), plain_ms=f.get("plain_ms"),
                bound_ms=f.get("bound_ms"), bound_by=f.get("bound_by"),
                library_ms=f.get("library_ms"),
                cuda_core_ms=f.get("cuda_core_ms"), mma_ms=f.get("mma_ms"),
                unit=f"K1 from {PAIR_SPLITK_MIN_TOKENS} to "
                     f"{PAIR_MMA_MIN_TOKENS - 1} rows: one decode forward at "
                     f"T=8 (B = 8), {LAYERS} layers x 4 projections + the "
                     "lm_head; cuda_core_ms / mma_ms: K1's other bodies "
                     "there; library_ms: dense bf16 torch.matmul; launches: "
                     "the generate path",
                per_forward={T: {b: v.get(b + "_ms") for b in K1_BODIES}
                             for T, v in body_time.get(
                                 "per_forward", {}).items()},
                crossover=body_time.get("crossover"))
        elif k.name == "pair_matmul_mma":
            f = body_time.get("per_forward", {}).get(K1_CHUNK_TOKENS, {})
            err = results.get("pair_variants_err", {}).get(k.name, {})
            entry.update(
                launches=paged_launches.get(k.name, 0),
                max_abs_err=err.get("max_abs_err"),
                max_err_over_max_y=err.get("max_err_over_max_y"),
                ms=f.get("mma_ms"), plain_ms=f.get("plain_ms"),
                bound_ms=f.get("bound_ms"), bound_by=f.get("bound_by"),
                library_ms=f.get("library_ms"),
                cuda_core_ms=f.get("cuda_core_ms"),
                splitk_ms=f.get("splitk_ms"),
                unit=f"K1 above {PAIR_MMA_MIN_TOKENS - 1} rows: one "
                     f"{K1_CHUNK_TOKENS}-row admission forward, {LAYERS} "
                     "layers x 4 projections (its lm_head samples one row "
                     "a sequence on another body); cuda_core_ms / "
                     "splitk_ms: K1's other bodies there; library_ms: dense "
                     "bf16 torch.matmul; launches: the paged engine's first "
                     "bf16 run",
                crossover=body_time.get("crossover"))
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
        elif k.name in GLUE_KERNELS:
            g = results.get("glue", {})
            rows = [r for r in g.get("rows", []) if r["kernel"] == k.name]
            main = next((r for r in rows if r["N"] == GLUE_MAIN_ROWS), {})
            err = g.get("err", {}).get(k.name, {})
            entry.update(
                launches=paged_launches.get(k.name, 0),
                max_abs_err=err.get("max_abs_err"),
                max_err_over_max_y=err.get("max_err_over_max_y"),
                ms=main.get("ms"), plain_ms=main.get("plain_ms"),
                bound_ms=main.get("bound_ms"),
                bound_by=main.get("bound_by", "bytes"),
                library_ms=main.get("library_ms"),
                unit=f"one launch at {GLUE_MAIN_ROWS} rows in the decode "
                     f"layer's form at Mistral-7B's widths (hidden "
                     f"{GLUE_H}, {GLUE_NQ}/{GLUE_NKV} heads of "
                     f"{HEAD_DIM}, intermediate {GLUE_I}); max_abs_err: "
                     + ("the norm against the plain version's (the "
                        "residual bit for bit)" if k.name == "add_rms_norm"
                        else "against the plain version (bit for bit)")
                     + "; library_ms: "
                     + ("torch.nn.functional.rms_norm, the norm alone"
                        if k.name == "add_rms_norm" else "none (torch has "
                        "no fused form)")
                     + "; launches: the paged engine's first bf16 run",
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
                              + " run; d256: Gemma2-9B's shape (B=4, 1900 "
                              "live tokens, KVH 8, G 2, D 256, softcap 50, "
                              "window 4096), library_ms there SDPA on "
                              "contiguous bf16 keys",
                         by_shape=rows)
            err256 = results.get("attn_err_d256", {}).get(k.name, {})
            entry["d256"] = dict(
                max_abs_err=err256.get("max_abs_err"),
                max_err_over_max_out=err256.get("max_err_over_max_out"),
                rows=[{f: r[f] for f in ("form", "q_span", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}
                      for r in results.get("attn_time_d256", [])
                      if r["kernel"] == k.name])
        # the load phase: K2 in every load, K10/K7 in the exports, every
        # kernel of the CLI runs
        entry["load_launches"] = results.get("launches_load", {}).get(
            k.name, 0)
        # the evals phase: the proxy build, the parity runs, the twins and
        # the IFEval proxy's arms
        entry["evals_launches"] = results.get("launches_evals", {}).get(
            k.name, 0)
        # the parallel phase: every path's launches on rank 0
        entry["parallel_launches"] = results.get("launches_parallel",
                                                 {}).get(k.name, 0)
        # the gemma2 phase: its build, generates and engine runs
        entry["gemma2_launches"] = results.get("launches_gemma2", {}).get(
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
                   ("attn", lambda: (phase_attn(dev, gen, results),
                                     phase_attn_gemma2(dev, gen, results))),
                   ("time", lambda: (phase_time(dev, gen, results),
                                     phase_attn_time(dev, gen, results))),
                   ("glue", lambda: phase_glue(dev, gen, results)),
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
                   ("gemma2", lambda: phase_gemma2(dev, gen, results)),
                   ("load", lambda: phase_load(dev, results)),
                   ("evals", lambda: phase_evals(dev, results)),
                   ("parallel", lambda: phase_parallel(dev, results)),
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
