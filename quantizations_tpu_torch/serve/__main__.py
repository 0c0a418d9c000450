"""CLI: generate token ids (or text) from a checkpoint or a demo model
(counterpart of ``quantizations_tpu/serve/__main__.py``).

    python -m quantizations_tpu_torch.serve --demo
    python -m quantizations_tpu_torch.serve --model /path/to/hf_llama \\
        --prompt-ids 1,2,3 --max-new-tokens 60 [--engine paged] \\
        [--device cpu]

Runs on the card unless ``--device cpu`` asks for the CPU (the kernels'
plain versions). Prints one JSON line per run, with the JAX package's
keys. ``--tp`` above 1 (tensor-parallel serving) is not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import torch

from ..config import QuantConfig, ServeConfig
from ..device import resolve_device
from ..models.llama import (KVCache, TINY_LLAMA, fuse_projections,
                            init_llama_params)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="quantizations_tpu_torch.serve")
    p.add_argument("--model", help="HF checkpoint dir (config.json + "
                   "safetensors [+ tokenizer])")
    p.add_argument("--demo", action="store_true",
                   help="tiny random model, token-id I/O")
    p.add_argument("--prompt", default="The key to a fast TPU kernel is")
    p.add_argument("--prompt-ids", help="comma-separated token ids "
                   "(skips the tokenizer)")
    p.add_argument("--max-new-tokens", type=int, default=60)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--eos-id", type=int, default=None,
                   help="freeze a row to this id once emitted")
    p.add_argument("--quant-type", default="fp4", choices=["fp4", "nf4"])
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (not ported above 1)")
    p.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (greedy or "
                        "temperature sampling)")
    p.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                   help="KV cache element type")
    p.add_argument("--pipeline", default="grid", choices=["grid", "manual"],
                   help="decode-band pair-kernel weight streaming (K1 or "
                        "K9)")
    p.add_argument("--engine", default="generate",
                   choices=["generate", "slot", "paged"],
                   help="generate = one prompt at a time; slot/paged = "
                        "continuous-batching engines (';'-separate "
                        "--prompt-ids for several requests)")
    p.add_argument("--slots", type=int, default=4, help="engine batch slots")
    p.add_argument("--spec-k", type=int, default=0,
                   help="engine speculative window (prompt-lookup "
                        "drafts, one verify forward per window)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="engine decode steps per host read")
    p.add_argument("--prefix-cache", action="store_true",
                   help="paged engine: share full prompt-prefix pages "
                        "across requests")
    p.add_argument("--num-pages", type=int, default=0,
                   help="paged engine pool size (0 = slots*max_seq/"
                        "page_size + slack)")
    p.add_argument("--page-size", type=int, default=128)
    p.add_argument("--fuse", action="store_true",
                   help="fuse qkv/gate_up projections (4 weight kernels "
                        "per layer, not 7)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (cpu: the kernels' plain "
                        "versions)")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    if args.tp > 1:
        raise SystemExit(
            "--tp > 1 (tensor-parallel serving over a mesh, "
            "quantizations_tpu/serve/__main__.py:100-103) is not ported")
    dev = resolve_device(args.device)

    quant = QuantConfig(quant_type=args.quant_type,
                        pair_pipeline=args.pipeline)
    serve = ServeConfig(
        max_seq_len=args.max_seq, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, eos_id=args.eos_id,
    )

    tokenizer = None
    if args.demo or not args.model:
        cfg = dataclasses.replace(TINY_LLAMA, quant=quant,
                                  kv_cache_dtype=args.kv_dtype)
        params = init_llama_params(cfg, seed=0, device=dev)
        serve = dataclasses.replace(serve, max_seq_len=min(args.max_seq, 128))
    else:
        from ..models.hf_loader import load_hf_llama

        cfg, params = load_hf_llama(args.model, quant=quant, device=dev)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_dtype)
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(args.model)
        except Exception:
            tokenizer = None

    if args.fuse:
        params = fuse_projections(params)

    if args.prompt_ids:
        prompts = [[int(t) for t in grp.split(",")]
                   for grp in args.prompt_ids.split(";") if grp]
    elif tokenizer is not None:
        prompts = [tokenizer.encode(args.prompt)]
    else:
        prompts = [[1, 2, 3, 4, 5]]  # demo: raw ids

    def text(ids):
        return tokenizer.decode(ids) if tokenizer is not None else None

    if args.engine != "generate":
        if args.engine == "slot":
            from .engine import Engine

            eng = Engine(params, cfg, serve, slots=args.slots,
                         temperature=serve.temperature,
                         top_k=serve.top_k, top_p=serve.top_p)
        else:
            from .paged import PagedEngine

            psz = args.page_size
            npages = args.num_pages or (
                args.slots * -(-serve.max_seq_len // psz) + 8)
            eng = PagedEngine(
                params, cfg, num_pages=npages, page_size=psz,
                slots=args.slots, max_seq=serve.max_seq_len,
                temperature=serve.temperature, top_k=serve.top_k,
                top_p=serve.top_p, prefix_cache=args.prefix_cache)
        t0 = time.perf_counter()
        uids = [eng.submit(p_, max_new_tokens=args.max_new_tokens,
                           eos_id=args.eos_id,
                           temperature=args.temperature)
                for p_ in prompts]
        done = eng.run(spec_k=args.spec_k,
                       steps_per_dispatch=args.steps_per_dispatch)
        dt = time.perf_counter() - t0
        total = sum(len(done[u].output_ids) for u in uids)
        print(json.dumps({
            "engine": args.engine,
            "requests": [{
                "prompt_ids": p_,
                "output_ids": done[u].output_ids,
                "output_text": text(done[u].output_ids),
            } for p_, u in zip(prompts, uids)],
            "wall_s": round(dt, 3),
            "tokens_per_s_incl_compile": round(total / dt, 2),
        }))
        return

    if args.speculative:
        from .speculative import make_speculative_generate_fn

        spec = make_speculative_generate_fn(cfg, serve)
    else:
        from .generate import make_generate_fn

        gen = make_generate_fn(cfg, serve)

    # every ';'-separated prompt runs in turn (the generate path is
    # batch-1; the engines serve several at once). One generator, seeded
    # from the serve config, takes the JAX package's key splits' place.
    generator = torch.Generator(device=dev)
    generator.manual_seed(serve.seed)
    recs = []
    t0 = time.perf_counter()
    for ids in prompts:
        prompt = torch.tensor([ids], dtype=torch.int32, device=dev)
        cache = KVCache.create(cfg, 1, serve.max_seq_len, device=dev)
        tp0 = time.perf_counter()
        verify_steps = None
        if args.speculative:
            toks, verify_steps, _ = spec(params, prompt, cache, generator)
        else:
            toks, _ = gen(params, prompt, cache, generator)
        out = toks[0].tolist()
        dt = time.perf_counter() - tp0
        rec = {
            "prompt_ids": ids,
            "output_ids": out,
            "output_text": text(out),
            "wall_s": round(dt, 3),
            "tokens_per_s_incl_compile": round(len(out) / dt, 2),
        }
        if verify_steps is not None:
            rec["speculative_verify_steps"] = verify_steps
            rec["tokens_per_verify_step"] = round(len(out) / verify_steps, 2)
        recs.append(rec)
        del cache
    if len(recs) == 1:
        print(json.dumps(recs[0]))
    else:
        total = sum(len(r["output_ids"]) for r in recs)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "requests": recs,
            "wall_s": round(dt, 3),
            "tokens_per_s_incl_compile": round(total / dt, 2),
        }))


if __name__ == "__main__":
    main()
