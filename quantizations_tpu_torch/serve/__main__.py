"""CLI: generate token ids (or text) from a checkpoint or a demo model
(counterpart of ``quantizations_tpu/serve/__main__.py``).

    python -m quantizations_tpu_torch.serve --demo
    python -m quantizations_tpu_torch.serve --model /path/to/hf_llama \\
        --prompt-ids 1,2,3 --max-new-tokens 60 [--engine paged] \\
        [--device cpu]

Runs on the card unless ``--device cpu`` asks for the CPU (the kernels'
plain versions). Prints one JSON line per run, with the JAX package's
keys.

``--tp N`` serves tensor-parallel from this one command: it starts N
ranks (``parallel.launch``; NCCL when each has a card of its own, gloo
when they share one or run on the CPU), each loads its shard
(``load_hf_llama(mesh=...)``, or the demo model's shard) and runs the
same generate or engine loop, and rank 0's JSON line is printed once
every rank has returned the same tokens. ``--speculative`` stays
single-device, as in the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
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
                   help="tensor-parallel ways: starts this many ranks")
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


def _tokens(rec: dict) -> list:
    """The token ids of a run's record (every rank's must agree)."""
    return [r["output_ids"] for r in rec.get("requests", [rec])]


def _serve_rank(argv: List[str]) -> dict:
    """One rank of ``--tp``: its mesh, then :func:`_serve` on it."""
    from ..parallel import make_mesh

    args = _parser().parse_args(argv)
    mesh = make_mesh((args.tp,), ("tp",), device=args.device)
    return _serve(args, mesh.device, mesh)


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.tp > 1:
        if args.speculative:
            raise SystemExit("--speculative is single-device")
        from ..parallel import launch
        # by its module's own name: under ``python -m`` this module is
        # ``__main__``, which a spawned rank cannot import
        from .__main__ import _serve_rank as rank_fn

        recs = launch(rank_fn, args.tp, argv, device=args.device)
        if any(_tokens(r) != _tokens(recs[0]) for r in recs[1:]):
            raise SystemExit("tensor-parallel ranks returned different "
                             "tokens")
        print(json.dumps(recs[0]))
        return
    print(json.dumps(_serve(args, resolve_device(args.device))))


def _serve(args: argparse.Namespace, dev: torch.device,
           mesh=None) -> dict:
    """Load (or build) the model on ``dev``, this rank's shard of it
    under a ``mesh``, run the requested path and return its record."""
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
        if mesh is not None:
            from ..parallel.shard import shard_llama_params

            params = shard_llama_params(params, mesh, cfg)
        serve = dataclasses.replace(serve, max_seq_len=min(args.max_seq, 128))
    else:
        from ..models.hf_loader import load_hf_llama

        cfg, params = load_hf_llama(args.model, quant=quant, device=dev,
                                    mesh=mesh)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_dtype)
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(args.model)
        except Exception:
            tokenizer = None

    if args.fuse:
        params = fuse_projections(params)    # each rank fuses its own rows

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
                         top_k=serve.top_k, top_p=serve.top_p, mesh=mesh)
        else:
            from .paged import PagedEngine

            psz = args.page_size
            npages = args.num_pages or (
                args.slots * -(-serve.max_seq_len // psz) + 8)
            eng = PagedEngine(
                params, cfg, num_pages=npages, page_size=psz,
                slots=args.slots, max_seq=serve.max_seq_len,
                temperature=serve.temperature, top_k=serve.top_k,
                top_p=serve.top_p, prefix_cache=args.prefix_cache,
                mesh=mesh)
        t0 = time.perf_counter()
        uids = [eng.submit(p_, max_new_tokens=args.max_new_tokens,
                           eos_id=args.eos_id,
                           temperature=args.temperature)
                for p_ in prompts]
        done = eng.run(spec_k=args.spec_k,
                       steps_per_dispatch=args.steps_per_dispatch)
        dt = time.perf_counter() - t0
        total = sum(len(done[u].output_ids) for u in uids)
        return {
            "engine": args.engine,
            "requests": [{
                "prompt_ids": p_,
                "output_ids": done[u].output_ids,
                "output_text": text(done[u].output_ids),
            } for p_, u in zip(prompts, uids)],
            "wall_s": round(dt, 3),
            "tokens_per_s_incl_compile": round(total / dt, 2),
        }

    if args.speculative:
        from .speculative import make_speculative_generate_fn

        spec = make_speculative_generate_fn(cfg, serve)
    else:
        from .generate import make_generate_fn

        gen = make_generate_fn(cfg, serve, axis_name=(
            None if mesh is None else mesh.axis("tp")))

    # every ';'-separated prompt runs in turn (the generate path is
    # batch-1; the engines serve several at once). One generator, seeded
    # from the serve config, takes the JAX package's key splits' place.
    generator = torch.Generator(device=dev)
    generator.manual_seed(serve.seed)
    recs = []
    t0 = time.perf_counter()
    for ids in prompts:
        prompt = torch.tensor([ids], dtype=torch.int32, device=dev)
        if mesh is None:
            cache = KVCache.create(cfg, 1, serve.max_seq_len, device=dev)
        else:
            from ..parallel.shard import sharded_cache

            cache = sharded_cache(cfg, 1, serve.max_seq_len, mesh)
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
        return recs[0]
    total = sum(len(r["output_ids"]) for r in recs)
    dt = time.perf_counter() - t0
    return {
        "requests": recs,
        "wall_s": round(dt, 3),
        "tokens_per_s_incl_compile": round(total / dt, 2),
    }




if __name__ == "__main__":
    main()
