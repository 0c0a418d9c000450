"""CLI: accuracy evaluations of a checkpoint (counterpart of
``quantizations_tpu/evals/__main__.py``).

    # logit/ppl parity of 4-bit vs dequantized-dense on random tokens
    python -m quantizations_tpu_torch.evals --model <hf_dir> --parity

    # the same on the trained-distribution proxy at Llama3-8B, with the
    # dense-twin control arm
    python -m quantizations_tpu_torch.evals --preset 8b --proxy \\
        --parity --parity-control

    # IFEval score parity on the proxy (the Engine, 4-bit vs dense twin)
    python -m quantizations_tpu_torch.evals --preset 8b --ifeval-proxy

    # IFEval (the official input_data.jsonl and a tokenizer)
    python -m quantizations_tpu_torch.evals --model <hf_dir> \\
        --ifeval /path/to/input_data.jsonl --max-new-tokens 512

Runs on the card unless ``--device cpu`` asks for the CPU (the kernels'
plain versions). Prints one JSON line with the JAX package's keys. Run
``--ifeval`` twice (once with ``--dequantized``) and diff the scores.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import torch


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="quantizations_tpu_torch.evals")
    p.add_argument("--model", required=False,
                   help="HF checkpoint dir; omit for a random model")
    p.add_argument("--quant-type", default="fp4", choices=["fp4", "nf4"])
    p.add_argument("--parity", action="store_true",
                   help="logit-parity report (quantized vs dequantized)")
    p.add_argument("--parity-control", action="store_true",
                   help="also run the parity with the model-path arm in "
                        "dense-twin mode: both arms then use the same dense "
                        "weights, so any disagreement is implementation "
                        "rounding (the cache's bf16 K/V, the attention "
                        "paths) amplified by the network like quantization "
                        "error; on a random-weight deep model this is the "
                        "floor the quantized parity is read against")
    p.add_argument("--parity-tokens", type=int, default=128)
    p.add_argument("--ifeval", help="path to IFEval input_data.jsonl")
    p.add_argument("--ifeval-proxy", action="store_true",
                   help="IFEval score parity on the proxy model: the "
                        "synthesized dataset (all 25 instruction ids) "
                        "through the Engine twice, 4-bit kernels vs the "
                        "dense twin, and the score deltas")
    p.add_argument("--ifeval-slots", type=int, default=8)
    p.add_argument("--dequantized", action="store_true",
                   help="run IFEval on the dequantized bf16 twin instead")
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument("--proxy", action="store_true",
                   help="use the trained-distribution weight proxy (heavy "
                        "tails, row-scale spread, outlier columns) instead "
                        "of i.i.d. normal weights")
    p.add_argument("--preset", default="tiny", choices=["tiny", "8b"],
                   help="model shape when no --model dir is given")
    p.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                   help="KV cache dtype of the quantized side: parity then "
                        "measures 4-bit weights and int8 KV jointly")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (cpu: the kernels' plain "
                        "versions)")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)

    if args.ifeval_proxy:
        from .ifeval_proxy import run_ifeval_proxy

        print(json.dumps(run_ifeval_proxy(
            preset=args.preset, quant_type=args.quant_type,
            kv_dtype=args.kv_dtype, max_new_tokens=args.max_new_tokens,
            slots=args.ifeval_slots, device=args.device)))
        return

    import numpy as np

    from ..config import QuantConfig, ServeConfig
    from ..device import resolve_device
    from ..models.llama import LLAMA3_8B, TINY_LLAMA, init_llama_params

    dev = resolve_device(args.device)
    tokenizer = None
    if args.model:
        from ..models.hf_loader import load_hf_llama

        cfg, params = load_hf_llama(
            args.model, quant=QuantConfig(quant_type=args.quant_type),
            device=dev)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_dtype)
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(args.model)
        except Exception:
            tokenizer = None
    else:
        base = LLAMA3_8B if args.preset == "8b" else TINY_LLAMA
        cfg = dataclasses.replace(
            base, kv_cache_dtype=args.kv_dtype,
            quant=QuantConfig(quant_type=args.quant_type))
        params = init_llama_params(
            cfg, seed=0, dist="trained_proxy" if args.proxy else "normal",
            device=dev)

    out = {}
    if args.parity or not args.ifeval:
        from .parity import logit_parity

        rng = np.random.default_rng(0)
        ids = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, args.parity_tokens)),
            dtype=torch.int32, device=dev)
        out["parity"] = logit_parity(params, cfg, ids).to_dict()
        if args.parity_control:
            twin_cfg = dataclasses.replace(
                cfg, quant=dataclasses.replace(cfg.quant, dense_twin=True))
            out["parity_control"] = logit_parity(
                params, twin_cfg, ids).to_dict()

    if args.ifeval:
        if tokenizer is None:
            raise SystemExit("--ifeval needs a tokenizer (HF checkpoint)")
        from ..models.llama import KVCache
        from ..serve.generate import make_generate_fn
        from .ifeval import evaluate

        if args.dequantized:
            cfg = dataclasses.replace(
                cfg, quant=dataclasses.replace(cfg.quant, dense_twin=True))

        serve = ServeConfig(max_seq_len=args.max_seq,
                            max_new_tokens=args.max_new_tokens)
        gen = make_generate_fn(cfg, serve)
        # one generator, seeded 0, in place of the JAX package's PRNGKey(0)
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
        eos = tokenizer.eos_token_id

        def generate_fn(prompt: str) -> str:
            msgs = [{"role": "user", "content": prompt}]
            try:
                ids = tokenizer.apply_chat_template(
                    msgs, add_generation_prompt=True)
            except Exception:
                ids = tokenizer.encode(prompt)
            toks, _ = gen(params,
                          torch.tensor([ids], dtype=torch.int32, device=dev),
                          KVCache.create(cfg, 1, serve.max_seq_len,
                                         device=dev), generator)
            toks = toks[0].tolist()
            if eos in toks:
                toks = toks[:toks.index(eos)]
            return tokenizer.decode(toks)

        with open(args.ifeval) as f:
            dataset = [json.loads(line) for line in f if line.strip()]
        out["ifeval"] = evaluate(generate_fn, dataset).to_dict()

    print(json.dumps(out))


if __name__ == "__main__":
    main()
