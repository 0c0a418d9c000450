"""CLI: quantize an HF checkpoint offline and save it (counterpart of
``quantizations_tpu/convert.py``).

    python -m quantizations_tpu_torch.convert --model /path/to/hf_llama \\
        --out /path/to/out --format bnb [--quant-type nf4] [--device cpu]

Formats:
- ``bnb``: an HF directory in the bitsandbytes flat-key serialization,
  which ``load_hf_llama`` reloads without re-quantizing (the packed codes
  are taken verbatim);
- ``native``: one safetensors file in the runtime layout
  (``save_quantized``; ``load_quantized`` reloads it).

The model is loaded and quantized on ``--device`` (the card by default:
K2 quantizes every weight, K10/K7 dequantize the 4-bit embedding and
lm_head of a bnb export). Prints one JSON line: the format, the
effective quant type (a bnb source overrides ``--quant-type``), the
output path and size, and the load and save times.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import torch

from .config import QuantConfig
from .device import resolve_device
from .models.hf_loader import (load_hf_llama, save_bnb_checkpoint,
                               save_quantized)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="quantizations_tpu_torch.convert")
    p.add_argument("--model", required=True,
                   help="source HF checkpoint dir (dense or bnb)")
    p.add_argument("--out", required=True, help="output path/dir")
    p.add_argument("--format", default="bnb", choices=["bnb", "native"])
    p.add_argument("--quant-type", default="fp4", choices=["fp4", "nf4"],
                   help="codebook for quantizing a DENSE source; a "
                        "pre-quantized bnb source dictates its own "
                        "stored type (this flag is then ignored)")
    p.add_argument("--no-double-quant", action="store_true",
                   help="store fp32 absmax instead of bnb's nested "
                        "8-bit statistics (exact round-trip, +1.5%% "
                        "size)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model is quantized (cpu: the kernels' "
                        "plain versions)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    quant = QuantConfig(quant_type=args.quant_type)
    t0 = time.perf_counter()
    cfg, params = load_hf_llama(args.model, quant=quant, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    if args.format == "bnb":
        save_bnb_checkpoint(params, cfg, args.out,
                            compress_statistics=not args.no_double_quant)
        out = os.path.join(args.out, "model.safetensors")
    else:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        save_quantized(params, args.out)
        out = args.out
    t2 = time.perf_counter()
    print(json.dumps({
        "format": args.format,
        # the effective type: a bnb source overrides --quant-type
        "quant_type": cfg.quant.quant_type,
        "out": out,
        "bytes": os.path.getsize(out),
        "load_quantize_s": round(t1 - t0, 2),
        "save_s": round(t2 - t1, 2),
    }))


if __name__ == "__main__":
    main()
