"""The port's native checkpoint of a quantized model (counterpart of
``quantizations_tpu/models/checkpoint.py``, whose orbax format needs a
package the port does not use).

A checkpoint is a directory holding ``llama_config.json``, the JAX
package's config file (the dataclass as JSON, dtypes by name,
``"bf16x2"`` kept), and ``params.safetensors``: every tensor of the
params tree under its dotted path (``layers.q.wp``, ``embed``, ...) in
its own dtype, so a round trip is exact. Fused params (``layers.qkv``,
``layers.gate_up``) round-trip too.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple, Union

import torch

from ..config import QuantConfig
from ..device import resolve_device
from ..quant.state import dtype_from_name, dtype_name
from .llama import LlamaConfig, LlamaLayer, LlamaParams, QLinear, named_tensors
from .safetensors_io import load_file, save_file

__all__ = ["save_checkpoint", "load_checkpoint"]

_CFG_FILE = "llama_config.json"
_PARAMS_FILE = "params.safetensors"


def _cfg_to_json(cfg: LlamaConfig) -> str:
    d = dataclasses.asdict(cfg)
    d["quant"]["compute_dtype"] = dtype_name(cfg.quant.compute_dtype)
    d["quant"]["scales_dtype"] = dtype_name(cfg.quant.scales_dtype)
    return json.dumps(d, indent=1)


def _cfg_from_json(s: str) -> LlamaConfig:
    d = json.loads(s)
    q = d.pop("quant")
    q["compute_dtype"] = dtype_from_name(q["compute_dtype"])
    sd = q.get("scales_dtype", "float32")
    q["scales_dtype"] = sd if sd == "bf16x2" else dtype_from_name(sd)
    if d.get("rope_scaling") is not None:
        d["rope_scaling"] = tuple(d["rope_scaling"])
    return LlamaConfig(quant=QuantConfig(**q), **d)


def save_checkpoint(params: LlamaParams, cfg: LlamaConfig, path: str) -> None:
    """Write ``params`` and ``cfg`` into the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    save_file(dict(named_tensors(params)), os.path.join(path, _PARAMS_FILE))
    with open(os.path.join(path, _CFG_FILE), "w") as f:
        f.write(_cfg_to_json(cfg))


def load_checkpoint(path: str, device: Union[str, torch.device] = "cuda",
                    mesh=None) -> Tuple[LlamaConfig, LlamaParams]:
    """Restore ``(cfg, params)`` onto ``device``. ``mesh`` (a
    :class:`~quantizations_tpu_torch.parallel.Mesh` with a ``"tp"`` axis)
    restores this rank's tensor-parallel shard onto the mesh's device:
    the whole params on the device, then
    :func:`~quantizations_tpu_torch.parallel.shard.shard_for_rank` (o and
    down repacked planar there); fused params raise ``ValueError``."""
    shard = None
    if mesh is not None:
        from ..parallel.shard import AXIS, check_mesh

        ax = check_mesh(mesh).axis(AXIS)
        shard = (ax.size, ax.rank)
        device = mesh.device
    dev = resolve_device(device)
    with open(os.path.join(path, _CFG_FILE)) as f:
        cfg = _cfg_from_json(f.read())
    t = load_file(os.path.join(path, _PARAMS_FILE))

    def node(key):
        if key in t:
            return t[key].to(dev)
        if key + ".wp" in t:
            return QLinear(wp=t[key + ".wp"].to(dev),
                           scales=t[key + ".scales"].to(dev))
        return None

    layers = LlamaLayer(**{f.name: node("layers." + f.name)
                           for f in dataclasses.fields(LlamaLayer)})
    params = LlamaParams(embed=node("embed"), layers=layers,
                         final_norm=node("final_norm"),
                         lm_head=node("lm_head"))
    if shard is not None:
        from ..parallel.shard import shard_for_rank

        params = shard_for_rank(params, cfg, *shard)
    return cfg, params
