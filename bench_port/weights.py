"""A configuration's shapes and its seeded random weights.

Both sides of the comparison draw their weights here: the program
quantizes them through its own build path, the plain reference
quantizes them again with its own copy of the quantizer. Every tensor
comes from a ``torch.Generator`` on the run's device, seeded from the
run's seed and the tensor's place in the model, so that either side can
draw one layer again without drawing the others. A layer is one
``randn`` call; the embedding and the lm_head a few, in row slabs.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Tuple

import torch

# The order of a layer's projections in its one draw.
LAYER_PARTS = ("q", "k", "v", "o", "gate", "up", "down")

# Rows of the embedding or lm_head drawn per call.
HEAD_SLAB_ROWS = 16384


@dataclasses.dataclass(frozen=True)
class Dims:
    """The shapes of a Llama-family decoder, from HF ``config.json`` keys."""

    vocab: int
    hidden: int
    inter: int
    layers: int
    n_q: int
    n_kv: int
    head_dim: int
    rope_theta: float
    eps: float
    sliding_window: object = None
    tie_embeddings: bool = False

    @classmethod
    def from_config(cls, c: dict) -> "Dims":
        return cls(vocab=c["vocab_size"], hidden=c["hidden_size"],
                   inter=c["intermediate_size"],
                   layers=c["num_hidden_layers"],
                   n_q=c["num_attention_heads"],
                   n_kv=c.get("num_key_value_heads",
                              c["num_attention_heads"]),
                   head_dim=c.get("head_dim") or
                   c["hidden_size"] // c["num_attention_heads"],
                   rope_theta=float(c.get("rope_theta", 10000.0)),
                   eps=float(c.get("rms_norm_eps", 1e-5)),
                   sliding_window=c.get("sliding_window"),
                   tie_embeddings=bool(c.get("tie_word_embeddings", False)))

    def part_shapes(self) -> Dict[str, Tuple[int, int]]:
        """(out, in) of each projection of a layer."""
        h, qs, kvs = self.hidden, self.n_q * self.head_dim, \
            self.n_kv * self.head_dim
        return {"q": (qs, h), "k": (kvs, h), "v": (kvs, h), "o": (h, qs),
                "gate": (self.inter, h), "up": (self.inter, h),
                "down": (h, self.inter)}

    def layer_params(self) -> int:
        return sum(o * i for o, i in self.part_shapes().values())

    def head_params(self) -> int:
        return self.vocab * self.hidden


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for tensor ``name`` of run ``seed``."""
    d = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(d[:8], "little") >> 1


def _gen(seed: int, name: str, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, name))
    return g


def _draw(gen: torch.Generator, n: int, sigma: float,
          device: torch.device) -> torch.Tensor:
    """``n`` normal draws times ``sigma``, rounded once to bf16."""
    return torch.randn(n, generator=gen, device=device,
                       dtype=torch.float32).mul_(sigma).to(torch.bfloat16)


def layer_weights(dims: Dims, seed: int, layer: int, device: torch.device,
                  sigma: float = 0.02) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s bf16 projections ``[out, in]``, views into one
    draw."""
    shapes = dims.part_shapes()
    flat = _draw(_gen(seed, f"layer{layer}", device),
                 sum(o * i for o, i in shapes.values()), sigma, device)
    out, at = {}, 0
    for name in LAYER_PARTS:
        o, i = shapes[name]
        out[name] = flat[at:at + o * i].view(o, i)
        at += o * i
    return out


def head_weight(dims: Dims, seed: int, name: str, device: torch.device,
                sigma: float = 0.02) -> torch.Tensor:
    """The bf16 ``[vocab, hidden]`` table ``name`` ("embed" or
    "lm_head"), drawn in slabs of :data:`HEAD_SLAB_ROWS` rows."""
    gen = _gen(seed, name, device)
    out = torch.empty((dims.vocab, dims.hidden), dtype=torch.bfloat16,
                      device=device)
    for r in range(0, dims.vocab, HEAD_SLAB_ROWS):
        rows = min(HEAD_SLAB_ROWS, dims.vocab - r)
        out[r:r + rows] = _draw(gen, rows * dims.hidden, sigma,
                                device).view(rows, dims.hidden)
    return out
