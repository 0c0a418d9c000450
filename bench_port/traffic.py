"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and makes the requests of a run from its seed.

A closed loop of ``clients`` clients: each sends its next request as
soon as its last one finished. Lengths are drawn in blocks of
``clients`` requests, each block holding the same stratified sample of
the stated distributions (the quantiles at ``(j + 1/2) / clients``) in
an order the run's seed draws; the first block is the first wave, which
may take its output lengths from ``first_wave_output_tokens``. So every
seed serves the same set of sizes, block by block, in an order of its
own (which requests share an admission, which step finishes which
request), and the seed also draws the tokens (uniform over the
vocabulary). Every request is greedy and stops at its length (no eos).
A mix's ``source`` names the published statistics its lengths follow.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from .weights import stream_seed

DISTS = ("uniform", "log_uniform")


@dataclasses.dataclass
class Req:
    """One request as the client sends it."""

    prompt: List[int]
    max_new: int


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The ``n`` stratified integer quantiles of ``dist``: ``uniform`` or
    ``log_uniform`` over ``[low, high]``, both ends included (a fixed
    length is ``low == high``)."""
    kind = dist["dist"]
    if kind not in DISTS:
        raise ValueError(f"length distribution {kind!r} not in {DISTS}")
    lo, hi = int(dist["low"]), int(dist["high"])
    u = (np.arange(n) + 0.5) / n
    if kind == "uniform":
        v = lo + np.floor(u * (hi - lo + 1))
    else:
        v = np.floor(np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo))))
    return np.clip(v, lo, hi).astype(np.int64)


class Traffic:
    """The requests of one run: :meth:`first_wave`, then :meth:`next`
    for each request a client sends after one finished."""

    def __init__(self, spec: dict, seed: int, vocab: int):
        if spec["loop"] != "closed" or spec["sampling"] != "greedy":
            raise ValueError("only a closed loop of greedy requests is "
                             "generated")
        self.spec = spec
        self.clients = int(spec["clients"])
        self.vocab = vocab
        self.rng = np.random.default_rng(stream_seed(seed, "traffic"))
        self.order = np.random.default_rng(stream_seed(seed, "order"))
        self._block: List[Req] = []

    def _make_block(self, out_dist: dict) -> List[Req]:
        n = self.clients
        plens = self.order.permutation(quantiles(self.spec["prompt_tokens"],
                                                 n))
        outs = self.order.permutation(quantiles(out_dist, n))
        return [Req(self.rng.integers(0, self.vocab, int(p)).tolist(), int(o))
                for p, o in zip(plens, outs)]

    def first_wave(self) -> List[Req]:
        return self._make_block(self.spec.get("first_wave_output_tokens",
                                              self.spec["output_tokens"]))

    def next(self) -> Req:
        if not self._block:
            self._block = self._make_block(self.spec["output_tokens"])[::-1]
        return self._block.pop()
