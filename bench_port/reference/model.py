"""The plain reference: a Llama-family decoder (Mistral's equations) in
fp32 torch, with no cache, no batching and no kernel of the program.

Per layer: RMSNorm, q/k/v projections, rotary embeddings (HF
``rotate_half``), causal grouped-query attention over the whole
sequence, the o projection and the residual; RMSNorm, SwiGLU
(``silu(gate) * up``), the down projection and the residual. Then the
final RMSNorm and the lm_head. Every projection's weight is the 4-bit
weight of :mod:`.quant`, dequantized to fp32; the embedding is the bf16
table. Every norm gain is 1, as the seeded weights make it.

The forward goes layer by layer over all the sequences at once, drawing
each layer's weights again from the seed (:mod:`bench_port.weights`),
so that only one layer's fp32 weights are on the device at a time.
Matrix products run in fp32 with TF32 off.

``act_dtype``: the control. Every projection's input is rounded to that
8-bit float type, each row scaled by its absmax to the type's largest
value first (a W4A8 model in place of the W4A16 one the configuration
states).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch

from .. import weights as W
from . import quant

# Query rows of one attention block (bounds the [heads, rows, keys]
# score tensor of a long sequence).
ATTN_BLOCK = 1024


@contextlib.contextmanager
def fp32_exact() -> Iterator[None]:
    """fp32 products in full fp32: TF32 off for the block."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def round_rows(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` rounded to ``dtype`` row by row (absmax to the type's
    largest value), back in fp32; ``dtype`` None leaves it."""
    if dtype is None:
        return x
    top = torch.finfo(dtype).max
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / top
    return (x / s).to(dtype).float() * s


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [S, H, D]`` at positions 0..S-1."""
    S, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)[:, None, :]
    rot = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q ``[S, Hq, D]``, k/v ``[S, Hkv, D]`` -> ``[S, Hq * D]``."""
    S, Hq, D = q.shape
    G = Hq // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)     # [Hq, S, D]
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((S, Hq, D), dtype=torch.float32, device=q.device)
    for a in range(0, S, ATTN_BLOCK):
        b = min(S, a + ATTN_BLOCK)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * D ** -0.5
        keep = (torch.arange(b, device=q.device)[None, :]
                <= torch.arange(a, b, device=q.device)[:, None])
        s = s.masked_fill(~keep[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, dim=-1),
                                v[:, :b])
    return out.reshape(S, Hq * D)


def forward_logits(dims: W.Dims, seed: int, device: torch.device,
                   seqs: Sequence[Sequence[int]], starts: Sequence[int],
                   quant_type: str = "fp4", blocksize: int = 64,
                   compress_statistics: bool = True, sigma: float = 0.02,
                   act_dtype: Optional[torch.dtype] = None
                   ) -> List[torch.Tensor]:
    """For each sequence ``seqs[i]``, the fp32 logits ``[n_i, vocab]`` of
    positions ``starts[i] - 1 .. len - 2``: the logits that chose tokens
    ``starts[i] .. len - 1``."""
    if dims.sliding_window is not None:
        raise NotImplementedError("the reference has no sliding window")
    if dims.tie_embeddings:
        raise NotImplementedError("the reference has no tied lm_head")

    def deq(w):
        return quant.dequantized_weight(w, quant_type, blocksize,
                                        compress_statistics)

    def lin(x, w):
        return round_rows(x, act_dtype) @ w.T

    D = dims.head_dim
    with fp32_exact(), torch.inference_mode():
        embed = W.head_weight(dims, seed, "embed", device, sigma)
        hs = [embed[torch.as_tensor(list(s), device=device)].float()
              for s in seqs]
        del embed
        for layer in range(dims.layers):
            raw = W.layer_weights(dims, seed, layer, device, sigma)
            wq, wk, wv, wo = (deq(raw[n]) for n in ("q", "k", "v", "o"))
            for i, x in enumerate(hs):
                a = rms_norm(x, dims.eps)
                S = x.shape[0]
                q = rope(lin(a, wq).view(S, dims.n_q, D), dims.rope_theta)
                k = rope(lin(a, wk).view(S, dims.n_kv, D), dims.rope_theta)
                v = lin(a, wv).view(S, dims.n_kv, D)
                hs[i] = x + lin(causal_attention(q, k, v), wo)
            del wq, wk, wv, wo
            wg, wu = deq(raw["gate"]), deq(raw["up"])
            wd = deq(raw["down"])
            for i, x in enumerate(hs):
                m = rms_norm(x, dims.eps)
                act = torch.nn.functional.silu(lin(m, wg)) * lin(m, wu)
                hs[i] = x + lin(act, wd)
            del raw, wg, wu, wd
        head = deq(W.head_weight(dims, seed, "lm_head", device, sigma))
        out = [lin(rms_norm(x[st - 1:x.shape[0] - 1], dims.eps), head)
               for x, st in zip(hs, starts)]
    return out
