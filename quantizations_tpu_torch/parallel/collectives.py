"""The collectives of the parallel path over a mesh :class:`~.mesh.Axis`.

The JAX package's XLA collectives map to ``torch.distributed`` as:

- ``psum`` of the row-parallel partials: :func:`all_reduce_sum`, an
  all-gather and a sum in coordinate order on the tensor's own device.
  Every rank then adds the same values in the same order, so the result
  is the same bits on every rank, whatever the backend and however the
  rows are chunked (``tp_overlap_chunks``); a ring all-reduce's order
  depends on the chunk an element falls in.
- tiled ``all_gather`` of the vocab-sharded logits: :func:`all_gather_cat`.
- ``ppermute`` of a stage activation or a K/V chunk: :func:`ring_shift`
  and :func:`send_recv` (point-to-point, ``batch_isend_irecv``).
- the last stage's logits to every stage: :func:`broadcast`.

With ranks sharing one card the backend is gloo, which does not take
every collective for CUDA tensors. Such a collective goes through
:func:`_stage`, the one place that copies a CUDA tensor to the host and
back: it computes nothing on the CPU, counts each call in the mesh's
:class:`~.mesh.CommStats` and logs the first one of each collective.
Every call is counted and timed there too.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis

__all__ = ["all_reduce_sum", "all_gather", "all_gather_cat",
           "start_all_gather", "ordered_sum", "broadcast", "ring_shift",
           "send_recv",
           "GLOO_CUDA_NATIVE"]

log = logging.getLogger(__name__)

# the collectives of this module that gloo takes for CUDA tensors in the
# card's torch (2.11.0+cu128, two ranks on one H100). Its send/recv hand
# the device pointer to the TCP transport and the rank dies ("writev ...
# Bad address"), so point-to-point is staged through the host.
GLOO_CUDA_NATIVE = frozenset({"all_gather", "broadcast"})


def _staged(op: str, axis: Axis, t: torch.Tensor) -> bool:
    return (t.is_cuda and axis.backend == "gloo"
            and op not in GLOO_CUDA_NATIVE)


def _log_first(op: str, axis: Axis) -> None:
    if not axis.stats.staged.get(op):
        log.warning("gloo takes no CUDA tensor for %s: staging it through "
                    "the host", op)


def _stage(op: str, axis: Axis, t: torch.Tensor,
           run: Callable[[torch.Tensor], List[torch.Tensor]]
           ) -> List[torch.Tensor]:
    """Run collective ``op`` through ``run(tensor) -> [tensors]``: on the
    tensor itself, or, where gloo refuses the CUDA tensor, on a host copy
    with every result copied back to the tensor's device. Counts and
    times the call."""
    t0 = time.perf_counter()
    staged = _staged(op, axis, t)
    if staged:
        _log_first(op, axis)
        out = [r.to(t.device) for r in run(t.cpu())]
    else:
        out = run(t)
    axis.stats.add(op, time.perf_counter() - t0,
                   t.numel() * t.element_size(), staged)
    return out


def all_gather(t: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """Every coordinate's ``t`` along ``axis``, in coordinate order (the
    local one is ``t`` itself)."""
    if axis.size == 1:
        return [t]
    t = t.contiguous()

    def run(x):
        got = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(got, x, group=axis.group)
        return got

    got = _stage("all_gather", axis, t, run)
    got[axis.rank] = t
    return got


class _Pending:
    """An all-gather in flight (:func:`start_all_gather`)."""

    def __init__(self, t: torch.Tensor, axis: Axis):
        self._t, self._axis = t, axis
        self._staged = _staged("all_gather", axis, t)
        if self._staged:
            _log_first("all_gather", axis)
        self._t0 = time.perf_counter()
        src = t.cpu() if self._staged else t
        self._got = [torch.empty_like(src) for _ in range(axis.size)]
        self._work = dist.all_gather(self._got, src, group=axis.group,
                                     async_op=True)

    def wait(self) -> List[torch.Tensor]:
        self._work.wait()
        got = [g.to(self._t.device) for g in self._got]
        got[self._axis.rank] = self._t
        self._axis.stats.add("all_gather", time.perf_counter() - self._t0,
                             self._t.numel() * self._t.element_size(),
                             self._staged)
        return got


def start_all_gather(t: torch.Tensor, axis: Axis) -> _Pending:
    """Start :func:`all_gather` over an axis of more than one coordinate
    and return a handle whose ``wait()`` returns its result: the chunked
    row-parallel reduction computes chunk ``c + 1`` while chunk ``c`` is
    in flight."""
    return _Pending(t.contiguous(), axis)


def ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in that order."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def all_reduce_sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over ``axis``: an all-gather, then coordinate 0 +
    1 + ... on ``t``'s device, the same bits on every rank."""
    if axis.size == 1:
        return t
    return ordered_sum(all_gather(t, axis))


def all_gather_cat(t: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """The JAX package's tiled ``all_gather``: every coordinate's ``t``
    concatenated along ``dim`` in coordinate order."""
    if axis.size == 1:
        return t
    return torch.cat(all_gather(t, axis), dim=dim)


def broadcast(t: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """Coordinate ``src``'s ``t`` on every coordinate (``t`` is the buffer
    on the others, of the same shape and dtype); returns it."""
    if axis.size == 1:
        return t
    t = t.contiguous()

    def run(x):
        dist.broadcast(x, src=axis.ranks[src], group=axis.group)
        return [x]

    return _stage("broadcast", axis, t, run)[0]


def send_recv(send: Optional[Tuple[torch.Tensor, int]],
              recv: Optional[Tuple[torch.Tensor, int]],
              axis: Axis) -> Optional[torch.Tensor]:
    """Point-to-point along ``axis``: send ``send[0]`` to coordinate
    ``send[1]`` and receive into a tensor shaped like ``recv[0]`` from
    coordinate ``recv[1]``, both posted at once (``batch_isend_irecv``),
    either may be None. Returns the received tensor, or None."""
    ref = send[0] if send is not None else recv[0]
    op = "send_recv"
    staged = _staged(op, axis, ref)
    t0 = time.perf_counter()
    if staged:
        _log_first(op, axis)
    ops, got = [], None
    if send is not None:
        x = send[0].contiguous()
        x = x.cpu() if staged else x
        ops.append(dist.P2POp(dist.isend, x, axis.ranks[send[1]],
                              group=axis.group))
    if recv is not None:
        got = torch.empty_like(recv[0], device="cpu" if staged else None)
        ops.append(dist.P2POp(dist.irecv, got, axis.ranks[recv[1]],
                              group=axis.group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if got is not None and staged:
        got = got.to(ref.device)
    axis.stats.add(op, time.perf_counter() - t0,
                   ref.numel() * ref.element_size(), staged)
    return got


def ring_shift(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The JAX package's ``ppermute`` ``i -> i + 1`` around the ring:
    sends ``t`` to the next coordinate and returns the previous one's."""
    if axis.size == 1:
        return t
    n, r = axis.size, axis.rank
    return send_recv((t, (r + 1) % n), (t, (r - 1) % n), axis)
