"""Named mesh axes over the ranks of ``torch.distributed`` (counterpart of
``quantizations_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process, a ``Mesh`` of devices
and ``shard_map``. The port is multi-controller: one process per rank,
each running the same program on its own shard, with ``torch.distributed``
collectives over per-axis process groups. :func:`make_mesh` lays the
initialized world out row-major over named axes (the last axis is the
minor one) and gives each axis the process group of the rank's line
along it.

The mesh is the port's own and not torch's ``DeviceMesh``: a
``DeviceMesh`` of device type ``cuda`` starts NCCL groups, which refuse
several ranks on one card, and it expects one device per rank. Here ranks
may share a card under gloo (:func:`choose_backend`), and an axis needs
only its group, size and coordinate.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Axis", "Mesh", "CommStats", "make_mesh", "rank_device",
           "choose_backend", "DEFAULT_TIMEOUT"]

# every process group's timeout: a collective that a rank never reaches
# raises on the others after this long
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


class CommStats:
    """Per-process collective counters of one mesh: calls, seconds on the
    host clock (the staging copies included), bytes sent, and the calls
    that were staged through the host (:mod:`.collectives`)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}
        self.bytes: Dict[str, int] = {}
        self.staged: Dict[str, int] = {}

    def add(self, op: str, seconds: float, nbytes: int, staged: bool) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.seconds[op] = self.seconds.get(op, 0.0) + seconds
        self.bytes[op] = self.bytes.get(op, 0) + nbytes
        if staged:
            self.staged[op] = self.staged.get(op, 0) + 1

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "seconds": dict(self.seconds),
                "bytes": dict(self.bytes), "staged": dict(self.staged),
                "total_s": sum(self.seconds.values())}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its ``size``, this rank's
    coordinate ``rank`` on it, the global ranks of this rank's line along
    it (``ranks[c]`` holds coordinate ``c``) and their process ``group``
    (None when ``size == 1``). This is what the port passes as
    ``axis_name``."""

    name: str
    size: int
    rank: int
    ranks: Tuple[int, ...]
    group: Optional[object]
    backend: str
    stats: CommStats = dataclasses.field(compare=False, repr=False,
                                         default_factory=CommStats)


class Mesh:
    """Named axes over the world's ranks. ``shape`` maps each axis name
    to its size, as the JAX ``Mesh.shape`` does; :meth:`axis` gives the
    :class:`Axis`; ``device`` is this rank's device and ``stats`` the
    counters of every collective over its axes."""

    def __init__(self, axes: Sequence[Axis], device: torch.device,
                 backend: str, stats: CommStats):
        self._axes = {a.name: a for a in axes}
        self.axis_names = tuple(a.name for a in axes)
        self.shape = {a.name: a.size for a in axes}
        self.device = device
        self.backend = backend
        self.stats = stats

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise ValueError(f"mesh has no axis {name!r}: its axes are "
                             f"{self.axis_names}")
        return self._axes[name]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, device={self.device}, "
                f"backend={self.backend})")


def rank_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """This rank's device: the CPU when the caller asks for it, else
    ``cuda:(LOCAL_RANK % device_count)``, so that ranks beyond the
    card count share cards."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device: Union[str, torch.device], local_ranks: int) -> str:
    """NCCL when each of the ``local_ranks`` ranks of this host has a card
    of its own, gloo when ranks share a card (NCCL refuses two ranks on
    one GPU) or run on the CPU."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_ranks):
        return "nccl"
    return "gloo"


def _resolve_shape(shape: Sequence[int], n: int) -> Tuple[int, ...]:
    shape = tuple(int(s) for s in shape)
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape {shape}: at most one -1")
    known = math.prod(s for s in shape if s != -1)
    if -1 in shape:
        if n % known:
            raise ValueError(f"mesh shape {shape} does not divide {n} ranks")
        shape = tuple(n // known if s == -1 else s for s in shape)
    return shape


def make_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = ("tp",),
              device: Union[str, torch.device] = "cuda",
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """A :class:`Mesh` of ``shape`` (``-1`` absorbs the remaining ranks)
    named ``axes`` over the initialized world, or over this one process
    when ``torch.distributed`` is not initialized (every axis of size 1).

    Every rank must call it, with the same arguments, in the same order:
    ``dist.new_group`` is collective over the world. The ranks are laid
    out row-major, the last axis minor (a (dp, tp) mesh puts tp
    neighbours on consecutive ranks). Raises ``ValueError`` when the
    shape does not cover the world exactly."""
    axes = tuple(axes)
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    me = dist.get_rank() if init else 0
    shape = _resolve_shape(shape, world)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} repeat a name")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, the world has {world}")
    backend = str(dist.get_backend()) if init else "none"
    grid = torch.arange(world).reshape(shape)
    coords = [int(c) for c in torch.nonzero(grid == me)[0]]
    stats = CommStats()
    out = []
    for ax, name in enumerate(axes):
        mine = grid.movedim(ax, -1)[tuple(
            c for i, c in enumerate(coords) if i != ax)]
        mine = tuple(int(r) for r in mine)
        group = None
        if shape[ax] > 1:
            # every line of this axis, in one order on every rank
            lines = grid.movedim(ax, -1).reshape(-1, shape[ax])
            for line in lines.tolist():
                g = dist.new_group(ranks=line, timeout=timeout)
                if tuple(line) == mine:
                    group = g
        out.append(Axis(name=name, size=shape[ax], rank=coords[ax],
                        ranks=mine, group=group, backend=backend,
                        stats=stats))
    return Mesh(out, rank_device(device), backend, stats)
