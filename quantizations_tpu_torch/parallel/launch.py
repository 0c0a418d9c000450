"""Start N ranks and run one function on each (the port's counterpart of
the JAX package's single controller).

    results = launch(fn, 2, *args, device="cpu")
    with RankPool(4, device="cuda") as pool:
        a = pool.run(fn_a, x)
        b = pool.run(fn_b, y)

Each rank is a process made with the spawn start method. It joins a
process group (:func:`~.mesh.choose_backend`: NCCL when every rank has
a card of its own, gloo when ranks share one or run on the CPU) through
a ``file://`` rendezvous in a fresh temporary directory, so pools of
concurrent test workers never meet, with the group timeout
:data:`~.mesh.DEFAULT_TIMEOUT`. Then it runs every ``fn(*args)`` it is
sent and sends back the result, its tensors moved to the CPU. ``fn``
travels by import path (a module-level function) and must be called on
every rank, since ranks meet in collectives.

On the card the kernels are built before the ranks start, so that ranks
never race to build them. When a rank raises, dies or misses the
deadline, every rank is killed and :class:`RankError` is raised.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Union

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import DEFAULT_TIMEOUT, choose_backend, rank_device

__all__ = ["launch", "RankPool", "RankError"]

# seconds for every rank to start and join the group
START_DEADLINE = 300.0


class RankError(RuntimeError):
    """A rank raised, died or missed the deadline; every rank was
    killed."""


def _host(obj: Any) -> Any:
    """``obj`` with every tensor moved to the CPU (lists, tuples and dicts
    walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world: int, init_file: str, device: str,
               backend: str, threads: int, conn) -> None:
    """A rank's loop: join the group, then run each ``(fn, args)`` it
    receives until it receives None."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(threads)
    try:
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=DEFAULT_TIMEOUT)
        conn.send(("ok", None))
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            job = conn.recv()
            if job is None:
                break
            fn, args = job
            try:
                out = ("ok", _host(fn(*args)))
            except Exception:
                out = ("err", traceback.format_exc())
            conn.send(out)
    finally:
        dist.destroy_process_group()


class RankPool:
    """``nprocs`` ranks that stay up between :meth:`run` calls (one spawn
    and one group for many runs). ``device="cpu"`` runs the ranks on the
    CPU; ``threads`` sets each rank's ``torch.set_num_threads`` (by
    default the host's cores shared out, at least one: ranks that each
    take every core spin against each other). After a failed run the
    pool is closed."""

    def __init__(self, nprocs: int, device: Union[str, torch.device] = "cuda",
                 threads: Optional[int] = None):
        dev = resolve_device(device)
        if dev.type == "cuda":
            from ..ops.cuda import KERNELS, build

            build(KERNELS)
        self.nprocs = nprocs
        self.device = dev.type
        if threads is None:
            threads = max(1, (os.cpu_count() or 1) // nprocs)
        self.backend = choose_backend(dev, nprocs)
        self._dir = tempfile.mkdtemp(prefix="qt_ranks_")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for r in range(nprocs):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                r, nprocs, os.path.join(self._dir, "rendezvous"),
                self.device, self.backend, threads, child))
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self._collect(START_DEADLINE, "start")

    def _collect(self, deadline: float, what: str) -> List[Any]:
        """Every rank's reply within ``deadline`` seconds, or kill them all
        and raise."""
        end = time.monotonic() + deadline
        out: dict = {}
        waiting = {c: r for r, c in enumerate(self._conns)}
        sentinels = {p.sentinel: r for r, p in enumerate(self._procs)}
        while waiting:
            left = end - time.monotonic()
            ready = mpc.wait(list(waiting) + list(sentinels), max(left, 0))
            if not ready:
                self.close(kill=True)
                raise RankError(
                    f"{what}: ranks {sorted(waiting.values())} missed the "
                    f"{deadline:.0f} s deadline; every rank was killed")
            for obj in ready:
                if obj in waiting:
                    r = waiting.pop(obj)
                    try:
                        status, val = obj.recv()
                    except EOFError:
                        status, val = "err", "the rank died"
                    if status != "ok":
                        self.close(kill=True)
                        raise RankError(f"{what}: rank {r} failed:\n{val}")
                    out[r] = val
                elif obj in sentinels and sentinels[obj] in waiting.values():
                    r = sentinels.pop(obj)
                    conn = self._conns[r]
                    if conn.poll():          # its reply is waiting
                        continue
                    self.close(kill=True)
                    raise RankError(f"{what}: rank {r} exited with code "
                                    f"{self._procs[r].exitcode}")
                else:
                    sentinels.pop(obj, None)
        return [out[r] for r in range(self.nprocs)]

    def run(self, fn: Callable, *args, deadline: float = 600.0) -> List[Any]:
        """``fn(*args)`` on every rank; returns each rank's result in rank
        order. Raises :class:`RankError` (every rank killed) when a rank
        raises, dies or has not answered after ``deadline`` seconds."""
        if not self._procs:
            raise RankError("the pool is closed")
        for c in self._conns:
            c.send((fn, args))
        return self._collect(deadline, getattr(fn, "__name__", "run"))

    def close(self, kill: bool = False) -> None:
        """Stop the ranks (killed with ``kill``, else asked to leave and
        killed if they have not after 30 s) and remove the rendezvous."""
        for c, p in zip(self._conns, self._procs):
            if not kill and p.is_alive():
                try:
                    c.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for p in self._procs:
            if not kill:
                p.join(30)
            if p.is_alive():
                p.kill()
            p.join()
        for c in self._conns:
            c.close()
        self._procs, self._conns = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch(fn: Callable, nprocs: int, *args,
           device: Union[str, torch.device] = "cuda",
           threads: Optional[int] = None, deadline: float = 600.0
           ) -> List[Any]:
    """Spawn ``nprocs`` ranks, run ``fn(*args)`` on each and return every
    rank's result in rank order (see :class:`RankPool`)."""
    with RankPool(nprocs, device=device, threads=threads) as pool:
        return pool.run(fn, *args, deadline=deadline)
