"""Failure detection and request re-dispatch across serving engines
(counterpart of ``quantizations_tpu/serve/watchdog.py``).

A host-side watchdog drives several engines, detects a dead step (an
exception from the runtime, or a wall-clock hang) and re-dispatches the
failed engine's unfinished requests to a healthy engine. A recovered
request's prompt is extended by the tokens it already emitted
(``Engine.recover``), so under greedy decoding the healthy engine
continues the same stream, up to bf16 near-ties between the prefill of
the extended prompt and the decode steps it replaces.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

from .engine import Engine, Request

__all__ = ["Watchdog"]


class Watchdog:
    """Drive ``engines`` to completion, surviving engine failures.

    - An exception raised by an engine's step marks that engine dead.
    - A step exceeding ``step_timeout_s`` wall-clock (run on a daemon
      thread) marks the engine dead; the stuck thread is abandoned (a
      hung device call cannot be interrupted from the host: the requests
      are what is saved, and a deployment restarts the process behind
      it). The step is dispatched on the caller's CUDA stream.
    - A dead engine's in-flight requests are recovered with ``recover()``
      (prompt extended by the generated tokens) and its whole queue goes
      to the least-loaded live engine.

    The engine interface is duck-typed (``step``, ``step_window``,
    ``recover``, ``has_work``, ``queue``, ``active``, ``finished``,
    ``stats``): the slot ``Engine`` and ``PagedEngine`` both qualify and
    a pool may mix them (re-dispatch moves only Request objects, never
    device state).
    """

    def __init__(self, engines: List[Engine],
                 step_timeout_s: Optional[float] = None,
                 steps_per_dispatch: int = 1):
        if not engines:
            raise ValueError("need at least one engine")
        self.engines = list(engines)
        self.dead = [False] * len(engines)
        self.step_timeout_s = step_timeout_s
        self.steps_per_dispatch = steps_per_dispatch
        self.failures: List[int] = []      # engine indices, in order

    # -- failure handling --------------------------------------------------

    def _live_indices(self) -> List[int]:
        return [i for i, d in enumerate(self.dead) if not d]

    def _mark_dead_and_redispatch(self, idx: int) -> int:
        """Recover engine ``idx``'s work onto a healthy engine. Returns
        the number of requests moved."""
        self.dead[idx] = True
        self.failures.append(idx)
        src = self.engines[idx]
        live = self._live_indices()
        if not live:
            raise RuntimeError(
                f"engine {idx} failed and no live engine remains")
        try:
            src.recover()             # in-flight -> queue (prefix kept)
        except Exception:
            # the engine may be too broken to reset its cache; its
            # requests are still host-side
            for i, r in enumerate(src.active):
                if r is not None:
                    r.prompt_ids = r.prompt_ids + r.output_ids
                    src.queue.appendleft(r)
                    src.active[i] = None
        tgt = self.engines[min(
            live, key=lambda i: len(self.engines[i].queue))]
        moved = 0
        while src.queue:
            tgt.queue.append(src.queue.popleft())
            moved += 1
        return moved

    def _guarded_step(self, idx: int) -> bool:
        """One dispatch on engine ``idx``; False if the engine died."""
        eng = self.engines[idx]

        def do_step():
            if self.steps_per_dispatch > 1:
                eng.step_window(self.steps_per_dispatch)
            else:
                eng.step()

        if self.step_timeout_s is None:
            try:
                do_step()
                return True
            except Exception:
                return False

        # a new thread starts on the default stream: keep the caller's
        stream = (torch.cuda.current_stream()
                  if torch.cuda.is_available() and torch.cuda.is_initialized()
                  else None)
        err: Dict[str, BaseException] = {}

        def run():
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    do_step()
            except BaseException as e:   # noqa: BLE001 - reported upward
                err["e"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(self.step_timeout_s)
        if t.is_alive():                 # hung step
            return False
        return "e" not in err

    # -- public ------------------------------------------------------------

    def has_work(self) -> bool:
        return any(not self.dead[i] and self.engines[i].has_work()
                   for i in range(len(self.engines)))

    def run(self, max_rounds: int = 100000) -> List[Request]:
        """Drive all engines until every request finishes (or every
        engine dies). Returns the finished requests (uids are
        engine-local and a re-dispatched request keeps its original
        uid, so identity, not uid, is the key). A moved request whose uid
        an engine's own request also has overwrites it in that engine's
        ``finished`` dict, so the requests held at the start are gathered
        too (the JAX package returns only the dicts' values)."""
        held = [r for eng in self.engines
                for r in list(eng.queue) + list(eng.active) if r is not None]
        rounds = 0
        while self.has_work() and rounds < max_rounds:
            rounds += 1
            for i in self._live_indices():
                if not self.engines[i].has_work():
                    continue
                if not self._guarded_step(i):
                    self._mark_dead_and_redispatch(i)
        out: List[Request] = []
        seen = set()
        finished = [r for eng in self.engines for r in eng.finished.values()]
        for r in finished + [r for r in held if r.done]:
            if id(r) not in seen:
                seen.add(id(r))
                out.append(r)
        return out

    def stats(self) -> dict:
        return {
            "engines": len(self.engines),
            "dead": [i for i, d in enumerate(self.dead) if d],
            "failures": list(self.failures),
            "per_engine": [e.stats() for e in self.engines],
        }


def _heartbeat_age(last_beat: float) -> float:
    """Seconds since the last heartbeat (the multi-host liveness
    primitive: each host publishes ``time.time()`` after every successful
    step, and the coordinator marks dead the hosts whose age exceeds the
    step deadline)."""
    return time.time() - last_beat
