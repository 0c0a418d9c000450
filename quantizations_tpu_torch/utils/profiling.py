"""Profiling and tracing of the port (counterpart of
``quantizations_tpu/utils/profiling.py``).

``trace()`` runs ``torch.profiler`` over the enclosed block (the CPU,
and the card when there is one), with the spans' ranges on, and writes
a Chrome trace (view it in Perfetto or ``chrome://tracing``);
``model_weight_bytes`` counts a
params tree's bytes.

``span(name)`` marks a stretch of the serving path, as a context manager
or a decorator, and ``count(name, n)`` adds to a named counter. Two
switches, independent of each other and both off until turned on by
API, decide what a span does:

- while :data:`ranges` is on (``ranges.enable()``; ``trace()`` turns it
  on for its block) and a ``torch.profiler`` runs, it enters
  ``torch.profiler.record_function("qt:" + name)``, so the range sits on
  the profiler's timeline beside the device operations launched inside
  it. A profiler alone does not turn it on: under CUDA activity the
  profiler puts a copy of each range on the device's timeline, and a
  reader of the trace that does not know the prefix would count that
  copy as a kernel and its time twice;
- while :data:`tracer` is on (``tracer.enable()``), it adds to the
  tracer's totals per span path (``engine.step/decode.forward``): calls,
  host nanoseconds (``time.perf_counter_ns``) and self nanoseconds (the
  total less the time of the child spans); counters are kept only then.

With both off, ``span`` reads no clock and enters no range: it costs a
flag test and a shared null context. The tracer is one per process and
assumes one thread drives the spans, as the engines do.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Dict, Iterator, List, Sequence

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "model_weight_bytes", "span", "count", "tracer",
           "ranges", "Switch", "Tracer", "RANGE_PREFIX"]

RANGE_PREFIX = "qt:"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block, the spans' ``qt:`` ranges on, and write
    ``trace.json`` (Chrome trace format) into ``log_dir``, made if
    missing. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = ranges.on
    ranges.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    finally:
        ranges.on = was
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def model_weight_bytes(params) -> int:
    """Bytes of every tensor of a params tree, the JAX package's count.
    With a dense embedding table this is more than a decode token
    streams: a token reads one row of the table, not all of it."""
    from ..models.llama import named_tensors

    return sum(t.numel() * t.element_size() for _, t in named_tensors(params))


class Switch:
    """A switch of the spans, off until :meth:`enable`."""

    def __init__(self):
        self.on = False

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False


ranges = Switch()


class Tracer(Switch):
    """The in-memory span totals and counters; off until :meth:`enable`.

    ``_stack`` holds a frame ``[path, start_ns, child_ns]`` for each span
    open while the tracer was on; ``_spans`` maps a path to ``[calls,
    total_ns, self_ns]``."""

    def __init__(self):
        super().__init__()
        self._stack: List[list] = []
        self._spans: Dict[str, List[int]] = {}
        self._counters: Dict[str, int] = {}

    def reset(self) -> None:
        """Forget the totals and counters (spans still open keep their
        frames and are recorded when they close)."""
        self._spans = {}
        self._counters = {}

    def snapshot(self) -> dict:
        """``{"spans": {path: {"calls", "total_ns", "self_ns"}},
        "counters": {name: n}}``: the totals so far, copied."""
        return {"spans": {p: {"calls": c, "total_ns": t, "self_ns": s}
                          for p, (c, t, s) in self._spans.items()},
                "counters": dict(self._counters)}

    def _push(self, name: str) -> list:
        parent = self._stack[-1][0] + "/" if self._stack else ""
        frame = [parent + name, time.perf_counter_ns(), 0]
        self._stack.append(frame)
        return frame

    def _pop(self, frame: list) -> None:
        dt = time.perf_counter_ns() - frame[1]
        if not self._stack or self._stack[-1] is not frame:
            return
        self._stack.pop()
        acc = self._spans.get(frame[0])
        if acc is None:
            acc = self._spans[frame[0]] = [0, 0, 0]
        acc[0] += 1
        acc[1] += dt
        acc[2] += dt - frame[2]
        if self._stack:
            self._stack[-1][2] += dt


tracer = Tracer()


class _Span:
    """One span's entry: a context manager, or a decorator whose wrapper
    tests the switches at each call."""

    __slots__ = ("name", "uids", "_range", "_frame")

    def __init__(self, name: str, uids: Sequence[int] = ()):
        self.name = name
        self.uids = uids
        self._range = None
        self._frame = None

    def __enter__(self):
        if ranges.on and _autograd_profiler._is_profiler_enabled:
            args = ("uids=" + ",".join(map(str, self.uids))
                    if self.uids else None)
            self._range = torch.profiler.record_function(
                RANGE_PREFIX + self.name, args)
            self._range.__enter__()
        if tracer.on:
            self._frame = tracer._push(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self._frame is not None:
            tracer._pop(self._frame)
            self._frame = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not (tracer.on or ranges.on):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return traced


class _Off(_Span):
    """The shared null context of a span name, handed out while both
    switches are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF: Dict[str, _Off] = {}


def span(name: str, uids: Sequence[int] = ()) -> _Span:
    """A span named ``name``: ``with span(name): ...`` or ``@span(name)``.
    ``uids``: the request uids the span serves, the profiler range's
    ``args`` (``uids=3,4``)."""
    if tracer.on or ranges.on:
        return _Span(name, uids)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while the tracer is on."""
    if tracer.on:
        tracer._counters[name] = tracer._counters.get(name, 0) + n
