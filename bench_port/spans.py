"""The traced run's spans: ranges the benchmark wraps around calls into
the program, from its own files.

Each ``spans/*.json`` lists wrap points: ``name`` (the span, and its
``torch.profiler.record_function`` range ``bench:<name>``), ``module``,
optional ``object`` (a class), ``attr``, ``kind`` (``function``, a
method or a function; ``factory``, a function whose returned callable is
the span), ``during`` and optional ``counter``, the file
``counters/<counter>.py`` whose ``before(rec, call)`` and
``count(rec, call)`` see each call. ``during`` says when the wrap is in
place: ``window`` from set-up to the window's close (a span a step or an
admission: its host cost is a few microseconds a step), ``stretch``
only while the profiler runs (a span a projection or a layer, whose
wrapper and counter would slow the host's side of every step). A wrap
point that no longer exists is listed in :attr:`Recorder.missing` and
left out; the metrics that need it then find nothing to read.

:class:`Recorder` holds what the spans record: the spans the host is
in, the host time inside each span over the window until the profiler
starts, and the counters' operations, bytes and
least times by phase (``prefill`` inside ``engine.admit``, else
``decode``) over the profiled stretch.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from . import roofline

ADMIT = "engine.admit"


@dataclasses.dataclass
class Call:
    """One call through a span: its arguments and result; ``outer`` the
    factory's arguments for a ``factory`` span."""

    args: tuple
    kwargs: dict
    result: Any = None
    outer: tuple = ()


@dataclasses.dataclass
class Acc:
    calls: int = 0
    ops: float = 0.0
    bytes: float = 0.0
    least_s: float = 0.0


class Recorder:
    def __init__(self):
        self.stack: List[str] = []
        self.in_window = False
        self.profiling = False
        self.host_ns: Dict[str, int] = collections.defaultdict(int)
        self.totals: Dict[tuple, Acc] = collections.defaultdict(Acc)
        self.round = None          # (starts, takes) of the prefill round
        self.missing: List[str] = []
        self.installed: List[str] = []

    @property
    def phase(self) -> str:
        return "prefill" if ADMIT in self.stack else "decode"

    def add(self, counter: str, ops: float, nbytes: float) -> None:
        if not self.profiling:
            return
        a = self.totals[(counter, self.phase)]
        a.calls += 1
        a.ops += ops
        a.bytes += nbytes
        a.least_s += roofline.least_seconds(ops, nbytes)

    def acc(self, counter: str, phase: str) -> Acc:
        return self.totals.get((counter, phase), Acc())


def _load_counter(bench_dir: Path, name: Optional[str]):
    if not name:
        return None
    path = bench_dir / "counters" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_counter_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(rec: Recorder, name: str, fn: Callable, counter,
          outer: tuple = ()) -> Callable:
    label = "bench:" + name
    before = getattr(counter, "before", None)
    count = getattr(counter, "count", None)

    def wrapped(*args, **kwargs):
        call = Call(args, kwargs, outer=outer)
        if before is not None:
            before(rec, call)
        rec.stack.append(name)
        t = time.perf_counter_ns()
        try:
            with torch.profiler.record_function(label):
                call.result = fn(*args, **kwargs)
        finally:
            rec.stack.pop()
            if rec.in_window:
                rec.host_ns[name] += time.perf_counter_ns() - t
        if count is not None:
            count(rec, call)
        return call.result

    return wrapped


class Spans:
    """The wrap points of ``bench_dir/spans/*.json``, resolved and with
    their counters loaded; :meth:`on` and :meth:`off` put the wraps of
    one ``during`` in place and take them away."""

    def __init__(self, rec: Recorder, bench_dir: Path):
        self.rec = rec
        self.points: Dict[str, list] = collections.defaultdict(list)
        self.undo: Dict[str, list] = collections.defaultdict(list)
        for path in sorted((bench_dir / "spans").glob("*.json")):
            for e in json.loads(path.read_text()):
                try:
                    owner = importlib.import_module(e["module"])
                    if e.get("object"):
                        owner = getattr(owner, e["object"])
                    orig = owner.__dict__[e["attr"]] \
                        if isinstance(owner, type) \
                        else getattr(owner, e["attr"])
                except (ImportError, AttributeError, KeyError):
                    rec.missing.append(e["name"])
                    continue
                counter = _load_counter(bench_dir, e.get("counter"))
                if e.get("kind", "function") == "factory":
                    def wrapped(*fa, _o=orig, _n=e["name"], _c=counter,
                                **fk):
                        return _span(rec, _n, _o(*fa, **fk), _c, outer=fa)
                else:
                    wrapped = _span(rec, e["name"], orig, counter)
                self.points[e.get("during", "window")].append(
                    (owner, e["attr"], orig, wrapped, e["name"]))

    def on(self, during: str) -> None:
        for owner, attr, orig, wrapped, name in self.points[during]:
            setattr(owner, attr, wrapped)
            self.undo[during].append((owner, attr, orig))
            self.rec.installed.append(name)

    def off(self, during: str) -> None:
        for owner, attr, orig in reversed(self.undo.pop(during, [])):
            setattr(owner, attr, orig)

    def remove(self) -> None:
        for during in list(self.undo):
            self.off(during)
