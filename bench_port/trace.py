"""The traced run's device reading: ``torch.profiler`` over a steady
stretch of the window, read in memory (no trace is written).

Each device operation is attributed to the innermost benchmark span
(``bench:<name>`` range) the host was in when it launched it: the launch
is found through the CUDA runtime call of the same correlation id (a
kernel launched by a CUDA graph's replay, through the graph's launch),
else through the CPU op the profiler links it to. :class:`DeviceSummary`
holds the device time and count of operations by span path (``""``:
launched outside every span) and kernel name, the busy and idle time of
the stretch, the longest operations by name and the idle time by what
the host was inside.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

RANGE_PREFIX = "bench:"


@dataclasses.dataclass
class DeviceSummary:
    window_s: float                       # the profiled stretch
    busy_s: float                         # device operations' union
    device_s: Dict[str, float]            # span path -> device seconds
    kernels: Dict[str, int]               # span path -> kernels launched
    by_name: Dict[Tuple[str, str], Tuple[float, int]]  # (path, op) -> s, n
    spans: Dict[str, int]                 # span name -> ranges profiled
    top_ops: List[Tuple[str, float]]
    idle_by_host: List[Tuple[str, float]]
    launch_found: int                     # attributed through the runtime call
    link_found: int                       # through the linked CPU op
    unlinked: int

    def select(self, under: str, phase: Optional[str] = None,
               admit: str = "engine.admit",
               names: Optional[Sequence[str]] = None) -> Tuple[float, int]:
        """(device seconds, kernels) of paths inside span ``under``,
        in ``phase`` (``prefill``: inside ``admit``; ``decode``: not),
        and with ``names`` of those operations alone whose name holds one
        of them followed by ``<`` or ``(`` (a kernel's function name)."""
        s, n = 0.0, 0
        for (path, op), (t, k) in self.by_name.items():
            parts = path.split("/") if path else []
            if under not in parts:
                continue
            if phase is not None and (admit in parts) != (phase == "prefill"):
                continue
            if names is not None and not any(
                    f"{x}<" in op or f"{x}(" in op for x in names):
                continue
            s += t
            n += k
        return s, n


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def _is_device(e) -> bool:
    return str(e.device_type()).split(".")[-1] in ("CUDA", "GPU")


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or (name.startswith("cu") and len(name) > 2
                                       and name[2].isupper())


def profiler() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  profile_memory=False, with_stack=False)


def summarize(events) -> DeviceSummary:
    """Read a list of the profiler's kineto events
    (``prof.profiler.kineto_results.events()``)."""
    ranges, launches, cpu_ops, dev = [], {}, {}, []
    t_lo, t_hi = None, None
    for e in events:
        st = _ns(e, "start")
        en = st + (int(e.duration_ns()) if hasattr(e, "duration_ns")
                   else int(e.duration_us() * 1000))
        t_lo = st if t_lo is None else min(t_lo, st)
        t_hi = en if t_hi is None else max(t_hi, en)
        name = e.name()
        if name.startswith(RANGE_PREFIX):
            # the device timeline's copy of a range is no device operation
            if not _is_device(e):
                ranges.append((st, en, name[len(RANGE_PREFIX):]))
                cpu_ops[e.correlation_id()] = st
        elif _is_device(e):
            dev.append((st, en, name, e.correlation_id(),
                        e.linked_correlation_id()))
        elif _is_runtime(name):
            launches[e.correlation_id()] = st
        else:
            cpu_ops[e.correlation_id()] = st
    if t_lo is None:
        t_lo = t_hi = 0

    # host time of each device operation's launch
    found = linked = 0
    timed = []
    for st, en, name, corr, link in dev:
        h = launches.get(corr)
        if h is not None:
            found += 1
        elif link and link in cpu_ops:
            h = cpu_ops[link]
            linked += 1
        timed.append((h, st, en, name))

    ranges.sort(key=lambda r: (r[0], -r[1]))
    spans = collections.Counter(r[2] for r in ranges)

    def paths_at(times: List[int]) -> List[str]:
        """Innermost span path at each time (``times`` ascending)."""
        out, stack, i = [], [], 0
        for t in times:
            while i < len(ranges) and ranges[i][0] <= t:
                r = ranges[i]
                while stack and stack[-1][1] <= r[0]:
                    stack.pop()
                parent = stack[-1][3] if stack else ""
                stack.append((r[0], r[1], r[2],
                              f"{parent}/{r[2]}" if parent else r[2]))
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out.append(stack[-1][3] if stack else "")
        return out

    device_s: Dict[str, float] = collections.defaultdict(float)
    nker: Dict[str, int] = collections.defaultdict(int)
    ops: Dict[Tuple[str, str], List] = collections.defaultdict(
        lambda: [0.0, 0])

    def is_kernel(name: str) -> bool:
        return not name.startswith(("Memcpy", "Memset"))

    def add(path: str, st: int, en: int, name: str) -> None:
        device_s[path] += (en - st) / 1e9
        nker[path] += is_kernel(name)
        o = ops[(path, name)]
        o[0] += (en - st) / 1e9
        o[1] += is_kernel(name)

    with_host = sorted((x for x in timed if x[0] is not None),
                       key=lambda x: x[0])
    for (h, st, en, name), path in zip(with_host,
                                       paths_at([x[0] for x in with_host])):
        add(path, st, en, name)
    for h, st, en, name in timed:
        if h is None:
            add("", st, en, name)

    # busy union and idle gaps
    by_name: Dict[str, float] = collections.defaultdict(float)
    merged: List[List[int]] = []
    for h, st, en, name in sorted(timed, key=lambda x: x[1]):
        by_name[name] += (en - st) / 1e9
        if merged and st <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], en)
        else:
            merged.append([st, en])
    busy = sum(b - a for a, b in merged) / 1e9
    gaps, prev = [], t_lo
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t_hi > prev:
        gaps.append((prev, t_hi))
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    idle: Dict[str, float] = collections.defaultdict(float)
    for (mid, length), path in zip(mids, paths_at([m for m, _ in mids])):
        idle[path or "(outside every span)"] += length / 1e9

    def top(d):
        return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]

    return DeviceSummary(
        window_s=(t_hi - t_lo) / 1e9, busy_s=busy, device_s=dict(device_s),
        kernels=dict(nker), by_name={k: tuple(v) for k, v in ops.items()},
        spans=dict(spans),
        top_ops=[[k[:160], v] for k, v in top(by_name)],
        idle_by_host=top(idle), launch_found=found, link_found=linked,
        unlinked=len(dev) - found - linked)


def read(prof: torch.profiler.profile) -> DeviceSummary:
    return summarize(prof.profiler.kineto_results.events())
