"""The decode step's host work around its forward: the program's spans
``engine.step/decode.prepare`` (pages, the block table, position and
token copies, the sampling rows) and ``engine.step/decode.commit`` (each
slot's token appended, ``on_token``, retirement), their host time per
decode step over the clean window, ms/step.

``on_token`` is the engine's caller's callback, here the harness's
``run_window.on_token``, which timestamps and records every token: its
time is part of ``decode.commit``, so a change to the harness's
collection moves this metric too."""


def program(run):
    """The program's tracer totals over the clean window, which
    ``counters/program_tracer.py`` leaves on the recorder."""
    return getattr(run.rec, "program", None) or {}


def read(run):
    spans = program(run).get("spans", {})
    prep = spans.get("engine.step/decode.prepare")
    commit = spans.get("engine.step/decode.commit")
    if not prep or not prep["calls"] or not commit:
        return None
    return (prep["total_ns"] + commit["total_ns"]) / prep["calls"] / 1e6
