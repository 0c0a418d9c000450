"""Admission wall (span ``engine.admit``, host clock) per 1,000 prompt
tokens admitted, both before the profiler's start, ms/ktok."""


def read(run):
    if run.rec is None or "engine.admit" not in run.rec.installed:
        return None
    ktok = run.prompt_tokens() / 1e3
    return run.rec.host_ns["engine.admit"] / 1e6 / ktok if ktok else None
