"""Share of the window's wall before the profiler's start that the host
spent inside ``PagedEngine._admit`` (span ``engine.admit``), %."""


def read(run):
    if run.rec is None or "engine.admit" not in run.rec.installed:
        return None
    return run.rec.host_ns["engine.admit"] / 1e9 / run.clean_s * 100
