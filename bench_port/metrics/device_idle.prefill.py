"""Share of the clean window (the window before the profiler starts,
with no wrap inside a step) in which no operation ran on the device,
%. Its busy seconds come from the profiled stretch
(``RunRecord.clean_busy_s``): the stretch's decode device time a step
times the clean window's steps, plus its admission device time a prompt
token times the clean window's prompt tokens. The stretch's own idle
share, which the profiler's host cost inflates, is the result's
``trace.stretch_idle_pct``."""


def read(run):
    busy = run.clean_busy_s()
    if busy is None or run.clean_s <= 0:
        return None
    return (1.0 - busy / run.clean_s) * 100
