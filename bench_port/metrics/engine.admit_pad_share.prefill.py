"""Share of the admission rows computed that carry no prompt token, over
the clean window, %: ``1 - prefill.tokens / prefill.rows``, the
program's counters of every prefill round dispatched (rows x bucket
length, and the prompt tokens of the rows that have a chunk). Bucket
padding and the garbage rounds of a group's unused or finished rows make
up the rest."""


def program(run):
    """The program's tracer totals over the clean window, which
    ``counters/program_tracer.py`` leaves on the recorder."""
    return getattr(run.rec, "program", None) or {}


def read(run):
    c = program(run).get("counters", {})
    rows = c.get("prefill.rows")
    if not rows:
        return None
    return (1 - c.get("prefill.tokens", 0) / rows) * 100
