"""Host time a decode step takes to enqueue its forward: the program's
span ``engine.step/decode.forward`` (``PagedEngine.step``'s call of
``paged_decode_step``) per call over the clean window, ms/step. The
forward launches its kernels eagerly, so this is what launching the
decode forward costs the host, and what a CUDA graph of the step
cuts."""


def program(run):
    """The program's tracer totals over the clean window, which
    ``counters/program_tracer.py`` leaves on the recorder."""
    return getattr(run.rec, "program", None) or {}


def read(run):
    s = program(run).get("spans", {}).get(
        "engine.step/decode.forward")
    if not s or not s["calls"]:
        return None
    return s["total_ns"] / s["calls"] / 1e6
