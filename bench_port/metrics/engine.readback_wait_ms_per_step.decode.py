"""How long the host waits for the device in a decode step, after it has
enqueued everything: the program's span ``engine.step/decode.readback``
(the ``.cpu()`` of the sampled tokens) per call over the clean window,
ms/step. Near 0 means the host paces the step (the device is done before
the host asks); a gain on the host's side of the step raises it, since
the host then reaches the read-back sooner and waits for the device."""


def program(run):
    """The program's tracer totals over the clean window, which
    ``counters/program_tracer.py`` leaves on the recorder."""
    return getattr(run.rec, "program", None) or {}


def read(run):
    s = program(run).get("spans", {}).get(
        "engine.step/decode.readback")
    if not s or not s["calls"]:
        return None
    return s["total_ns"] / s["calls"] / 1e6
