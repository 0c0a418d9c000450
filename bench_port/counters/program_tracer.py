"""The program's own span tracer (``utils/profiling.py tracer``) over a
traced run's clean window, switched through the wrap of
``PagedEngine.stats``, which the window calls once before its first
step and once after each step (the pool's pages in use).

At a call before the window: the tracer reset and on. At each call
inside the clean window (``rec.in_window``): its totals so far copied to
``rec.program``. At the first call after it, in the profiler's stretch:
the tracer off, so its spans cost the stretch nothing. ``rec.program``
thus holds the clean window's totals to its last step (a window that
closes before its stretch leaves the tracer on, and ``rec.program`` the
whole window's). A program without the tracer leaves ``rec.program`` unset, and the metrics that
read it find nothing to read."""

try:
    from quantizations_tpu_torch.utils.profiling import tracer
except ImportError:
    tracer = None


def count(rec, call):
    if tracer is None or getattr(rec, "program_done", False):
        return
    if rec.in_window:
        rec.program = tracer.snapshot()
    elif getattr(rec, "program", None) is None:
        tracer.reset()
        tracer.enable()
    else:
        tracer.disable()
        rec.program_done = True
