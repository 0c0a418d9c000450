"""The KV pool's high-water mark: the most pages in use after any step
of the window (``PagedEngine.stats()``: ``pages_total`` less
``pages_free``) over the pool's pages, %. The pool is sized for the
worst case, so this is how much of what ``peak_mem_gib`` counts for it
the traffic wrote."""


def read(run):
    if run.pages_peak is None or not run.pages_total:
        return None
    return run.pages_peak / run.pages_total * 100
