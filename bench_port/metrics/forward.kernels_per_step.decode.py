"""Device kernels launched inside ``PagedEngine.step`` but outside its
admission, per step of the profiled stretch."""


def read(run):
    d = run.device
    if d is None or not d.spans.get("engine.step"):
        return None
    _, kernels = d.select("engine.step", "decode")
    return kernels / d.spans["engine.step"] if kernels else None
