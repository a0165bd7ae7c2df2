"""Device kernels a flight step in the traced slice: a flight of
cell["trace"]["steps"] steps from the start (its first replan cold, the
next warm), on step graphs captured before the profiler opened."""


def read(drv, trace):
    n = drv.counters.get("slice_steps")
    ks = trace.kernels() if trace is not None else []
    return len(ks) / n if ks and n else None
