"""Device time of the solve's set-up a batch, in ms: the `solve.setup`
spans (the inputs in the kernels' layout, quantize_t, the per-problem
constants and the first rollout), which `solve.glue_ms_per_iter` folds
into the iterations, over the batches of a window of the cell with the
port's spans on (flightbench/spanned.py)."""

from flightbench import spanned


def read(drv, trace):
    s, n = spanned.summary(drv), spanned.per(drv, "batches")
    if s is None or not n or "solve.setup" not in s["spans"]:
        return None
    return 1e-6 * s["spans"]["solve.setup"][1] / n
