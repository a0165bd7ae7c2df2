"""The card's wait a batch, in ms: the time of a window of the cell with
the port's spans on (flightbench/spanned.py) that no work span of the
solve covers (its set-up, copies in and out, blocks and solution), over
its batches; the caller's fetch of each answer included."""

from flightbench import spanned


def read(drv, trace):
    s, n = spanned.summary(drv), spanned.per(drv, "batches")
    return None if s is None or not n else 1e-6 * s["wait_ns"] / n
