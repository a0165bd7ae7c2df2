"""Device time of a replan, in ms: the `flight.replan` spans (the window
inputs, DNN2, the batched solve and the warm-start shift) over their
number, in a window of the cell with the port's spans on
(flightbench/spanned.py)."""

from flightbench import spanned


def read(drv, trace):
    s = spanned.summary(drv)
    n, ns = (s or {}).get("spans", {}).get("flight.replan", (0, 0))
    return 1e-6 * ns / n if n else None
