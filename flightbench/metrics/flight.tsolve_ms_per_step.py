"""Device time of the traversal-time fixed point a flight step, in ms: the
`flight.tsolve` spans (the guess, the seed evaluation and the conditional
blocks of DNN2 evaluations) over the steps of a window of the cell with
the port's spans on (flightbench/spanned.py)."""

from flightbench import spanned


def read(drv, trace):
    s, n = spanned.summary(drv), spanned.per(drv, "steps")
    if s is None or not n or "flight.tsolve" not in s["spans"]:
        return None
    return 1e-6 * s["spans"]["flight.tsolve"][1] / n
