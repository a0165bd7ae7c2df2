"""The card's wait a flight step, in ms: the time of a window of the cell
with the port's spans on (flightbench/spanned.py) that no `flight.step`
span covers, over its steps; a flight's start and end, and the caller's
fetch of its log, included."""

from flightbench import spanned


def read(drv, trace):
    s, n = spanned.summary(drv), spanned.per(drv, "steps")
    return None if s is None or not n else 1e-6 * s["wait_ns"] / n
