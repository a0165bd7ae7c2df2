"""The fixed point's iterations a flight step: the t-solver's counter
(`count[1]`, iterations with the loop's test true, counted on the card)
over the steps of a window of the cell with the port's spans on
(flightbench/spanned.py)."""

from flightbench import spanned


def read(drv, trace):
    s, n = spanned.summary(drv), spanned.per(drv, "steps")
    if s is None or not n or "flight.tsolve" not in s["counters"]:
        return None
    return s["counters"]["flight.tsolve"][1] / n
