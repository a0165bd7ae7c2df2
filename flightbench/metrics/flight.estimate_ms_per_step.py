"""Device time of the gate's observation and the Kalman filter's predict
and update a flight step, in ms: the `flight.estimate` spans over the
steps of a window of the cell with the port's spans on
(flightbench/spanned.py).  None where the program records no such span."""

from flightbench import spanned


def read(drv, trace):
    s, n = spanned.summary(drv), spanned.per(drv, "steps")
    if s is None or not n or "flight.estimate" not in s["spans"]:
        return None
    return 1e-6 * s["spans"]["flight.estimate"][1] / n
