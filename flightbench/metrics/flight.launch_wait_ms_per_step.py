"""The part of the card's wait a flight step (`flight.host_wait_ms_per_step`)
put down to the host's `flight.launch`, the replay of a step's graph, in
ms: waits whose middle falls in that host span."""

from flightbench import spanned


def read(drv, trace):
    s, n = spanned.summary(drv), spanned.per(drv, "steps")
    return None if s is None or not n else 1e-6 * s["waits"].get("flight.launch", 0) / n
