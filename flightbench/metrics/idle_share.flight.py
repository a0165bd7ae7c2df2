"""The device's idle share of the flight's traced slice, in %: 1 - the
union of its operations' intervals over the traced span.  The slice is a
flight of cell["trace"]["steps"] steps from the start."""


def read(drv, trace):
    return None if trace is None else trace.idle_share()
