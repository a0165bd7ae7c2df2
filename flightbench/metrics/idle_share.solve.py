"""The device's idle share of the solve's traced slice, in %: 1 - the union
of its operations' intervals over the traced span."""


def read(drv, trace):
    return None if trace is None else trace.idle_share()
