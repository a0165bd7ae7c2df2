"""K1 launches a replan over the window's flights, from the port's launch
counters with the conditional bodies' device ledger settled
(`utils/graphs.py` `settle`)."""


def read(drv, trace):
    c = drv.counters
    return c["K1"] / c["replans"] if c.get("replans") else None
