"""Host reads of a device value that the port's loops make a batch over
the window (`utils/graphs.py` `host_reads`; the harness's own fetch of
each answer is not one of them)."""


def read(drv, trace):
    c = drv.counters
    return c["host_reads"] / c["batches"] if c.get("batches") else None
