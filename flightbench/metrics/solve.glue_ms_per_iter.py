"""Device time of every kernel but K1 and K2 in the traced slice, over the
DDP iterations run there (one K2 launch an iteration), in ms."""

from flightbench.yardstick import K1_KERNEL, K2_KERNEL


def read(drv, trace):
    n = drv.counters.get("slice_K2")
    if trace is None or not n:
        return None
    glue = [k for k in trace.kernels() if K1_KERNEL not in k.name and K2_KERNEL not in k.name]
    return 1e3 * trace.device_seconds(glue) / n
