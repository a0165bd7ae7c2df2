"""K1's share of its roofline in the traced slice: the least time a launch
could take at the batch and horizon (the larger of its operations at the
f32 peak and its bytes at the memory rate) over K1's mean device time a
launch, in %."""

from flightbench import yardstick


def read(drv, trace):
    ks = trace.kernels(yardstick.K1_KERNEL) if trace is not None else []
    if not ks:
        return None
    B, H = drv.counters["B"], drv.counters["H"]
    return yardstick.roofline_pct(yardstick.K1_FLOPS * B * H, yardstick.k1_bytes(B, H),
                                  trace.device_seconds(ks) / len(ks))
