"""The window's share of the card's f32 peak, in %: the operations the
batches needed, counted from the answers (each lane's DDP iterations times
K2's operations a step, the solve's line-search trips and first rollout
times K1's, over the horizon), over the window's seconds at 67 TFLOP/s.
Counted from the answers, not from launches, so it reads the same work
whatever implements it."""

from flightbench.yardstick import F32_FLOPS_PER_S


def read(drv, trace):
    c = drv.counters
    if not c.get("window_s"):
        return None
    return 100.0 * c["flops"] / (c["window_s"] * F32_FLOPS_PER_S)
