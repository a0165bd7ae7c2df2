"""Device time of the solve's blocks a DDP iteration, in ms: the
`solve.block` spans (each a block of the solver's GRAPH_BLOCK gated
iterations: K2, K1's line-search trips, the glue and the graph's own
scheduling) over the iterations they ran, in a window of the cell with
the port's spans on (flightbench/spanned.py)."""

from flightbench import spanned


def read(drv, trace):
    s = spanned.summary(drv)
    n, ns = (s or {}).get("spans", {}).get("solve.block", (0, 0))
    if not n:
        return None
    from learningagileflight_se3_torch.solver.ilqr_batched import GRAPH_BLOCK

    return 1e-6 * ns / (n * GRAPH_BLOCK)
