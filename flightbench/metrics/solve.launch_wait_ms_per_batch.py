"""The part of the card's wait a batch (`solve.host_wait_ms_per_batch`)
put down to the host's `solve.launch`, the replay of a block's graph, in
ms: waits whose middle falls in that host span."""

from flightbench import spanned


def read(drv, trace):
    s, n = spanned.summary(drv), spanned.per(drv, "batches")
    return None if s is None or not n else 1e-6 * s["waits"].get("solve.launch", 0) / n
