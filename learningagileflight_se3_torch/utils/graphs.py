"""Device-resident loops: CUDA-graph capture and capped while loops.

The JAX package runs its loops on the device: the t-solver's two
`lax.while_loop`s, the solver's DDP `while_loop` and the closed loop's
`lax.scan` with a `lax.cond` replan (on the card the port runs the
t-solver's as one kernel, sim/tsolver.py).  Here a capped while loop is
written once, as a pure iteration on a carry whose every update is gated
by `go` (so an iteration with `go` False leaves the carry bit for bit as
it was); its owner's eager loop reads the loop test on the host before
each iteration (the CPU, and the card while solver/watch.py's watchers
watch), and `while_blocks` drives it with no host read in one of two ways:

  * "blocks": every block of k gated iterations runs, with no test at all:
    the CPU's check of exactly what a chain captures;
  * "chain": inside an open capture, one CUDA-graph conditional IF node per
    block, whose predicate the graph computes from the carry just before
    it, so a block past the loop's exit is skipped on the device.  The body
    writes its results back into the carry's buffers, since whatever
    follows the node reads them whether or not the body ran.

PyTorch 2.11 has no binding for conditional nodes, so `if_node` makes them
through the CUDA runtime (utils/graph_if.cu, ops/build.py graph_library()):
the node goes into the graph that the current stream is capturing, and its
body is captured on a second stream of the same device, whose allocations
go to a private memory pool of their own.

`capture` captures a function into a graph after a warm-up on that second
stream.  The kernel wrappers count a launch when their Python code runs,
which a replay does not do: `Graph.replay` adds the launches the capture
saw outside conditional bodies, and each body adds its own to a device-side
ledger when it runs (`settle` moves the ledger to the wrappers' counters).
`host_reads` counts the loops' host reads of a device flag and the tick's
fetch.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch

from learningagileflight_se3_torch.utils.profiling import spans

host_reads = 0       # host reads of a device value by the loops (each waits for the card)
eager_on_card = False  # set by solver/watch.py's watchers while they watch

_ledgers = {}        # device -> int64 (6,) launches made in conditional bodies, not yet settled
_body_streams = {}   # device -> the stream that captures conditional bodies (and warms up)
_body_pools = {}     # device -> the memory pool of the bodies' allocations


def read(flag: torch.Tensor) -> bool:
    """bool(flag), counted in `host_reads`."""
    global host_reads
    host_reads += 1
    return bool(flag)


def fetch(t: torch.Tensor) -> torch.Tensor:
    """t on the host, counted in `host_reads`."""
    global host_reads
    host_reads += 1
    return t.cpu()


def drive(device) -> str:
    """The drive of a loop on `device` whose caller names none: "eager" on
    the CPU and while the watchers watch, "chain" inside an open capture,
    "graph" (the loop's own captured graph) otherwise."""
    if torch.device(device).type != "cuda" or eager_on_card:
        return "eager"
    return "chain" if torch.cuda.is_current_stream_capturing() else "graph"


def _wrappers():
    from learningagileflight_se3_torch.ops import ddp_glue, line_search, riccati_fused, riccati_unfused, rollout, tsolve

    return rollout, riccati_fused, riccati_unfused, tsolve, line_search, ddp_glue


def _counts():
    return [m.launches for m in _wrappers()]


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def _ledger(device) -> torch.Tensor:
    """The device's launch ledger, made before its first capture."""
    i = _index(device)
    if i not in _ledgers:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the launch ledger is made by utils/graphs.py capture(), before its capture")
        _ledgers[i] = torch.zeros(len(_wrappers()), dtype=torch.int64, device=torch.device("cuda", i))
    return _ledgers[i]


def _body_stream(device) -> torch.cuda.Stream:
    i = _index(device)
    if i not in _body_streams:
        _body_streams[i] = torch.cuda.Stream(device=torch.device("cuda", i))
        _body_pools[i] = torch.cuda.graph_pool_handle()
    return _body_streams[i]


def settle() -> None:
    """Add the launches that conditional bodies made on the card to the
    kernel wrappers' counters (one host read per device that has a ledger,
    outside any loop) and zero the ledgers."""
    for led in _ledgers.values():
        for m, n in zip(_wrappers(), led.tolist()):
            m.launches += n
        led.zero_()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: cudaError {rc}")


@contextlib.contextmanager
def if_node(pred: torch.Tensor):
    """Inside the block, the work queued on the current stream goes into the
    body of a conditional IF node, added to the graph that the current
    stream is capturing, which runs it when `pred` (a 0-dim bool on the
    card, read when the graph runs) is True.  The kernel wrappers' launches
    inside the body go to the device ledger."""
    from learningagileflight_se3_torch.ops import build

    lib = build.graph_library().lib
    outer = torch.cuda.current_stream(pred.device)
    body = _body_stream(pred.device)
    i = _index(pred.device)
    led = _ledger(pred.device)
    _check(lib.laf_if_begin(outer.cuda_stream, pred.data_ptr(), body.cuda_stream), "laf_if_begin")
    with torch.cuda.stream(body):
        torch._C._cuda_beginAllocateCurrentStreamToPool(i, _body_pools[i])
        n0 = _counts()
        try:
            yield
            for k, (m, a) in enumerate(zip(_wrappers(), n0)):
                if m.launches != a:
                    led[k].add_(m.launches - a)
        finally:
            for m, a in zip(_wrappers(), n0):
                m.launches = a  # a capture launches nothing
            torch._C._cuda_endAllocateToPool(i, _body_pools[i])
            _check(lib.laf_if_end(body.cuda_stream), "laf_if_end")


class Graph(NamedTuple):
    """A captured graph, what its function returned (static buffers: the
    next replay overwrites them) and the launches each wrapper made outside
    conditional bodies (added at each replay)."""

    graph: torch.cuda.CUDAGraph
    out: object
    launches: tuple

    def replay(self) -> None:
        self.graph.replay()
        for m, n in zip(_wrappers(), self.launches):
            m.launches += n


class Captures:
    """The captures of one owner (a solver, a flight, a tick): one memory
    pool, their count and seconds; `pool_bytes` what the pool holds."""

    def __init__(self):
        self.pool = None
        self.count = 0
        self.seconds = 0.0

    @torch.no_grad()
    def capture(self, fn, warmup=None) -> Graph:
        """fn() captured into a CUDA graph in this owner's pool, after the
        kernels' build and `warmup()` (default: fn()) run once on the card
        off the capturing stream.  A capture that fails raises."""
        from learningagileflight_se3_torch.ops import build

        t0 = time.perf_counter()
        build.library(), build.graph_library()  # nvcc at first use: not inside a capture
        device = torch.device("cuda", torch.cuda.current_device())
        _ledger(device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        side = _body_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            (warmup or fn)()
        torch.cuda.current_stream(device).wait_stream(side)
        n0 = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = fn()
            launches = tuple(b - a for a, b in zip(n0, _counts()))
        finally:
            for m, a in zip(_wrappers(), n0):
                m.launches = a  # a capture launches nothing
        self.count += 1
        self.seconds += time.perf_counter() - t0
        return Graph(graph, out, launches)

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in this owner's pool (0 before the
        first capture); the bodies' pool is shared and not included."""
        return 0 if self.pool is None else _pool_bytes([self.pool])


def body_pool_bytes() -> int:
    """Bytes the allocator holds in the conditional bodies' pools."""
    return _pool_bytes(_body_pools.values())


def _pool_bytes(pools) -> int:
    pools = {tuple(p) for p in pools}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def _block(carry, body, k: int, span: Optional[str]):
    """k gated iterations, each its own gate; a device span `span` around them."""
    with spans.device(span, carry[0].device) if span else contextlib.nullcontext():
        for _ in range(k):
            carry = body(carry)
    return carry


def while_blocks(carry, pred, body, k: int, n_blocks: int, drive: str, span: Optional[str] = None):
    """The capped loop `while pred(carry): carry = body(carry)`.

    carry: a tuple (or NamedTuple) of tensors; pred(carry) -> 0-dim bool on
    the carry's device, True while an iteration would change the carry (its
    cap included); body(carry) -> carry, one iteration with every update
    gated on the device by pred(carry), which the body computes itself (the
    solver's DDP iteration finds it inside a kernel it runs anyway).  k *
    n_blocks must reach the loop's cap.  drive:
    "blocks" or "chain" (see the module's docstring; "chain" only while a
    capture is open, and its carry must be tensors made before the chain:
    the bodies write into them, a field that shares another's buffer into a
    clone of its own).  span: the name of a device span (utils/profiling.py
    `spans`) around each block run, inside its conditional body under
    "chain".  Returns the final carry."""
    if drive == "blocks":
        for _ in range(n_blocks):
            carry = _block(carry, body, k, span)
        return carry
    if drive != "chain":
        raise ValueError(f"unknown drive: {drive!r}")
    # each field its own buffer: a body writes every one back
    seen, fields = set(), []
    for t in carry:
        fields.append(t.clone() if t.data_ptr() in seen else t)
        seen.add(t.data_ptr())
    carry = carry._make(fields) if hasattr(carry, "_make") else tuple(fields)
    for _ in range(n_blocks):
        with if_node(pred(carry)):
            out = _block(carry, body, k, span)
            for dst, src in zip(carry, out):
                if dst is not src:
                    dst.copy_(src)
    return carry
