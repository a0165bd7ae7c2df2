"""One torch.profiler session a process, reduced to what the metrics read.

The session traces CPU and CUDA activity over a slice of a run.  Its
result keeps the device operations (name, start, end in ns), the host's
operations for naming idle gaps, and the arithmetic over them: the union
of device intervals (busy), the traced span, the device operations that
took most time, and the longest idle gaps by what the host was doing.
Only one session runs in a process: on the port's conditional CUDA graphs
a second session in the same process has crashed in `replay`.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple


class Op(NamedTuple):
    name: str
    start: int  # ns
    end: int    # ns
    kind: str   # the profiler's activity type where torch gives one ("kernel", "gpu_memcpy", ...), else ""


def union_ns(intervals: List[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals: List[Tuple[int, int]], span: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The idle gaps (start, end) of the span that no interval covers."""
    out, t = [], span[0]
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, span[1])))
        t = max(t, e)
    if t < span[1]:
        out.append((t, span[1]))
    return [g for g in out if g[1] > g[0]]


class Trace:
    """A reduced trace: `device` and `host` ops, the traced `span` (ns)."""

    def __init__(self, device: List[Op], host: List[Op], span: Tuple[int, int]):
        self.device, self.host, self.span = device, host, span

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return union_ns([(o.start, o.end) for o in self.device]) * 1e-9

    def idle_share(self) -> Optional[float]:
        """1 - busy / span, in %, or None where the device ran nothing."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self, match: Optional[str] = None) -> List[Op]:
        """Device kernels (not copies or sets), those whose name holds `match` if given."""
        copy = lambda o: any(w in (o.kind + " " + o.name).lower() for w in ("memcpy", "memset"))  # noqa: E731
        ks = [o for o in self.device if not copy(o)]
        return ks if match is None else [o for o in ks if match in o.name]

    def device_seconds(self, ops: List[Op]) -> float:
        return sum(o.end - o.start for o in ops) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the n device operations that took most time, summed by name."""
        by = {}
        for o in self.device:
            by[o.name] = by.get(o.name, 0) + (o.end - o.start)
        return [[k[:120], v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]] of the n longest idle gaps:
        the innermost host operation that covers the gap's middle."""
        gaps = gaps_ns([(o.start, o.end) for o in self.device], self.span)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        host = sorted(self.host, key=lambda o: o.start)
        out = []
        for s, e in gaps:
            mid = (s + e) // 2
            cover = [o for o in host if o.start <= mid < o.end]
            name = min(cover, key=lambda o: o.end - o.start).name if cover else "host: outside any traced op"
            out.append([name[:120], (e - s) * 1e-9])
        return out


def _ns(ev, what: str) -> int:
    """An event's `what` ("start", "end") in ns, from whichever accessor
    this torch's events have."""
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


@contextlib.contextmanager
def session(box: list):
    """Profile the block; append its `Trace` to `box` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])) as prof:
        yield
        sync()
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + int(ev.duration_ns()) if hasattr(ev, "duration_ns") else _ns(ev, "end")
        kind = str(ev.activity_type()) if hasattr(ev, "activity_type") else ""  # torch 2.11's events have none
        op = Op(ev.name(), start, end, kind)
        (device if "CUDA" in str(ev.device_type()) else host).append(op)
    every = device + host
    span = (min(o.start for o in every), max(o.end for o in every)) if every else (0, 0)
    box.append(Trace(device, host, span))
