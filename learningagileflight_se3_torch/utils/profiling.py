"""Stage timing, device traces and spans.

Port of `learningagileflight_se3_tpu/utils/profiling.py`:

  * `StageTimer`: host wall-clock accounting of named pipeline stages
    (sample / solve / update / ...); `block` waits for the card's queued
    work so a stage's time includes it.
  * `device_trace`: a `torch.profiler` trace of a region (the CPU, and the
    card where there is one), written as a Chrome trace under `log_dir`.

and the port's own:

  * `spans` (a `Spans`): named spans of the hot paths on one clock, the
    host's `time.perf_counter_ns()`.  Device spans are pairs of stamps that
    the card writes from inside the work, CUDA graphs and their conditional
    bodies included, where the host sees nothing; host spans time the host
    calls that feed the graphs; counters are tensors the work adds to on
    the device.  `summarize` puts the card's time outside a set of work
    spans (its waits) down to the host span each wait fell in.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Sequence

import torch


def _sync(value):
    """torch.cuda.synchronize() for each CUDA device holding a tensor of
    `value` (a tensor, or a tuple / list / dict / NamedTuple of them)."""
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(value)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulates wall time per named stage across repeated entries.

    >>> timer = StageTimer()
    >>> with timer("solve", block=sol):   # block: tensors to wait for on exit
    ...     sol = solve(...)
    >>> timer.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._order: List[str] = []

    @contextlib.contextmanager
    def __call__(self, stage: str, block=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if block is not None:
                _sync(block)
            dt = time.perf_counter() - t0
            if stage not in self.totals:
                self.totals[stage] = 0.0
                self.counts[stage] = 0
                self._order.append(stage)
            self.totals[stage] += dt
            self.counts[stage] += 1

    def block(self, value):
        """Wait for the card's work on `value` inside a stage; returns the value."""
        _sync(value)
        return value

    def report(self, log_fn=print) -> Dict[str, float]:
        total = sum(self.totals.values()) or 1.0
        for s in self._order:
            n = self.counts[s]
            t = self.totals[s]
            log_fn(
                f"[profile] {s:<20s} {t:8.3f}s  ({100.0 * t / total:5.1f}%)"
                f"  x{n}  {t / n * 1e3:8.2f} ms/call"
            )
        return dict(self.totals)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block (CPU activity, and CUDA where a
    card is present) written as `trace.json` (Chrome trace format) under
    log_dir.  No-op when log_dir is None, so call sites can pass a CLI flag
    straight through."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_OFF = contextlib.nullcontext()
# `summarize` reads no window whose clock map errs by more than this
MAX_ERR_NS = 50_000
# ... nor one whose work spans plus waits miss its wall by more than this share of it
MAX_MISFIT = 0.01


class Spans:
    """Spans and counters of the port's hot paths, on the host's clock.

    Off by default: a call site costs one attribute test, and work captured
    into a CUDA graph while spans are off holds no stamp (the graphs that
    stamp are captured apart: their owners key their graphs by `on`).

    >>> spans.enable("cuda")        # before the captures that should stamp
    >>> spans.reset()               # a window starts
    >>> with spans.host("launch"):  # a host span
    ...     with spans.device("work", "cuda"):  # a device span: two stamps
    ...         ...
    >>> got = spans.collect()       # the window ends

    A stamp on a CUDA device is a one-thread kernel (utils/graph_if.cu
    `laf_stamp`) launched on the current stream: eagerly it stamps at once,
    while the stream captures it becomes a node of the graph or of the
    conditional body being captured, and each replay of that graph stamps.
    It writes (id, the card's %globaltimer in ns) into the next slot of a
    ring of `CAP` slots made once per device before any capture (the graphs
    hold its address, so `reset` zeroes its head in place).  On the CPU a
    stamp takes `perf_counter_ns()` when it is queued, which is when it
    runs.  `enable`, `reset` and `collect` calibrate the card's clock against
    the host's (`CAL_TRIPS` round trips of host time, an eager stamp and a
    synchronize; the shortest trip's midpoint, its half-length the error),
    and the calibrations at `reset` and `collect` map the window's stamps
    onto the host clock linearly.  While a torch.profiler session is open,
    each host span is also a `record_function` of its name."""

    CAP = 1 << 18  # stamps a window can hold
    CAL_TRIPS = 16

    def __init__(self):
        self.on = False
        self._names: List[str] = []  # stamp id // 2 -> name; an id is odd at a span's end
        self._ids: Dict[str, int] = {}
        # CUDA index -> (ring (cap, 2) int64, its head (1,) int64, the calibration's ring and head)
        self._rings: Dict[int, tuple] = {}
        self._device = torch.device("cpu")
        self._cpu: List[tuple] = []        # (id, ns) of the stamps of CPU work
        self._host: List[tuple] = []       # (name, start ns, end ns)
        self._counters: Dict[tuple, torch.Tensor] = {}  # (name, device) -> int32 (2,)
        self._cal0 = (0, 0, 0)             # (card ns, host ns, error ns) at reset
        self._t0 = 0

    # ------------------------------------------------------------ state
    def enable(self, device) -> None:
        """Spans on, recorded for work on `device` (a CUDA device's rings
        are made here, and the stamp's library built: call it outside any
        capture); then `reset`."""
        device = torch.device(device)
        if device.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("spans.enable inside a capture: the rings are made before any capture")
            from learningagileflight_se3_torch.ops import build

            build.graph_library()  # nvcc at first use
            i = _index(device)
            device = torch.device("cuda", i)
            if i not in self._rings:
                i64 = dict(dtype=torch.int64, device=device)
                self._rings[i] = (torch.zeros((self.CAP, 2), **i64), torch.zeros(1, **i64),
                                  torch.zeros((self.CAL_TRIPS, 2), **i64), torch.zeros(1, **i64))
        self._device = device
        self.on = True
        self.reset()

    def disable(self) -> None:
        """Spans off (the rings stay: captured graphs hold their address)."""
        self.on = False

    def reset(self) -> None:
        """Forget every stamp, host span and count, calibrate, and start a window."""
        for ring in self._rings.values():
            ring[1].zero_()
        for c in self._counters.values():
            c.zero_()
        self._cpu.clear()
        self._host.clear()
        self._cal0 = self._calibrate()
        self._t0 = time.perf_counter_ns()

    def counter(self, name: str, device) -> torch.Tensor:
        """The int32 (2,) tensor on `device` registered as counter `name`
        (made at the first call, outside any capture; zeroed by `reset`)."""
        key = (name, torch.device(device))
        if key not in self._counters:
            if key[1].type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"counter {name!r} is made before the capture that adds to it")
            self._counters[key] = torch.zeros(2, dtype=torch.int32, device=key[1])
        return self._counters[key]

    # ------------------------------------------------------------ spans
    def device(self, name: str, device):
        """A device span of `name` around the block's work on `device`
        (a context manager; nothing while spans are off)."""
        return self._device_span(name, torch.device(device)) if self.on else _OFF

    def host(self, name: str):
        """A host span of `name` around the block (a context manager;
        nothing while spans are off)."""
        return self._host_span(name) if self.on else _OFF

    @contextlib.contextmanager
    def _device_span(self, name, device):
        self._stamp(name, False, device)
        yield
        self._stamp(name, True, device)

    @contextlib.contextmanager
    def _host_span(self, name):
        rf = torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else _OFF
        t0 = time.perf_counter_ns()
        with rf:
            yield
        self._host.append((name, t0, time.perf_counter_ns()))

    def _stamp(self, name: str, end: bool, device) -> None:
        """One stamp of `name`, a span's start or end, on `device`'s current stream."""
        if name not in self._ids:
            self._ids[name] = len(self._names)
            self._names.append(name)
        sid = 2 * self._ids[name] + int(end)
        device = torch.device(device)
        if device.type != "cuda":
            self._cpu.append((sid, time.perf_counter_ns()))
            return
        ring = self._rings.get(_index(device))
        if ring is None:
            raise RuntimeError(f"spans are not enabled on {device}")
        self._launch(ring[0], ring[1], self.CAP, sid, device)

    @staticmethod
    def _launch(buf, head, cap, sid, device):
        from learningagileflight_se3_torch.ops import build

        rc = build.graph_library().lib.laf_stamp(buf.data_ptr(), head.data_ptr(), cap, sid,
                                                 torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"laf_stamp: cudaError {rc}")

    # ------------------------------------------------------------ clock
    def _calibrate(self) -> tuple:
        """(card ns, host ns, error ns): the card's clock at the midpoint of
        the shortest of CAL_TRIPS round trips (the host's clock at their
        ends around an eager stamp and a synchronize), and half that trip."""
        if self._device.type != "cuda":
            t = time.perf_counter_ns()
            return t, t, 0
        _, _, buf, head = self._rings[self._device.index]
        torch.cuda.synchronize(self._device)
        head.zero_()
        trips = []
        for _ in range(self.CAL_TRIPS):
            h0 = time.perf_counter_ns()
            self._launch(buf, head, self.CAL_TRIPS, 0, self._device)
            torch.cuda.synchronize(self._device)
            trips.append((h0, time.perf_counter_ns()))
        card = buf[:, 1].tolist()
        k = min(range(self.CAL_TRIPS), key=lambda j: trips[j][1] - trips[j][0])
        h0, h1 = trips[k]
        return card[k], (h0 + h1) // 2, (h1 - h0 + 1) // 2

    def collect(self) -> dict:
        """The window since `reset`, on the host's clock (ns):

          * "window": (start, end), the host's clock at `reset` and here;
          * "device": [(name, start, end)] the paired device spans, by start;
          * "host": [(name, start, end)] the host spans, by start;
          * "counters": {name: [two ints]} summed over devices;
          * "clock": {"err_ns", "drift_ppm"} of the card's clock mapped onto
            the host's (0, 0 on the CPU);
          * "overflow": whether the stamps overran the ring (the device
            spans are then incomplete); "stamps": how many were written;
            "unpaired": stamps left without their pair."""
        t1 = time.perf_counter_ns()
        cal1 = self._calibrate()
        if self._device.type == "cuda":
            ring, head = self._rings[self._device.index][:2]
            n = int(head.item())
            rows = [tuple(r) for r in ring[:min(n, self.CAP)].tolist()]
        else:
            n, rows = len(self._cpu), self._cpu[:self.CAP]
        to_host, clock = clock_map(self._cal0, cal1)
        device, unpaired = pair([(sid, to_host(g)) for sid, g in rows], self._names)
        counters: Dict[str, list] = {}
        for (name, _), c in self._counters.items():
            counters[name] = [a + b for a, b in zip(counters.get(name, [0, 0]), c.tolist())]
        return {"window": (self._t0, t1), "device": device,
                "host": sorted(self._host, key=lambda s: s[1]), "counters": counters,
                "clock": clock,
                "overflow": n > self.CAP, "stamps": n, "unpaired": unpaired}


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def clock_map(cal0: tuple, cal1: tuple):
    """(card ns -> host ns, {"err_ns", "drift_ppm"}): the line through two
    calibrations (card ns, host ns, error ns); its error the larger of
    theirs, its drift how far the card's clock ran fast of the host's, in
    parts per million."""
    (g0, h0, e0), (g1, h1, e1) = cal0, cal1
    slope = (h1 - h0) / (g1 - g0) if g1 != g0 else 1.0
    return (lambda g: h0 + round((g - g0) * slope)), {"err_ns": max(e0, e1), "drift_ppm": (1.0 / slope - 1.0) * 1e6}


def pair(stamps: Sequence[tuple], names: Sequence[str]):
    """([(name, start, end)] by start, stamps left unpaired) from stamps
    (id, ns) in the order they were written: an even id opens a span of
    name names[id // 2], the next odd id of that name closes the latest
    one open (spans of one name nest)."""
    open_, spans_, unpaired = {}, [], 0
    for sid, ns in stamps:
        name = names[sid // 2]
        if sid % 2 == 0:
            open_.setdefault(name, []).append(ns)
        elif open_.get(name):
            spans_.append((name, open_[name].pop(), ns))
        else:
            unpaired += 1
    unpaired += sum(len(v) for v in open_.values())
    return sorted(spans_, key=lambda s: (s[1], -s[2])), unpaired


def summarize(got: dict, work: Sequence[str]):
    """The window of `got` (a `Spans.collect()`) split into the card's work
    and its waits, or None where it cannot be read: the ring overflowed,
    the clock's error is over `MAX_ERR_NS`, or the work spans plus the waits
    miss the window's wall by more than `MAX_MISFIT` of it (work spans
    that overlap, or stamps mapped off the window).

    Work spans are the device spans named in `work`, clipped to the
    window; the waits are the window's time that no work span covers.
    Each wait is put down to the innermost host span that covers its
    midpoint, or to "caller" where none does.  Returns {"wall_ns",
    "work_ns", "wait_ns", "misfit", "waits": {host span: ns}, "spans":
    {device span name: [count, ns]} (every device span inside the window),
    "counters", "clock"}."""
    if got["overflow"] or got["clock"]["err_ns"] > MAX_ERR_NS:
        return None
    t0, t1 = got["window"]
    wall = t1 - t0
    if wall <= 0:
        return None
    clip = [(max(s, t0), min(e, t1)) for name, s, e in got["device"] if name in work and e > t0 and s < t1]
    work_ns = sum(e - s for s, e in clip)
    gaps, t = [], t0
    for s, e in sorted(clip):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < t1:
        gaps.append((t, t1))
    wait_ns = sum(e - s for s, e in gaps)
    misfit = abs(work_ns + wait_ns - wall) / wall
    if misfit > MAX_MISFIT:
        return None
    waits: Dict[str, int] = {}
    host = got["host"]
    for s, e in gaps:
        mid = (s + e) // 2
        cover = [h for h in host if h[1] <= mid < h[2]]
        name = min(cover, key=lambda h: h[2] - h[1])[0] if cover else "caller"
        waits[name] = waits.get(name, 0) + (e - s)
    spans_: Dict[str, list] = {}
    for name, s, e in got["device"]:
        if s >= t0 and e <= t1:
            c = spans_.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += e - s
    return {"wall_ns": wall, "work_ns": work_ns, "wait_ns": wait_ns, "misfit": misfit, "waits": waits,
            "spans": spans_, "counters": dict(got["counters"]), "clock": dict(got["clock"])}


spans = Spans()
