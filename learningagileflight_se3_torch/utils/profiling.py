"""Stage timing and device traces.

Port of `learningagileflight_se3_tpu/utils/profiling.py`:

  * `StageTimer`: host wall-clock accounting of named pipeline stages
    (sample / solve / update / ...); `block` waits for the card's queued
    work so a stage's time includes it.
  * `device_trace`: a `torch.profiler` trace of a region (the CPU, and the
    card where there is one), written as a Chrome trace under `log_dir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

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
