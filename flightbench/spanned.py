"""A window of the cell with the port's spans on, for the span readers.

A traced run profiles its slice after the window, in the process's one
torch.profiler session, on graphs that stamp nothing.  The span readers
(`metrics/solve.iter_wall_ms.py` and the others that import this module)
read another window instead: in a process of its own, where no profiler
has run, the port's spans (`utils/profiling.py` `spans`) are enabled
before the cell's driver is built, so that set-up's captures carry the
stamps; then the cell's driver sets up, the spans are reset, it runs a
window of SECONDS, and the spans are collected.  The first span reader of
a run starts that process and keeps its result on the cell's driver.  A program
without spans (an older commit) starts nothing, and its readers read None.

    python3 -m flightbench.spanned --workload <cell> --seed <n>

from the root of a checkout prints the result as one JSON line.  The
first reader logs a brief of it, with the spanned window's own rate beside
the run's window's (the solve cell's windows may each fall in one of two
modes, so the two rates say whether the spans describe the run's mode).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional

from flightbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the solve's window: about 110 batches; the flight's: one flight, since its windows run whole flights
SECONDS = 10.0
# each driver's work spans: the card's time outside them is its wait
WORK = {"solve": ("solve.setup", "solve.copy_in", "solve.block", "solve.copy_out", "solve.solution"),
        "flight": ("flight.step",)}


def has_spans() -> bool:
    """Whether the program records spans."""
    try:
        from learningagileflight_se3_torch.utils.profiling import spans  # noqa: F401
    except ImportError:
        return False
    return True


def measure(cell: harness.Cell, seed: int, seconds: float, device) -> dict:
    """The spans of one window of `cell` with the spans on from before its
    driver is built: {"driver", "collected" (`spans.collect()`), "counters"
    (the cell driver's, over the window), "elapsed"}."""
    import torch

    from learningagileflight_se3_torch.utils.profiling import spans

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spans.enable(device)
    try:
        drv = cell.driver().Driver(cell.cell, cell.config, cell.mix, seed, device)
        drv.setup()
        spans.reset()
        window = drv.window(seconds)
        got = spans.collect()
    finally:
        spans.disable()
    counters = {k: v for k, v in drv.counters.items() if isinstance(v, (int, float))}
    return {"driver": cell.cell["driver"], "collected": got, "counters": counters, "elapsed": window["elapsed"]}


def _run(drv) -> dict:
    """measure() of the cell and seed of `drv` in a process of its own."""
    cmd = [sys.executable, "-m", "flightbench.spanned", "--workload", drv.cell["name"], "--seed", str(drv.seed)]
    p = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True, timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"the spanned window of {drv.cell['name']} exited with code {p.returncode}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def window(drv) -> Optional[dict]:
    """measure()'s result for the run of `drv` with "summary", the port's
    `summarize` of it over its driver's work spans (None where it cannot
    be read), or None where the program records no spans.  Measured once a
    run, at the first call."""
    if not hasattr(drv, "spanned"):
        drv.spanned = _run(drv) if has_spans() else None
    r = drv.spanned
    if r is None:
        return None
    if "summary" not in r:
        from learningagileflight_se3_torch.utils.profiling import summarize

        r["summary"] = summarize(r["collected"], WORK[r["driver"]])
        harness.log(f"spanned window: {json.dumps(_brief(r, getattr(drv, 'counters', {})))}")
    return r


def rate(counters: dict) -> Optional[float]:
    """A window's end-to-end rate from its driver's counters: solves/s
    (solve) or lane-steps/s (flight); None before a window."""
    c = counters
    n = c.get("batches", 0) * c.get("B", 0) or c.get("flights", 0) * c.get("lanes", 0) * c.get("steps", 0)
    return n / c["window_s"] if c.get("window_s") else None


def _brief(r: dict, run_counters: dict) -> dict:
    s = r["summary"]
    got = r["collected"]
    brief = {"elapsed": r["elapsed"], "rate": rate(r["counters"]), "run_rate": rate(run_counters),
             "stamps": got["stamps"], "overflow": got["overflow"],
             "unpaired": got["unpaired"], "clock": got["clock"], "counters": got["counters"]}
    if s is not None:
        brief.update({k: s[k] for k in ("wall_ns", "work_ns", "wait_ns", "misfit", "waits", "spans")})
    return brief


def summary(drv) -> Optional[dict]:
    """The spanned window's summary, None where there is none to read."""
    r = window(drv)
    return None if r is None else r["summary"]


def per(drv, what: str) -> Optional[float]:
    """How many batches ("batches") or flight steps ("steps") the spanned window ran."""
    r = window(drv)
    if r is None:
        return None
    c = r["counters"]
    n = c.get("batches") if what == "batches" else c.get("flights", 0) * c.get("steps", 0)
    return float(n) if n else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="One window of a cell with the port's spans on.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the spanned window runs only on the card")
        return 3
    cell = harness.Cell(args.workload, harness.load_json(ROOT, "BENCHMARK.json"))
    print(json.dumps(measure(cell, args.seed, SECONDS, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
