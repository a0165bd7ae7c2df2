"""The general runner of a cell.

A run is a new process:
  1. the card is required (no CPU fallback) and TF32 is turned off and
     checked;
  2. the cell's driver (`drivers/<driver>.py`, named by `cells/<cell>.json`)
     builds the port's entry, makes the inputs from `--seed` and warms up
     the cell's own shapes: `setup_s` runs from the process's start to here;
  3. the driver measures for `--seconds` (the window), and with `--trace 1`
     profiles its fixed slice after the window, in the process's one
     profiler session;
  4. the device's peak memory is read, the port's state is freed and the
     plain reference (`reference/`) judges what the window produced;
  5. the numbers compared are printed beside their limits as the last lines
     of standard error, and the result as the last line of standard output.

With `--trace 0` the metrics are the cell's `end_to_end` metrics of
BENCHMARK.json, with `--trace 1` its `per_layer` metrics, each read by its
own reader `metrics/<metric>.py`; a reader that finds nothing returns None
and the metric is left out.  A run that finds JAX or the JAX package loaded
once the window has closed prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "learningagileflight_se3_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A cell with everything the files name: its BENCHMARK.json entry, its
    cell file, its configuration and its traffic mix."""

    def __init__(self, name: str, bench: dict):
        from flightbench import traffic

        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entries[name]
        self.cell = load_json(HERE, "cells", f"{name}.json")
        self.config = load_json(HERE, "configs", f"{self.entry['config']}.json")
        self.mix = traffic.load(self.entry["traffic"])
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]

    def driver(self):
        return importlib.import_module(f"flightbench.drivers.{self.cell['driver']}")


def reader(metric: str):
    """The reader `metrics/<metric>.py` of a per-layer metric."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"flightbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(numbers: list) -> bool:
    """Every number compared is finite and at most its limit."""
    return all(math.isfinite(n["value"]) and n["value"] <= n["limit"] for n in numbers)


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             require_card: bool = True) -> dict:
    """One run of `cell` on `device`: the result's fields and the numbers
    compared.  Raises where the card the cell asks for is missing (unless
    `require_card` is False: the tests' drive of the rest of a run)."""
    import torch

    device = torch.device(device)
    chips = cell.entry["chips"]
    if require_card and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise RuntimeError(f"cell {cell.name} needs {chips} CUDA device(s); "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is still on")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    split = {"interpreter_and_imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    torch.zeros(1, device=device)
    sync()
    split["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    drv = cell.driver().Driver(cell.cell, cell.config, cell.mix, seed, device)
    split["entry_build_s"] = time.perf_counter() - t
    drv.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    split.update(drv.counters.get("setup_split", {}))
    log(f"{cell.name}: set-up {setup_s:.3f} s: {json.dumps(split)}")

    window = drv.window(seconds)
    log(f"{cell.name}: window {window['elapsed']:.3f} s, {window['attempted']} attempted")
    traced = None
    if trace:
        traced = drv.traced()
    mem = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded once the window closed: {', '.join(found)}")

    values = {"setup_s": setup_s, **window["metrics"]}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(drv, traced)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        missing = [m["name"] for m in cell.end_to_end if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the driver reports no {missing}")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}

    t = time.perf_counter()
    numbers = drv.check()
    log(f"{cell.name}: the reference's check {time.perf_counter() - t:.3f} s")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded once the window closed: {', '.join(found)}")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": chips, "memory_peak_bytes": int(mem)}
    result = {"correct": judge(numbers), "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
        result["breakdown"] = {"device_ops": traced.top_ops(), "idle_gaps": traced.idle_gaps()}
    result["setup_split"] = split
    result["checks"] = {n["name"]: {"value": n["value"], "limit": n["limit"]} for n in numbers}
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = Cell(args.workload, bench)
    try:
        import torch

        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark runs only on the card")
            return 3
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    except RuntimeError:
        log(f"{cell.name}: no result\n{traceback.format_exc()}")
        return 4
    for name, n in result["checks"].items():
        log(f"check {name}: {n['value']!r} (limit {n['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
