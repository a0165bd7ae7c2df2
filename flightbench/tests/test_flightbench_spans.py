"""The span readers (`metrics/` files that read `flightbench/spanned.py`):
on synthetic spanned windows with known answers, on the cases a window
cannot be read (the ring overflowed, the clock's error over 50 us, work
spans and waits that miss the window's wall), on a program without spans
(they read None and start nothing), and on a spanned window of each cell
run at a size the CPU holds."""

from __future__ import annotations

import importlib.util
import os
import time
import types

import pytest
import torch

from flightbench import harness, spanned
from flightbench.tests.test_flightbench_faults import FLIGHT, SEED, SOLVE, tiny

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVE_READERS = ("solve.iter_wall_ms", "solve.setup_ms_per_batch", "solve.host_wait_ms_per_batch",
                 "solve.launch_wait_ms_per_batch")
FLIGHT_READERS = ("flight.tsolve_ms_per_step", "flight.tsolve_iters_per_step", "flight.replan_ms",
                  "flight.host_wait_ms_per_step", "flight.launch_wait_ms_per_step")
MS = 1_000_000  # ns


def reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  os.path.join(BENCH_DIR, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class FakeDriver:
    def __init__(self, spanned_=None):
        if spanned_ is not None:
            self.spanned = spanned_


def solve_window(overflow=False, err_ns=2_000, overlap=False):
    """Two batches in a 40 ms window: each a set-up of 1 ms, a copy in, two
    blocks of 8 ms, a copy out and a solution, the waits between them put
    down to the replays, the flag reads and the caller's fetch."""
    device, host = [], []
    for b in range(2):
        t = b * 20 * MS
        device += [("solve.setup", t, t + MS), ("solve.copy_in", t + MS, t + MS + 100_000),
                   ("solve.block", t + 2 * MS, t + 10 * MS), ("solve.block", t + 11 * MS, t + 19 * MS),
                   ("solve.copy_out", t + 19 * MS, t + 19 * MS + 100_000),
                   ("solve.solution", t + 19 * MS + 100_000, t + 19 * MS + 200_000)]
        host += [("solve.launch", t + MS, t + 2 * MS + MS // 2), ("solve.read", t + 10 * MS, t + 11 * MS + 1)]
    if overlap:
        device.append(("solve.block", 30 * MS, 35 * MS))
    got = {"window": (0, 40 * MS), "device": device, "host": host, "counters": {},
           "clock": {"err_ns": err_ns, "drift_ppm": 3.0}, "overflow": overflow, "stamps": 4 * len(device),
           "unpaired": 0}
    return {"driver": "solve", "collected": got, "counters": {"batches": 2}, "elapsed": 0.04}


def flight_window(**kw):
    """One flight of 20 steps of 1 ms in a 30 ms window: the fixed point 0.5
    ms a step, a replan of 0.3 ms every 10 steps, 1.5 iterations a step."""
    device, host = [], []
    for i in range(20):
        t = MS + i * 1_200_000
        device += [("flight.step", t, t + MS), ("flight.tsolve", t, t + MS // 2)]
        if i % 10 == 0:
            device.append(("flight.replan", t + MS // 2, t + 800_000))
        host.append(("flight.launch", t - 200_000, t + 100_000))
    host += [("flight.prepare", 0, MS - 100_000), ("flight.finish", 25 * MS, 26 * MS)]
    got = {"window": (0, 30 * MS), "device": device, "host": host, "counters": {"flight.tsolve": [9, 30]},
           "clock": {"err_ns": kw.get("err_ns", 2_000), "drift_ppm": -1.0}, "overflow": kw.get("overflow", False),
           "stamps": 2 * len(device), "unpaired": 0}
    return {"driver": "flight", "collected": got, "counters": {"flights": 1, "steps": 20}, "elapsed": 0.03}


def test_solve_readers_on_a_synthetic_window():
    drv = FakeDriver(solve_window())
    r = {name: reader(name)(drv, None) for name in SOLVE_READERS}
    assert r["solve.iter_wall_ms"] == pytest.approx(8.0 / 4)  # a block is 4 iterations
    assert r["solve.setup_ms_per_batch"] == pytest.approx(1.0)
    # waits a batch: [0.1 ms after the copy in, 1 ms] in a launch, [10, 11] ms in a read, [19.2, 20] ms the caller's
    assert r["solve.host_wait_ms_per_batch"] == pytest.approx(0.9 + 1.0 + 0.8)
    assert r["solve.launch_wait_ms_per_batch"] == pytest.approx(0.9)
    assert drv.spanned["summary"]["waits"] == {"solve.launch": 1_800_000, "solve.read": 2_000_000,
                                               "caller": 1_600_000}


def test_flight_readers_on_a_synthetic_window():
    drv = FakeDriver(flight_window())
    r = {name: reader(name)(drv, None) for name in FLIGHT_READERS}
    assert r["flight.tsolve_ms_per_step"] == pytest.approx(0.5)
    assert r["flight.tsolve_iters_per_step"] == pytest.approx(1.5)
    assert r["flight.replan_ms"] == pytest.approx(0.3)
    # the wait: 30 ms less 20 steps of 1 ms; the 0.2 ms gaps between steps each in a launch (19 of them)
    assert r["flight.host_wait_ms_per_step"] == pytest.approx(10.0 / 20)
    assert r["flight.launch_wait_ms_per_step"] == pytest.approx(19 * 0.2 / 20)


@pytest.mark.parametrize("case", ["overflow", "clock error over 50 us", "work and waits miss the wall"])
def test_readers_read_none_where_the_window_cannot_be_read(case):
    windows = {"overflow": (solve_window(overflow=True), flight_window(overflow=True)),
               "clock error over 50 us": (solve_window(err_ns=50_001), flight_window(err_ns=50_001)),
               "work and waits miss the wall": (solve_window(overlap=True), None)}[case]
    for names, w in zip((SOLVE_READERS, FLIGHT_READERS), windows):
        if w is not None:
            drv = FakeDriver(w)
            assert [reader(name)(drv, None) for name in names] == [None] * len(names), case


def test_a_program_without_spans_reads_none_and_starts_nothing(monkeypatch):
    monkeypatch.setattr(spanned, "has_spans", lambda: False)
    monkeypatch.setattr(spanned, "_run", lambda drv: pytest.fail("started a spanned window"))
    drv = FakeDriver()
    assert [reader(name)(drv, None) for name in SOLVE_READERS + FLIGHT_READERS] == [None] * 9


@pytest.mark.parametrize("name", [SOLVE, FLIGHT])
def test_a_spanned_window_at_a_cpu_size(name):
    """The spanned window of each cell at the fault tests' size on the CPU:
    its spans tile the window, a set-up a batch or a fixed point a step, the
    t-solver's counter read; the solve's blocks are the card's (the CPU's
    solve runs the eager loop), so that reader alone reads None."""
    cell = tiny(name)
    r = spanned.measure(cell, SEED, 0.0, "cpu")
    drv = FakeDriver(r)
    s = spanned.summary(drv)
    assert s is not None and s["misfit"] < 1e-9 and s["wait_ns"] > 0
    readers = SOLVE_READERS if name == SOLVE else FLIGHT_READERS
    values = {n: reader(n)(drv, None) for n in readers}
    if name == SOLVE:
        assert s["spans"]["solve.setup"][0] == r["counters"]["batches"] >= 1
        assert values.pop("solve.iter_wall_ms") is None
    else:
        steps = cell.mix["steps"] * r["counters"]["flights"]
        assert s["spans"]["flight.step"][0] == s["spans"]["flight.tsolve"][0] == steps
        assert values["flight.tsolve_iters_per_step"] >= 1
    assert all(v is not None and v >= 0 for v in values.values()), values


@pytest.mark.parametrize("counters,expect", [
    ({"B": 2048, "batches": 110, "window_s": 10.0}, 2048 * 110 / 10.0),
    ({"lanes": 128, "steps": 500, "flights": 1, "window_s": 12.5}, 128 * 500 / 12.5),
    ({"lanes": 128, "steps": 500}, None),
])
def test_a_windows_rate_from_its_counters(counters, expect):
    assert spanned.rate(counters) == expect


def _recording(calls: list):
    """A driver module whose Driver records how it was built and set up."""

    class Driver:
        def __init__(self, cell, config, mix, seed, device):
            calls.append(("build", cell, config, mix, seed, str(torch.device(device)),
                          torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            self.cell, self.counters, self.names = cell, {}, names

        def setup(self):
            calls.append(("setup",))

        def window(self, seconds):
            calls.append(("window", seconds))
            return {"elapsed": seconds, "attempted": 1, "failed": 0, "metrics": {n: 1.0 for n in self.names}}

        def check(self):
            return []

    names = []
    return types.SimpleNamespace(Driver=Driver, names=names)


@pytest.mark.parametrize("name", [SOLVE, FLIGHT])
def test_the_spanned_window_builds_and_sets_up_its_driver_as_a_run_does(name, monkeypatch):
    """measure() and harness.run_cell build the cell's driver from the same
    files, seed and device with TF32 off, then set it up and open a window
    of the same length, and nothing else, in that order."""
    cell = tiny(name)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])  # other tests of this process may load JAX
    seen = {}
    for path in ("run", "spanned"):
        calls = []
        mod = _recording(calls)
        mod.names.extend(m["name"] for m in cell.end_to_end if m["name"] != "setup_s")
        monkeypatch.setattr(cell, "driver", lambda mod=mod: mod)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        if path == "run":
            harness.run_cell(cell, SEED, 0.0, False, "cpu", time.perf_counter(), require_card=False)
        else:
            spanned.measure(cell, SEED, 0.0, "cpu")
        seen[path] = calls
    assert seen["run"] == seen["spanned"]
    assert [c[0] for c in seen["run"]] == ["build", "setup", "window"]
    assert seen["run"][0][-2:] == (False, False)
