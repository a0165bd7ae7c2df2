"""The cell `flight.main.b128.kalman` (flights whose planner is fed the gate
filter's estimate): its files against `main`'s and `flight.main.b128`'s,
a whole run at a size the CPU holds (sound, it comes out correct), the
readings of readings_kalman.py at that size (the control and every fault
turn it not correct), the reader of `flight.estimate_ms_per_step` and the
counter `estimate.wraps` on a synthetic and a CPU spanned window, and, on
the card (marker `gpu`), the command's traced run.

The sizes: flights of 4 lanes and 20 steps, 3 DDP iterations a replan.  No
lane reaches the gate in 20 steps, so `fail_share`'s limit is 1 here."""

from __future__ import annotations

import json
import math
import os
import subprocess
import time

import pytest
import torch

from flightbench import harness, spanned
from flightbench.tests import readings_kalman
from flightbench.tests.test_flightbench_run import command
from flightbench.tests.test_flightbench_spans import FakeDriver, flight_window, reader

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KALMAN, FLIGHT = "flight.main.b128.kalman", "flight.main.b128"
TINY = {"mix": {"lanes": 4, "steps": 20}, "solver": {"max_iters": 3}}
SEED = 2**31 + 147  # flight 0: lane 1's gate turns edge-on at step 8, so the pitch innovation wraps
MS = 1_000_000  # ns


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny() -> harness.Cell:
    cell = harness.Cell(KALMAN, bench())
    cell.mix.update(TINY["mix"])
    cell.cell["solver"].update(TINY["solver"])
    cell.cell["check"]["limits"]["fail_share"] = 1.0
    return cell


# ------------------------------------------------------------ files

def test_the_configuration_is_mains_with_the_estimator():
    """main.kalman.json holds every key and value of main.json but its name,
    source, description, reference and assumptions, and adds the filter's
    numbers; nothing is reduced."""
    with open(os.path.join(ROOT, "flightbench", "configs", "main.json")) as f:
        main = json.load(f)
    with open(os.path.join(ROOT, "flightbench", "configs", "main.kalman.json")) as f:
        kal = json.load(f)
    own = {"name", "source", "what", "reference", "assumed"}
    assert {k: v for k, v in main.items() if k not in own} == {k: v for k, v in kal.items() if k in main and k not in own}
    assert set(kal) - set(main) == {"estimator"} and kal["reduced"] == []
    assert kal["assumed"][:len(main["assumed"])] == main["assumed"]
    e = kal["estimator"]
    assert (e["q_accel"], e["r_meas"], e["pos_var"], e["vel_var"], e["pitch_period"]) == (25.0, 1e-4, 1.0, 4.0, math.pi)
    entry = {c["name"]: c for c in bench()["configs"]}["main.kalman"]
    assert entry["source"] == kal["source"] and len(entry["source"]) <= 200


def test_the_cell_is_the_ground_truth_flights_with_the_filter_judged():
    b = bench()
    cells = {}
    for name in (KALMAN, FLIGHT):
        with open(os.path.join(ROOT, "flightbench", "cells", f"{name}.json")) as f:
            cells[name] = json.load(f)
    k, g = cells[KALMAN], cells[FLIGHT]
    assert k["driver"] == "flight_kalman" and all(k[x] == g[x] for x in ("solver", "sim", "trace"))
    assert set(k["check"]["limits"]) == set(g["check"]["limits"]) | {"kalman_gap"}
    assert set(k["check"]["why"]) == set(k["check"]["limits"])
    with open(os.path.join(ROOT, "flightbench", "mixes", "flights_b128_obs.json")) as f:
        obs = json.load(f)
    with open(os.path.join(ROOT, "flightbench", "mixes", "flights_b128.json")) as f:
        base = json.load(f)
    assert {k_: obs[k_] for k_ in base if k_ != "name"} == {k_: v for k_, v in base.items() if k_ != "name"}
    assert obs["obs_noise_std"] == 0.01
    entry = {w["name"]: w for w in b["workloads"]}[KALMAN]
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("main.kalman", "flights_b128_obs", 1)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert KALMAN in e2e["flight_lane_steps_per_s"]["workloads"]
    # the ground-truth cell's flight metrics, whose readers read this driver's window and slice too, and the filter's
    flight = [m["name"] for m in b["per_layer"] if FLIGHT in m["workloads"]]
    assert [m["name"] for m in b["per_layer"] if KALMAN in m["workloads"]] == flight + ["flight.estimate_ms_per_step"]


def test_the_driver_registers_its_work_spans():
    from flightbench.drivers import flight_kalman  # noqa: F401

    assert spanned.WORK["flight_kalman"] == spanned.WORK["flight"]


def test_the_corner_noise_is_its_own_stream_of_the_seed():
    from flightbench.drivers.flight_kalman import observation_noise

    mix = {"lanes": 3, "steps": 5, "obs_noise_std": 0.01}
    a, b = observation_noise(mix, SEED, 0, "cpu"), observation_noise(mix, SEED, 0, "cpu")
    assert a.shape == (3, 5, 4, 3) and a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, observation_noise(mix, SEED, 1, "cpu"))
    assert 0.002 < float(a.std()) < 0.03


# ------------------------------------------------------------ runs and readings

def test_a_sound_run_is_correct():
    r = harness.run_cell(tiny(), SEED, 0.0, False, "cpu", time.perf_counter(), require_card=False)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == set(tiny().cell["check"]["limits"])
    assert set(r["metrics"]) == {"flight_lane_steps_per_s", "setup_s"}


@pytest.fixture(scope="module")
def readings():
    """readings_kalman's readings at the tiny size on the CPU."""
    return readings_kalman.kalman_readings([SEED], 1, "cpu", overrides=TINY)


@pytest.mark.parametrize("kind", ("control",) + readings_kalman.FAULTS)
def test_the_control_and_each_fault_turn_correct_false(kind, readings):
    limits = tiny().cell["check"]["limits"]
    sound, got = readings["sound"][SEED], readings[kind][SEED]
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert any(got[k] > limits[k] for k in limits), (kind, got)


# ------------------------------------------------------------ the reader and the counter

def kalman_window(**kw):
    """flight_window's flight with a 0.25 ms `flight.estimate` span at the
    start of each step and the counter `estimate.wraps` [20, 7]."""
    w = flight_window(**kw)
    got = w["collected"]
    steps = [(s, e) for name, s, e in got["device"] if name == "flight.step"]
    got["device"] += [("flight.estimate", s, s + MS // 4) for s, _ in steps]
    got["counters"]["estimate.wraps"] = [20, 7]
    w["driver"] = "flight_kalman"
    return w


def test_the_estimate_reader_on_a_synthetic_window():
    from flightbench.drivers import flight_kalman  # noqa: F401  (its work spans)

    drv = FakeDriver(kalman_window())
    assert reader("flight.estimate_ms_per_step")(drv, None) == pytest.approx(0.25)
    assert drv.spanned["summary"]["counters"]["estimate.wraps"] == [20, 7]
    assert reader("flight.tsolve_ms_per_step")(drv, None) == pytest.approx(0.5)
    # a program whose flights stamp no such span, and a window that cannot be read
    assert reader("flight.estimate_ms_per_step")(FakeDriver(flight_window()), None) is None
    assert reader("flight.estimate_ms_per_step")(FakeDriver(kalman_window(overflow=True)), None) is None


def test_the_estimate_reader_reads_none_without_spans(monkeypatch):
    monkeypatch.setattr(spanned, "has_spans", lambda: False)
    monkeypatch.setattr(spanned, "_run", lambda drv: pytest.fail("started a spanned window"))
    assert reader("flight.estimate_ms_per_step")(FakeDriver(), None) is None


def test_a_spanned_window_at_a_cpu_size():
    """The cell's spanned window on the CPU: a `flight.estimate` span and
    an update of the wrap counter a step, inside the steps' work."""
    cell = tiny()
    r = spanned.measure(cell, SEED, 0.0, "cpu")
    drv = FakeDriver(r)
    s = spanned.summary(drv)
    steps = cell.mix["steps"] * r["counters"]["flights"]
    assert s is not None and s["misfit"] < 1e-9
    assert s["spans"]["flight.estimate"][0] == s["spans"]["flight.step"][0] == steps
    assert s["counters"]["estimate.wraps"][0] == steps and 0 <= s["counters"]["estimate.wraps"][1] <= 4 * steps
    v = reader("flight.estimate_ms_per_step")(drv, None)
    assert v is not None and 0 < v < 1e-6 * s["spans"]["flight.step"][1] / steps


# ------------------------------------------------------------ the card

@pytest.mark.gpu
def test_the_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(command(KALMAN, 2, 1), cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["metrics"]["flight.estimate_ms_per_step"]["value"] > 0
