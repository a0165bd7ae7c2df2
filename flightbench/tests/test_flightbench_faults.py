"""A whole run of each cell, the card's look skipped, at a size the CPU
holds: sound, it comes out correct; with the timed path broken underneath
it comes out not correct, once for each fault the cell can have (a step
that returns its state unchanged, half of the batch left out, an answer
altered where it is produced, a solve's loop that exits after a few
iterations); and the control, the reference computed in
TF32 in the port's place, fails one of the cell's numbers.

The sizes: solves of 8 lanes at H=10 (the control's at H=50), 40 DDP
iterations, every lane polished; flights of 2 lanes and 20 steps, 3 DDP iterations a replan.
No lane reaches the gate in 20 steps, so the flights' `fail_share` limit
is 1 here."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from flightbench import harness, traffic
from flightbench.reference import flight_check, solve_check
from flightbench.tests import readings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOLVE, FLIGHT = "solve.main.b2048", "flight.main.b128"
SEED = 2**31 + 123


def tiny(name: str) -> harness.Cell:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(name, json.load(f))
    if cell.cell["driver"] == "solve":
        cell.mix.update(batch=8, distinct_batches=1, judged_passes=1)
        cell.config["horizon"] = 10
        cell.cell["solver"]["max_iters"] = 40
    else:
        cell.mix.update(lanes=2, steps=20)
        cell.cell["solver"]["max_iters"] = 3
        cell.cell["check"]["limits"]["fail_share"] = 1.0
    return cell


def run(cell) -> dict:
    return harness.run_cell(cell, SEED, 0.0, False, "cpu", time.perf_counter(), require_card=False)


def broken(result, number: str) -> bool:
    n = result["checks"][number]
    return result["correct"] is False and not n["value"] <= n["limit"]


@pytest.mark.parametrize("name", [SOLVE, FLIGHT])
def test_a_sound_run_is_correct(name):
    r = run(tiny(name))
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in tiny(name).end_to_end}
    assert list(r)[-1] == "checks"


def test_solve_state_unchanged(monkeypatch):
    from learningagileflight_se3_torch.solver import ilqr_batched

    monkeypatch.setattr(ilqr_batched.BatchedSolver, "iteration", readings.unchanged_iteration)
    assert broken(run(tiny(SOLVE)), "polish_share")


def test_solve_half_the_batch(monkeypatch):
    from learningagileflight_se3_torch.solver import ilqr

    make = ilqr.make_batched_mpc_solver
    monkeypatch.setattr(ilqr, "make_batched_mpc_solver", lambda *a, **k: readings.half_solver(make(*a, **k)))
    assert broken(run(tiny(SOLVE)), "cost_gap_max")


def test_solve_answer_altered(monkeypatch):
    from learningagileflight_se3_torch.solver import ilqr

    make = ilqr.make_batched_mpc_solver
    cell = tiny(SOLVE)
    lb, ub = cell.config["bounds"]["u_lb"], cell.config["bounds"]["u_ub"]
    monkeypatch.setattr(ilqr, "make_batched_mpc_solver",
                        lambda *a, **k: readings.altered_solver(make(*a, **k), lb, ub))
    assert broken(run(cell), "cost_gap_max")


def test_solve_early_exit(monkeypatch):
    from learningagileflight_se3_torch.solver import ilqr

    make = ilqr.make_batched_mpc_solver
    monkeypatch.setattr(ilqr, "make_batched_mpc_solver", readings.early_exit_factory(make, iters=4))
    assert broken(run(tiny(SOLVE)), "polish_share")


def test_flight_state_unchanged(monkeypatch):
    from learningagileflight_se3_torch.sim import closed_loop

    monkeypatch.setattr(closed_loop, "euler_step_renorm", readings.unchanged_plant)
    assert broken(run(tiny(FLIGHT)), "plant_gap")


def test_flight_half_the_batch(monkeypatch):
    from learningagileflight_se3_torch.sim import closed_loop

    make = closed_loop.make_closed_loop_sim
    monkeypatch.setattr(closed_loop, "make_closed_loop_sim", lambda *a, **k: readings.half_sim(make(*a, **k)))
    assert broken(run(tiny(FLIGHT)), "dnn2_gap")


def test_flight_answer_altered(monkeypatch):
    from learningagileflight_se3_torch.utils import weights

    load = weights.load_dnn2

    def altered(*a, **k):
        model = load(*a, **k)
        with torch.no_grad():
            model.layers[-1].bias.add_(0.05)
        return model

    monkeypatch.setattr(weights, "load_dnn2", altered)
    assert broken(run(tiny(FLIGHT)), "dnn2_gap")


def test_solve_control_fails():
    """The reference's own solve in TF32 in the port's place fails a
    number; in float64 it passes, as the port's answers do."""
    cell = tiny(SOLVE)
    cell.config["horizon"] = 50  # over H=10 TF32's rounding has too few steps to grow
    drv = cell.driver().Driver(cell.cell, cell.config, cell.mix, SEED, "cpu")
    problems = traffic.solve_batches(cell.mix, cell.config, SEED, "cpu")
    answers = readings._solve_answers(drv, problems)
    check = cell.cell["check"]
    limits = check["limits"]
    lanes = solve_check.sample(SEED, len(problems), cell.mix["batch"], check["sample"])
    sound = solve_check.numbers(problems, answers, cell.config, lanes, check)
    assert all(sound[k] <= limits[k] for k in limits), sound
    for prec, fails in (("f64", False), ("tf32", True)):
        probs, ans, ln = solve_check.reference_answers(problems, lanes, cell.config, cell.cell["solver"], prec)
        ref = solve_check.numbers(probs, ans, cell.config, ln, check)
        assert any(ref[k] > limits[k] for k in limits) is fails, (prec, ref)


def test_flight_control_fails():
    cell = tiny(FLIGHT)
    drv = cell.driver().Driver(cell.cell, cell.config, cell.mix, SEED, "cpu")
    flight = drv._fly(drv.sim, 0, cell.mix["steps"])
    limits = cell.cell["check"]["limits"]
    sound = flight_check.numbers(cell.config, cell.cell, [flight], "cpu")
    control = flight_check.numbers(cell.config, cell.cell, [flight], "cpu", control=True)
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert any(control[k] > limits[k] for k in limits), control
