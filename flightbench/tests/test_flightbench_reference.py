"""The frozen pieces of the benchmark against the port, on the CPU in
float64: the traffic generator's copies, and the plain reference's cost,
plant, DNN2, window inputs, gate motion and scorecard.  The test imports
both sides; the reference itself imports nothing of the port."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest
import torch

from flightbench import traffic
from flightbench.reference import plain
from flightbench.reference.plain import Arith

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
F64 = Arith("f64")


def config(name):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,variant", [("main", "MAIN"), ("pybullet", "PYBULLET")])
def test_configs_are_the_ports_presets(name, variant):
    from learningagileflight_se3_torch.config import Variant, preset

    P, W, C, _, S, G = preset(getattr(Variant, variant))
    cfg = config(name)
    assert cfg["quad"] == dataclasses.asdict(P) and cfg["cost"] == dataclasses.asdict(W)
    assert cfg["bounds"] == {"u_lb": C.u_lb, "u_ub": C.u_ub, "w_bound": C.w_bound,
                             "w_bound_weight": C.w_bound_weight}
    assert cfg["horizon"] == C.horizon and cfg["dt"] == C.dt
    as_lists = lambda d: {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(d).items()}  # noqa: E731
    assert cfg["sampler"] == as_lists(S) and cfg["gate_motion"] == as_lists(G)


@pytest.mark.parametrize("name", ["main", "pybullet"])
def test_frozen_sampler_and_problem_are_the_ports(name):
    from learningagileflight_se3_torch.benchmarks.problems import bench_args
    from learningagileflight_se3_torch.config import SamplerConfig
    from learningagileflight_se3_torch.models.sampler import sample_scenarios

    cfg = config(name)
    sc = SamplerConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["sampler"].items()})
    ours = traffic.scenarios(torch.Generator().manual_seed(9), 64, cfg["sampler"], torch.float64)
    theirs = sample_scenarios(torch.Generator().manual_seed(9), 64, sc, torch.float64)
    assert torch.equal(ours, theirs)
    for a, b in zip(traffic.bench_problem(ours), bench_args(ours, "cpu", torch.float64)):
        assert torch.allclose(a, b, rtol=0, atol=1e-15)


def test_gate_noise_is_the_ports_draw():
    from learningagileflight_se3_torch.geometry.gate import gate_move

    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    noise = traffic.gate_noise(g1, 3, 50, 0.1, 0.1, torch.float64)
    pts = torch.zeros((3, 4, 3), dtype=torch.float64)
    _, V = gate_move(pts, g2, (1.0, 0.3, 0.4), 0.0, T=0.5, dt=0.01, noise_std=0.1, noise_clip=0.1)
    assert torch.allclose(V[:, 1:] - torch.tensor([1.0, 0.3, 0.4], dtype=torch.float64), noise, atol=1e-15)


def test_seed_streams():
    a = traffic.generator(2**31 + 11, 0, "cpu")
    b = traffic.generator(2**31 + 11, 0, "cpu")
    c = traffic.generator(2**31 + 11, 1, "cpu")
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert not torch.equal(torch.rand(4, generator=traffic.generator(2**31 + 11, 0, "cpu")),
                           torch.rand(4, generator=c))


@pytest.mark.parametrize("name", ["main", "pybullet"])
def test_reference_cost_is_the_ports_solve_cost(name):
    """The port's CPU solve in float64 at H=10: the cost it reports is the
    reference's cost of the controls it returns; its KKT residual is the
    reference's where it ended on the test."""
    from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    cfg = dict(config(name), horizon=10)
    P, W = QuadParams(**cfg["quad"]), CostWeights(**cfg["cost"])
    C = SolverConfig(horizon=10, dt=cfg["dt"], **cfg["bounds"], max_iters=40, tol=1e-9, gtol=1e-7)
    problem = traffic.bench_problem(traffic.scenarios(torch.Generator().manual_seed(3), 6, cfg["sampler"],
                                                      torch.float64))
    problem = problem[:5] + (torch.full((6,), 0.5, dtype=torch.float64),)  # the gate inside the horizon
    sol = make_batched_mpc_solver(P, W, C)(*problem)
    J, pg = plain.projected_gradient(problem, sol.control_traj, cfg, F64)
    assert torch.allclose(J, sol.cost, rtol=1e-11, atol=1e-9)
    done = sol.status == 1
    assert bool(done.any())
    # the solver's residual is that of its last sweep, one accepted step behind
    assert torch.all(pg[done] <= 10 * C.gtol * (1.0 + J[done].abs()))


def test_reference_plant_dnn2_window_and_gate_are_the_ports():
    from learningagileflight_se3_torch.config import QuadParams
    from learningagileflight_se3_torch.dynamics.quadrotor import euler_step_renorm
    from learningagileflight_se3_torch.geometry.gate import (gate_from_width, gate_move, rotate_y,
                                                             translate, window_inputs)
    from learningagileflight_se3_torch.utils.weights import load_dnn2

    cfg = config("main")
    g = torch.Generator().manual_seed(5)
    x = torch.randn((7, 13), generator=g, dtype=torch.float64)
    x[:, 6:10] /= x[:, 6:10].norm(dim=-1, keepdim=True)
    u = torch.rand((7, 4), generator=g, dtype=torch.float64) * 2.44
    assert torch.allclose(plain.euler_renorm(x, u, 0.01, cfg["quad"], F64),
                          euler_step_renorm(x, u, 0.01, QuadParams(**cfg["quad"])), rtol=0, atol=1e-13)

    scen = traffic.scenarios(g, 7, cfg["sampler"], torch.float64)
    pts = gate_from_width(scen[:, 7], scen[:, 8])
    assert torch.allclose(plain.gate_from_width(scen[:, 7], scen[:, 8]), pts, atol=1e-14)
    noise = traffic.gate_noise(g, 7, 30, 0.1, 0.1, torch.float64)
    moves, V = gate_move(pts, None, (1.0, 0.3, 0.4), 1.5707963267948966, T=0.3, dt=0.01, noise=noise)
    m2, V2 = plain.gate_moves(pts, (1.0, 0.3, 0.4), 1.5707963267948966, noise, 0.01)
    assert torch.allclose(moves, m2, atol=1e-13) and torch.allclose(V, V2, atol=1e-15)

    t = torch.rand(7, generator=g, dtype=torch.float64) * 2
    vel, w = V[:, 3], torch.full((7,), 1.5707963267948966, dtype=torch.float64)
    theirs = window_inputs(rotate_y(translate(moves[:, 3], vel * t[:, None]), w * t), x, scen[:, 3:6])
    ours = plain.predicted_inputs(moves[:, 3], vel, w, t, x, scen[:, 3:6], F64)
    assert torch.allclose(ours, theirs, atol=1e-12)

    model = load_dnn2(os.path.join(ROOT, cfg["dnn2_weights"])).double()
    ref = plain.MLP(os.path.join(ROOT, cfg["dnn2_weights"]), F64, "cpu")
    assert torch.allclose(ref(ours), model(ours), atol=1e-12)


def test_reference_scorecard_is_the_ports():
    from learningagileflight_se3_torch.sim.closed_loop import ClosedLoopLog, evaluate_closed_loop_full

    g = torch.Generator().manual_seed(8)
    B, N = 6, 40
    moves = torch.zeros((B, N + 1, 4, 3), dtype=torch.float64)
    moves[..., :, :] = torch.tensor([[-0.5, 0, 1], [0.5, 0, 1], [0.5, 0, -1], [-0.5, 0, -1]], dtype=torch.float64)
    states = torch.zeros((B, N + 1, 13), dtype=torch.float64)
    states[..., 1] = torch.linspace(-2, 2, N + 1, dtype=torch.float64)  # flies through y = 0
    states[..., 0] = torch.randn((B, 1), generator=g, dtype=torch.float64) * 0.6
    states[..., 6] = 1.0
    states[1, 20:, 0] = float("nan")
    log = ClosedLoopLog(states, *(torch.zeros(1),) * 7, moves, torch.zeros(1), torch.zeros(1))
    goal = torch.zeros((B, 3), dtype=torch.float64)
    m = evaluate_closed_loop_full(log, goal)
    traversed, diverged = plain.scorecard(states, moves, goal)
    assert torch.equal(traversed, m.traversed) and torch.equal(diverged, m.diverged)


def test_flights_draw_new_scenarios_per_seed_and_flight():
    cfg, mix = config("main"), traffic.load("flights_b128")
    a = traffic.flight_inputs(mix, cfg, 2**31 + 5, 0, "cpu")
    again = traffic.flight_inputs(mix, cfg, 2**31 + 5, 0, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    for other in (traffic.flight_inputs(mix, cfg, 2**31 + 6, 0, "cpu"),
                  traffic.flight_inputs(mix, cfg, 2**31 + 5, 1, "cpu")):
        assert not torch.equal(a[0], other[0]) and not torch.equal(a[1], other[1])
    assert a[0].shape == (mix["lanes"], 9) and a[1].shape == (mix["lanes"], mix["steps"], 3)


def test_reference_solver_agrees_with_the_ports_solve():
    """The port's CPU solve and the reference's own solver (`ddp.py`), both
    in float64 at H=10 and solved tightly: the lanes end at the same local
    optimum, and the reference cannot improve the port's answers."""
    from flightbench.reference import ddp
    from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    cfg = dict(config("main"), horizon=10)
    P, W = QuadParams(**cfg["quad"]), CostWeights(**cfg["cost"])
    C = SolverConfig(horizon=10, dt=cfg["dt"], **cfg["bounds"], max_iters=200, tol=1e-12, gtol=1e-9)
    problem = traffic.bench_problem(traffic.scenarios(torch.Generator().manual_seed(3), 8, cfg["sampler"],
                                                      torch.float64))
    sol = make_batched_mpc_solver(P, W, C)(*problem)
    U, J, status = ddp.solve(problem, cfg, {"max_iters": 200, "tol": 1e-12}, F64)
    rel = (sol.cost - J).abs() / (1.0 + J.abs())
    assert int((rel < 1e-6).sum()) >= 6, rel
    J0, J1 = ddp.polish(problem, sol.control_traj, cfg, 10)
    assert torch.allclose(J0, sol.cost, rtol=1e-12) and torch.all((J0 - J1) / (1.0 + J0.abs()) < 1e-8)
