"""PyTorch port, the closed loop fed the gate filter's estimate, on the CPU
in f64 at a small size, against the benchmark's plain filter
(flightbench/reference/kalman.py, written from the filter's equations and
importing nothing of the port) and judged by its check
(flightbench/reference/kalman_check.py).

  (a) the port's Kalman step against the plain filter: 8 gates turning at
      pi/2 rad/s for 300 steps on noisy corners, so the observed pitch
      jumps by pi and the innovation wraps; equal to 1e-10, and the port's
      wrap counter "estimate.wraps" equals the plain filter's wraps;
  (b) a flight with `estimate_gate_motion` on a seeded random DNN2 (4
      lanes, 23 steps, three replans and a partial period; lane 0's gate
      turns edge-on at step 7), under the step graphs' "blocks" drive and
      the host step loop: the velocity and pitch rate fed to the planner
      equal the plain filter's on the same observations, to 1e-10;
  (c) the check reads that flight correct, and its plant, scorecard and
      controls' numbers are flight_check.py's on the same log; the
      driver refuses a configuration whose filter tuning is not the
      port's;
  (d) and reads it not correct with a fault planted in the port (the
      planner fed the ground truth, the corner noise dropped, R scaled by
      10, the pitch innovation left unwrapped) or with the plain filter
      computed in TF32 in the port's place (the control);
  (e) spans add to the flight only the "flight.estimate" stamps and the
      "estimate.wraps" counter, and nothing to the ground-truth flight but
      the t-solver's counter it had: the ops a flight of 11 steps runs
      under the step graphs' code (what they capture on the card) with
      spans on and off.

No lane reaches the gate in 23 steps, so the check's `fail_share` limit is
1 here.
"""

import collections
import json
import math
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flightbench import harness, traffic
from flightbench.reference import flight_check, kalman, kalman_check
from flightbench.reference.plain import Arith
from flightbench.tests.readings_kalman import fault
from learningagileflight_se3_torch.config import CostWeights, GateMotionConfig, QuadParams, SolverConfig
from learningagileflight_se3_torch.models.mlp import make_dnn2
from learningagileflight_se3_torch.sim import closed_loop
from learningagileflight_se3_torch.sim import estimator as est
from learningagileflight_se3_torch.utils.profiling import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "flight.main.b128.kalman"
B, STEPS, SEED = 4, 23, 2**31 + 77
SHORT = 11  # steps of the flights whose ops are counted: two replans, lane 0's gate edge-on at step 7
LOGGED = ("states", "controls", "hl_variables", "tra_times", "gate_moves", "gate_vel_used")
PORT_FAULTS = ("truth", "no_obs_noise", "r_x10", "unwrapped")


@pytest.fixture(autouse=True)
def spans_off():
    spans.disable()
    yield
    spans.disable()


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The cell's files, the configuration's DNN2 a seeded random one
    (written where the check reads it) and `fail_share`'s limit 1."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        c = harness.Cell(CELL, json.load(f))
    dnn2 = make_dnn2(generator=torch.Generator().manual_seed(5))
    path = tmp_path_factory.mktemp("dnn2") / "dnn2.npz"
    np.savez(path, **{f"params/Dense_{i}/{k}": (layer.weight.T if k == "kernel" else layer.bias).detach().numpy()
                      for i, layer in enumerate(dnn2.layers) for k in ("kernel", "bias")})
    c.config["dnn2_weights"] = str(path)
    c.cell["check"]["limits"]["fail_share"] = 1.0
    c.dnn2 = dnn2.double()
    return c


def _sim(c, estimate=True, steps=STEPS):
    cfg, s = c.config, c.cell["sim"]
    motion = dict(cfg["gate_motion"], velocity=tuple(cfg["gate_motion"]["velocity"]))
    solver = SolverConfig(horizon=10, dt=cfg["dt"], **cfg["bounds"], **dict(c.cell["solver"], max_iters=10))
    return closed_loop.make_closed_loop_sim(
        c.dnn2, QuadParams(**cfg["quad"]), CostWeights(**cfg["cost"]), solver, GateMotionConfig(**motion),
        steps=steps, control_every=s["control_every"], plant_dt=s["plant_dt"],
        fixed_point_tol=s["fixed_point_tol"], fixed_point_accel=s["fixed_point_accel"],
        warm_start=s["warm_start"], estimate_gate_motion=estimate, device="cpu", dtype=torch.float64)


def _inputs(c, steps=STEPS):
    """(scenarios, gate noise, corner noise) of the flight, f64; lane 0's
    gate starts 0.1 rad short of edge-on."""
    gen = traffic.generator(SEED, 1_000_000, "cpu")
    scen = traffic.scenarios(gen, B, c.config["sampler"]).double()
    scen[0, 8] = math.pi / 2 - 0.1
    motion = c.config["gate_motion"]
    noise = traffic.gate_noise(gen, B, steps, motion["noise_std"], motion["noise_clip"]).double()
    obs = 0.01 * torch.randn((B, steps, 4, 3), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    return scen, noise, obs


def _fly(c, drive="eager", estimate=True, obs=True, steps=STEPS):
    scen, noise, obs_noise = _inputs(c, steps)
    log = _sim(c, estimate, steps)(scen, gate_noise=noise, obs_noise=obs_noise if obs else None, drive=drive)
    host = {k: getattr(log, k) for k in LOGGED}
    host["hl"] = host.pop("hl_variables")
    return scen, noise, obs_noise, host


@pytest.fixture(scope="module")
def flights(cell):
    return {drive: _fly(cell, drive) for drive in ("eager", "blocks")}


def _plain_filter(c):
    return kalman.Filter(c.config["estimator"], c.cell["sim"]["plant_dt"], Arith("f64"), "cpu")


# ------------------------------------------------------------ (a)

def test_the_kalman_step_equals_the_plain_filter_across_pitch_wraps(cell):
    """300 steps of 8 gates turning at pi/2 rad/s on noisy corners: the
    state's velocity and pitch rate equal to 1e-10, and the wrap counter
    equals the plain filter's wraps (each gate passes edge-on)."""
    g = torch.Generator().manual_seed(8)
    width = 0.5 + 0.75 * torch.rand(8, generator=g, dtype=torch.float64)
    pitch = (torch.rand(8, generator=g, dtype=torch.float64) - 0.5) * math.pi
    from flightbench.reference import plain

    pts = plain.gate_from_width(width, pitch)
    vel = torch.tensor([1.0, 0.3, 0.4], dtype=torch.float64)
    moves, _ = plain.gate_moves(pts, vel, math.pi / 2, 0.05 * torch.randn((8, 300, 3), generator=g,
                                                                          dtype=torch.float64), 0.01)
    noisy = moves[:, :300] + 0.01 * torch.randn((8, 300, 4, 3), generator=g, dtype=torch.float64)
    ref, wraps = _plain_filter(cell).track(kalman.observe(moves[:, 0]), kalman.observe(noisy))

    e = cell.config["estimator"]
    step = est.make_kalman_step(dt=0.01, q_accel=e["q_accel"], r_meas=e["r_meas"], pitch_period=e["pitch_period"])
    step.count = torch.zeros(2, dtype=torch.int32)
    ks = est.kalman_init(est.gate_observation(moves[:, 0]), e["pos_var"], e["vel_var"], dtype=torch.float64)
    fed = []
    for k in range(300):
        ks = step(ks, est.gate_observation(noisy[:, k]))
        v, w = est.estimated_velocity(ks)
        fed.append(torch.cat([v, w[:, None]], dim=1))
    fed = torch.stack(fed, dim=1)
    assert wraps >= 2 * 8 and step.count.tolist() == [300, wraps]
    assert float((fed - ref).abs().max()) < 1e-10


# ------------------------------------------------------------ (b), (c)

@pytest.mark.parametrize("drive", ["eager", "blocks"])
def test_the_flight_feeds_the_planner_the_plain_filters_estimate(drive, cell, flights):
    """The logged [v, pitch rate] the planner was fed, under the host step
    loop and the step graphs' code, against the plain filter on the
    flight's own gate corners and corner noise."""
    scen, noise, obs, log = flights[drive]
    moves = log["gate_moves"]
    ref, wraps = _plain_filter(cell).track(kalman.observe(moves[:, 0]), kalman.observe(moves[:, :STEPS] + obs))
    assert wraps > 0  # lane 0's gate turned edge-on
    assert float((log["gate_vel_used"] - ref).abs().max()) < 1e-10
    assert torch.equal(log["gate_vel_used"], flights["eager"][3]["gate_vel_used"])


def test_the_check_reads_the_flight_correct(cell, flights):
    numbers = kalman_check.numbers(cell.config, cell.cell, [flights["blocks"]], "cpu")
    limits = cell.cell["check"]["limits"]
    assert set(numbers) == set(limits)
    checked = [{"name": k, "value": v, "limit": limits[k]} for k, v in numbers.items()]
    assert harness.judge(checked), numbers
    assert numbers["kalman_gap"] < 1e-10 and numbers["dnn2_gap"] < 1e-10


@pytest.mark.parametrize("control", [False, True])
def test_the_checks_plant_and_score_numbers_are_flight_checks(control, cell, flights):
    """The numbers the check computes as flight_check.py does, on the same
    flight's log, sound and with the TF32 control."""
    scen, noise, obs, log = flights["blocks"]
    ours = kalman_check.numbers(cell.config, cell.cell, [(scen, noise, obs, log)], "cpu", control=control)
    theirs = flight_check.numbers(cell.config, cell.cell, [(scen, noise, log)], "cpu", control=control)
    for k in ("plant_gap", "fail_share", "control_excess"):
        assert ours[k] == theirs[k], k


@pytest.mark.parametrize("key", ["q_accel", "r_meas", "pos_var", "vel_var", "pitch_period"])
def test_the_driver_refuses_a_tuning_the_port_does_not_fly(key, cell):
    """make_closed_loop_sim flies the port's default tuning, so a configuration
    that states another is refused before any flight."""
    from flightbench.drivers import flight_kalman

    assert {k: cell.config["estimator"][k] for k in flight_kalman.port_tuning()} == flight_kalman.port_tuning()
    config = dict(cell.config, estimator=dict(cell.config["estimator"], **{key: 2 * cell.config["estimator"][key]}))
    with pytest.raises(ValueError, match="not the port's tuning"):
        flight_kalman.Driver(cell.cell, config, cell.mix, 0, "cpu")


# ------------------------------------------------------------ (d)

@pytest.mark.parametrize("kind", PORT_FAULTS + ("tf32",))
def test_a_planted_fault_turns_correct_false(kind, cell, flights):
    """Each fault breaks `kalman_gap`, and so `correct`."""
    if kind == "tf32":
        numbers = kalman_check.numbers(cell.config, cell.cell, [flights["eager"]], "cpu", control=True)
    else:
        with fault(kind, cell.config):
            flight = _fly(cell, "eager", obs=True)
        numbers = kalman_check.numbers(cell.config, cell.cell, [flight], "cpu")
    limits = cell.cell["check"]["limits"]
    checked = [{"name": k, "value": v, "limit": limits[k]} for k, v in numbers.items()]
    assert not harness.judge(checked)
    assert numbers["kalman_gap"] > limits["kalman_gap"], numbers


# ------------------------------------------------------------ (e)

class _Ops(TorchDispatchMode):
    """The ATen ops run inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _ops_and_spans(c, estimate, on):
    """(ops, device span names, counters) of one flight of SHORT steps under
    the step graphs' code (the spans' counters made before it, as a
    capture needs them)."""
    for name in ("flight.tsolve", "tsolve.fused", "estimate.wraps"):
        spans.counter(name, "cpu")
    if on:
        spans.enable("cpu")
    with _Ops() as rec:
        _fly(c, "blocks", estimate, steps=SHORT)
    got = spans.collect() if on else {"device": [], "counters": {}}
    spans.disable()
    return rec.ops, collections.Counter(name for name, _, _ in got["device"]), got["counters"]


def _count_ops(fn):
    with _Ops() as rec:
        fn()
    return rec.ops


def _tsolve_counter_ops(iters: int):
    """The ops of the t-solver's counter over `iters` iterations of its eager loop."""
    count = torch.zeros(2, dtype=torch.int32)
    return collections.Counter({k: iters * n for k, n in _count_ops(lambda: count[1].add_(1)).items()})


def test_spans_add_to_the_ground_truth_flight_only_the_tsolvers_counter(cell, monkeypatch):
    """The filter never runs (a filter that raises is never called), no
    "flight.estimate" span is stamped nor the wrap counter added to, and
    spans add no op but the t-solver's counter's."""
    def no_filter(*a, **kw):
        def step(*a, **kw):
            raise AssertionError("the ground-truth flight ran the filter")
        return step

    monkeypatch.setattr(closed_loop, "make_kalman_step", no_filter)
    off_ops, _, _ = _ops_and_spans(cell, False, False)
    on_ops, names, counters = _ops_and_spans(cell, False, True)
    assert "flight.estimate" not in names and counters["estimate.wraps"] == [0, 0]
    assert on_ops - off_ops == _tsolve_counter_ops(counters["flight.tsolve"][1])
    assert not off_ops - on_ops


def test_spans_add_to_the_estimated_flight_only_its_span_and_counter(cell):
    """A "flight.estimate" span a step, and a step the wrap counter's ops
    (those one Kalman step adds with its counter set) besides the
    t-solver's counter's."""
    ks = est.kalman_init(torch.zeros(B, 4, dtype=torch.float64), dtype=torch.float64)
    y = torch.full((B, 4), 0.1, dtype=torch.float64)
    step = est.make_kalman_step()
    step(ks, y)  # its model matrices are made at the first call
    off = _count_ops(lambda: step(ks, y))
    step.count = torch.zeros(2, dtype=torch.int32)
    counter_ops = _count_ops(lambda: step(ks, y)) - off
    assert sum(counter_ops.values()) > 0

    off_ops, _, _ = _ops_and_spans(cell, True, False)
    on_ops, names, counters = _ops_and_spans(cell, True, True)
    updates, wraps = counters["estimate.wraps"]
    assert names["flight.estimate"] == names["flight.step"] == updates == SHORT and wraps > 0
    extra = _tsolve_counter_ops(counters["flight.tsolve"][1])
    extra.update({k: SHORT * n for k, n in counter_ops.items()})
    assert on_ops - off_ops == extra and not off_ops - on_ops


def test_the_estimate_span_lies_inside_each_step_before_the_fixed_point(cell):
    spans.enable("cpu")
    _fly(cell, "blocks")
    got = spans.collect()
    by = collections.defaultdict(list)
    for name, s, e in got["device"]:
        by[name].append((s, e))
    assert len(by["flight.estimate"]) == len(by["flight.step"]) == len(by["flight.tsolve"]) == STEPS
    for (s, e), (es, ee), (ts, _) in zip(by["flight.step"], by["flight.estimate"], by["flight.tsolve"]):
        assert s <= es <= ee <= ts <= e
