"""Closed-loop flights back to back, scoring a DNN2 checkpoint.

Entry: the port's `sim.closed_loop.make_closed_loop_sim(model2, params,
weights, solver_cfg, motion_cfg, steps, ...)` then `sim(scenarios,
gate_noise=...)`, DNN2 loaded by the port's `utils.weights.load_dnn2` from
the configuration's weights file.  Each flight gets new scenarios and gate
noise from the seed; its log is fetched to the host before the next flight
is sent.  The window runs whole flights: flights start while less than
`--seconds` have passed, and the window closes when the last one started
has landed, so the rate counts all the work and all the time.

Set-up flies one warm-up flight (its own stream of the seed): the first
flight of a sim captures its two step graphs.  The traced slice, after the
window, is a flight of `cell["trace"]["steps"]` steps from the start on a
sim of that length, captured by a warm-up flight of its own before the
profiler opens.  The check judges every flight of the window.
"""

from __future__ import annotations

import os
import time

import torch

from flightbench import traffic, tracing
from flightbench.reference import flight_check

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOGGED = ("states", "controls", "hl_variables", "tra_times", "gate_moves")  # what the check reads


class Driver:
    def __init__(self, cell: dict, config: dict, mix: dict, seed: int, device):
        from learningagileflight_se3_torch.config import (CostWeights, GateMotionConfig, QuadParams,
                                                          SolverConfig)
        from learningagileflight_se3_torch.utils.weights import load_dnn2

        self.cell, self.config, self.mix, self.seed = cell, config, mix, seed
        self.device = torch.device(device)
        self.params = QuadParams(**config["quad"])
        self.weights = CostWeights(**config["cost"])
        self.solver_cfg = SolverConfig(horizon=config["horizon"], dt=config["dt"], **config["bounds"],
                                       **cell["solver"])
        motion = dict(config["gate_motion"])
        motion["velocity"] = tuple(motion["velocity"])
        self.motion = GateMotionConfig(**motion)
        self.model2 = load_dnn2(os.path.join(ROOT, config["dnn2_weights"]))
        self.sim = self._make(mix["steps"])
        self.counters = {"lanes": mix["lanes"], "steps": mix["steps"],
                         "control_every": cell["sim"]["control_every"]}
        self.flights = []

    def _make(self, steps: int):
        from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim

        s = self.cell["sim"]
        return make_closed_loop_sim(self.model2, self.params, self.weights, self.solver_cfg,
                                    motion_cfg=self.motion, steps=steps, control_every=s["control_every"],
                                    plant_dt=s["plant_dt"], fixed_point_tol=s["fixed_point_tol"],
                                    fixed_point_accel=s["fixed_point_accel"], warm_start=s["warm_start"],
                                    device=self.device, dtype=torch.float32)

    def _fly(self, sim, flight: int, steps: int) -> tuple:
        """(scenarios, noise, the log's fields on the host) of one flight."""
        scen, noise = traffic.flight_inputs(self.mix, self.config, self.seed, flight, self.device)
        log = sim(scen, gate_noise=noise[:, :steps])
        host = {k: getattr(log, k).cpu() for k in LOGGED}  # the first fetch waits for the flight
        host["hl"] = host.pop("hl_variables")
        return scen, noise[:, :steps], host

    def _k1(self) -> int:
        from learningagileflight_se3_torch.ops import rollout
        from learningagileflight_se3_torch.utils import graphs

        graphs.settle()
        return rollout.launches

    def setup(self):
        split = self.counters["setup_split"] = {}
        t = time.perf_counter()
        if self.device.type == "cuda":
            from learningagileflight_se3_torch.ops import build

            build.library(), build.graph_library()  # nvcc at a checkout's first run, else a load
        split["kernel_libraries_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self._fly(self.sim, -1, self.mix["steps"])
        split["warmup_flight_s"] = time.perf_counter() - t
        split["step_graph_captures_s"] = self.sim.captures.seconds

    def window(self, seconds: float) -> dict:
        steps, lanes = self.mix["steps"], self.mix["lanes"]
        k0 = self._k1()
        t0 = time.perf_counter()
        while True:
            self.flights.append(self._fly(self.sim, len(self.flights), steps))
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        n = len(self.flights)
        self.counters.update(flights=n, window_s=elapsed, K1=self._k1() - k0,
                             replans=n * -(-steps // self.cell["sim"]["control_every"]))
        return {"elapsed": elapsed, "attempted": n * lanes, "failed": 0,
                "metrics": {"flight_lane_steps_per_s": n * lanes * steps / elapsed}}

    def traced(self):
        steps = self.cell["trace"]["steps"]
        sim = self._make(steps)
        self._fly(sim, -2, steps)  # captures this length's step graphs before the profiler opens
        box = []
        with tracing.session(box):
            self._fly(sim, -2, steps)
        self.counters.update(slice_steps=steps)
        return box[0]

    def check(self) -> list:
        """The reference's numbers over every flight of the window."""
        self.sim = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        values = flight_check.numbers(self.config, self.cell, self.flights, self.device)
        limits = self.cell["check"]["limits"]
        return [{"name": k, "value": v, "limit": limits[k]} for k, v in values.items()]
