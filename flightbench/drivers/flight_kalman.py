"""Closed-loop flights whose planner is fed the gate filter's estimate of
the gate's motion, scoring a DNN2 checkpoint as it would fly on a
perception stack's noisy corners.

The flights of `drivers/flight.py`, with the port's
`make_closed_loop_sim(..., estimate_gate_motion=True)`: every step the
gate's four corners are observed with Gaussian noise (the mix's
`obs_noise_std` metres, unclipped, a corner, axis and step), the port's
constant-velocity Kalman filter updates on their centre and pitch, and the
t-solver and the replans take the filter's velocity and pitch rate in
place of the ground truth.  The corner noise is drawn with each flight's
other inputs, from (seed, flight) on a stream of its own, and kept with
the flight; `reference/kalman_check.py` judges every flight of the window,
the filter included.

The port's filter takes its tuning from its own defaults
(`sim/estimator.py` `make_kalman_step`, `kalman_init`), which
`make_closed_loop_sim` does not pass on: a configuration whose `estimator`
block differs from them is refused at set-up, not flown and judged false.

`flightbench/spanned.py` keys its work spans by driver name, and has none
for this driver: importing this module registers this driver's, the
flight's ("flight.step"; the filter's "flight.estimate" lies inside it).
"""

from __future__ import annotations

import inspect

import torch

from flightbench import spanned, traffic
from flightbench.drivers import flight
from flightbench.reference import kalman_check

spanned.WORK.setdefault("flight_kalman", spanned.WORK["flight"])
LOGGED = flight.LOGGED + ("gate_vel_used",)  # what the check reads


def observation_noise(mix: dict, seed: int, flight_no: int, device) -> torch.Tensor:
    """(lanes, steps, 4, 3) float32 corner noise of flight number
    `flight_no`, drawn from (seed, flight) on its own stream."""
    gen = traffic.generator(seed, 2_000_000 + flight_no, device)
    return mix["obs_noise_std"] * torch.randn((mix["lanes"], mix["steps"], 4, 3), generator=gen,
                                              device=gen.device, dtype=torch.float32)


def port_tuning() -> dict:
    """The port's filter tuning: its defaults, under the configuration's keys."""
    from learningagileflight_se3_torch.sim.estimator import kalman_init, make_kalman_step

    defaults = {}
    for fn in (make_kalman_step, kalman_init):
        defaults.update({k: p.default for k, p in inspect.signature(fn).parameters.items()
                         if k in ("q_accel", "r_meas", "pitch_period", "pos_var", "vel_var")})
    return defaults


class Driver(flight.Driver):
    def __init__(self, cell: dict, config: dict, mix: dict, seed: int, device):
        port, est = port_tuning(), config["estimator"]
        if {k: est[k] for k in port} != port:
            raise ValueError(f"the configuration's estimator {est} is not the port's tuning {port}")
        super().__init__(cell, config, mix, seed, device)

    def _make(self, steps: int):
        from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim

        s = self.cell["sim"]
        return make_closed_loop_sim(self.model2, self.params, self.weights, self.solver_cfg,
                                    motion_cfg=self.motion, steps=steps, control_every=s["control_every"],
                                    plant_dt=s["plant_dt"], fixed_point_tol=s["fixed_point_tol"],
                                    fixed_point_accel=s["fixed_point_accel"], warm_start=s["warm_start"],
                                    estimate_gate_motion=True, device=self.device, dtype=torch.float32)

    def _fly(self, sim, flight_no: int, steps: int) -> tuple:
        """(scenarios, gate noise, corner noise, the log's fields on the
        host) of one flight."""
        scen, noise = traffic.flight_inputs(self.mix, self.config, self.seed, flight_no, self.device)
        obs = observation_noise(self.mix, self.seed, flight_no, self.device)[:, :steps]
        log = sim(scen, gate_noise=noise[:, :steps], obs_noise=obs)
        host = {k: getattr(log, k).cpu() for k in LOGGED}  # the first fetch waits for the flight
        host["hl"] = host.pop("hl_variables")
        return scen, noise[:, :steps], obs, host

    def check(self) -> list:
        """The reference's numbers over every flight of the window."""
        self.sim = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        values = kalman_check.numbers(self.config, self.cell, self.flights, self.device)
        limits = self.cell["check"]["limits"]
        return [{"name": k, "value": v, "limit": limits[k]} for k, v in values.items()]
