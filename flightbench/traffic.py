"""The one traffic generator: reads a mix's parameters (`mixes/<name>.json`)
and a configuration's sampler, and draws the inputs from `--seed`.

Frozen copies, so that a later change to the port's own sampler does not
move the yardstick:
  * the scenario sampler of `learningagileflight_se3_torch/models/sampler.py`
    `sample_scenarios` (the MAIN and PyBullet ranges are the configuration's
    `sampler` numbers);
  * bench.py's problem (bench.py:74-85, the port's `benchmarks/problems.py`
    `bench_args`): u_last 0, tra_pos 0, tra_ang [0, pitch / 2, 0],
    t = clip(|p0| / 4, 2, 4);
  * the gate's velocity noise of `geometry/gate.py` `gate_move`:
    clip(std N(0, 1), -clip, clip) a step and axis.

Every draw is made on the device from a `torch.Generator` seeded from
(seed, stream), so one seed gives the same inputs and each stream (a batch,
a flight) its own.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
    """The traffic mix `name`'s parameters."""
    with open(os.path.join(HERE, "mixes", f"{name}.json")) as f:
        return json.load(f)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for stream `stream` of `seed` (any whole
    number; streams of one seed are independent)."""
    state = np.random.SeedSequence([int(seed) % 2**64, int(stream)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2**63 - 1))


def scenarios(gen: torch.Generator, n: int, sampler: dict, dtype=torch.float32) -> torch.Tensor:
    """(n, 9) scenarios [init_pos(3), final_pos(3), yaw, width, pitch], the
    pitch from the width-coupled bimodal clipped normal."""
    kw = dict(generator=gen, device=gen.device, dtype=dtype)
    uni = lambda shape, half: (2.0 * torch.rand(shape, **kw) - 1.0) * half  # noqa: E731
    off = lambda v: torch.tensor(v, dtype=dtype, device=gen.device)  # noqa: E731
    init_pos = uni((n, 3), sampler["init_pos_halfwidth"]) + off(sampler["init_pos_offset"])
    final_pos = uni((n, 3), sampler["final_pos_halfwidth"]) + off(sampler["final_pos_offset"])
    yaw = uni((n,), sampler["yaw_halfwidth"])
    lo, hi = sampler["width_clip"]
    width = torch.clamp(sampler["width_mean"] + sampler["width_std"] * torch.randn((n,), **kw), lo, hi)
    angle = torch.clamp(1.3 * (1.2 - width), 0.0, math.pi / 3)
    angle1 = (math.pi / 2 - angle) / 3.0
    judge = torch.randn((n,), **kw)
    eps = torch.randn((n,), **kw)
    pitch_pos = torch.minimum(torch.maximum(angle + angle1 + (2 * angle1 / 3) * eps, angle),
                              torch.full_like(angle, math.pi / 2))
    pitch_neg = torch.minimum(torch.maximum(-angle - angle1 + (2 * angle1 / 3) * eps,
                                            torch.full_like(angle, -math.pi / 2)), -angle)
    pitch = torch.where(judge > 0, pitch_pos, pitch_neg)
    return torch.cat([init_pos, final_pos, yaw[:, None], width[:, None], pitch[:, None]], dim=1)


def initial_state(scen: torch.Tensor) -> torch.Tensor:
    """(n, 13) [init_pos, 0, the yaw quaternion about z, 0] of scenarios."""
    yaw = scen[:, 6]
    zeros = torch.zeros_like(scen[:, 0:3])
    q = torch.stack([torch.cos(yaw / 2), torch.zeros_like(yaw), torch.zeros_like(yaw), torch.sin(yaw / 2)], dim=1)
    return torch.cat([scen[:, 0:3], zeros, q, zeros], dim=1)


def bench_problem(scen: torch.Tensor) -> tuple:
    """bench.py's problem of scenarios (n, 9): (x0, u_last, goal, tra_pos,
    tra_ang, t) in the scenarios' dtype and device."""
    x0 = initial_state(scen)
    n = scen.shape[0]
    zeros = lambda *shape: torch.zeros(shape, dtype=scen.dtype, device=scen.device)  # noqa: E731
    tra_ang = torch.cat([zeros(n, 1), scen[:, 8:9] * 0.5, zeros(n, 1)], dim=1)
    t = torch.clamp(torch.linalg.vector_norm(x0[:, 0:3], dim=1) / 4.0, 2.0, 4.0)
    return x0, zeros(n, 4), scen[:, 3:6].clone(), zeros(n, 3), tra_ang, t


def gate_noise(gen: torch.Generator, n: int, steps: int, std: float, clip: float,
               dtype=torch.float32) -> torch.Tensor:
    """(n, steps, 3) clipped Gaussian gate-velocity noise."""
    raw = torch.randn((n, steps, 3), generator=gen, device=gen.device, dtype=dtype)
    return torch.clamp(std * raw, -clip, clip)


def solve_batches(mix: dict, config: dict, seed: int, device) -> list:
    """The mix's `distinct_batches` problems of `batch` lanes each, one
    stream a batch."""
    return [bench_problem(scenarios(generator(seed, i, device), mix["batch"], config["sampler"]))
            for i in range(mix["distinct_batches"])]


def flight_inputs(mix: dict, config: dict, seed: int, flight: int, device) -> tuple:
    """(scenarios (n, 9), gate noise (n, steps, 3)) of flight number
    `flight` (set-up's flights are negative): new scenarios and noise for
    each flight, drawn from (seed, flight)."""
    gen = generator(seed, 1_000_000 + flight, device)
    scen = scenarios(gen, mix["lanes"], config["sampler"])
    motion = config["gate_motion"]
    return scen, gate_noise(gen, mix["lanes"], mix["steps"], motion["noise_std"], motion["noise_clip"])
