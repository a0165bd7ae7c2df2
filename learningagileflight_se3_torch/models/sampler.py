"""Scenario sampler on a `torch.Generator`.

Port of `sample_scenario(s)` and `scenario_to_problem` of
`learningagileflight_se3_tpu/models/sampler.py`: the same distributions,
drawn from PyTorch's generator (so not the JAX package's numbers).

9-dim scenario: [init_pos(3), final_pos(3), yaw, gate width, gate pitch],
with the pitch drawn from the width-coupled bimodal clipped normal.
"""

from __future__ import annotations

import math

import torch

from learningagileflight_se3_torch.config import SamplerConfig
from learningagileflight_se3_torch.core.rotations import axis_angle_to_quat
from learningagileflight_se3_torch.geometry.gate import gate_from_width


def sample_scenarios(generator: torch.Generator, batch: int,
                     cfg: SamplerConfig = SamplerConfig(), dtype=torch.float32):
    """(batch, 9) scenarios on the generator's device."""
    kw = dict(generator=generator, device=generator.device, dtype=dtype)
    uni = lambda shape, half: (2.0 * torch.rand(shape, **kw) - 1.0) * half
    off = lambda v: torch.tensor(v, dtype=dtype, device=generator.device)
    init_pos = uni((batch, 3), cfg.init_pos_halfwidth) + off(cfg.init_pos_offset)
    final_pos = uni((batch, 3), cfg.final_pos_halfwidth) + off(cfg.final_pos_offset)
    yaw = uni((batch,), cfg.yaw_halfwidth)
    width = torch.clamp(cfg.width_mean + cfg.width_std * torch.randn((batch,), **kw),
                        cfg.width_clip[0], cfg.width_clip[1])
    angle = torch.clamp(1.3 * (1.2 - width), 0.0, math.pi / 3)
    angle1 = (math.pi / 2 - angle) / 3.0
    judge = torch.randn((batch,), **kw)
    eps = torch.randn((batch,), **kw)
    pitch_pos = torch.minimum(torch.maximum(angle + angle1 + (2 * angle1 / 3) * eps, angle),
                              torch.full_like(angle, math.pi / 2))
    pitch_neg = torch.minimum(torch.maximum(-angle - angle1 + (2 * angle1 / 3) * eps,
                                            torch.full_like(angle, -math.pi / 2)), -angle)
    pitch = torch.where(judge > 0, pitch_pos, pitch_neg)
    return torch.cat([init_pos, final_pos, yaw[:, None], width[:, None], pitch[:, None]], dim=1)


def sample_scenario(generator: torch.Generator, cfg: SamplerConfig = SamplerConfig(),
                    dtype=torch.float32):
    """One 9-dim scenario vector."""
    return sample_scenarios(generator, 1, cfg, dtype)[0]


def scenario_to_problem(scenario, half_height: float = 1.0):
    """Scenario (..., 9) -> dict(x0 (..., 13), goal_pos (..., 3),
    gate_pts (..., 4, 3)): gate corners from the width pitched by the
    scenario's pitch, and the initial state [pos, 0, yaw quaternion about z, 0]."""
    init_pos, goal = scenario[..., 0:3], scenario[..., 3:6]
    yaw, width, pitch = scenario[..., 6], scenario[..., 7], scenario[..., 8]
    gate_pts = gate_from_width(width, pitch, half_height)
    axis = torch.zeros_like(init_pos)
    axis[..., 2] = 1.0
    q0 = axis_angle_to_quat(yaw, axis)
    zeros3 = torch.zeros_like(init_pos)
    x0 = torch.cat([init_pos, zeros3, q0, zeros3], dim=-1)
    return {"x0": x0, "goal_pos": goal, "gate_pts": gate_pts}
