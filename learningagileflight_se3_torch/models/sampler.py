"""Scenario sampler on a `torch.Generator`.

Port of `learningagileflight_se3_tpu/models/sampler.py`: the same
distributions, drawn from PyTorch's generator (so not the JAX package's
numbers).

9-dim scenario: [init_pos(3), final_pos(3), yaw, gate width, gate pitch],
with the pitch drawn from the width-coupled bimodal clipped normal.
Pretrain label: zeros except t = clip(round(|init_pos|/4, 1), 2, 4).

The random gate and the 25-dim general scenario are split into their raw
draws (unit uniforms and standard normals, `draw_*`) and the deterministic
placement (`*_from_draws`), so the placement can be held against the JAX
package on the same draws.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from learningagileflight_se3_torch.config import SamplerConfig
from learningagileflight_se3_torch.core.rotations import (
    axis_angle_to_quat,
    normalize,
    rodrigues_to_quat,
    skew,
)
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


def pretrain_label(scenario):
    """Scenario (..., 9) -> label (..., 7): zeros except the traversal time
    clip(round(|init_pos|/4 to 0.1), 2, 4) (round half to even)."""
    t = torch.clamp(
        torch.round(torch.linalg.vector_norm(scenario[..., 0:3], dim=-1) / 4.0 * 10.0) / 10.0,
        2.0, 4.0)
    return torch.cat([torch.zeros_like(scenario[..., 0:6]), t[..., None]], dim=-1)


def _draw(generator, batch, dtype, uniforms, normals):
    """{name: unit uniform or standard normal of shape (*batch, *shape)}."""
    lead = () if batch is None else (batch,)
    kw = dict(generator=generator, device=generator.device, dtype=dtype)
    d = {k: torch.rand(lead + shape, **kw) for k, shape in uniforms.items()}
    d.update({k: torch.randn(lead + shape, **kw) for k, shape in normals.items()})
    return d


_GATE_UNIFORMS = {"dia": (), "p2z": (), "p4z": ()}
_GATE_NORMALS = {"p2x": (), "p4x": ()}


def draw_random_gate(generator: torch.Generator, batch: Optional[int] = None,
                     dtype=torch.float32):
    """The raw draws of `random_gate_from_draws`."""
    return _draw(generator, batch, dtype, _GATE_UNIFORMS, _GATE_NORMALS)


def random_gate_from_draws(d):
    """A random planar quadrilateral gate in the x-z plane, (..., 4, 3):
    corner 1 at the origin, corner 3 on the +x axis at the diagonal length
    dia ~ U(1.5, 3), corners 2 / 4 scattered above / below (x ~ N(dia/2,
    dia/2), z ~ U(0, dia) / U(-dia, 0))."""
    dia = 1.5 + 1.5 * d["dia"]
    zero = torch.zeros_like(dia)
    p1 = torch.stack([zero, zero, zero], dim=-1)
    p3 = torch.stack([dia, zero, zero], dim=-1)
    p2 = torch.stack([dia / 2 + (dia / 2) * d["p2x"], zero, d["p2z"] * dia], dim=-1)
    p4 = torch.stack([dia / 2 + (dia / 2) * d["p4x"], zero, d["p4z"] * dia - dia], dim=-1)
    return torch.stack([p1, p2, p3, p4], dim=-2)


def sample_random_gate(generator: torch.Generator, batch: Optional[int] = None,
                       dtype=torch.float32):
    """(batch, 4, 3) random gates ((4, 3) without `batch`)."""
    return random_gate_from_draws(draw_random_gate(generator, batch, dtype))


def _rotvec_to_dcm(rv):
    """Rotation vector (..., 3) -> rotation matrix (Rodrigues' formula)."""
    theta = torch.linalg.vector_norm(rv, dim=-1, keepdim=True)
    K = skew(rv / torch.clamp_min(theta, 1e-12))
    theta = theta[..., None]
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device)
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)


def draw_general_scenario(generator: torch.Generator, batch: Optional[int] = None,
                          dtype=torch.float32):
    """The raw draws of `general_scenario_from_draws`."""
    three = (3,)
    return _draw(
        generator, batch, dtype,
        {"scaling": (), "phi": (), "beta": (), "length": (), "dist": (), **_GATE_UNIFORMS},
        {"theta": (), "axis": three, "angle": (), "translation": three, "velocity": three,
         "rd": three, "final": three, **_GATE_NORMALS},
    )


def general_scenario_from_draws(d):
    """The fully general 25-dim scenario: an initial position on a random
    sphere, a random quadrilateral gate placed by a composed y / z / rotation-
    vector rotation and a noisy translation, a random initial velocity and
    attitude, and a noisy final point.

    Layout: [init_pos(3), gate corners row-major (12), velocity(3),
    quaternion wxyz (4), final_pos(3)]."""
    scaling = 3.0 + 13.0 * d["scaling"]
    phi = 2 * math.pi * d["phi"]
    theta = torch.clamp(math.pi / 2 + (math.pi / 8) * d["theta"], math.pi / 4, 3 * math.pi / 4)
    sdir = torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                        torch.cos(theta)], dim=-1)
    init_pos = scaling[..., None] * sdir

    beta = 2 * math.pi * d["beta"]
    cb, sb = torch.cos(beta), torch.sin(beta)
    zero, one = torch.zeros_like(cb), torch.ones_like(cb)
    mat = lambda rows: torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    rot1 = mat([[cb, zero, sb], [zero, one, zero], [-sb, zero, cb]])
    g = phi - math.pi / 2
    cg, sg = torch.cos(g), torch.sin(g)
    rot2 = mat([[cg, -sg, zero], [sg, cg, zero], [zero, zero, one]])
    axis = normalize(d["axis"], eps=1e-12)
    a = (math.pi / 16) * d["angle"]
    rot = _rotvec_to_dcm(a[..., None] * axis) @ (rot2 @ rot1)

    length = torch.clamp_min(d["length"] * (scaling - 1.0 - 2.0) + 2.0, 2.0)
    translation = length[..., None] * sdir + d["translation"]
    gate_pts = random_gate_from_draws(d) @ rot.transpose(-1, -2) + translation[..., None, :]

    velocity = 3.0 * d["velocity"]
    quat = rodrigues_to_quat(0.5 * d["rd"])
    dist = d["dist"] * scaling
    final_pos = dist[..., None] * sdir + d["final"]
    return torch.cat([init_pos, gate_pts.flatten(-2), velocity, quat, final_pos], dim=-1)


def sample_general_scenario(generator: torch.Generator, batch: Optional[int] = None,
                            dtype=torch.float32):
    """(batch, 25) general scenarios ((25,) without `batch`)."""
    return general_scenario_from_draws(draw_general_scenario(generator, batch, dtype))


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
