"""Branch-free collision score and trajectory reward, batched.

Port of `learningagileflight_se3_tpu/geometry/collision.py`.  The JAX
version scores one rotor-tip trajectory and vmaps over rotors and lanes;
here the lanes and the rotors are leading batch axes of every tensor:

  * the first gate-plane crossing is the first maximum of a masked argmax
    over the horizon (cast to an integer type: torch.argmax takes no bool);
  * the 4-sector classification is 4 predicated updates in reference
    order, later sectors overwriting earlier ones;
  * inside the gate: score = -max(0, d_min - m)^2, m the distance to the
    nearest of the 4 edge lines;
  * outside: score = -2 d_min m - d_min^2, m the distance to the nearest of
    the 3 edge segments (s-1, s, s+1) of sector s;
  * "started on the far side" and "no crossing" give score 0, by masks.

The values and NaNs are the JAX package's: with no crossing the unit
vector of a zero step is 0/0, masked in the value but not in the gradient
(0 * NaN through `where`), in both frameworks.  The RL step masks such
rows out of the update.

reward = 1000 * sum_rotors collision - 0.5 * path + 100, with
path = sum_{p=0..3} |r_{H-1-p} - goal|^2.
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.config import RewardConfig
from learningagileflight_se3_torch.dynamics.quadrotor import rotor_positions

_NEXT = [1, 2, 3, 0]
# the edge segments (s-1, s, s+1) that sector s measures against
_SECTOR_EDGES = [[3, 0, 1], [0, 1, 2], [1, 2, 3], [2, 3, 0]]


def _norm(v):
    # sqrt(sum v^2) as jnp.linalg.norm differentiates it (NaN gradient at 0)
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _unit(v):
    return v / _norm(v)[..., None]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _line_vertical(p1, p2, point):
    """Distance from point to the infinite line through p1, p2."""
    return _norm(_cross(point - p1, _unit(p1 - p2)))


def _line_segment_distance(p1, p2, point):
    """The reference's segment metric, with its particular casing."""
    a = _line_vertical(p1, p2, point)
    b = _norm(point - p1)
    c = _norm(point - p2)
    d = _norm(p1 - p2)
    far_branch = torch.where((b**2 - d**2) > a**2, c, a)
    near_branch = torch.where((c**2 - d**2) > a**2, b, a)
    return torch.where(b > c, far_branch, near_branch)


def collision_score(gate_pts, tip_traj, horizon: int, d_min: float = 0.2):
    """gate_pts (..., 4, 3), tip_traj (..., horizon+1, 3), batch axes
    broadcast together -> (collision (...), traversed_inside (...) bool)."""
    p = gate_pts
    p_next = p[..., _NEXT, :]
    c = torch.mean(p, dim=-2)
    vec1 = p - c[..., None, :]
    vec2 = p_next - c[..., None, :]
    normals = _unit(_cross(vec2, vec1))                     # (..., 4, 3)
    n_main = normals[..., 0, :]
    n1 = _unit(_cross(vec1, normals))
    n2 = _unit(_cross(normals, vec2))
    n3 = _unit(_cross(normals, p_next - p))

    sides = _dot(tip_traj[..., :horizon, :] - c[..., None, :], n_main[..., None, :])
    started_far = sides[..., 0] < 0
    crossed = sides < 0
    has_crossing = torch.any(crossed, dim=-1)
    t_first = torch.argmax(crossed.to(torch.int8), dim=-1)  # first True, 0 if none

    def at(i):
        idx = i[..., None, None].expand(*i.shape, 1, 3)
        return torch.gather(tip_traj.expand(*i.shape, *tip_traj.shape[-2:]), -2, idx)[..., 0, :]

    pt_t = at(t_first)
    pt_prev = at(torch.clamp_min(t_first - 1, 0))
    dvec = _unit(pt_t - pt_prev)
    tt = _dot(n_main, pt_t - c) / _dot(dvec, n_main)
    intersect = pt_t - tt[..., None] * dvec

    rel = (intersect - c)[..., None, :]
    in_sector = (_dot(n1, rel) > 0) & (_dot(n2, rel) > 0)        # (..., 4)
    inside_gate = _dot(p - intersect[..., None, :], n3) > 0       # (..., 4)

    point = intersect[..., None, :]
    m_inside = torch.amin(_line_vertical(p, p_next, point), dim=-1)
    score_inside = -torch.clamp_min(d_min - m_inside, 0.0) ** 2
    seg_d = _line_segment_distance(p, p_next, point)              # (..., 4)
    m_out = torch.amin(seg_d[..., _SECTOR_EDGES], dim=-1)         # (..., 4 sectors)
    score_out = -2.0 * d_min * m_out - d_min**2

    collision = torch.zeros_like(score_inside)
    traversed = torch.zeros_like(started_far)
    for s in range(4):
        val = torch.where(inside_gate[..., s], score_inside, score_out[..., s])
        collision = torch.where(in_sector[..., s], val, collision)
        traversed = torch.where(in_sector[..., s], inside_gate[..., s], traversed)

    valid = has_crossing & ~started_far
    collision = torch.where(valid, collision, torch.zeros_like(collision))
    traversed = traversed & valid
    return collision, traversed


def trajectory_reward(state_traj, gate_pts, goal_pos, cfg: RewardConfig, horizon: int):
    """Reward of state trajectories (..., H+1, 13) against gates (..., 4, 3)
    and goals (..., 3).  Returns (reward, collision_sum, path, inside_any),
    each (...)."""
    tips = rotor_positions(state_traj, cfg.wing_len).transpose(-3, -2)  # (..., 4, H+1, 3)
    cols, insides = collision_score(gate_pts[..., None, :, :], tips, horizon, cfg.d_min)
    collision = torch.sum(cols, dim=-1)
    inside_any = torch.any(insides, dim=-1)
    ends = state_traj[..., [horizon - 1 - i for i in range(cfg.n_path_points)], 0:3]
    path = torch.sum((ends - goal_pos[..., None, :]) ** 2, dim=(-2, -1))
    reward = cfg.collision_weight * collision - cfg.path_weight * path + cfg.reward_offset
    return reward, collision, path, inside_any
