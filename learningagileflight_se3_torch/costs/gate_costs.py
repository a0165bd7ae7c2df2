"""Gate-traversal optimal-control costs on tensors.

Port of `learningagileflight_se3_tpu/costs/gate_costs.py`, batched over
leading dimensions:

  stage_k = amp*exp(-decay*(dt*k - t)^2) * tra_cost(x_k) + goal_cost(x_k)
          + wthrust*|u_k|^2 + w_du*|u_k - u_{k-1}|^2
  total   = sum_k stage_k + goal_cost(x_H)
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.config import CostWeights
from learningagileflight_se3_torch.core.rotations import quat_to_dcm_w2b


def attitude_error(q, q_goal):
    """tr(I - R(q_goal)^T R(q)); both R are world -> body DCMs."""
    Rg = quat_to_dcm_w2b(q_goal)
    Rq = quat_to_dcm_w2b(q)
    return 3.0 - torch.sum(Rg * Rq, dim=(-2, -1))


def goal_cost(x, goal_pos, w: CostWeights):
    """Path / final goal cost (zero goal velocity; identity goal attitude
    when wqf is on)."""
    r, v, q, om = x[..., 0:3], x[..., 3:6], x[..., 6:10], x[..., 10:13]
    c = (
        w.wrf * torch.sum((r - goal_pos) ** 2, dim=-1)
        + w.wvf * torch.sum(v**2, dim=-1)
        + w.wwf * torch.sum(om**2, dim=-1)
    )
    if w.wqf != 0.0:
        gq = torch.zeros_like(q)
        gq[..., 0] = 1.0
        c = c + w.wqf * attitude_error(q, gq)
    return c


def traversal_cost(x, tra_pos, tra_quat, w: CostWeights):
    """Traversal cost: attitude term squared (MAIN) or linear (PYBULLET)."""
    r, q = x[..., 0:3], x[..., 6:10]
    att = attitude_error(q, tra_quat)
    att_term = att**2 if w.squared_attitude else att
    return w.wrt * torch.sum((r - tra_pos) ** 2, dim=-1) + w.wqt * att_term


def thrust_cost(u, w: CostWeights):
    """wthrust * |u|^2."""
    return w.wthrust * torch.sum(u**2, dim=-1)


def traversal_weight(k, dt, t, w: CostWeights):
    """Gaussian time window amp*exp(-decay*(dt*k - t)^2)."""
    return w.tra_amp * torch.exp(-w.tra_decay * (dt * k - t) ** 2)


def final_cost(x, goal_pos, w: CostWeights):
    """Terminal cost == goal cost."""
    return goal_cost(x, goal_pos, w)
