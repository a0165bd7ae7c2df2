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


def goal_cost(x, goal_pos, w: CostWeights, goal_q=None, goal_vel=None):
    """Path / final goal cost: wrf|r - goal_pos|^2 + wvf|v - goal_vel|^2 +
    wwf|w|^2, plus wqf tr(I - R(goal_q)^T R(q)) when wqf is on.  goal_vel
    defaults to zero and goal_q to the identity attitude."""
    r, v, q, om = x[..., 0:3], x[..., 3:6], x[..., 6:10], x[..., 10:13]
    dv = v if goal_vel is None else v - goal_vel
    c = (
        w.wrf * torch.sum((r - goal_pos) ** 2, dim=-1)
        + w.wvf * torch.sum(dv**2, dim=-1)
        + w.wwf * torch.sum(om**2, dim=-1)
    )
    if w.wqf != 0.0:
        if goal_q is None:
            goal_q = torch.zeros_like(q)
            goal_q[..., 0] = 1.0
        c = c + w.wqf * attitude_error(q, goal_q)
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


def stage_cost(x, u, u_prev, k, dt, t, goal_pos, tra_pos, tra_quat, w: CostWeights):
    """Full stage cost C_k, batched over leading dims (k and t broadcast)."""
    return (
        traversal_weight(k, dt, t, w) * traversal_cost(x, tra_pos, tra_quat, w)
        + goal_cost(x, goal_pos, w)
        + thrust_cost(u, w)
        + w.w_du * torch.sum((u - u_prev) ** 2, dim=-1)
    )


def total_trajectory_cost(X, U, u_last, dt, t, goal_pos, tra_pos, tra_quat, w: CostWeights):
    """Total cost of X (..., H+1, 13), U (..., H, 4) with U_{-1} = u_last
    (..., 4); t (...), goal_pos / tra_pos (..., 3), tra_quat (..., 4).
    The shooting objective the differentiable solver's VJP differentiates."""
    H = U.shape[-2]
    U_prev = torch.cat([u_last[..., None, :], U[..., :-1, :]], dim=-2)
    ks = torch.arange(H, dtype=X.dtype, device=X.device)
    stages = stage_cost(X[..., :-1, :], U, U_prev, ks, dt, t[..., None],
                        goal_pos[..., None, :], tra_pos[..., None, :],
                        tra_quat[..., None, :], w)
    return torch.sum(stages, dim=-1) + final_cost(X[..., H, :], goal_pos, w)
