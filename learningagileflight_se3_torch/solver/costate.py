"""Costate (adjoint) trajectories of an optimal solution: the reference's
two costate options.

Port of `learningagileflight_se3_tpu/solver/costate.py`.  Along the optimal
trajectory, the multipliers of the lifted NLP's dynamics constraints
x_{k+1} = x_k + dt f(x_k, u_k) satisfy the discrete adjoint recursion

    lam_{k-1} = dC_k/dx(x_k, u_k) + A_k^T lam_k,    lam_{H-1} = dphi/dx(x_H)

with A_k = d/dx [x + dt f(x, u)].

  * `costate_option=0`: C_k the full stage cost's state part (the
    Gaussian-weighted traversal term, the goal term and, when
    `w_bound_weight > 0`, the omega-box penalty): the exact multipliers.
  * `costate_option=1`: the reference's hand-rolled PMP recursion, which
    uses the goal path cost ONLY (it omits the traversal term); kept as it
    is, so that a consumer sees the reference's values.

A cold diagnostic, so plain autodiff: `torch.func.jacfwd` of the Euler step
and `torch.func.grad` of the costs, vmapped over the steps (and lanes), and
a reverse loop over the horizon.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacfwd, vmap

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.core.rotations import rodrigues_to_quat
from learningagileflight_se3_torch.costs.gate_costs import final_cost, goal_cost, traversal_cost
from learningagileflight_se3_torch.dynamics.quadrotor import euler_step


def make_costate_extractor(params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                           costate_option: int = 0):
    """costates(X, U, goal, tra_pos, tra_ang, t) -> lams.

    X (..., H+1, 13) is the optimal state trajectory, U (..., H, 4) its
    controls, goal / tra_pos / tra_ang (..., 3) and t (...); an optional
    leading batch axis runs every lane at once.  Row k of lams (..., H, 13)
    is the multiplier of the constraint x_{k+1} = x_k + dt f(x_k, u_k) for
    k = 0 .. H-2, and row H-1 is dphi/dx(x_H)."""
    H, dt = cfg.horizon, cfg.dt

    def stage_cost_x(x, k_w, goal, tra_pos, tra_quat):
        c = k_w * traversal_cost(x, tra_pos, tra_quat, weights) + goal_cost(x, goal, weights)
        if cfg.w_bound_weight > 0.0:
            viol = torch.clamp_min(torch.abs(x[10:13]) - cfg.w_bound, 0.0)
            c = c + cfg.w_bound_weight * torch.sum(viol**2)
        return c

    def one(X, U, goal, tra_pos, tra_ang, t):
        if cfg.quantize_t:
            t = torch.round(t * 10.0) / 10.0
        tra_quat = rodrigues_to_quat(tra_ang.to(X.dtype))
        ks = torch.arange(H, dtype=X.dtype, device=X.device)
        t_w = weights.tra_amp * torch.exp(-weights.tra_decay * (dt * ks - t) ** 2)
        A = vmap(jacfwd(lambda x, u: euler_step(x, u, dt, params)))(X[1:H], U[1:H])  # (H-1,13,13)
        if costate_option == 0:
            lx = vmap(grad(stage_cost_x), in_dims=(0, 0, None, None, None))(
                X[1:H], t_w[1:H], goal, tra_pos, tra_quat)
        else:
            lx = vmap(grad(lambda x: goal_cost(x, goal, weights)))(X[1:H])
        lam = grad(lambda x: final_cost(x, goal, weights))(X[H])
        rows = [lam]
        for k in reversed(range(H - 1)):
            lam = lx[k] + A[k].T @ lam
            rows.append(lam)
        return torch.stack(rows[::-1])

    def costates(X, U, goal, tra_pos, tra_ang, t):
        t = torch.as_tensor(t, dtype=X.dtype, device=X.device)
        if X.dim() == 2:
            return one(X, U, goal, tra_pos, tra_ang, t)
        return vmap(one)(X, U, goal, tra_pos, tra_ang, t)

    return costates
