"""Policy layer: the reward through the batched MPC solve, and its two
learning signals for the RL stage.

Port of the batched signals of `learningagileflight_se3_tpu/policy.py`:

  * `make_fd_gradient_batched`: the reference's finite-difference signal,
    9 probe solves per scenario as ONE batched solve of 9 B lanes;
  * `make_analytic_gradient_batched`: one solve per scenario, with
    d reward / d(tra_pos, tra_ang, t) through the implicit-function VJP of
    `solver/diff.py`, shaped (by default) by the FD scheme's trust region.

Both take the JAX package's layout with the batch axis leading:
(x0 (B,13), u_last (B,4), goal (B,3), gate_pts (B,4,3), tra_pos (B,3),
tra_ang (B,3), t (B,)).  The single-problem signals and the policy searches
are not ported: a batch of one is the single problem.
"""

from __future__ import annotations

import torch

from learningagileflight_se3_torch.config import (
    CostWeights,
    LearnedGradConfig,
    QuadParams,
    RewardConfig,
    SolverConfig,
)
from learningagileflight_se3_torch.dynamics.quadrotor import rollout
from learningagileflight_se3_torch.geometry.collision import trajectory_reward


def _time_step(up, dn, like, grad_cfg: LearnedGradConfig):
    """+t_step where `up`, else -t_step where `dn`, else 0, in like's dtype."""
    zero = torch.zeros_like(like)
    return torch.where(up, zero + grad_cfg.t_step, torch.where(dn, zero - grad_cfg.t_step, zero))


def make_fd_gradient_batched(params: QuadParams, weights: CostWeights, solver_cfg: SolverConfig,
                             reward_cfg: RewardConfig,
                             grad_cfg: LearnedGradConfig = LearnedGradConfig()):
    """fd(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t) ->
    (neg_grad (B,7), reward (B,)), in the reference's [-dr/dx.., -dr/dt]
    convention.  The probes of each scenario are [base, +dx, +dy, +dz, +da,
    +db, +dc, t - t_probe, t + t_probe], scenario-major; differences are
    clipped to +-clip, positions scaled by pos_scale, angles by
    1/(ang_scale_a a^2 + ang_scale_b), and the time gradient is +-t_step by
    the reward threshold test, probe 8 (t + t_probe) before probe 7."""
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    bsolve = make_batched_mpc_solver(params, weights, solver_cfg, return_gains=False)
    H = solver_cfg.horizon

    def fd(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        B = x0.shape[0]
        eye = torch.eye(3, dtype=tra_pos.dtype, device=tra_pos.device) * grad_cfg.delta
        tp = torch.cat([tra_pos[:, None], tra_pos[:, None] + eye,
                        tra_pos[:, None].expand(B, 5, 3)], dim=1)
        ta = torch.cat([tra_ang[:, None].expand(B, 4, 3), tra_ang[:, None] + eye,
                        tra_ang[:, None].expand(B, 2, 3)], dim=1)
        ts = torch.cat([t[:, None].expand(B, 7), t[:, None] - grad_cfg.t_probe,
                        t[:, None] + grad_cfg.t_probe], dim=1)
        rep = lambda a: torch.repeat_interleave(a, 9, dim=0)
        sol = bsolve(rep(x0), rep(u_last), rep(goal), tp.reshape(B * 9, 3),
                     ta.reshape(B * 9, 3), ts.reshape(B * 9))
        X = sol.state_traj.reshape(B, 9, H + 1, 13)
        r, *_ = trajectory_reward(X, gate_pts[:, None].to(X.dtype), goal[:, None].to(X.dtype),
                                  reward_cfg, H)                     # (B,9)
        r0 = r[:, 0]
        diffs = torch.clamp(r[:, 1:7] - r0[:, None], -grad_cfg.clip, grad_cfg.clip)
        g_pos = diffs[:, 0:3] * grad_cfg.pos_scale
        g_ang = diffs[:, 3:6] / (grad_cfg.ang_scale_a * tra_ang**2 + grad_cfg.ang_scale_b)
        g_t = _time_step(r[:, 8] - r0 > grad_cfg.t_threshold,
                         r[:, 7] - r0 > grad_cfg.t_threshold, r0, grad_cfg)
        return -torch.cat([g_pos, g_ang, g_t[:, None]], dim=1), r0

    return fd


def make_rewards_batched(params: QuadParams, weights: CostWeights, solver_cfg: SolverConfig,
                         reward_cfg: RewardConfig):
    """rewards(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t) -> (B,): the
    analytic signal's reward (the differentiable solve's U*, rolled out),
    differentiable in tra_pos, tra_ang and t."""
    from learningagileflight_se3_torch.solver.diff import make_differentiable_control_solver_batched

    solve_u = make_differentiable_control_solver_batched(params, weights, solver_cfg)
    H = solver_cfg.horizon

    def rewards(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        U = solve_u(x0, u_last, goal, tra_pos, tra_ang, t)             # (B,H,4)
        X = rollout(x0.to(U.dtype), U, solver_cfg.dt, params)
        r, *_ = trajectory_reward(X, gate_pts.to(U.dtype), goal.to(U.dtype), reward_cfg, H)
        return r

    return rewards


def make_analytic_gradient_batched(params: QuadParams, weights: CostWeights,
                                   solver_cfg: SolverConfig, reward_cfg: RewardConfig,
                                   grad_cfg: LearnedGradConfig = LearnedGradConfig(),
                                   shaped: bool = True):
    """ana(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t) ->
    (ascent grad (B,7), reward (B,)).

    shaped=True passes the raw gradient through the FD scheme's trust
    region: per-coordinate clip of delta * grad at +-clip, the position and
    angle scales, and the +-t_step time rule on +-t_probe * g_t, the
    delta -> 0 limit of the FD signal at one solve instead of 9."""
    rewards = make_rewards_batched(params, weights, solver_cfg, reward_cfg)

    def analytic_gradient(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        with torch.enable_grad():
            theta = [a.detach().requires_grad_(True) for a in (tra_pos, tra_ang, t)]
            r = rewards(x0.detach(), u_last.detach(), goal.detach(), gate_pts.detach(), *theta)
            # each lane's reward depends only on its own theta, so the
            # gradient of the sum is the per-lane gradient stack
            g_tp, g_ta, g_t = torch.autograd.grad(r.sum(), theta)
        r = r.detach()
        if not shaped:
            return torch.cat([g_tp, g_ta, g_t[:, None]], dim=1), r
        d, c = grad_cfg.delta, grad_cfg.clip
        g_pos = torch.clamp(d * g_tp, -c, c) * grad_cfg.pos_scale
        g_ang = torch.clamp(d * g_ta, -c, c) / (grad_cfg.ang_scale_a * tra_ang**2
                                                 + grad_cfg.ang_scale_b)
        g_time = _time_step(grad_cfg.t_probe * g_t > grad_cfg.t_threshold,
                            -grad_cfg.t_probe * g_t > grad_cfg.t_threshold, g_t, grad_cfg)
        return torch.cat([g_pos, g_ang, g_time[:, None]], dim=1), r

    return analytic_gradient
