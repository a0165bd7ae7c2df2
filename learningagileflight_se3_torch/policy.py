"""Policy layer: the reward through the batched MPC solve, its two learning
signals for the RL stage, and the NN-free policy searches.

Port of `learningagileflight_se3_tpu/policy.py`:

  * `make_objective`: one batched solve, then the trajectory reward;
  * `make_fd_gradient_batched`: the reference's finite-difference signal,
    9 probe solves per scenario as ONE batched solve of 9 B lanes;
  * `make_analytic_gradient_batched`: one solve per scenario, with
    d reward / d(tra_pos, tra_ang, t) through the implicit-function VJP of
    `solver/diff.py`, shaped (by default) by the FD scheme's trust region;
  * `make_fd_gradient`, `make_analytic_gradient`, `make_get_input`: the
    single-problem interfaces, each a batch of one;
  * `make_policy_search`, `make_lsfd_search`: gradient ascent over the 7
    decision variables of one scenario, each iteration's probes one batched
    objective (where the JAX package vmaps single solves).

The batched functions take the JAX package's layout with the batch axis
leading: (x0 (B,13), u_last (B,4), goal (B,3), gate_pts (B,4,3),
tra_pos (B,3), tra_ang (B,3), t (B,)).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


class ObjectiveResult(NamedTuple):
    """The objective's per-lane results, leading batch axis."""

    reward: torch.Tensor
    collision: torch.Tensor
    path: torch.Tensor
    inside_gate: torch.Tensor
    state_traj: torch.Tensor
    control_traj: torch.Tensor
    solver_iterations: torch.Tensor
    solver_converged: torch.Tensor


def make_objective(params: QuadParams, weights: CostWeights, solver_cfg: SolverConfig,
                   reward_cfg: RewardConfig):
    """objective(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t, U_init=None)
    -> ObjectiveResult: one batched solve, the trajectories mapped to rotor
    tips, collision + terminal path scored and combined."""
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    solve = make_batched_mpc_solver(params, weights, solver_cfg, return_gains=False)
    H = solver_cfg.horizon

    def objective(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t, U_init=None):
        sol = solve(x0, u_last, goal, tra_pos, tra_ang, t, U_init=U_init)
        X = sol.state_traj
        reward, collision, path, inside = trajectory_reward(
            X, gate_pts.to(X.dtype), goal.to(X.dtype), reward_cfg, H)
        return ObjectiveResult(reward=reward, collision=collision, path=path, inside_gate=inside,
                               state_traj=X, control_traj=sol.control_traj,
                               solver_iterations=sol.iterations, solver_converged=sol.converged)

    return objective


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


def _one(*args):
    """Each argument with a leading batch axis of one."""
    return [torch.as_tensor(a)[None] for a in args]


def make_fd_gradient(params: QuadParams, weights: CostWeights, solver_cfg: SolverConfig,
                     reward_cfg: RewardConfig, grad_cfg: LearnedGradConfig = LearnedGradConfig()):
    """fd_gradient(x0 (13,), u_last, goal, gate_pts (4,3), tra_pos, tra_ang, t)
    -> (neg_grad (7,), reward ()): `make_fd_gradient_batched` on a batch of
    one, its 9 probes one solve."""
    fd = make_fd_gradient_batched(params, weights, solver_cfg, reward_cfg, grad_cfg)

    def fd_gradient(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        g, r = fd(*_one(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t))
        return g[0], r[0]

    return fd_gradient


def make_analytic_gradient(params: QuadParams, weights: CostWeights, solver_cfg: SolverConfig,
                           reward_cfg: RewardConfig,
                           grad_cfg: LearnedGradConfig = LearnedGradConfig(), shaped: bool = True):
    """analytic_gradient(x0 (13,), u_last, goal, gate_pts (4,3), tra_pos,
    tra_ang, t) -> (ascent grad (7,), reward ()): the batched analytic
    signal on a batch of one."""
    ana = make_analytic_gradient_batched(params, weights, solver_cfg, reward_cfg, grad_cfg, shaped)

    def analytic_gradient(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t):
        g, r = ana(*_one(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t))
        return g[0], r[0]

    return analytic_gradient


def make_get_input(params: QuadParams, weights: CostWeights, solver_cfg: SolverConfig):
    """get_input(x0 (13,), u_last, tra_pos, tra_ang, t, goal, U_init=None|(H,4))
    -> (u0 (4,), sol): one solve (a batch of one) and its first control, the
    receding-horizon convention; `sol` keeps the batch axis of one.  Pass the
    previous solution's controls as U_init to warm-start."""
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    solve = make_batched_mpc_solver(params, weights, solver_cfg, return_gains=False)

    def get_input(x0, u_last, tra_pos, tra_ang, t, goal, U_init: Optional[torch.Tensor] = None):
        sol = solve(*_one(x0, u_last, goal, tra_pos, tra_ang, t),
                    U_init=None if U_init is None else U_init[None])
        return sol.control_traj[0, 0], sol

    return get_input


class PolicySearchResult(NamedTuple):
    """A policy search's result (the reference's run_quad.optimize list)."""

    t: torch.Tensor            # final traversal time ()
    tra_pos: torch.Tensor      # (3,)
    tra_ang: torch.Tensor      # (3,) Rodrigues
    reward: torch.Tensor       # last evaluated base reward ()
    collision: torch.Tensor
    path: torch.Tensor
    reward_hist: torch.Tensor  # (iters,) each iteration's base reward


def _hover(solver_cfg: SolverConfig, like):
    return torch.full((solver_cfg.horizon, 4), 0.5 * (solver_cfg.u_lb + solver_cfg.u_ub),
                      dtype=like.dtype, device=like.device)


def _round_t(t):
    """To the 0.1 s grid (half to even, as jnp.round)."""
    return torch.round(t * 10.0) / 10.0


def make_policy_search(params: QuadParams, weights: CostWeights, solver_cfg: SolverConfig,
                       reward_cfg: RewardConfig, grad_cfg: LearnedGradConfig = LearnedGradConfig(),
                       iters: int = 200, warm_start: bool = True):
    """search(x0 (13,), u_last, goal, gate_pts (4,3), tra_pos0 (3,), t0) ->
    PolicySearchResult: FD gradient ascent over (tra_pos, tra_ang, t) from
    tra_pos0, zero rotation and t0.  Per iteration:

      * 9 probes [base, pos + d e_i, ang + d e_i, t - t_probe, t + t_probe],
        one batched objective, every probe warm-started (with `warm_start`)
        from the previous base solution's controls; differences clipped to
        +-clip;
      * steps 0.1 (position) and 1/(ang_scale_a a_i^2 + ang_scale_b) (angles);
      * t moves -t_probe if that probe improves the reward by more than
        t_threshold, else +t_probe if that one does, then rounds to 0.1 s.

    The loop runs on the device of x0 with no fetch of its own; the reward
    history stays there until the end."""
    objective = make_objective(params, weights, solver_cfg, reward_cfg)
    c = grad_cfg

    def search(x0, u_last, goal, gate_pts, tra_pos0, t0):
        x0 = torch.as_tensor(x0)
        dtype, device = x0.dtype, x0.device
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        tra_pos, tra_ang, t = as_t(tra_pos0), torch.zeros(3, dtype=dtype, device=device), as_t(t0)
        rep = lambda a: as_t(a)[None].expand((9,) + as_t(a).shape)
        eye = torch.eye(3, dtype=dtype, device=device) * c.delta
        U_warm = _hover(solver_cfg, x0)
        hist, res = [], None
        for _ in range(iters):
            tp = torch.cat([tra_pos[None], tra_pos[None] + eye, tra_pos[None].expand(5, 3)])
            ta = torch.cat([tra_ang[None].expand(4, 3), tra_ang[None] + eye, tra_ang[None].expand(2, 3)])
            ts = torch.cat([t[None].expand(7), (t - c.t_probe)[None], (t + c.t_probe)[None]])
            res = objective(rep(x0), rep(u_last), rep(goal), rep(gate_pts), tp, ta, ts,
                            U_init=U_warm[None].expand(9, -1, -1))
            r = res.reward
            j = r[0]
            diffs = torch.clamp(r[1:7] - j, -c.clip, c.clip)
            tra_pos = tra_pos + 0.1 * diffs[0:3]
            tra_ang = tra_ang + diffs[3:6] / (c.ang_scale_a * tra_ang**2 + c.ang_scale_b)
            t = torch.where(r[7] - j > c.t_threshold, t - c.t_probe,
                            torch.where(r[8] - j > c.t_threshold, t + c.t_probe, t))
            t = _round_t(t)
            if warm_start:
                U_warm = res.control_traj[0]
            hist.append(j)
        return PolicySearchResult(t=t, tra_pos=tra_pos, tra_ang=tra_ang, reward=hist[-1],
                                  collision=res.collision[0], path=res.path[0],
                                  reward_hist=torch.stack(hist))

    return search


def make_lsfd_search(params: QuadParams, weights: CostWeights, solver_cfg: SolverConfig,
                     reward_cfg: RewardConfig, iters: int = 50, n_samples: int = 24,
                     deviation: float = 1e-3, warm_start: bool = True):
    """search(x0 (13,), u_last, goal, gate_pts (4,3), tra_pos0 (3,), t0,
    generator=None, noise=None) -> PolicySearchResult: least-squares
    finite-difference ascent over the 6 pose parameters.  Per iteration:

      * the base and `n_samples` perturbations deviation * N(0,1) of the pose
        (`noise[i]`, shape (n_samples, 6), or drawn from `generator`), one
        batched objective warm-started from the previous base solution;
      * the gradient by least squares, solve(dx^T dx, dx^T f), and a step of
        lr [2e-4 x3, 5e-5 x3];
      * the base re-evaluated at the updated pose with the time probes
        [t, t + 0.1, t - 0.1] (one batched objective); t moves +0.1 if that
        improves the reward by more than 20, else -0.1 if that does, then
        rounds to 0.1 s.

    `noise` (iters, n_samples, 6) holds the standard normal draws where the
    caller made them; else they are drawn from `generator` on its device."""
    objective = make_objective(params, weights, solver_cfg, reward_cfg)

    def search(x0, u_last, goal, gate_pts, tra_pos0, t0, generator=None, noise=None):
        x0 = torch.as_tensor(x0)
        dtype, device = x0.dtype, x0.device
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        if noise is None:
            noise = torch.randn((iters, n_samples, 6), generator=generator, dtype=dtype,
                                device=generator.device)
        noise = as_t(noise)
        lr = as_t([2e-4, 2e-4, 2e-4, 5e-5, 5e-5, 5e-5])
        rep = lambda a, n: as_t(a)[None].expand((n,) + as_t(a).shape)
        para = torch.cat([as_t(tra_pos0), torch.zeros(3, dtype=dtype, device=device)])
        t = as_t(t0)
        U_warm = _hover(solver_cfg, x0)
        n = n_samples + 1
        hist, res2 = [], None
        for i in range(iters):
            dx = deviation * noise[i]
            probes = torch.cat([para[None], para[None] + dx])
            res = objective(rep(x0, n), rep(u_last, n), rep(goal, n), rep(gate_pts, n),
                            probes[:, 0:3], probes[:, 3:6], t[None].expand(n),
                            U_init=U_warm[None].expand(n, -1, -1))
            f = res.reward[1:] - res.reward[0]
            g = torch.linalg.solve(dx.T @ dx, dx.T @ f)
            para = para + lr * g
            ts = torch.stack([t, t + 0.1, t - 0.1])
            res2 = objective(rep(x0, 3), rep(u_last, 3), rep(goal, 3), rep(gate_pts, 3),
                             rep(para[0:3], 3), rep(para[3:6], 3), ts,
                             U_init=U_warm[None].expand(3, -1, -1))
            j = res2.reward[0]
            t = torch.where(res2.reward[1] - j > 20.0, t + 0.1,
                            torch.where(res2.reward[2] - j > 20.0, t - 0.1, t))
            t = _round_t(t)
            if warm_start:
                U_warm = res2.control_traj[0]
            hist.append(j)
        return PolicySearchResult(t=t, tra_pos=para[0:3], tra_ang=para[3:6], reward=hist[-1],
                                  collision=res2.collision[0], path=res2.path[0],
                                  reward_hist=torch.stack(hist))

    return search
