"""Differentiable MPC: gradients of the solver's controls with respect to the
DNN-predicted traversal parameters theta = (tra_pos, tra_ang, t), batched.

Port of `learningagileflight_se3_tpu/solver/diff.py` (the implicit-function
VJP, `make_differentiable_control_solver_batched`, and the single-problem
`make_differentiable_control_solver` as a batch of one).  At the solver's
fixed point grad_U J(U*, theta) = 0, so dU*/dtheta = -H^{-1} J_{U theta}
with H the shooting Hessian.  The VJP theta_bar = -J_{theta U} H^{-1} U_bar
needs one solve with H, done exactly by one affine-LQR Riccati sweep over
the DDP stage quadratics with the Hamiltonian second-order terms; controls
on a bound are frozen (their dU/dtheta is 0 while the bound stays active).

The whole batch is swept at once (lanes are a leading axis), with the
closed-form derivatives of `solver/analytic.py` in place of the JAX
package's Taylor-tensor contractions.  The forward runs the batched solver
without a graph; nothing of the solver enters the backward's graph, only
U* as a leaf.  The batch needs no padding: the port's solver takes any size.
"""

from __future__ import annotations

import dataclasses

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.core.rotations import rodrigues_to_quat
from learningagileflight_se3_torch.costs.gate_costs import total_trajectory_cost
from learningagileflight_se3_torch.dynamics.quadrotor import euler_step, rollout
from learningagileflight_se3_torch.solver.analytic import (
    explicit_h2,
    explicit_jacobians,
    make_cost_quadratics,
    make_final_quadratics,
)

NX, NU = 13, 4
NZ = NX + NU

# In float32 this is below the ULP at u_ub = 2.44: the comparison runs in the
# controls' own dtype (the Python constant is cast to it, as JAX's weakly
# typed constants are), which decides which control dims are frozen.
_BOUND_EPS = 1e-7


def free_mask(U, cfg: SolverConfig):
    """Control dims off both bounds (bool), compared in U's dtype."""
    return (U > cfg.u_lb + _BOUND_EPS) & (U < cfg.u_ub - _BOUND_EPS)


def shooting_cost(U, x0, u_last, goal, tra_pos, tra_ang, t, dt, params, weights):
    """J(U, theta) per lane: U (B,H,4), x0 (B,13), ..., t (B,) -> (B,)."""
    X = rollout(x0, U, dt, params)
    return total_trajectory_cost(X, U, u_last, dt, t, goal, tra_pos,
                                 rodrigues_to_quat(tra_ang), weights)


def make_vjp_batched(params: QuadParams, weights: CostWeights, cfg: SolverConfig):
    """vjp(U (B,H,4), x0, u_last, goal, tra_pos, tra_ang, t, U_bar (B,H,4)) ->
    (goal_bar, tra_pos_bar, tra_ang_bar, t_bar): the implicit-function VJP of
    every lane at once."""
    H, dt = cfg.horizon, cfg.dt
    cost_quadratics = make_cost_quadratics(weights, cfg)
    final_quadratics = make_final_quadratics(weights)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    tr = lambda M: M.transpose(-1, -2)

    @torch.no_grad()
    def newton_direction(U, x0, u_last, goal, tra_pos, tra_ang, t, U_bar):
        """w = H^{-1} U_bar on the free dims, by the affine-LQR sweep."""
        dtype, device = U.dtype, U.device
        ks = torch.arange(H, dtype=dtype, device=device)
        t_w = weights.tra_amp * torch.exp(-weights.tra_decay * (dt * ks - t[:, None]) ** 2)
        zs = [torch.cat([x0, u_last], dim=-1)]
        for k in range(H):
            zs.append(torch.cat([euler_step(zs[-1][:, :NX], U[:, k], dt, params), U[:, k]], dim=-1))
        Z = torch.stack(zs, dim=1)                                   # (B,H+1,17)
        ZU = torch.cat([Z[:, :-1], U], dim=-1)
        A, Bm = explicit_jacobians(ZU, params, dt)
        lz, _, lzz, luz, luu = cost_quadratics(
            Z[:, :-1], U, t_w, goal[:, None], tra_pos[:, None],
            rodrigues_to_quat(tra_ang)[:, None])
        phi_z, phi_zz = final_quadratics(Z[:, H], goal)

        # costate entering the second-order dynamics term of step k
        lam, lam_next = phi_z, [None] * H
        for k in reversed(range(H)):
            lam_next[k] = lam
            lam = lz[:, k] + mv(tr(A[:, k]), lam)
        H2 = explicit_h2(ZU, torch.stack(lam_next, dim=1), params, dt)
        lzz = lzz + H2[..., :NZ, :NZ]
        luz = luz + H2[..., NZ:, :NZ]
        luu = luu + H2[..., NZ:, NZ:]

        free = free_mask(U, cfg).to(dtype)
        eye = torch.eye(NU, dtype=dtype, device=device)
        Vz, Vzz = torch.zeros_like(phi_z), phi_zz
        kk, KK = [None] * H, [None] * H
        for k in reversed(range(H)):
            a, b, f = A[:, k], Bm[:, k], free[:, k]
            Qz = mv(tr(a), Vz)
            Qu = U_bar[:, k] + mv(tr(b), Vz)
            Qzz = lzz[:, k] + tr(a) @ Vzz @ a
            Quz = luz[:, k] + tr(b) @ Vzz @ a
            Quu = luu[:, k] + tr(b) @ Vzz @ b
            M = Quu * (f[:, :, None] * f[:, None, :]) + torch.diag_embed(1.0 - f) + 1e-9 * eye
            # one LU solve for [Qu | Quz] (the JAX package solves the two apart)
            sol, _ = torch.linalg.solve_ex(M, torch.cat([(Qu * f)[..., None], Quz * f[..., None]], dim=-1))
            k_ff = -sol[..., 0] * f
            K = -sol[..., 1:] * f[..., None]
            Vz = Qz + mv(tr(K), Qu) + mv(tr(Quz), k_ff) + mv(tr(K), mv(Quu, k_ff))
            Vzz = Qzz + tr(K) @ Quz + tr(Quz) @ K + tr(K) @ Quu @ K
            Vzz = 0.5 * (Vzz + tr(Vzz))
            kk[k], KK[k] = k_ff, K
        dz = torch.zeros_like(phi_z)
        dU = []
        for k in range(H):
            du = kk[k] + mv(KK[k], dz)
            dz = mv(A[:, k], dz) + mv(Bm[:, k], du)
            dU.append(du)
        return -torch.stack(dU, dim=1)

    def vjp(U, x0, u_last, goal, tra_pos, tra_ang, t, U_bar):
        w = newton_direction(U, x0, u_last, goal, tra_pos, tra_ang, t, U_bar)
        # theta_bar = -grad_theta sum(w * grad_U J(U*, theta)); lanes are
        # independent, so the gradient of the batch sum is the per-lane stack
        with torch.enable_grad():
            theta = [a.detach().requires_grad_(True) for a in (goal, tra_pos, tra_ang, t)]
            U_leaf = U.detach().requires_grad_(True)
            J = shooting_cost(U_leaf, x0.detach(), u_last.detach(), *theta, dt, params, weights)
            (gU,) = torch.autograd.grad(J.sum(), U_leaf, create_graph=True)
            grads = torch.autograd.grad(torch.sum(w * gU), theta)
        return tuple(-g for g in grads)

    return vjp


class _DifferentiableSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, u_last, goal, tra_pos, tra_ang, t, solve, vjp):
        U = solve(x0, u_last, goal, tra_pos, tra_ang, t).control_traj
        ctx.save_for_backward(U, x0, u_last, goal, tra_pos, tra_ang, t)
        ctx.vjp = vjp
        return U

    @staticmethod
    def backward(ctx, U_bar):
        U, x0, u_last, goal, tra_pos, tra_ang, t = ctx.saved_tensors
        g_goal, g_tp, g_ta, g_t = ctx.vjp(U, x0, u_last, goal, tra_pos, tra_ang, t,
                                          U_bar.to(U.dtype))
        # x0 and u_last are scenario data, never learned: zero cotangents
        return (torch.zeros_like(x0), torch.zeros_like(u_last), g_goal, g_tp, g_ta, g_t,
                None, None)


def make_differentiable_control_solver_batched(params: QuadParams, weights: CostWeights,
                                               cfg: SolverConfig):
    """solve_u(x0 (B,13), u_last (B,4), goal (B,3), tra_pos (B,3),
    tra_ang (B,3), t (B,)) -> U* (B,H,4), differentiable in goal, tra_pos,
    tra_ang and t through the implicit-function VJP.

    The forward is one batched solve (the kernels for CUDA tensors) with
    quantize_t=False: the 0.1 s rounding has zero gradient, so t stays
    smooth."""
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    cfg = dataclasses.replace(cfg, quantize_t=False)
    solve = make_batched_mpc_solver(params, weights, cfg, return_gains=False)
    vjp = make_vjp_batched(params, weights, cfg)

    def solve_u(x0, u_last, goal, tra_pos, tra_ang, t):
        return _DifferentiableSolve.apply(x0, u_last, goal, tra_pos, tra_ang, t, solve, vjp)

    return solve_u


def make_differentiable_control_solver(params: QuadParams, weights: CostWeights, cfg: SolverConfig):
    """solve_u(x0 (13,), u_last (4,), goal (3,), tra_pos (3,), tra_ang (3,),
    t ()) -> U* (H,4), differentiable in goal, tra_pos, tra_ang and t: the
    batched differentiable solve on a batch of one (quantize_t=False)."""
    solve_b = make_differentiable_control_solver_batched(params, weights, cfg)

    def solve_u(x0, u_last, goal, tra_pos, tra_ang, t):
        t = torch.as_tensor(t, dtype=x0.dtype, device=x0.device)
        return solve_b(x0[None], u_last[None], goal[None], tra_pos[None], tra_ang[None], t.reshape(1))[0]

    return solve_u
