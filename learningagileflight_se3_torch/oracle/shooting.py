"""CPU float64 shooting oracle for the gate-traversal MPC (test-only).

Port of `learningagileflight_se3_tpu/oracle/shooting.py`.  Solves the same
shooting problem as the batched DDP solver with an algorithmically
independent method: scipy L-BFGS-B (quasi-Newton, the thrust box as bounds)
over the flattened control sequence.

The objective is the port's `total_trajectory_cost` in torch.float64 on the
CPU, on the rollout of the oracle's own numpy plant
(`oracle/numpy_reference.py`, the same forward-Euler model written
independently; it agrees with the port's `rollout` to rounding).  The
gradient comes from torch.autograd, composed by the adjoint recursion:
the cost's gradient in (X, U) and the step Jacobians [A_k, B_k] of the
port's `euler_step` (`oracle/derivatives.py`: one backward pass over the
horizon and the 13 output rows at once), then lam_k = dC/dx_k + A_k^T lam_{k+1} and
dJ/du_k = dC/du_k + B_k^T lam_{k+1}.  That is the chain rule autograd
applies when it backpropagates through the rollout, with the per-step
derivatives batched over the horizon: at H=50 one value and gradient takes
under an eighth of a backward pass through 50 eager torch steps
(`scripts/compare_oracles.py`), and L-BFGS-B asks for thousands of them.  No derivative
comes from `solver/analytic.py`, whose closed forms the solver's kernels
mirror.

The oracle computes on the host by design: it takes and returns numpy
arrays, has no `device` argument and never calls the solver under test.
It is a yardstick, not an entry point.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from scipy.optimize import minimize

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.core.rotations import rodrigues_to_quat
from learningagileflight_se3_torch.costs.gate_costs import total_trajectory_cost
from learningagileflight_se3_torch.dynamics.quadrotor import euler_step, rollout
from learningagileflight_se3_torch.oracle.derivatives import batched_jacobian
from learningagileflight_se3_torch.oracle.numpy_reference import np_rollout

F64 = torch.float64
NX, NU = 13, 4


def one_blas_thread():
    """A context in which the BLAS libraries run on one thread, where
    threadpoolctl is installed.  scipy's L-BFGS-B calls a threaded BLAS on
    vectors of a few hundred entries, and the idle threads spin, several
    cores for one: that starves whatever runs beside the oracle.  Elsewhere
    set OPENBLAS_NUM_THREADS=1 in the environment before the process
    starts."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        return contextlib.nullcontext()
    return threadpool_limits(1, user_api="blas")


def _f64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64)


def make_shooting_objective(params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                            x0, u_last, goal_pos, tra_pos, tra_quat, t):
    """fun(U_flat (H*4,) numpy) -> (cost, gradient (H*4,) numpy) of the
    shooting problem, with the solver's soft omega-box penalty when
    `cfg.w_bound_weight` is on.  The problem data are float64 tensors and
    `t` a float (already quantized where it should be)."""
    H, dt = cfg.horizon, cfg.dt
    x0_np = x0.numpy()
    t = torch.tensor(t, dtype=F64)

    def step(xu):
        return euler_step(xu[..., :NX], xu[..., NX:], dt, params)

    def fun(U_flat):
        U_np = np.asarray(U_flat, dtype=np.float64).reshape(H, NU)
        X = _f64(np_rollout(x0_np, U_np, dt, params)).requires_grad_()
        U = _f64(U_np).requires_grad_()
        c = total_trajectory_cost(X, U, u_last, dt, t, goal_pos, tra_pos, tra_quat, weights)
        if cfg.w_bound_weight > 0.0:
            # the solver's soft omega-box penalty (stages x_0..x_{H-1},
            # quadratic hinge), so both optimize the same objective
            viol = torch.clamp_min(X[:-1, 10:13].abs() - cfg.w_bound, 0.0)
            c = c + cfg.w_bound_weight * torch.sum(viol**2)
        gX, gU = (g.numpy() for g in torch.autograd.grad(c, (X, U)))
        AB = batched_jacobian(step, torch.cat([X.detach()[:-1], U.detach()], dim=1), NX).numpy()
        grad = np.empty((H, NU))
        lam = gX[H]
        for k in range(H - 1, -1, -1):
            grad[k] = gU[k] + lam @ AB[k, :, NX:]
            lam = gX[k] + lam @ AB[k, :, :NX]
        return float(c.detach()), grad.ravel()

    return fun


def solve_shooting_oracle(
    params: QuadParams,
    weights: CostWeights,
    cfg: SolverConfig,
    x0,
    u_last,
    goal_pos,
    tra_pos,
    tra_ang,
    t,
    U_init=None,
    maxiter: int = 2000,
):
    """Returns (X, U, cost, scipy_result), numpy float64."""
    H, dt = cfg.horizon, cfg.dt
    if cfg.quantize_t:
        t = round(float(t) * 10.0) / 10.0
    x0 = _f64(x0)
    fun = make_shooting_objective(params, weights, cfg, x0, _f64(u_last), _f64(goal_pos),
                                  _f64(tra_pos), rodrigues_to_quat(_f64(tra_ang)), float(t))

    if U_init is None:
        U0 = np.full((H, 4), 0.5 * (cfg.u_lb + cfg.u_ub))
    else:
        U0 = np.asarray(U_init, dtype=np.float64)

    with one_blas_thread():
        res = minimize(
            fun,
            U0.ravel(),
            jac=True,
            method="L-BFGS-B",
            bounds=[(cfg.u_lb, cfg.u_ub)] * (H * 4),
            options={"maxiter": maxiter, "ftol": 1e-16, "gtol": 1e-12, "maxcor": 30},
        )
    U = res.x.reshape(H, 4)
    with torch.no_grad():
        X = rollout(x0, _f64(U), dt, params).numpy()
    return X, U, float(res.fun), res
