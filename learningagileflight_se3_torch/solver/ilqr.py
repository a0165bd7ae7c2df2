"""Batched control-limited DDP for the gate-traversal MPC: public entry.

Port of the entries of `learningagileflight_se3_tpu/solver/ilqr.py`: the
batched solver, and `make_mpc_solver`, the single-problem solve as a batch
of one through it.  The batched solve runs on the device its tensors lie on
(the kernels for CUDA tensors, their plain versions for CPU tensors); the
single-problem solve on the card unless given device="cpu".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig


class MPCSolution(NamedTuple):
    """Solver output, leading batch axis on every per-lane field."""

    state_traj: torch.Tensor    # (B, H+1, 13)
    control_traj: torch.Tensor  # (B, H, 4)
    cost: torch.Tensor          # (B,)
    iterations: torch.Tensor    # (B,) int32
    converged: torch.Tensor     # (B,) bool: any terminal exit with a sane cost
    gains_K: torch.Tensor       # (B, H, 4, 17) when return_gains, else (0,)
    grad_norm: torch.Tensor     # (B,) max projected |Q_u| (KKT residual proxy)
    reg_final: torch.Tensor     # (B,) final regularization
    ls_evals: torch.Tensor      # () lock-step line-search trips over the solve
    # exit reason per lane:
    #   0 = hit the iteration cap (still descending)
    #   1 = stationary (true KKT: decrement + projected gradient)
    #   2 = stalled (failed search at high reg, near-optimal gradient)
    #   3 = progress-window floor (no cost motion for a full window)
    #   4 = regularization blowout
    status: torch.Tensor        # (B,) int32


def make_batched_mpc_solver(params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                            return_gains: bool = False):
    """solve(x0[B,13], u_last[B,4], goal[B,3], tra_pos[B,3], tra_ang[B,3],
    t[B], U_init=None|[B,H,4], max_iters=None) -> MPCSolution."""
    from learningagileflight_se3_torch.solver.ilqr_batched import make_batched_solver

    return make_batched_solver(params, weights, cfg, return_gains=return_gains)


def make_mpc_solver(params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                    return_gains: bool = True, device="cuda", dtype=torch.float64):
    """The single-problem solver: solve(x0[13], u_last[4], goal_pos[3],
    tra_pos[3], tra_ang[3], t, U_init=None|[H,4]) -> MPCSolution with no
    batch axis (`gains_K` (H, 4, 17) when return_gains, else (0,)).

    A batch of one through the batched solver.  The inputs (tensors, arrays
    or lists) are moved to `device` in `dtype`: the card unless the caller
    passes device="cpu", and without a card the default raises here.  The
    JAX package's single-problem solver is another code path under the same
    rules (a `lax.while_loop` of its own); the port has one solver."""
    from learningagileflight_se3_torch.utils.device import resolve_device

    like = dict(dtype=dtype, device=resolve_device(device))
    solve_batch = make_batched_mpc_solver(params, weights, cfg, return_gains=return_gains)

    def solve(x0, u_last, goal_pos, tra_pos, tra_ang, t, U_init=None):
        one = lambda a: torch.as_tensor(a, **like)[None]  # noqa: E731
        sol = solve_batch(one(x0), one(u_last), one(goal_pos), one(tra_pos), one(tra_ang),
                          one(t), None if U_init is None else one(U_init))
        lane = {k: v[0] for k, v in sol._asdict().items() if k not in ("gains_K", "ls_evals")}
        gains = sol.gains_K[0] if return_gains else sol.gains_K
        return MPCSolution(gains_K=gains, ls_evals=sol.ls_evals, **lane)

    return solve
