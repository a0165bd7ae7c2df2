"""Batched control-limited DDP for the gate-traversal MPC: public entry.

Port of the batched entry of `learningagileflight_se3_tpu/solver/ilqr.py`.
The single-problem solver of the JAX package is not ported: a batch of one
is the single solve.  The solve runs on the device its tensors lie on (the
kernels for CUDA tensors, their plain versions for CPU tensors).
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
