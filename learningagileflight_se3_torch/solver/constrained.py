"""The omega box by penalty continuation, over the batched solver.

Port of `learningagileflight_se3_tpu/solver/constrained.py`.  The reference
imposes omega in [-pi/2, pi/2] as hard state bounds of its lifted NLP; a
shooting solver cannot bound states, so the box enters as the quadratic
hinge penalty `w_bound_weight * sum(max(|omega| - w_bound, 0)^2)` that the
costs, the closed forms and both kernels carry (K1 `csrc/rollout.cu`, K2
`csrc/riccati_fused.cu`).  One fixed weight either distorts the solution
(too big) or leaves violation (too small), so this runs the classical
continuation: solve at rho_0, warm-start the rho_1 solve from it, and so
up the ladder.  Each stage is one batched solve of every lane.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

DEFAULT_LADDER: Sequence[float] = (10.0, 1e2, 1e3, 1e4, 1e5, 1e6)


def make_w_bounded_solver(params: QuadParams, weights: CostWeights, cfg: SolverConfig,
                          ladder: Sequence[float] = DEFAULT_LADDER, return_gains: bool = False):
    """solve(x0 (B,13), u_last, goal, tra_pos, tra_ang, t (B,), U_init=None,
    all_stages=False) with the omega box enforced to about 1/ladder[-1]
    violation: one batched solve at `w_bound_weight = rho` for each rho of
    the ladder, each warm-started from the last.  Returns the last stage's
    MPCSolution, or with `all_stages` the list of every stage's."""
    stages = [make_batched_mpc_solver(params, weights, replace(cfg, w_bound_weight=float(rho)),
                                      return_gains=return_gains)
              for rho in ladder]

    def solve(x0, u_last, goal, tra_pos, tra_ang, t, U_init=None, all_stages=False):
        sols, U = [], U_init
        for stage in stages:
            sols.append(stage(x0, u_last, goal, tra_pos, tra_ang, t, U_init=U))
            U = sols[-1].control_traj
        return sols if all_stages else sols[-1]

    return solve
