"""The port's single-problem entry `solver/ilqr.py::make_mpc_solver` (a
batch of one through the batched solver) against a lane of the batch and
against the JAX package's single-problem solver, and the exported accuracy
scenarios against the JAX sampler."""

import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.solver.ilqr import make_mpc_solver as j_make_mpc_solver

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver, make_mpc_solver
from learningagileflight_se3_torch.utils.weights import accuracy_scenarios

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def canonical_args():
    """tests/test_oracle_lifted.py's canonical problem at t = 1.0."""
    x0 = np.zeros(13)
    x0[0:3] = [0.0, -8.0, 0.0]
    x0[6] = 1.0
    return (x0, np.zeros(4), np.array([0.0, 8.0, 0.0]), np.zeros(3), np.array([0.0, 0.6, 0.0]), 1.0)


def test_single_solve_equals_its_lane_of_a_batch(rng):
    """Each of three problems solved alone equals its lane of the batch of
    three, cold and warm-started, in f64 (the lanes are independent)."""
    cfg = tcfg.SolverConfig(horizon=8, max_iters=25)
    solve1 = make_mpc_solver(tcfg.QuadParams(), tcfg.CostWeights(), cfg, device="cpu")
    solveB = make_batched_mpc_solver(tcfg.QuadParams(), tcfg.CostWeights(), cfg, return_gains=True)
    x0 = np.zeros((3, 13))
    x0[:, 0:3] = rng.uniform(-1, 1, (3, 3)) + [0.0, -4.0, 0.0]
    x0[:, 6] = 1.0
    args = [x0, rng.uniform(0, 1, (3, 4)), rng.uniform(-1, 1, (3, 3)) + [0.0, 4.0, 0.0],
            np.zeros((3, 3)), rng.uniform(-0.4, 0.4, (3, 3)) * [0, 1, 0], np.array([1.0, 1.3, 0.8])]
    args = [torch.as_tensor(a, dtype=F64) for a in args]
    U_warm = torch.as_tensor(rng.uniform(0.8, 1.6, (3, 8, 4)), dtype=F64)
    for U_init in (None, U_warm):
        batch = solveB(*args, U_init=U_init)
        for i in range(3):
            one = solve1(*[a[i] for a in args], U_init=None if U_init is None else U_init[i])
            assert one.state_traj.shape == (9, 13) and one.gains_K.shape == (8, 4, 17)
            for name in ("state_traj", "control_traj", "cost", "iterations", "converged", "gains_K",
                         "grad_norm", "reg_final", "status"):
                torch.testing.assert_close(getattr(one, name), getattr(batch, name)[i], rtol=0, atol=1e-12,
                                           msg=name)


def test_single_solve_matches_jax_h15():
    """The canonical problem at H=15 in f64, cold: the port's
    make_mpc_solver and the JAX package's reach the same optimum."""
    kw = dict(horizon=15, max_iters=300, w_bound=float("inf"))
    args = canonical_args()
    ref = jax.jit(j_make_mpc_solver(jcfg.QuadParams(), jcfg.CostWeights(), jcfg.SolverConfig(**kw),
                                    return_gains=False))(*[jnp.asarray(a) for a in args])
    got = make_mpc_solver(tcfg.QuadParams(), tcfg.CostWeights(), tcfg.SolverConfig(**kw), return_gains=False,
                          device="cpu")(*args)
    assert bool(got.converged) and bool(ref.converged)
    assert got.gains_K.shape == (0,)
    np.testing.assert_allclose(got.control_traj.numpy(), np.asarray(ref.control_traj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.state_traj.numpy(), np.asarray(ref.state_traj), rtol=0, atol=1e-6)
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-9 * abs(float(ref.cost))


def test_accuracy_scenarios_match_jax_sampler():
    """weights/accuracy_scenarios.npz is what scripts/export_accuracy_scenarios.py
    draws with the JAX package now (PRNGKey(7), 8 a cell)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from export_accuracy_scenarios import accuracy_scenarios as sample
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    want, got = sample(), accuracy_scenarios()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["x0"].shape == (32, 13) and set(got["u_ub"]) == {2.44, 2.4}
    assert list(got["variant"][::8]) == ["main", "main", "pybullet_bounds", "pybullet_bounds"]
    assert list(got["regime"][::8]) == ["nominal", "aggressive", "nominal", "aggressive"]
