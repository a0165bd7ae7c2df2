"""PyTorch port, the batched DDP solver.

On the CPU (plain versions of the kernels, float64): against the JAX batched
Pallas solver in interpret mode with the setup and gates of
tests/test_solver.py::TestBatchedPallasSolver; per-lane independence (rows
of a ragged batch of 100 equal those of a batch of 128); a batch of one
equal to row 0 of a batch of 8 in the converged regime; the runtime
iteration cap; the warm-start guard.  The kernel path is held against the
plain path on the card by tests/test_torch_gpu.py."""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.solver.ilqr_batched import make_batched_mpc_solver_pallas

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver


def _problems(rng, B):
    """tests/test_solver.py::TestBatchedPallasSolver scenarios."""
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = rng.uniform(-0.5, 0.5, size=(B, 3)) + [0, -3, 0]
    x0[:, 6] = 1.0
    u_last = np.zeros((B, 4))
    goal = rng.uniform(-0.5, 0.5, size=(B, 3)) + [0, 3, 0]
    tra_pos = rng.uniform(-0.2, 0.2, size=(B, 3))
    tra_ang = rng.normal(size=(B, 3)) * 0.1
    t = np.full(B, 0.3)
    return (x0, u_last, goal, tra_pos, tra_ang, t)


def _torch_args(args, device="cpu", dtype=torch.float64):
    return [torch.tensor(a, dtype=dtype, device=device) for a in args]


def _solver(**kw):
    return make_batched_mpc_solver(tcfg.QuadParams(), tcfg.CostWeights(), tcfg.SolverConfig(**kw))


def test_solver_matches_jax_pallas_interpret(rng):
    args = _problems(rng, 128)
    psolve = jax.jit(make_batched_mpc_solver_pallas(
        jcfg.QuadParams(), jcfg.CostWeights(), jcfg.SolverConfig(horizon=6, max_iters=12),
        interpret=True))
    ps = psolve(*[jnp.asarray(a) for a in args])
    ts = _solver(horizon=6, max_iters=12)(*_torch_args(args))
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(ps.iterations))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(ps.status))
    Jp = np.asarray(ps.cost)
    rel = np.abs(ts.cost.numpy() - Jp) / np.maximum(np.abs(Jp), 1.0)
    assert (rel < 5e-5).mean() >= 0.97, f"cost-agreeing lanes {(rel < 5e-5).mean():.2%}"
    assert rel.max() < 1e-2, f"cost diverged beyond 1%: {rel.max()}"
    dU = np.abs(ts.control_traj.numpy() - np.asarray(ps.control_traj)).max(axis=(1, 2))
    assert (dU < 1e-6).mean() >= 0.95, f"control-agreeing lanes {(dU < 1e-6).mean():.2%}"
    assert ts.state_traj.shape == (128, 7, 13) and ts.control_traj.shape == (128, 6, 4)


def test_ragged_batch_rows_equal_full_batch_rows(rng):
    """Per-lane independence without the TPU's multiple-of-128 rule: rows
    0..99 of a 128-lane solve equal a 100-lane solve of the same rows."""
    args = _problems(rng, 128)
    solve = _solver(horizon=6, max_iters=12)
    s128 = solve(*_torch_args(args))
    s100 = solve(*_torch_args([a[:100] for a in args]))
    for name in ("control_traj", "state_traj", "cost", "iterations", "status",
                 "converged", "grad_norm", "reg_final"):
        a, b = getattr(s100, name), getattr(s128, name)[:100]
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_batch_of_one_equals_row0_of_batch8():
    """Converged regime of tests/test_solver.py::TestBatchedSolver."""
    x0 = np.zeros(13)
    x0[0:3] = [0.3, -8.0, 0.2]
    x0[6] = 1.0
    args1 = (x0[None], np.zeros((1, 4)), np.array([[0.1, 6.0, -0.2]]), np.zeros((1, 3)),
             np.array([[0.0, 0.2, 0.0]]), np.array([2.0]))
    args8 = [np.tile(a, (8,) + (1,) * (a.ndim - 1)) for a in args1]
    solve = _solver(horizon=10, max_iters=80)
    s1, s8 = solve(*_torch_args(args1)), solve(*_torch_args(args8))
    assert bool(s1.converged[0]) and bool(s8.converged[0])
    np.testing.assert_allclose(s8.control_traj[0].numpy(), s1.control_traj[0].numpy(), atol=1e-7)
    U8 = s8.control_traj.numpy()
    np.testing.assert_array_equal(U8.min(axis=0), U8.max(axis=0))


def test_runtime_max_iters_gains_and_warm_start_guard(rng):
    args = _torch_args([a[:16] for a in _problems(rng, 16)])
    solve = make_batched_mpc_solver(tcfg.QuadParams(), tcfg.CostWeights(),
                                    tcfg.SolverConfig(horizon=6, max_iters=12), return_gains=True)
    s = solve(*args, max_iters=3)
    assert int(s.iterations.max()) <= 3 and s.gains_K.shape == (16, 6, 4, 17)
    cold = solve(*args)
    # a warm start whose rollout cost is not finite is replaced by the
    # midpoint init (K1 clips the controls, so a NaN is what poisons it)
    U_bad = torch.full((16, 6, 4), float("nan"), dtype=torch.float64)
    guarded = solve(*args, U_init=U_bad)
    torch.testing.assert_close(guarded.control_traj, cold.control_traj, rtol=0, atol=0)
    # a sane warm start is kept: restarting from the solution stays near it
    warm = solve(*args, U_init=cold.control_traj)
    assert float((warm.cost - cold.cost).max()) <= 1e-9 * float(cold.cost.abs().max())
