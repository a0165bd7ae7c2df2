"""PyTorch port, the parallel-in-time Riccati sweep (cfg.backward="parallel").

On the CPU in float64, against the JAX package on the same numpy inputs:

  * `_combine` against the JAX `_combine` on seeded elements (1e-12);
  * `make_parallel_backward` against the JAX one, vmapped over the lanes,
    on the same derivative tuples: random trajectories of `ops/inputs.py`,
    with lanes forced to fail the pivot test; the port's batch-last tuple is
    split into JAX's per-lane layout (kk, KK, dV1, dV2 within 1e-9
    relative, fail equal);
  * the one-iteration identity of tests/test_parallel_riccati.py (reg 0,
    box +-50, no DDP term): the port's parallel solve against its sequential
    solve (K2's plain version) and against
    `jax.vmap(make_mpc_solver(backward="parallel"))`;
  * a short solve: finite, and the iterations and exit status of the JAX
    single-problem solver, vmapped;
  * the two `ValueError`s of `solver/ilqr.py`;
  * (slow) the full solve lands at the sequential sweep's optimum, the
    mirror of test_full_solve_same_optimum.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.models.sampler import sample_scenarios as jsample, scenario_to_problem
from learningagileflight_se3_tpu.solver import parallel_riccati as jpr
from learningagileflight_se3_tpu.solver.ilqr import make_mpc_solver

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.ops.inputs import as_tensors, backward_inputs, with_failing_lanes
from learningagileflight_se3_torch.ops.riccati_unfused import derivatives_plain, projected_gradient
from learningagileflight_se3_torch.solver import parallel_riccati as tpr
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

NZ = 17
P_T, W_T = tcfg.QuadParams(), tcfg.CostWeights()
P_J, W_J = jcfg.QuadParams(), jcfg.CostWeights()


def rel(a, b):
    """max |a-b| / (|b| + 1e-2) over entries finite in both; NaN patterns equal."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    both = np.isfinite(a) & np.isfinite(b)
    return float(np.max(np.abs(a[both] - b[both]) / (np.abs(b[both]) + 1e-2), initial=0.0))


def _elements(rng, n):
    """n seeded, well-conditioned (A, b, C, eta, J): C and J symmetric PSD."""
    A = rng.normal(size=(n, NZ, NZ)) * 0.3 + np.eye(NZ)
    L = rng.normal(size=(n, NZ, 4)) * 0.3
    M = rng.normal(size=(n, NZ, NZ)) * 0.2
    return (A, rng.normal(size=(n, NZ)), L @ L.transpose(0, 2, 1), rng.normal(size=(n, NZ)),
            M @ M.transpose(0, 2, 1) + 0.1 * np.eye(NZ))


def test_combine_matches_jax():
    rng = np.random.default_rng(0)
    ei, ej = _elements(rng, 6), _elements(rng, 6)
    got = tpr._combine([torch.tensor(x) for x in ei], [torch.tensor(x) for x in ej])
    want = jpr._combine(tuple(jnp.asarray(x) for x in ei), tuple(jnp.asarray(x) for x in ej))
    for name, g, w in zip("A b C eta J".split(), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12, err_msg=name)


def test_suffix_scan_equals_sequential_composition():
    """The Hillis-Steele scan over 11 elements (not a power of two) gives
    every suffix e_k o ... o e_10, each composed one element at a time."""
    rng = np.random.default_rng(1)
    elems = [torch.tensor(x).reshape((2, 11) + x.shape[1:]) for x in _elements(rng, 22)]
    out = tpr.suffix_scan(elems)
    for k in range(11):
        acc = [x[:, 10] for x in elems]
        for j in range(9, k - 1, -1):
            acc = tpr._combine([x[:, j] for x in elems], acc)
        for g, w in zip(out, acc):
            np.testing.assert_allclose(g[:, k].numpy(), w.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed,failing", [(0, []), (4, [1, 3])])
def test_parallel_backward_matches_jax(seed, failing):
    H, B = 8, 5
    cfg_t = tcfg.SolverConfig(horizon=H, use_ddp=False)
    k2 = as_tensors(backward_inputs(H, B, seed=seed))
    d = derivatives_plain(*k2, P_T, W_T, cfg_t)
    if failing:
        d = with_failing_lanes(d, failing, cfg_t.u_lb, cfg_t.u_ub)
    A, Bm, lz, lu, lzz, luz, luu, U, ZU, phi_z, phi_zz, reg = d
    pg = projected_gradient(A, Bm, lz, lu, U, phi_z, cfg_t.u_lb, cfg_t.u_ub)
    derivs = (A, Bm, lz, lu, lzz, luz, luu, phi_z, phi_zz, ZU, pg)
    kk, KK, dV1, dV2, fail, pg_out = tpr.make_parallel_backward(cfg_t, cfg_t.u_lb, cfg_t.u_ub)(
        derivs, U, reg[0])
    assert kk.shape == (H, 4, B) and KK.shape == (H, 4, NZ, B) and pg_out is pg

    # JAX's per-lane layout: batch-last -> one tuple per lane, vmapped
    lanes = lambda x: jnp.asarray(x.movedim(-1, 0).numpy())
    jback = jpr.make_parallel_backward(jcfg.SolverConfig(horizon=H, use_ddp=False), 0.0, 2.44)
    want = jax.jit(jax.vmap(jback))(tuple(lanes(x) for x in derivs), lanes(U), jnp.asarray(reg[0].numpy()))
    kk_j, KK_j, dV1_j, dV2_j, fail_j, _ = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(fail.numpy(), fail_j)
    assert fail.numpy()[failing].all() and (failing or not fail.any())
    assert rel(kk.movedim(-1, 0), kk_j) < 1e-9
    assert rel(KK.movedim(-1, 0), KK_j) < 1e-9
    assert rel(dV1, dV1_j) < 1e-9 and rel(dV2, dV2_j) < 1e-9


def _problems(n, seed):
    """tests/test_parallel_riccati.py::_solve_pair's scenarios (the JAX
    sampler's), as numpy."""
    scen = jsample(jax.random.PRNGKey(seed), n)
    probs = jax.vmap(scenario_to_problem)(scen)
    x0 = np.asarray(probs["x0"])
    t = np.clip(np.linalg.norm(x0[:, 0:3], axis=1) / 4.0, 2.0, 4.0)
    return [x0, np.zeros((n, 4)), np.asarray(probs["goal_pos"]), np.zeros((n, 3)), np.zeros((n, 3)), t]


def _port(args, **kw):
    solve = make_batched_mpc_solver(P_T, W_T, tcfg.SolverConfig(**kw))
    return solve(*[torch.tensor(a) for a in args])


def _jax(args, **kw):
    solve = jax.jit(jax.vmap(make_mpc_solver(P_J, W_J, jcfg.SolverConfig(**kw), return_gains=False)))
    return solve(*[jnp.asarray(a) for a in args])


def test_first_iteration_identical_unconstrained():
    """reg 0, bounds inactive, no DDP term: the first parallel sweep gives
    the sequential sweep's gains, so the 1-iteration solve is the same, in
    the port and in the JAX package."""
    kw = dict(horizon=16, max_iters=1, use_ddp=False, u_lb=-50.0, u_ub=50.0,
              reg_init=0.0, reg_min=0.0, tol=1e-12, gtol=1e-12)
    args = _problems(4, seed=3)
    par = _port(args, backward="parallel", **kw)
    seq = _port(args, backward="sequential", **kw)
    jpar = _jax(args, backward="parallel", **kw)
    for other in (seq.control_traj.numpy(), np.asarray(jpar.control_traj)):
        np.testing.assert_allclose(par.control_traj.numpy(), other, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(par.cost.numpy(), seq.cost.numpy(), rtol=1e-10)
    np.testing.assert_allclose(par.cost.numpy(), np.asarray(jpar.cost), rtol=1e-10)


def test_short_solve_finite_and_matches_jax_iterations():
    """A short parallel solve (H=12, 5 iterations) is finite and takes the
    iterations and exit of the JAX solver: a path that lost the true
    projected gradient would never meet the KKT exit."""
    kw = dict(horizon=12, max_iters=5, use_ddp=False, backward="parallel")
    args = _problems(3, seed=9)
    par = _port(args, **kw)
    jpar = _jax(args, **kw)
    assert torch.isfinite(par.control_traj).all() and torch.isfinite(par.cost).all()
    np.testing.assert_array_equal(par.iterations.numpy(), np.asarray(jpar.iterations))
    np.testing.assert_array_equal(par.status.numpy(), np.asarray(jpar.status))
    np.testing.assert_allclose(par.cost.numpy(), np.asarray(jpar.cost), rtol=1e-8)
    np.testing.assert_allclose(par.grad_norm.numpy(), np.asarray(jpar.grad_norm), rtol=1e-6, atol=1e-9)


def test_parallel_refuses_ddp_and_unknown_backward():
    with pytest.raises(ValueError, match="cannot honor use_ddp=True"):
        make_batched_mpc_solver(P_T, W_T, tcfg.SolverConfig(backward="parallel", use_ddp=True))
    with pytest.raises(ValueError, match="unknown cfg.backward: 'diagonal'"):
        make_batched_mpc_solver(P_T, W_T, tcfg.SolverConfig(backward="diagonal"))


@pytest.mark.slow
def test_full_solve_same_optimum():
    """Box-constrained, regularized problem (tests/test_parallel_riccati.py's
    scenarios and settings): the port's parallel solve equals the JAX
    package's on every lane and converges; the two sweeps may take different
    paths but land at the same optimum: within 1% where the sequential
    solve converged, and not above a sequential solve that stopped at the
    iteration cap (still descending) by more than 1%.  On these scenarios
    the port's sequential solve of lane 3 stops at the cap at 18349.50,
    1.2% above both parallel solves (18131.71) and the JAX sequential
    solve (18131.68, converged): the batched and the single-problem
    sequential solvers part at a tie there."""
    kw = dict(horizon=30, max_iters=60, tol=1e-9, gtol=1e-7, use_ddp=False)
    args = _problems(4, seed=3)
    seq = _port(args, backward="sequential", **kw)
    par = _port(args, backward="parallel", **kw)
    jpar = _jax(args, backward="parallel", **kw)
    Js, Jp = seq.cost.numpy(), par.cost.numpy()
    assert np.all(np.isfinite(Jp))
    assert par.converged.all(), "parallel mode did not converge"
    np.testing.assert_allclose(Jp, np.asarray(jpar.cost), rtol=1e-8)
    np.testing.assert_array_equal(par.status.numpy(), np.asarray(jpar.status))
    relc = (Jp - Js) / np.maximum(np.abs(Js), 1.0)
    capped = seq.status.numpy() == 0
    assert np.all(np.abs(relc[~capped]) < 1e-2), f"cost mismatch: {relc}"
    assert np.all(relc[capped] < 1e-2), f"parallel above a capped sequential solve: {relc}"
