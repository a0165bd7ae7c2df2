"""PyTorch port, the side solvers on the batched solver.

On the CPU, against the JAX package on the same numpy inputs (float64):
`goal_cost` with and without a goal attitude and velocity; the omega-box
penalty continuation; both costate options on one converged trajectory; the
two NN-free policy searches (the JAX draws handed to the port's LSFD); and
the single-problem interfaces (`make_get_input`, `make_fd_gradient`,
`make_analytic_gradient`, `make_differentiable_control_solver`), each a
batch of one in the port.  The JAX side solves single problems (vmapped
where it probes), the port one batched solve; the two share their rules, so
on these scenarios every decision falls the same way.  Tolerances are
stated in each test."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu import policy as jpolicy
from learningagileflight_se3_tpu.costs import gate_costs as jcosts
from learningagileflight_se3_tpu.geometry.gate import gate_from_width as jgate_from_width
from learningagileflight_se3_tpu.solver.constrained import make_w_bounded_solver as jw_bounded
from learningagileflight_se3_tpu.solver.costate import make_costate_extractor as jcostates
from learningagileflight_se3_tpu.solver.diff import make_differentiable_control_solver as jdiff
from learningagileflight_se3_tpu.solver.ilqr import make_mpc_solver

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch import policy as tpolicy
from learningagileflight_se3_torch.costs import gate_costs as tcosts
from learningagileflight_se3_torch.solver.constrained import make_w_bounded_solver
from learningagileflight_se3_torch.solver.costate import make_costate_extractor
from learningagileflight_se3_torch.solver.diff import make_differentiable_control_solver


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def jcfgs(**kw):
    return jcfg.QuadParams(), jcfg.CostWeights(), jcfg.SolverConfig(**kw), jcfg.RewardConfig()


def tcfgs(**kw):
    return tcfg.QuadParams(), tcfg.CostWeights(), tcfg.SolverConfig(**kw), tcfg.RewardConfig()


def scenario():
    """tests/test_costate_policy_search.py's scenario: (x0, u_last, goal,
    tra_pos, tra_ang, t)."""
    x0 = np.zeros(13)
    x0[0:3] = [0.5, -6.0, 0.2]
    x0[6] = 1.0
    return x0, np.zeros(4), np.array([0.0, 6.0, 0.0]), np.array([0.0, 0.1, 0.0]), np.array([0.0, 0.4, 0.0]), 2.0


def spinning():
    """A start spinning beyond the omega box (|omega| up to 3 rad/s against
    pi/2), so that the penalty acts from the first step."""
    x0, u_last, goal, tra_pos, tra_ang, _ = scenario()
    x0 = x0.copy()
    x0[0:3] = [0.3, -3.0, 0.1]
    x0[10:13] = [3.0, -2.5, 1.0]
    return x0, u_last, goal, tra_pos, tra_ang, 0.6


def same_grid_point(t, ref):
    """The same point of the 0.1 s grid.  Both sides round t * 10 half to
    even; XLA then multiplies by 0.1 where the port divides by 10, so JAX's
    grid value can be one ulp above k / 10 (1.2000000000000002 for k = 12)."""
    k = round(float(ref) * 10)
    return abs(float(ref) * 10 - k) < 1e-9 and float(t) == k / 10.0


def well_posed():
    """tests/test_diff_mpc.py's tight fixed-point scenario (a gate 2 m
    ahead), t = 0.5: every probe of the fd signal ends stationary."""
    x0 = np.zeros(13)
    x0[0:3] = [0.3, -2.0, 0.4]
    x0[6], x0[9] = np.cos(0.025), np.sin(0.025)
    return x0, np.zeros(4), np.array([0.2, 2.0, -0.1]), np.array([0.0, 0.0, 0.1]), np.array([0.05, 0.4, -0.03]), 0.5


# ------------------------------------------------------------- goal_cost
def test_goal_cost_matches_jax_with_and_without_goal_attitude_and_velocity():
    """Seeded states; neither argument, goal_vel alone and both (wqf on, so
    goal_q counts): within 1e-13 of JAX; the defaults equal the port's
    former closed form v . v bit for bit."""
    r = np.random.default_rng(0)
    X = r.normal(size=(16, 13))
    X[:, 6:10] /= np.linalg.norm(X[:, 6:10], axis=1, keepdims=True)
    goal, gv = r.normal(size=3), r.normal(size=3)
    gq = r.normal(size=4)
    gq /= np.linalg.norm(gq)
    for wq in (0.0, 2.5):
        jw, tw = jcfg.CostWeights(wqf=wq, wvf=0.7), tcfg.CostWeights(wqf=wq, wvf=0.7)
        for kw in ({}, dict(goal_vel=gv), dict(goal_q=gq, goal_vel=gv)):
            ref = np.array([float(jcosts.goal_cost(jnp.asarray(x), jnp.asarray(goal), jw,
                                                   **{k: jnp.asarray(v) for k, v in kw.items()}))
                            for x in X])
            got = tcosts.goal_cost(t64(X), t64(goal), tw, **{k: t64(v) for k, v in kw.items()})
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=1e-13)
        x = t64(X)
        former = (tw.wrf * torch.sum((x[:, 0:3] - t64(goal)) ** 2, dim=-1)
                  + tw.wvf * torch.sum(x[:, 3:6] ** 2, dim=-1) + tw.wwf * torch.sum(x[:, 10:13] ** 2, dim=-1))
        if wq == 0.0:
            assert torch.equal(tcosts.goal_cost(x, t64(goal), tw), former)


# ---------------------------------------------------- omega-box continuation
def test_w_bounded_solver_matches_jax():
    """H=12, the two-rung ladder (10, 1e3), a start beyond the box: the last
    stage's cost within 1e-8 relative and controls within 1e-6 of JAX's
    continuation (single solves); `all_stages` returns both rungs, the last
    the same, and the box violation falls from the first to the second."""
    kw = dict(horizon=12, max_iters=80)
    args = spinning()
    P, W, C, _ = jcfgs(**kw)
    ref = jax.jit(jw_bounded(P, W, C, ladder=(10.0, 1e3)))(*[jnp.asarray(a) for a in args])
    tP, tW, tC, _ = tcfgs(**kw)
    targs = [t64(a)[None] for a in args]
    got = make_w_bounded_solver(tP, tW, tC, ladder=(10.0, 1e3))(*targs)
    rel = abs(float(got.cost[0]) - float(ref.cost)) / abs(float(ref.cost))
    assert rel <= 1e-8, rel
    np.testing.assert_allclose(got.control_traj[0].numpy(), np.asarray(ref.control_traj), atol=1e-6, rtol=0)
    first, last = make_w_bounded_solver(tP, tW, tC, ladder=(10.0, 1e3))(*targs, all_stages=True)
    assert torch.equal(last.control_traj, got.control_traj)
    viol = lambda X: float(torch.clamp_min(X[..., 10:13].abs() - tC.w_bound, 0.0).max())
    assert viol(got.state_traj) < viol(first.state_traj)


# ------------------------------------------------------------- costates
@pytest.mark.parametrize("option,w_bound_weight", [(0, 0.0), (0, 50.0), (1, 0.0)])
def test_costates_match_jax(option, w_bound_weight):
    """Both options (option 0 also with the omega penalty on) on one
    converged trajectory of the JAX solver, passed to both: within 1e-10;
    the batched form equals the single one row for row (1e-12 of the
    largest entry: the vmapped products reassociate)."""
    kw = dict(horizon=12, max_iters=60, w_bound_weight=w_bound_weight)
    x0, u_last, goal, tra_pos, tra_ang, t = spinning() if w_bound_weight else scenario()
    P, W, C, _ = jcfgs(**kw)
    sol = jax.jit(make_mpc_solver(P, W, C, return_gains=False))(
        *[jnp.asarray(a) for a in (x0, u_last, goal, tra_pos, tra_ang, t)])
    X, U = np.asarray(sol.state_traj), np.asarray(sol.control_traj)
    ref = jcostates(P, W, C, option)(jnp.asarray(X), jnp.asarray(U), jnp.asarray(goal), jnp.asarray(tra_pos),
                                     jnp.asarray(tra_ang), jnp.asarray(t))
    tP, tW, tC, _ = tcfgs(**kw)
    extract = make_costate_extractor(tP, tW, tC, option)
    got = extract(t64(X), t64(U), t64(goal), t64(tra_pos), t64(tra_ang), t)
    assert got.shape == (12, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-10, rtol=1e-10)
    two = extract(*[torch.stack([t64(a), t64(a)]) for a in (X, U, goal, tra_pos, tra_ang, t)])
    torch.testing.assert_close(two[1], got, atol=1e-12 * float(got.abs().max()), rtol=0)


# --------------------------------------------------------- policy searches
def test_policy_search_matches_jax():
    """H=10, 3 iterations from the gate centroid: reward history within 1e-6
    relative, the final t the same grid point, tra_pos / tra_ang within 1e-6."""
    kw = dict(horizon=10, max_iters=30)
    x0, u_last, goal, *_ = scenario()
    pts = np.asarray(jgate_from_width(jnp.asarray(0.9), jnp.asarray(0.45)))
    P, W, C, R = jcfgs(**kw)
    ref = jax.jit(jpolicy.make_policy_search(P, W, C, R, jcfg.LearnedGradConfig(), iters=3))(
        jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal), jnp.asarray(pts), jnp.zeros(3), 1.5)
    tP, tW, tC, tR = tcfgs(**kw)
    got = tpolicy.make_policy_search(tP, tW, tC, tR, tcfg.LearnedGradConfig(), iters=3)(
        t64(x0), t64(u_last), t64(goal), t64(pts), torch.zeros(3, dtype=torch.float64), 1.5)
    np.testing.assert_allclose(got.reward_hist.numpy(), np.asarray(ref.reward_hist), rtol=1e-6)
    assert same_grid_point(got.t, ref.t)
    np.testing.assert_allclose(got.tra_pos.numpy(), np.asarray(ref.tra_pos), atol=1e-6)
    np.testing.assert_allclose(got.tra_ang.numpy(), np.asarray(ref.tra_ang), atol=1e-6)


def test_lsfd_search_matches_jax():
    """H=10, 2 iterations of 24 samples, the JAX draws (split of PRNGKey(0),
    then normal (24, 6) each) passed as `noise`: reward history within 1e-6
    relative, the final t the same grid point, tra_pos / tra_ang within
    1e-6; a seeded
    generator in place of `noise` runs and stays on the 0.1 s grid."""
    kw = dict(horizon=10, max_iters=30)
    x0, u_last, goal, *_ = scenario()
    pts = np.asarray(jgate_from_width(jnp.asarray(1.0), jnp.asarray(0.3)))
    P, W, C, R = jcfgs(**kw)
    key = jax.random.PRNGKey(0)
    ref = jax.jit(jpolicy.make_lsfd_search(P, W, C, R, iters=2))(
        key, jnp.asarray(x0), jnp.asarray(u_last), jnp.asarray(goal), jnp.asarray(pts), jnp.zeros(3), 1.5)
    noise = np.stack([np.asarray(jax.random.normal(k, (24, 6), jnp.float64))
                      for k in jax.random.split(key, 2)])
    tP, tW, tC, tR = tcfgs(**kw)
    search = tpolicy.make_lsfd_search(tP, tW, tC, tR, iters=2)
    args = (t64(x0), t64(u_last), t64(goal), t64(pts), torch.zeros(3, dtype=torch.float64), 1.5)
    got = search(*args, noise=noise)
    np.testing.assert_allclose(got.reward_hist.numpy(), np.asarray(ref.reward_hist), rtol=1e-6)
    assert same_grid_point(got.t, ref.t)
    np.testing.assert_allclose(got.tra_pos.numpy(), np.asarray(ref.tra_pos), atol=1e-6)
    np.testing.assert_allclose(got.tra_ang.numpy(), np.asarray(ref.tra_ang), atol=1e-6)
    drawn = search(*args, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn.reward_hist).all() and drawn.reward_hist.shape == (2,)
    assert abs(float(drawn.t) * 10 - round(float(drawn.t) * 10)) < 1e-9


# --------------------------------------------------- single-problem wrappers
def test_single_problem_interfaces_match_jax():
    """The well-posed scenario, H=10, max_iters=60, tol=1e-11:
    make_get_input (cold, then warm-started from the cold solution) ends
    with the same exit on both sides, cost within 1e-12 relative and
    controls within 1e-8; make_fd_gradient's signal and reward within 1e-6;
    make_analytic_gradient equal to the batched signal's row (which
    tests/test_torch_train.py holds against JAX); the VJP of
    make_differentiable_control_solver within 1e-6 relative.  (On a problem
    the horizon cannot reach, e.g. the policy-search scenario at t = 1,
    some of the 9 fd probes run to the cap and the three solvers, the JAX
    single and batched ones and the port's, stop in different places.)"""
    kw = dict(horizon=10, max_iters=60, tol=1e-11)
    x0, u_last, goal, tra_pos, tra_ang, t = well_posed()
    pts = np.asarray(jgate_from_width(jnp.asarray(0.9), jnp.asarray(0.45)))
    P, W, C, R = jcfgs(**kw)
    tP, tW, tC, tR = tcfgs(**kw)
    j = [jnp.asarray(a) for a in (x0, u_last, goal, pts, tra_pos, tra_ang, t)]
    a = [t64(v) for v in (x0, u_last, goal, pts, tra_pos, tra_ang, t)]

    jget, tget = jax.jit(jpolicy.make_get_input(P, W, C)), tpolicy.make_get_input(tP, tW, tC)
    ju, jsol = jget(j[0], j[1], j[4], j[5], j[6], j[2])
    tu, tsol = tget(a[0], a[1], a[4], a[5], a[6], a[2])
    assert int(jsol.status) == int(tsol.status[0]) and bool(tsol.converged[0])
    assert abs(float(tsol.cost[0]) - float(jsol.cost)) <= 1e-12 * abs(float(jsol.cost))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-8, rtol=0)
    np.testing.assert_allclose(tsol.control_traj[0].numpy(), np.asarray(jsol.control_traj), atol=1e-8, rtol=0)
    ju2, _ = jget(j[0], j[1], j[4], j[5], j[6], j[2], U_init=jsol.control_traj)
    tu2, _ = tget(a[0], a[1], a[4], a[5], a[6], a[2], U_init=tsol.control_traj[0])
    np.testing.assert_allclose(tu2.numpy(), np.asarray(ju2), atol=1e-8, rtol=0)

    jg, jr = jax.jit(jpolicy.make_fd_gradient(P, W, C, R))(*j)
    tg, tr = tpolicy.make_fd_gradient(tP, tW, tC, tR)(*a)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    assert abs(float(tr) - float(jr)) <= 1e-6 * max(abs(float(jr)), 1.0)

    # the analytic signal is the batched one on a batch of one (held against
    # JAX by tests/test_torch_train.py); its solve's VJP is held below
    tg, tr = tpolicy.make_analytic_gradient(tP, tW, tC, tR)(*a)
    bg, br = tpolicy.make_analytic_gradient_batched(tP, tW, tC, tR)(*[v[None] for v in a])
    assert torch.equal(tg, bg[0]) and torch.equal(tr, br[0])

    weights = np.random.default_rng(1).normal(size=(10, 4))
    loss = lambda U, w: (U * w).sum()
    jsolve = jdiff(P, W, C)
    jgrads = jax.grad(lambda tp, ta, tt: loss(jsolve(j[0], j[1], j[2], tp, ta, tt), jnp.asarray(weights)),
                      argnums=(0, 1, 2))(j[4], j[5], j[6])
    tsolve = make_differentiable_control_solver(tP, tW, tC)
    theta = [v.clone().requires_grad_(True) for v in (a[4], a[5], a[6])]
    U = tsolve(a[0], a[1], a[2], *theta)
    assert U.shape == (10, 4)
    tgrads = torch.autograd.grad(loss(U, t64(weights)), theta)
    for g, r in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-9)


def test_continuation_inputs_are_the_last_stage():
    """ops/inputs.py continuation_inputs (the card test's and the smoke's
    inputs) captures K2's and K1's inputs of the ladder's last stage
    (w_bound_weight 1e6) at the asked DDP iteration, batch-last; `perturbed`
    moves them by about 1e-15 relative and no more."""
    from learningagileflight_se3_torch.ops.inputs import continuation_inputs, perturbed

    sol, got = continuation_inputs(6, 5, max_iters=4, k2_call=2)
    (k2, k2_model, _), (k1, k1_model, _) = got["K2"], got["K1"]
    assert k2_model[2].w_bound_weight == 1e6 and k1_model[2].w_bound_weight == 1e6
    assert k2[0].shape == (6, 21, 5) and k1[3].shape == (6, 4, 17, 5)
    assert sol.control_traj.shape == (5, 6, 4)
    for a, b in zip(perturbed(k2), k2):
        assert torch.allclose(a, b, rtol=1e-14, atol=0) and (a.shape, a.dtype) == (b.shape, b.dtype)
    assert any(not torch.equal(a, b) for a, b in zip(perturbed(k2), k2))
