"""PyTorch port, the learning signal and stage-2 training.

On the CPU, against the JAX package on the same numpy inputs (float64
unless stated):

  * collision score and trajectory reward, including no crossing, a start on
    the far side, all four sectors, inside and outside the gate (rtol
    1e-12), and the NaN pattern of the reward's gradient;
  * Euler rollout, rotor positions and the shooting cost (rtol 1e-12);
  * rodrigues_to_quat's first and second derivatives at zero rotation;
  * the implicit-function VJP with the same U* and U_bar, lanes pinned at
    both bounds (rtol 1e-8), and its float32 clamp mask;
  * the batched analytic (shaped, unshaped) and FD signals (rtol 1e-8)
    and one RL step in both modes with a NaN row (float32 Adam: rtol 1e-5,
    atol 1e-6), the JAX side on the batched Pallas solver in interpret
    mode (the solver the TPU path runs; on the CPU `backend="auto"` would
    pick the vmapped single-problem solver);
  * the cosine schedule and Adam against optax; resume equal to an
    uninterrupted run; the exported DNN1 weights against the orbax
    checkpoints through JAX's `model.apply`.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.core import rotations as jrot
from learningagileflight_se3_tpu.dynamics import quadrotor as jdyn
from learningagileflight_se3_tpu.geometry import collision as jcol
from learningagileflight_se3_tpu.models import mlp as jmlp
from learningagileflight_se3_tpu.models.sampler import scenario_to_problem as jscenario_to_problem
from learningagileflight_se3_tpu.solver import diff as jdiff
from learningagileflight_se3_tpu.solver import ilqr as jilqr
from learningagileflight_se3_tpu.solver.ilqr_batched import make_batched_mpc_solver_pallas

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.core import rotations as trot
from learningagileflight_se3_torch.costs import gate_costs as tcost
from learningagileflight_se3_torch.dynamics import quadrotor as tdyn
from learningagileflight_se3_torch.geometry import collision as tcol
from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem
from learningagileflight_se3_torch.solver import diff as tdiff
from learningagileflight_se3_torch.utils import weights as tweights

TIGHT = dict(rtol=1e-12, atol=1e-12)
TINY = dict(horizon=6, max_iters=8)
PQ_J, CW_J, RC_J = jcfg.QuadParams(), jcfg.CostWeights(), jcfg.RewardConfig()
PQ_T, CW_T, RC_T = tcfg.QuadParams(), tcfg.CostWeights(), tcfg.RewardConfig()
GATE = np.array([[-0.6, 0, 1.0], [0.6, 0, 1.0], [0.6, 0, -1.0], [-0.6, 0, -1.0]])


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **(kw or TIGHT))


def pitched(pts, angle):
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return pts @ R.T


def line(p0, p1, n=21):
    return np.linspace(p0, p1, n)


# ------------------------------------------------------------- collision
# straight tip paths (from, to), through or past the gate plane y = 0
PATHS = {
    "center": ([0.05, -3, 0.1], [0.05, 3, 0.1]),
    "near_edge": ([0.45, -3, 0], [0.45, 3, 0]),
    "outside_right": ([1.5, -3, 0], [1.5, 3, 0]),
    "outside_left": ([-1.5, -3, 0.2], [-1.5, 3, 0.2]),
    "outside_top": ([0.1, -3, 1.7], [0.1, 3, 1.7]),
    "outside_bottom": ([-0.1, -3, -1.8], [-0.1, 3, -1.8]),
    "outside_corner": ([1.2, -3, 1.5], [1.0, 3, 1.3]),
    "slanted": ([-2.0, -3, -1.0], [2.0, 3, 1.2]),
    "no_crossing": ([0, -3, 0], [0, -1, 0]),
    "started_far": ([0, 3, 0], [0, -3, 0]),
}


@pytest.mark.parametrize("angle", [0.0, 0.7])
def test_collision_score_cases_match_jax(angle):
    gate = pitched(GATE, angle)
    trajs = np.stack([line(*PATHS[k]) for k in PATHS])              # (n, 21, 3)
    H = trajs.shape[1] - 1
    got, got_in = tcol.collision_score(t64(gate), t64(trajs), H, 0.2)
    want, want_in = jax.vmap(lambda tr: jcol.collision_score(jnp.asarray(gate), tr, H, 0.2))(
        jnp.asarray(trajs))
    close(got, want)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    names = list(PATHS)
    assert float(got[names.index("no_crossing")]) == 0.0
    assert float(got[names.index("started_far")]) == 0.0
    if angle == 0.0:
        assert float(got[names.index("center")]) == 0.0 and bool(got_in[names.index("center")])
        assert not bool(got_in[names.index("outside_right")])


def test_collision_score_covers_all_sectors():
    """The four sectors (top, right, bottom, left of the centroid) each
    decide some crossing of the random set, and every one agrees with JAX."""
    rng = np.random.default_rng(3)
    n = 64
    p0 = rng.uniform(-2.5, 2.5, (n, 3)) + [0, -4, 0]
    p1 = rng.uniform(-2.5, 2.5, (n, 3)) + [0, 4, 0]
    trajs = np.stack([line(a, b, 26) for a, b in zip(p0, p1)])
    got, got_in = tcol.collision_score(t64(GATE), t64(trajs), 25, 0.2)
    want, want_in = jax.vmap(lambda tr: jcol.collision_score(jnp.asarray(GATE), tr, 25, 0.2))(
        jnp.asarray(trajs))
    close(got, want)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    # the crossing point's sector, as the reference classifies it
    cross = trajs[np.arange(n), np.argmax(trajs[:, :, 1] >= 0, axis=1)]
    x, z = cross[:, 0], cross[:, 2]
    sectors = {"top": (z > 0) & (np.abs(x) < 0.6 * z), "bottom": (z < 0) & (np.abs(x) < -0.6 * z),
               "right": (x > 0) & (np.abs(z) < x / 0.6), "left": (x < 0) & (np.abs(z) < -x / 0.6)}
    assert all(s.any() for s in sectors.values()), {k: int(v.sum()) for k, v in sectors.items()}
    assert got_in.any() and (~got_in).any()


def _states(rng, B, H):
    X = np.zeros((B, H + 1, 13))
    X[:, :, 0:3] = line(np.c_[rng.uniform(-1, 1, B), np.full(B, -3.0), rng.uniform(-1, 1, B)],
                        np.c_[rng.uniform(-1, 1, B), np.full(B, 3.0), rng.uniform(-1, 1, B)],
                        H + 1).transpose(1, 0, 2)
    q = rng.normal(size=(B, H + 1, 4)) * 0.3
    q[..., 0] += 1.0
    X[:, :, 6:10] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    X[:, :, 3:6] = rng.normal(size=(B, H + 1, 3))
    return X


def test_trajectory_reward_and_its_gradient_match_jax():
    """Reward terms on seeded trajectories, with one that never reaches the
    gate: its value is finite (masked) and its gradient NaN in both."""
    rng = np.random.default_rng(5)
    B, H = 12, 15
    X = _states(rng, B, H)
    X[0, :, 1] = np.linspace(-3, -1, H + 1)  # no crossing
    gates = np.stack([pitched(GATE * rng.uniform(0.8, 1.2), rng.uniform(-0.8, 0.8)) for _ in range(B)])
    goal = rng.normal(size=(B, 3)) + [0, 4, 0]
    out = tcol.trajectory_reward(t64(X), t64(gates), t64(goal), RC_T, H)
    ref = jax.vmap(lambda x, g, gl: jcol.trajectory_reward(x, g, gl, RC_J, H))(
        jnp.asarray(X), jnp.asarray(gates), jnp.asarray(goal))
    for a, b in zip(out[:3], ref[:3]):
        close(a, b)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))

    Xt = t64(X).requires_grad_(True)
    g_t, = torch.autograd.grad(tcol.trajectory_reward(Xt, t64(gates), t64(goal), RC_T, H)[0].sum(), Xt)
    g_j = jax.jit(jax.grad(lambda x: jnp.sum(jax.vmap(
        lambda xi, g, gl: jcol.trajectory_reward(xi, g, gl, RC_J, H)[0])(x, jnp.asarray(gates),
                                                                       jnp.asarray(goal)))))(jnp.asarray(X))
    g_t, g_j = g_t.numpy(), np.asarray(g_j)
    np.testing.assert_array_equal(np.isnan(g_t), np.isnan(g_j))
    assert np.isnan(g_t[0]).any() and np.isfinite(g_t[1:]).all()
    ok = np.isfinite(g_j)
    np.testing.assert_allclose(g_t[ok], g_j[ok], rtol=1e-10, atol=1e-9)


# --------------------------------------------------------- dynamics, costs
def test_rollout_rotor_positions_and_shooting_cost_match_jax():
    rng = np.random.default_rng(7)
    B, H = 6, 12
    x0 = _states(rng, B, 0)[:, 0]
    x0[:, 10:13] = rng.normal(size=(B, 3)) * 0.3
    U = rng.uniform(0.0, 2.44, size=(B, H, 4))
    X = tdyn.rollout(t64(x0), t64(U), 0.1, PQ_T)
    Xj = jax.vmap(lambda x, u: jdyn.rollout(x, u, 0.1, PQ_J))(jnp.asarray(x0), jnp.asarray(U))
    close(X, Xj)
    tips = tdyn.rotor_positions(X, 1.5)
    tips_j = jax.vmap(jax.vmap(lambda x: jdyn.rotor_positions(x, 1.5)))(Xj)
    close(tips, tips_j)
    u_last, goal, tp = rng.uniform(0, 2, (B, 4)), rng.normal(size=(B, 3)), rng.normal(size=(B, 3))
    ta, t = rng.normal(size=(B, 3)) * 0.4, rng.uniform(0.2, 1.0, B)
    for squared in (True, False):
        wt, wj = tcfg.CostWeights(squared_attitude=squared), jcfg.CostWeights(squared_attitude=squared)
        J = tdiff.shooting_cost(t64(U), t64(x0), t64(u_last), t64(goal), t64(tp), t64(ta), t64(t),
                                0.1, PQ_T, wt)
        Jj = jax.vmap(lambda *a: jdiff._shooting_cost(*a, 0.1, PQ_J, wj))(
            *[jnp.asarray(a) for a in (U, x0, u_last, goal, tp, ta, t)])
        close(J, Jj)
        Jc = tcost.total_trajectory_cost(X, t64(U), t64(u_last), 0.1, t64(t), t64(goal), t64(tp),
                                         trot.rodrigues_to_quat(t64(ta)), wt)
        close(Jc, Jj)


def test_rodrigues_to_quat_derivatives_at_zero():
    w0 = np.zeros(3)
    J = torch.autograd.functional.jacobian(trot.rodrigues_to_quat, t64(w0))
    Hs = torch.stack([torch.autograd.functional.hessian(lambda w: trot.rodrigues_to_quat(w)[i], t64(w0))
                      for i in range(4)])
    J_j = jax.jacfwd(jrot.rodrigues_to_quat)(jnp.asarray(w0))
    H_j = jax.hessian(jrot.rodrigues_to_quat)(jnp.asarray(w0))
    assert torch.isfinite(J).all() and torch.isfinite(Hs).all()
    close(J, J_j)
    close(Hs, H_j)
    close(J, np.vstack([np.zeros(3), np.eye(3)]))


# ------------------------------------------------------------------- VJP
def test_vjp_matches_jax_with_pinned_lanes():
    rng = np.random.default_rng(13)
    B, H = 8, 6
    cfg_j, cfg_t = jcfg.SolverConfig(horizon=H), tcfg.SolverConfig(horizon=H)
    x0 = np.zeros((B, 13))
    x0[:, 0:3] = rng.uniform(-1, 1, (B, 3)) + [0, -3, 0]
    x0[:, 6] = 1.0
    U = rng.uniform(0.3, 2.2, (B, H, 4))
    U[0, :, 1] = 0.0          # pinned at u_lb
    U[1, 2:, 3] = 2.44        # pinned at u_ub
    U[2, 0] = [0.0, 2.44, 0.0, 2.44]
    args = [U, x0, rng.uniform(0, 2, (B, 4)), rng.normal(size=(B, 3)) + [0, 3, 0],
            rng.normal(size=(B, 3)) * 0.3, rng.normal(size=(B, 3)) * 0.3, rng.uniform(0.2, 0.5, B),
            rng.normal(size=(B, H, 4))]
    want = jax.jit(jax.vmap(jdiff._make_vjp_kernel(PQ_J, CW_J, cfg_j)))(*[jnp.asarray(a) for a in args])
    got = tdiff.make_vjp_batched(PQ_T, CW_T, cfg_t)(*[t64(a) for a in args])
    for g, w in zip(got, want[2:]):
        close(g, w, rtol=1e-8, atol=1e-10)


def test_clamp_mask_in_float32_matches_jax():
    """In float32 the bound eps is below the ULP at u_ub: the mask is decided
    in the controls' dtype, as JAX's weakly typed constants decide it."""
    ub = 2.44
    vals = np.array([0.0, 1e-7, 2e-7, 1e-8, 0.5, np.nextafter(np.float32(ub), 0), np.float32(ub),
                     np.float32(ub) - np.float32(2.4e-7), 2.4399998, 2.44000001], np.float32)
    got = tdiff.free_mask(torch.tensor(vals), tcfg.SolverConfig()).numpy()
    want = np.asarray((jnp.asarray(vals) > 0.0 + jdiff._BOUND_EPS)
                      & (jnp.asarray(vals) < ub - jdiff._BOUND_EPS))
    assert jnp.asarray(vals).dtype == jnp.float32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ signals, RL step
_SOLVERS = {}


def _pallas_interpret_batched(params, weights, cfg, return_gains=False, backend="auto"):
    """Stand-in for the JAX package's make_batched_mpc_solver: the Pallas
    solver in interpret mode, the batch padded to 128 lanes by repeating
    row 0 and sliced back.  Jitted once per config and reused."""
    key = (params, weights, cfg, return_gains)
    if key not in _SOLVERS:
        _SOLVERS[key] = jax.jit(make_batched_mpc_solver_pallas(
            params, weights, cfg, return_gains=return_gains, interpret=True))
    solve = _SOLVERS[key]

    def bsolve(x0, u_last, goal, tra_pos, tra_ang, t, U_init=None, max_iters=None):
        assert U_init is None and max_iters is None
        B = x0.shape[0]
        pad = (-B) % 128
        padb = lambda a: jnp.concatenate([a, jnp.repeat(a[:1], pad, axis=0)]) if pad else a
        sol = solve(*[padb(a) for a in (x0, u_last, goal, tra_pos, tra_ang, t)])
        return sol._replace(**{f: v[:B] for f, v in sol._asdict().items()
                               if v.ndim and v.shape[0] == B + pad})

    return bsolve


@pytest.fixture
def pallas_solver(monkeypatch):
    monkeypatch.setattr(jilqr, "make_batched_mpc_solver", _pallas_interpret_batched)


def _jax_dnn1(path):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, leaf = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(v)
    return jmlp.make_dnn1(), tree


def _scenarios(B, seed):
    """Sampler scenarios (numpy, float64) and their problems in both ports."""
    scen = sample_scenarios(torch.Generator().manual_seed(seed), B, dtype=torch.float64).numpy()
    probs_j = jax.vmap(jscenario_to_problem)(jnp.asarray(scen))
    probs_t = scenario_to_problem(t64(scen))
    for k in ("x0", "goal_pos", "gate_pts"):
        close(probs_t[k], probs_j[k])
    return scen, probs_j, probs_t


def _signal_inputs(B, seed):
    """(x0, u_last, goal, gate_pts, tra_pos, tra_ang, t) from nn_pre's output
    on sampled scenarios, in numpy."""
    scen, probs, _ = _scenarios(B, seed)
    model, params = _jax_dnn1(tweights.NN_PRE_DNN1)
    out = np.asarray(model.apply(params, jnp.asarray(scen)))
    return [np.asarray(probs["x0"]), np.zeros((B, 4)), np.asarray(probs["goal_pos"]),
            np.asarray(probs["gate_pts"]), out[:, 0:3], out[:, 3:6], out[:, 6]]


@pytest.mark.parametrize("shaped", [True, False])
def test_analytic_gradient_batched_matches_jax(pallas_solver, shaped):
    from learningagileflight_se3_tpu.policy import make_analytic_gradient_batched as jana_grad
    from learningagileflight_se3_torch.policy import make_analytic_gradient_batched as tana_grad

    args = _signal_inputs(8, seed=21)
    g_j, r_j = jana_grad(PQ_J, CW_J, jcfg.SolverConfig(**TINY), RC_J, shaped=shaped)(
        *[jnp.asarray(a) for a in args])
    g_t, r_t = tana_grad(PQ_T, CW_T, tcfg.SolverConfig(**TINY), RC_T, shaped=shaped)(
        *[t64(a) for a in args])
    close(r_t, r_j, rtol=1e-8, atol=1e-8)
    close(g_t, g_j, rtol=1e-8, atol=1e-10)
    assert np.isfinite(np.asarray(g_j)).all()


def test_fd_gradient_batched_matches_jax(pallas_solver):
    from learningagileflight_se3_tpu.policy import make_fd_gradient_batched as jfd
    from learningagileflight_se3_torch.policy import make_fd_gradient_batched as tfd

    args = _signal_inputs(8, seed=22)
    g_j, r_j = jfd(PQ_J, CW_J, jcfg.SolverConfig(**TINY), RC_J)(*[jnp.asarray(a) for a in args])
    g_t, r_t = tfd(PQ_T, CW_T, tcfg.SolverConfig(**TINY), RC_T)(*[t64(a) for a in args])
    close(r_t, r_j, rtol=1e-8, atol=1e-8)
    close(g_t, g_j, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("grad_mode", ["fd", "analytic"])
def test_rl_step_matches_jax(pallas_solver, grad_mode):
    """One make_rl_train_step from nn_pre in both ports, optax Adam against
    torch Adam, scenario row 1 poisoned with NaN: the same rewards, the NaN
    row masked, and the same updated float32 parameters.  The JAX step's
    jit is bypassed (`__wrapped__`) so its solves reuse the compiled
    interpret-mode solver."""
    from learningagileflight_se3_tpu.train.rl import make_rl_train_step as jstep
    from learningagileflight_se3_torch.train.rl import make_rl_train_step as tstep

    scen, _, _ = _scenarios(8, seed=23 if grad_mode == "fd" else 24)
    scen[1, 0] = np.nan
    model_j, params_j = _jax_dnn1(tweights.NN_PRE_DNN1)
    opt = optax.adam(1e-4)
    step_j = jstep(model_j, opt, PQ_J, CW_J, jcfg.SolverConfig(**TINY), RC_J, grad_mode=grad_mode)
    p_j, _, mr_j, r_j = step_j.__wrapped__(params_j, opt.init(params_j), jnp.asarray(scen))

    model_t = tweights.load_dnn1(tweights.NN_PRE_DNN1)
    optimizer = torch.optim.Adam(model_t.parameters(), lr=1e-4)
    step_t = tstep(model_t, optimizer, PQ_T, CW_T, tcfg.SolverConfig(**TINY), RC_T,
                   grad_mode=grad_mode)
    res = step_t(t64(scen))
    r_j = np.asarray(r_j)
    np.testing.assert_array_equal(np.isnan(res.rewards.numpy()), np.isnan(r_j))
    assert np.isnan(r_j[1]) and np.isnan(float(mr_j)) and np.isnan(float(res.mean_reward))
    close(res.rewards.numpy()[~np.isnan(r_j)], r_j[~np.isnan(r_j)], rtol=1e-8, atol=1e-8)
    np.testing.assert_array_equal(res.valid.numpy(), np.isfinite(r_j))
    p0 = tweights.load_dnn1(tweights.NN_PRE_DNN1).state_dict()
    want = tweights.jax_params_to_torch(jax.tree_util.tree_map(np.asarray, p_j))
    for name, p in model_t.state_dict().items():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()
        close(p.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6)
    assert any(not torch.equal(p, p0[n]) for n, p in model_t.state_dict().items())


# ----------------------------------------------------- optimizer, resume
def test_cosine_schedule_and_adam_match_optax():
    from learningagileflight_se3_torch.train.rl import cosine_decay_schedule

    sched_j = optax.cosine_decay_schedule(1e-4, 400, alpha=0.1)
    sched_t = cosine_decay_schedule(1e-4, 400, alpha=0.1)
    counts = np.arange(0, 420)
    close([sched_t(int(c)) for c in counts], [float(sched_j(c)) for c in counts], rtol=1e-12, atol=0)
    # Adam under the schedule on a float32 quadratic, 12 steps of 20
    rng = np.random.default_rng(2)
    target = rng.normal(size=(5,)).astype(np.float32)
    p0 = rng.normal(size=(5,)).astype(np.float32)
    opt = optax.adam(optax.cosine_decay_schedule(1e-2, 20, alpha=0.1))
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    sched = cosine_decay_schedule(1e-2, 20, alpha=0.1)
    pt = torch.tensor(p0, requires_grad=True)
    adam = torch.optim.Adam([pt], lr=1e-2)
    for e in range(12):
        g = jax.grad(lambda p: jnp.sum((p - target) ** 2 * jnp.arange(1, 6)))(pj)
        upd, state = opt.update(g, state, pj)
        pj = optax.apply_updates(pj, upd)
        adam.param_groups[0]["lr"] = sched(e)
        adam.zero_grad()
        torch.sum((pt - torch.tensor(target)) ** 2 * torch.arange(1, 6)).backward()
        adam.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)


def test_resume_equals_uninterrupted(tmp_path):
    """A 4-epoch run cut after its epoch-2 checkpoint and resumed equals the
    uninterrupted run: the Adam moments, the schedule's count and the
    per-epoch scenario stream survive the restart."""
    from learningagileflight_se3_torch.train.rl import run_rl_training

    class Cut(Exception):
        pass

    def cut_after_2(line):
        if line.startswith("rl epoch 2/"):
            raise Cut

    kw = dict(epochs=4, batch_size=3, lr=1e-3, solver_cfg=tcfg.SolverConfig(**TINY),
              grad_mode="analytic", lr_schedule=True, device="cpu")
    load = lambda: tweights.load_dnn1(tweights.NN_PRE_DNN1)
    m_full, r_full, v_full = run_rl_training(7, load(), log_fn=lambda *a: None, **kw)
    ck = str(tmp_path / "rl_ck")
    with pytest.raises(Cut):
        run_rl_training(7, load(), checkpoint_dir=ck, checkpoint_every=2, log_fn=cut_after_2, **kw)
    m_res, r_res, _ = run_rl_training(7, load(), checkpoint_dir=ck, checkpoint_every=2,
                                      resume=True, log_fn=lambda *a: None, **kw)
    assert len(r_res) == 2 and r_res == r_full[2:]
    for (n, a), b in zip(m_full.state_dict().items(), m_res.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    assert all(np.isfinite(r_full)) and v_full == [1.0] * 4


@pytest.mark.parametrize("name", ["nn_pre", "nn_deep"])
def test_exported_dnn1_matches_orbax_checkpoint(name):
    from learningagileflight_se3_tpu.utils.checkpoint import load_params

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model_j = jmlp.make_dnn1()
    like = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 9)))
    params = load_params(os.path.join(repo, "artifacts", name), like=like)
    model_t = tweights.load_dnn1(getattr(tweights, f"{name.upper()}_DNN1"))
    scen = sample_scenarios(torch.Generator().manual_seed(1), 32, dtype=torch.float64)
    # float32 input: float32 output in both; float64: promoted to float64 in both
    for dtype in (np.float32, np.float64):
        x = scen.numpy().astype(dtype)
        want = np.asarray(model_j.apply(params, jnp.asarray(x)))
        got = model_t(torch.tensor(x)).detach().numpy()
        assert got.dtype == want.dtype == dtype
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == np.float32 else dict(rtol=1e-12, atol=1e-12)
        close(got, want, **tol)
