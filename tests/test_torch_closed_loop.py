"""PyTorch port, the closed loop: batched t-solver, Kalman filter, the 100 Hz
flight and its scorecard.

On the CPU in float64, against the JAX package on the same scenarios, DNN2
weights (nn3_1) and noise:

  * the batched traversal-time solvers against a loop of single calls
    (bit-equal, a non-finite lane included) and against JAX (1e-10);
  * the Kalman step over 200 observations across a pitch wrap (1e-10) and
    the gate observation on the same corner noise (1e-12);
  * the closed loop at steps=40, H=10 and, with the filter, at steps=120,
    H=8 (the sizes of tests/test_sim.py): states within 1e-5, traversal
    times 1e-6, the other logs alongside; equal solver iterations are not
    required;
  * the plain-Euler plant against the NumPy oracle (1e-12);
  * the scorecard on the JAX log and on made-up flights: equal booleans;
  * a batch with a lane that diverges, and a batch of 3 against three
    batches of 1 (1e-9: the batch size changes the order of BLAS sums).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.geometry import gate as jgate
from learningagileflight_se3_tpu.models import mlp as jmlp
from learningagileflight_se3_tpu.oracle.numpy_reference import np_euler_step
from learningagileflight_se3_tpu.sim import closed_loop as jloop
from learningagileflight_se3_tpu.sim import estimator as jest
from learningagileflight_se3_tpu.sim.tsolver import make_traversal_time_solver as jtsolver

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.ops import riccati_fused, rollout
from learningagileflight_se3_torch.sim import closed_loop as tloop
from learningagileflight_se3_torch.sim import estimator as kal
from learningagileflight_se3_torch.sim.tsolver import make_traversal_time_solver
from learningagileflight_se3_torch.utils import weights as tweights

SCEN = np.array([[0.0, -8.0, 0.0, 0.0, 6.0, 0.0, 0.05, 1.0, 0.4],
                 [0.5, -7.0, 0.2, 0.0, 6.0, 0.0, 0.0, 1.1, 0.3],
                 [-1.0, -9.0, 0.5, 0.5, 5.5, 0.2, -0.05, 0.8, -0.7]])
VELO, W_ROT = np.array([1.0, 0.3, 0.4]), np.pi / 2


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(a, b, **kw):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **kw)


@pytest.fixture(scope="module")
def jax_dnn2():
    with np.load(tweights.NN3_1_DNN2) as z:
        params = {"params": {f"Dense_{i}": {"kernel": jnp.asarray(z[f"params/Dense_{i}/kernel"]),
                                            "bias": jnp.asarray(z[f"params/Dense_{i}/bias"])}
                             for i in range(3)}}
    return jmlp.make_dnn2(), params


@pytest.fixture(scope="module")
def torch_dnn2():
    return tweights.load_dnn2().double()


# -------------------------------------------------------------- t-solver
def _tsolver_inputs(n, seed):
    """n flight situations: states along the approach, gates in motion."""
    r = np.random.default_rng(seed)
    state = np.zeros((n, 13))
    state[:, 0:3] = r.normal(size=(n, 3)) * [1.5, 0.5, 0.8] + [0.0, -6.0, 0.0]
    state[:, 1] += np.linspace(0.0, 5.0, n)
    state[:, 3:6] = r.normal(size=(n, 3)) + [0.0, 2.0, 0.0]
    q = r.normal(size=(n, 4)) * 0.2
    q[:, 0] += 1.0
    state[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    final = r.normal(size=(n, 3)) + [0.0, 6.0, 0.0]
    pts = np.asarray(jax.vmap(jgate.gate_from_width)(jnp.asarray(r.uniform(0.6, 1.2, n)),
                                                     jnp.asarray(r.uniform(-1.2, 1.2, n))))
    pts = pts + r.normal(size=(n, 1, 3)) * 0.5
    velo = VELO + r.normal(size=(n, 3)) * 0.1
    w = W_ROT + r.normal(size=n) * 0.2
    return state, final, pts, velo, w


@pytest.mark.parametrize("accel,tol", [("reference", 1e-3), ("secant", 1e-3), ("reference", 1e-2)])
def test_batched_tsolver_equals_single_calls_and_jax(accel, tol, jax_dnn2, torch_dnn2):
    """One batch of 12 lanes against 12 single calls, bit for bit: a lane that
    has converged keeps its t while the others iterate.  Lane 5 has a
    non-finite state: it is NaN alone and holds no other lane up.  For the
    bit-equal comparison DNN2 is evaluated row by row in the batch too: the
    last bits of a BLAS product depend on how many rows it is given, and
    that is no property of the solver.  With DNN2 on the whole batch the
    lanes agree to 1e-12."""
    n = 12
    args = list(_tsolver_inputs(n, seed=3))
    args[0][5, 0] = np.nan
    tsolve = make_traversal_time_solver(torch_dnn2, tol=tol, accel=accel)
    by_row = lambda x: torch_dnn2(x) if x.ndim == 1 else torch.stack([torch_dnn2(r) for r in x])
    tsolve_rows = make_traversal_time_solver(by_row, tol=tol, accel=accel)
    with torch.no_grad():
        batch = tsolve(*[t64(a) for a in args])
        batch_rows = tsolve_rows(*[t64(a) for a in args])
        singles = torch.stack([tsolve(*[t64(a[i]) for a in args]) for i in range(n)])
    assert batch.shape == (n,) and torch.isnan(batch[5]) and torch.isnan(singles[5])
    ok = np.arange(n) != 5
    assert torch.equal(batch_rows[ok], singles[ok]), (batch_rows - singles).abs().max()
    close(batch[ok], singles[ok], rtol=0, atol=1e-12)
    # the lanes need different numbers of iterations: the guess's error varies
    model2, params = jax_dnn2
    want = jax.jit(jax.vmap(jtsolver(model2, tol=tol, accel=accel), in_axes=(None, 0, 0, 0, 0, 0)))(
        params, *[jnp.asarray(a) for a in args])
    close(batch[ok], np.asarray(want)[ok], rtol=0, atol=1e-10)
    assert np.isnan(np.asarray(want)[5])
    assert float(batch[ok].max() - batch[ok].min()) > 0.5


def test_tsolver_takes_a_number_or_a_tensor_for_the_pitch_rate(torch_dnn2):
    state, final, pts, velo, _ = _tsolver_inputs(4, seed=4)
    tsolve = make_traversal_time_solver(torch_dnn2)
    with torch.no_grad():
        a = tsolve(t64(state), t64(final), t64(pts), t64(velo), W_ROT)
        b = tsolve(t64(state), t64(final), t64(pts), t64(velo), torch.full((4,), W_ROT, dtype=torch.float64))
    assert torch.equal(a, b)


# ------------------------------------------------------------- estimator
def test_kalman_step_matches_jax_across_a_pitch_wrap():
    """Two gates turning at pi/2 rad/s from 0.4 and 1.0 rad: 200 observations
    take the atan pitch through its wrap; mean and covariance at every step."""
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    pts0 = [jgate.rotate_y(jgate.gate_from_width(jnp.asarray(1.0)), jnp.asarray(p)) for p in (0.4, 1.0)]
    moves = np.stack([np.asarray(jgate.gate_move(p, k, jnp.asarray(VELO), W_ROT, T=2.0, dt=0.01,
                                                 noise_std=0.05, noise_clip=0.05)[0])
                      for p, k in zip(pts0, keys)])                      # (2, 201, 4, 3)
    obs_j = np.asarray(jax.vmap(jax.vmap(jest.gate_observation))(moves))
    obs_t = kal.gate_observation(t64(moves))
    close(obs_t, obs_j, rtol=1e-12, atol=1e-12)
    assert (np.diff(obs_j[:, :, 3], axis=1) < -2.0).any(), "no pitch wrap in the observations"

    kstep_j, kstep_t = jax.jit(jax.vmap(jest.make_kalman_step(dt=0.01))), kal.make_kalman_step(dt=0.01)
    ks_j = jax.vmap(lambda o: jest.kalman_init(o, dtype=jnp.float64))(obs_j[:, 0])
    ks_t = kal.kalman_init(obs_t[:, 0], dtype=torch.float64)
    close(ks_t.x, ks_j.x, rtol=0, atol=0)
    close(ks_t.P, ks_j.P, rtol=0, atol=0)
    for i in range(200):
        ks_j = kstep_j(ks_j, obs_j[:, i])
        ks_t = kstep_t(ks_t, obs_t[:, i])
        close(ks_t.x, ks_j.x, rtol=1e-10, atol=1e-10)
        close(ks_t.P, ks_j.P, rtol=1e-10, atol=1e-10)
    v_t, w_t = kal.estimated_velocity(ks_t)
    v_j, w_j = jax.vmap(jest.estimated_velocity)(ks_j)
    close(v_t, v_j, rtol=1e-10, atol=1e-10)
    close(w_t, w_j, rtol=1e-10, atol=1e-10)
    assert float((w_t - W_ROT).abs().max()) < 0.3  # the filter followed the turn through the wrap
    # one filter alone is the batch's lane
    one = kal.kalman_init(obs_t[1, 0], dtype=torch.float64)
    for i in range(5):
        one = kstep_t(one, obs_t[1, i])
    ref = kal.kalman_init(obs_t[:, 0], dtype=torch.float64)
    for i in range(5):
        ref = kstep_t(ref, obs_t[:, i])
    close(one.x, ref.x[1], rtol=1e-13, atol=1e-13)


def test_innovation_wrap_uses_pythons_sign_rule():
    """A pitch innovation just under -pi/2 wraps to just under +pi/2 (`%`
    keeps the divisor's sign), in both packages."""
    obs0 = np.array([0.0, 0.0, 0.0, 1.5])
    obs1 = np.array([0.0, 0.0, 0.0, -1.5])  # innovation -3.0, wrapped to pi - 3.0 > 0
    ks_j = jest.make_kalman_step()(jest.kalman_init(obs0, dtype=jnp.float64), jnp.asarray(obs1))
    ks_t = kal.make_kalman_step()(kal.kalman_init(t64(obs0), dtype=torch.float64), t64(obs1))
    close(ks_t.x, ks_j.x, rtol=1e-12, atol=1e-12)
    assert float(ks_t.x[6]) > 1.5


def test_gate_observation_noise_from_a_tensor_or_a_generator():
    pts = np.asarray(jgate.rotate_y(jgate.gate_from_width(jnp.asarray(1.0)), jnp.asarray(0.3)))
    key = jax.random.PRNGKey(5)
    noise = 0.01 * np.asarray(jax.random.normal(key, (4, 3), jnp.float64))
    close(kal.gate_observation(t64(pts), noise=t64(noise)), jest.gate_observation(jnp.asarray(pts), key, 0.01),
          rtol=1e-12, atol=1e-12)
    g = lambda: torch.Generator().manual_seed(1)
    a = kal.gate_observation(t64(pts).expand(500, 4, 3), g(), 0.01)
    b = kal.gate_observation(t64(pts).expand(500, 4, 3), g(), 0.01)
    clean = kal.gate_observation(t64(pts))
    assert torch.equal(a, b) and torch.equal(kal.gate_observation(t64(pts), g(), 0.0), clean)
    # the centre is a mean of 4 corners: its noise has std 0.01 / 2
    assert abs(float((a[:, 0:3] - clean[0:3]).std()) / 0.005 - 1.0) < 0.15


# ----------------------------------------------------------- closed loop
def _jax_noise(keys, steps, motion=jcfg.GateMotionConfig(), obs_std=0.0):
    """What the JAX closed loop draws from each scenario's key: gate_move's
    clipped velocity noise (B, steps, 3) and the corner observation noise
    (B, steps, 4, 3)."""
    gate = [jnp.clip(motion.noise_std * jax.random.normal(k, (steps, 3), jnp.float64),
                     -motion.noise_clip, motion.noise_clip) for k in keys]
    obs = [[obs_std * jax.random.normal(jax.random.fold_in(jax.random.fold_in(k, 0x6B66), i), (4, 3),
                                        jnp.float64) for i in range(steps)] for k in keys]
    return np.asarray(gate), np.asarray(obs)


def _run_both(jax_dnn2, scen, steps, H, max_iters, **kw):
    model2, params = jax_dnn2
    keys = jax.random.split(jax.random.PRNGKey(3), len(scen))
    cfg = dict(horizon=H, max_iters=max_iters)
    sim_j = jax.jit(jax.vmap(
        jloop.make_closed_loop_sim(model2, solver_cfg=jcfg.SolverConfig(**cfg), steps=steps, **kw),
        in_axes=(None, 0, 0)))
    log_j = sim_j(params, jnp.asarray(scen), keys)
    gate_noise, obs_noise = _jax_noise(keys, steps, obs_std=kw.get("gate_obs_noise", 0.0))
    sim_t = tloop.make_closed_loop_sim(tweights.load_dnn2(), solver_cfg=tcfg.SolverConfig(**cfg),
                                       steps=steps, device="cpu", dtype=torch.float64, **kw)
    plain = (rollout.plain_calls, riccati_fused.plain_calls)
    log_t = sim_t(scen, gate_noise=gate_noise,
                  obs_noise=obs_noise if kw.get("gate_obs_noise", 0.0) > 0.0 else None)
    assert rollout.plain_calls > plain[0] and riccati_fused.plain_calls > plain[1]
    return log_j, log_t


def _assert_logs_agree(log_t, log_j, B, steps):
    assert log_t.states.shape == (B, steps + 1, 13) and log_t.gate_moves.shape == (B, steps + 1, 4, 3)
    for name, a in log_t._asdict().items():
        assert a.shape == getattr(log_j, name).shape, name
    assert np.isfinite(np.asarray(log_j.states)).all()
    close(log_t.gate_moves, log_j.gate_moves, rtol=0, atol=1e-10)
    close(log_t.states, log_j.states, rtol=0, atol=1e-5)
    close(log_t.tra_times, log_j.tra_times, rtol=0, atol=1e-6)
    close(log_t.abs_tra_times, log_j.abs_tra_times, rtol=0, atol=1e-6)
    close(log_t.controls, log_j.controls, rtol=0, atol=1e-5)
    close(log_t.torques, log_j.torques, rtol=0, atol=1e-5)
    close(log_t.hl_variables, log_j.hl_variables, rtol=0, atol=1e-5)
    close(log_t.gate_vel_used, log_j.gate_vel_used, rtol=0, atol=1e-6)
    close(log_t.times, log_j.times, rtol=0, atol=1e-12)
    close(log_t.pitches, log_j.pitches, rtol=0, atol=1e-12)
    it_t, it_j = log_t.solver_iters.numpy(), np.asarray(log_j.solver_iters)
    np.testing.assert_array_equal(it_t > 0, it_j > 0)


def test_closed_loop_matches_jax(jax_dnn2):
    """steps=40, H=10, ground-truth gate velocity, two scenarios."""
    steps, B = 40, 2
    log_j, log_t = _run_both(jax_dnn2, SCEN[:B], steps, H=10, max_iters=15)
    _assert_logs_agree(log_t, log_j, B, steps)
    it = log_t.solver_iters.numpy()
    assert (it[:, 0] > 0).all() and (it[:, 1:10] == 0).all() and (it[:, 10] > 0).all()
    U = log_t.controls.numpy()
    assert U.min() >= -1e-9 and U.max() <= 2.44 + 1e-9
    # the scorecard on the JAX log and on the port's: equal booleans
    m_j = jax.vmap(jloop.evaluate_closed_loop_full)(log_j, jnp.asarray(SCEN[:B, 3:6]))
    as_t = tloop.ClosedLoopLog(*[torch.tensor(np.asarray(a)) for a in log_j])
    for m_t in (tloop.evaluate_closed_loop_full(as_t, t64(SCEN[:B, 3:6])),
                tloop.evaluate_closed_loop_full(log_t, t64(SCEN[:B, 3:6]))):
        for name in ("traversed", "reached_1m", "reached_2m", "diverged"):
            np.testing.assert_array_equal(getattr(m_t, name).numpy(), np.asarray(getattr(m_j, name)), name)
        close(m_t.final_dist, m_j.final_dist, rtol=0, atol=1e-5)
        close(m_t.goal_speed_end, m_j.goal_speed_end, rtol=0, atol=1e-5)


def test_closed_loop_with_the_filter_matches_jax(jax_dnn2):
    """steps=120, H=8, the Kalman filter over noisy gate observations."""
    steps, B = 120, 2
    log_j, log_t = _run_both(jax_dnn2, SCEN[:B], steps, H=8, max_iters=8,
                             estimate_gate_motion=True, gate_obs_noise=0.002)
    _assert_logs_agree(log_t, log_j, B, steps)
    used = log_t.gate_vel_used.numpy()
    assert np.median(np.linalg.norm(used[:, 80:, 0:3] - VELO, axis=-1)) < 0.5
    assert np.median(np.abs(used[:, 80:, 3] - W_ROT)) < 0.4


def test_plain_euler_plant_matches_the_numpy_oracle():
    """renorm_plant=False is the reference's Euler step exactly; the default
    plant is that step followed by the quaternion's renormalization."""
    cfg = tcfg.SolverConfig(horizon=8, max_iters=10)
    p = jcfg.QuadParams()
    for renorm in (False, True):
        sim = tloop.make_closed_loop_sim(tweights.load_dnn2(), solver_cfg=cfg, steps=15,
                                         renorm_plant=renorm, device="cpu", dtype=torch.float64)
        log = sim(SCEN[1:3], generator=torch.Generator().manual_seed(5))
        states, controls = log.states.numpy(), log.controls.numpy()
        for b in range(2):
            for i in range(15):
                want = np_euler_step(states[b, i], controls[b, i + 1], 0.01, p)
                if renorm:
                    want[6:10] /= np.linalg.norm(want[6:10])
                np.testing.assert_allclose(states[b, i + 1], want, rtol=0, atol=1e-12)
        if renorm:
            np.testing.assert_allclose(np.linalg.norm(states[:, 1:, 6:10], axis=-1), 1.0, atol=1e-12)


def test_non_integer_warm_shift_is_refused():
    kw = dict(device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="integer multiple of the solver dt"):
        tloop.make_closed_loop_sim(tweights.load_dnn2(), control_every=15, **kw)
    with pytest.raises(ValueError, match="integer multiple of the solver dt"):
        tloop.make_closed_loop_sim(tweights.load_dnn2(), control_every=100,
                                   solver_cfg=tcfg.SolverConfig(horizon=5), **kw)
    tloop.make_closed_loop_sim(tweights.load_dnn2(), control_every=15, warm_start=False, **kw)


def test_closed_loop_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.make_closed_loop_sim(tweights.load_dnn2())


# ------------------------------------------------- lanes stay independent
@pytest.fixture(scope="module")
def batch_of_three():
    cfg = tcfg.SolverConfig(horizon=10, max_iters=15)
    sim = tloop.make_closed_loop_sim(tweights.load_dnn2(), solver_cfg=cfg, steps=30, device="cpu",
                                     dtype=torch.float64)
    noise = np.clip(0.1 * np.random.default_rng(2).normal(size=(3, 30, 3)), -0.1, 0.1)
    return sim, noise, sim(SCEN, gate_noise=noise)


def test_batch_of_three_equals_three_batches_of_one(batch_of_three):
    sim, noise, log3 = batch_of_three
    for b in range(3):
        log1 = sim(SCEN[b:b + 1], gate_noise=noise[b:b + 1])
        for name, a in log1._asdict().items():
            close(a[0], getattr(log3, name)[b], rtol=0, atol=1e-9, err_msg=f"{name}, lane {b}")


def test_a_diverged_lane_leaves_the_others_alone(batch_of_three):
    """Lane 1 starts from a non-finite position: its rows are NaN from the
    first step, the solver retires it, and lanes 0 and 2 fly as they do in
    the finite batch."""
    sim, noise, log3 = batch_of_three
    bad = SCEN.copy()
    bad[1, 0] = np.nan
    log = sim(bad, gate_noise=noise)
    assert torch.isnan(log.states[1, 1:, 0]).all() and torch.isnan(log.tra_times[1]).all()
    for name, a in log._asdict().items():
        close(a[[0, 2]], getattr(log3, name)[[0, 2]], rtol=0, atol=1e-9, err_msg=name)
    assert torch.isfinite(log.states[[0, 2]]).all()
    m = tloop.evaluate_closed_loop_full(log, t64(SCEN[:, 3:6]))
    assert m.diverged.tolist() == [False, True, False] and not bool(m.traversed[1])
    # the blown-out lane's replans stop at the regularisation ceiling, far from the cap
    assert int(log.solver_iters[1].max()) <= 12


# ------------------------------------------- watching the solver's kernels
def test_watched_kernels_report_every_call_in_its_place(batch_of_three):
    """Over 30 steps (3 replans, the later two warm-started) the watcher
    names 3 solves; each solve's sweeps number its slowest lane's iterations,
    its trips count up from 0 after each sweep, and it opens with two
    rollouts (the guard of the given initial controls, then the trajectory);
    the log is unchanged and the solver's names are restored."""
    from learningagileflight_se3_torch.solver import ilqr_batched, watch

    sim, noise, log3 = batch_of_three
    names = (ilqr_batched.rollout_forward, ilqr_batched.riccati_backward)
    seen = []
    with watch.watched_kernels(lambda kind, solve, it, trip, a, kw, out: seen.append((kind, solve, it, trip))):
        log = sim(SCEN, gate_noise=noise)
    assert (ilqr_batched.rollout_forward, ilqr_batched.riccati_backward) == names
    for name, a in log._asdict().items():
        assert torch.equal(a, getattr(log3, name)), name
    assert sorted({s for _, s, _, _ in seen}) == [0, 1, 2]
    for s in range(3):
        mine = [c for c in seen if c[1] == s]
        sweeps = [c[2] for c in mine if c[0] == "K2"]
        assert sweeps == list(range(int(log.solver_iters[:, 10 * s].max())))
        assert [c[0] for c in mine[:3]] == ["K1 cost", "K1 cost", "K2"]
        assert [c[0] for c in mine].count("K1 cost") == 2
        assert all(c[2] == -1 for c in mine if c[0] == "K1 cost")
        for k in sweeps:  # an iteration's trips count up from 0 after its sweep
            trips = [c[3] for c in mine if c[0] == "K1" and c[2] == k]
            assert trips == list(range(len(trips)))


def test_capture_inputs_keeps_the_named_solves_call():
    """The inputs kept are those of the named solve's k2_call-th sweep and of
    the first line-search rollout under its gains: replayed through the
    wrappers they give what the solver got (bit-equal)."""
    from learningagileflight_se3_torch.solver import watch

    cfg = tcfg.SolverConfig(horizon=10, max_iters=15)
    sim = tloop.make_closed_loop_sim(tweights.load_dnn2(), solver_cfg=cfg, steps=11, device="cpu",
                                     dtype=torch.float64)
    outs = {}

    def keep(kind, solve, it, trip, a, kw, out):
        if solve == 1 and it == 2 and kind in ("K1", "K2") and not trip:
            outs[kind] = out

    with watch.watched_kernels(keep):
        _, got = watch.capture_inputs(lambda: sim(SCEN, gate_noise=np.zeros((3, 11, 3))), solve=1, k2_call=3)
    (k1, k1_args, k1_kw), (k2, k2_args, k2_kw) = got["K1"], got["K2"]
    assert k2[0].shape == (10, 21, 3) and k1[3].shape == (10, 4, 17, 3)  # ZU; the gains KK
    for a, b in zip(riccati_fused.riccati_backward(*k2, *k2_args, **k2_kw), outs["K2"]):
        assert torch.equal(a, b)
    for a, b in zip(rollout.rollout_forward(*k1, *k1_args, **k1_kw), outs["K1"]):
        assert torch.equal(a, b)
    assert torch.equal(k1[2], outs["K2"][0])  # the rollout's gains are that sweep's


# --------------------------------------------------- scoring by flights
@pytest.mark.parametrize("device_type, tol, window", [("cpu", 1e-9, 0), ("cuda", 1e-4, 10)])
def test_flight_solver_settings_follow_the_device(device_type, tol, window):
    from learningagileflight_se3_torch.sim import bench

    cfg = bench.solver_config(torch.device(device_type), horizon=12, max_iters=7)
    assert (cfg.horizon, cfg.max_iters, cfg.tol, cfg.no_progress_iters) == (12, 7, tol, window)
    named = bench.tight_solver_config if device_type == "cpu" else bench.flight_solver_config
    assert cfg == named(12, 7)


def test_fly_and_summarize_score_a_batch(batch_of_three):
    """`fly` is the closed loop in float32 under a timer with its scorecard;
    `summarize` gives bench_success.py's fields from it."""
    from learningagileflight_se3_torch.sim import bench

    _, noise, _ = batch_of_three
    cfg = tcfg.SolverConfig(horizon=10, max_iters=15)
    trace, metrics, wall = bench.fly(tweights.load_dnn2(), SCEN, noise, steps=30, device="cpu", solver_cfg=cfg)
    assert trace.states.shape == (3, 31, 13) and trace.states.dtype == torch.float32 and wall > 0
    out = bench.summarize(metrics, trace.solver_iters, sim_steps=30)
    assert out["n_scenarios"] == 3 and out["sim_steps"] == 30 and 0.0 <= out["value"] <= 1.0
    assert out["n_diverged"] == int(metrics.diverged.sum())
    its = trace.solver_iters[trace.solver_iters > 0].numpy()
    assert out["replan_solver_iters_p50"] == float(np.median(its))


# ------------------------------------------------------------- scorecard
def _made_up_flights():
    """Six straight flights through or past a moving gate, 60 steps: through
    the centre, near the edge, outside in x, above, never reaching the plane,
    and through the centre but then running away; plus one that goes NaN
    before the plane."""
    n, N = 7, 60
    pts0 = np.asarray(jgate.rotate_y(jgate.gate_from_width(jnp.asarray(1.0)), jnp.asarray(0.5)))
    moves = np.asarray(jgate.gate_move(jnp.asarray(pts0), jax.random.PRNGKey(1), jnp.asarray(VELO) * 0.2,
                                       0.5, T=N * 0.01, dt=0.01)[0])
    moves = np.repeat(moves[None], n, 0)
    c = moves[0, N // 2].mean(axis=0)
    offs = np.array([[0, 0, 0], [0.3, 0, 0.1], [1.5, 0, 0], [0, 0, 1.6], [0, 0, 0], [0, 0, 0], [0, 0, 0.0]])
    y0 = np.array([-3.0, -3.0, -3.0, -3.0, -9.0, -3.0, -3.0])
    states = np.zeros((n, N + 1, 13))
    states[:, :, 6] = 1.0
    s = np.linspace(0.0, 1.0, N + 1)
    for b in range(n):
        start = c + offs[b] + [0, y0[b], 0]
        end = start + [0, 6.0, 0]
        states[b, :, 0:3] = start + s[:, None] * (end - start)
        states[b, :, 3:6] = (end - start) / (N * 0.01)
    states[5, -5:, 0] += 80.0
    states[6, 20:, :] = np.nan
    goal = np.repeat((c + [0, 3.0, 0])[None], n, 0)
    goal[1] += [0.5, 0.3, 0.0]
    zeros = lambda *shape: np.zeros((n,) + shape)
    return dict(states=states, controls=zeros(N + 1, 4), torques=zeros(N + 1, 4),
                hl_variables=zeros(N + 1, 7), tra_times=zeros(N), abs_tra_times=zeros(N), times=zeros(N),
                pitches=zeros(N), gate_moves=moves, solver_iters=zeros(N).astype(np.int32),
                gate_vel_used=zeros(N, 4)), goal


def test_scorecard_matches_jax_on_made_up_flights():
    fields, goal = _made_up_flights()
    m_j = jax.vmap(jloop.evaluate_closed_loop_full)(
        jloop.ClosedLoopLog(**{k: jnp.asarray(a) for k, a in fields.items()}), jnp.asarray(goal))
    log_t = tloop.ClosedLoopLog(**{k: torch.tensor(a) for k, a in fields.items()})
    m_t = tloop.evaluate_closed_loop_full(log_t, t64(goal))
    for name in ("traversed", "reached_1m", "reached_2m", "diverged"):
        np.testing.assert_array_equal(getattr(m_t, name).numpy(), np.asarray(getattr(m_j, name)), name)
    assert m_t.traversed.tolist() == [True, True, False, False, False, True, False]
    assert m_t.diverged.tolist() == [False, False, False, False, False, True, True]
    assert m_t.reached_1m.tolist()[:2] == [True, True]
    finite = [0, 1, 2, 3, 4, 5]
    for name in ("margin", "final_dist", "goal_speed_end"):
        close(getattr(m_t, name)[finite], np.asarray(getattr(m_j, name))[finite], rtol=1e-12, atol=1e-12)
    trav, margin, dist = tloop.evaluate_closed_loop(log_t, t64(goal))
    assert torch.equal(trav, m_t.traversed) and torch.equal(margin[finite], m_t.margin[finite])
    assert torch.equal(dist[finite], m_t.final_dist[finite])
