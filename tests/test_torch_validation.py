"""PyTorch port, the validation plant and the validation flight.

On the CPU, against the JAX package on the same numpy inputs (float64): the
port's copy of the numpy plant bit for bit over 200 seeded steps and in the
physics checks of tests/test_validation_env.py; the scenario sampler; the
logger's files; the traversal metrics; and a 0.3 s flight (30 plant steps,
3 ticks) of a fresh DNN2 carried across by `jax_params_to_torch`, with the
JAX gate-noise draws handed to the port.  Tolerances are stated in each
test."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.geometry import gate as jgate
from learningagileflight_se3_tpu.models import mlp as jmlp
from learningagileflight_se3_tpu.sim import validation_env as jenv
from learningagileflight_se3_tpu.sim import validation_sim as jsim
from learningagileflight_se3_tpu.utils.checkpoint import load_params

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.models import mlp as tmlp
from learningagileflight_se3_torch.sim import validation_env as tenv
from learningagileflight_se3_torch.sim import validation_sim as tsim
from learningagileflight_se3_torch.sim.external_controller import euler_rates_to_body
from learningagileflight_se3_torch.utils.weights import jax_params_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _envs(env_cfg=None, **kw):
    jc = jenv.ValidationEnvConfig(**kw)
    tc = tenv.ValidationEnvConfig(**kw)
    return jenv.ValidationEnv(jcfg.QuadParams(), jc), tenv.ValidationEnv(tcfg.QuadParams(), tc)


@pytest.mark.parametrize("kw", [{}, dict(mass_error=0.1, inertia_error=-0.2, clip_actions=False)],
                         ids=["default", "mismatch"])
def test_env_equals_original_bit_for_bit(kw):
    """200 steps of seeded random actions (some beyond the clip bounds): the
    states, observations and gate tests equal exactly (tolerance 0)."""
    r = np.random.default_rng(7)
    motion = lambda k: (np.array([[0, 1 + 0.01 * k, 0]] * 4, dtype=float), np.zeros(3))
    je, te = _envs(**kw)
    je.gate_motion = te.gate_motion = motion
    rpy0 = r.uniform(-0.3, 0.3, size=3)
    np.testing.assert_array_equal(je.reset([0.5, -1.0, 2.0], rpy0), te.reset([0.5, -1.0, 2.0], rpy0))
    m = jcfg.QuadParams().mass * 9.8
    for _ in range(200):
        a = np.array([m, 0.0, 0.0, 0.0]) + r.normal(size=4) * [3.0, 0.05, 0.05, 0.01]
        np.testing.assert_array_equal(je.step(a), te.step(a))
        np.testing.assert_array_equal(je.x, te.x)
        assert je.gate_crossed() == te.gate_crossed()
    np.testing.assert_array_equal(je.gate_points(), te.gate_points())


def test_env_conversions_equal_original():
    """quat_to_rpy, rpy_to_quat, body_rates_to_euler_rates, _quat_dcm_b2w
    equal the originals bit for bit on seeded inputs."""
    r = np.random.default_rng(3)
    for _ in range(20):
        rpy = r.uniform(-1.2, 1.2, size=3)
        q = r.normal(size=4)
        q /= np.linalg.norm(q)
        om = r.normal(size=3)
        np.testing.assert_array_equal(tenv.rpy_to_quat(rpy), jenv.rpy_to_quat(rpy))
        np.testing.assert_array_equal(tenv.quat_to_rpy(q), jenv.quat_to_rpy(q))
        np.testing.assert_array_equal(tenv.body_rates_to_euler_rates(om, rpy),
                                      jenv.body_rates_to_euler_rates(om, rpy))
        np.testing.assert_array_equal(tenv._quat_dcm_b2w(q), jenv._quat_dcm_b2w(q))


def test_env_physics():
    """tests/test_validation_env.py's physics and convention checks on the
    port's copy: hover, free fall, quaternion norm, torque, clipping, the
    round trips and the state20 layout (same tolerances)."""
    P = tcfg.QuadParams()
    cfg = tenv.ValidationEnvConfig()
    env = tenv.ValidationEnv(P, cfg)
    env.reset([0.0, 0.0, 2.0])
    for _ in range(100):
        env.step(np.array([P.mass * cfg.g, 0.0, 0.0, 0.0]))
    assert np.allclose(env.x[0:3], [0.0, 0.0, 2.0], atol=1e-9)
    assert np.allclose(env.x[3:6], 0.0, atol=1e-9)
    assert np.allclose(env.x[6:10], [1, 0, 0, 0], atol=1e-12)

    env.reset([0.0, 0.0, 10.0])
    for _ in range(50):
        env.step(np.zeros(4))
    assert abs(env.x[2] - (10.0 - 0.5 * cfg.g * 0.25)) < 1e-9

    env.reset([0, 0, 0], (0.1, -0.2, 0.3))
    for _ in range(200):
        env.step(np.array([5.0, 0.02, -0.015, 0.004]))
    assert abs(np.linalg.norm(env.x[6:10]) - 1.0) < 1e-12

    free = tenv.ValidationEnv(P, tenv.ValidationEnvConfig(clip_actions=False))
    free.reset([0, 0, 0])
    for _ in range(100):
        free.step([P.mass * 9.8, 0.0, 0.0, 0.002])
    assert abs(free.x[12] - 0.002 / P.Jz) < 1e-6

    env.reset([0, 0, 0])
    obs = env.step([1e9, 1e9, -1e9, 1e9])
    assert env.x[5] <= (cfg.thrust2weight - 1.0) * cfg.g * cfg.dt * 1.01
    assert obs.shape == (20,)

    rpy = np.array([0.3, -0.4, 1.1])
    assert np.allclose(tenv.quat_to_rpy(tenv.rpy_to_quat(rpy)), rpy, atol=1e-12)
    rpy, omega = np.array([0.2, -0.5, 0.9]), np.array([0.7, -1.3, 0.4])
    assert np.allclose(euler_rates_to_body(tenv.body_rates_to_euler_rates(omega, rpy), rpy), omega,
                       atol=1e-12)
    obs = env.reset([1.0, 2.0, 3.0], (0.0, 0.0, 0.5))
    assert np.allclose(obs[0:3], [1, 2, 3])
    assert np.allclose(tenv.quat_to_rpy(obs[[6, 3, 4, 5]]), [0, 0, 0.5], atol=1e-12)
    assert np.allclose(obs[7:10], [0, 0, 0.5], atol=1e-12)


def test_scenario_sampler_equals_original():
    """The same np.random.Generator stream gives the same scenarios (exact)."""
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(50):
        sj = jsim.sample_validation_scenario(a, jsim.ValidationSimConfig())
        st = tsim.sample_validation_scenario(b, tsim.ValidationSimConfig())
        assert sj.keys() == st.keys()
        for k in sj:
            np.testing.assert_array_equal(st[k], sj[k])


def test_logger_files(tmp_path):
    """npy of (n,) and (n, 16), CSV of (n, 21), equal to the original's files."""
    logs = (jsim.SimLogger(), tsim.SimLogger())
    for i in range(5):
        for log in logs:
            log.log(i * 0.01, np.arange(20.0) + i, np.ones(4) * i, extra=2.5)
    for log, d in zip(logs, ("jax", "torch")):
        log.save(str(tmp_path / d))
        log.save_as_csv(str(tmp_path / d))
    ts = np.load(tmp_path / "torch" / "validation_timestamps.npy")
    st = np.load(tmp_path / "torch" / "validation_states.npy")
    assert ts.shape == (5,) and st.shape == (5, 16)
    csv = np.loadtxt(tmp_path / "torch" / "validation.csv", delimiter=",", skiprows=1)
    assert csv.shape == (5, 21)
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_traversal_metrics_equal_original():
    """Seeded straight-line flights through a moving, pitched gate, some
    inside and some outside the opening: equal results (exact)."""
    r = np.random.default_rng(5)
    for _ in range(20):
        n = 60
        start = np.array([r.uniform(-0.6, 0.6), -1.0, r.uniform(-0.8, 0.8)])
        end = start + [r.uniform(-0.3, 0.3), 2.0, r.uniform(-0.3, 0.3)]
        states = np.zeros((n, 13))
        states[:, 0:3] = start + np.linspace(0, 1, n)[:, None] * (end - start)
        pts0 = np.asarray(jgate.gate_from_width(0.8, r.uniform(-0.5, 0.5), 0.5))
        gates = [pts0 + [0.002 * i, 0.0, 0.0] for i in range(n)]
        assert tsim._traversal_metrics(states, gates, 0.8, 0.5) == jsim._traversal_metrics(states, gates, 0.8, 0.5)


@pytest.fixture(scope="module")
def nn3_1():
    """The shipped DNN2 (artifacts/nn3_1) in flax, and the same weights
    carried into the port's MLP by `jax_params_to_torch`."""
    model2 = jmlp.make_dnn2()
    like = model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    params2 = load_params(os.path.join(REPO, "artifacts", "nn3_1"), like=like)
    tmodel = tmlp.make_dnn2()
    tmodel.load_state_dict(jax_params_to_torch(jax.device_get(params2)))
    return model2, params2, tmodel


def _jax_gate_noise(seed, cfg):
    """The draws the JAX package's flight makes for the gate: clip(noise_std * N(0,1)
    from PRNGKey(seed), +-noise_clip), n = int(T / dt) steps, float64."""
    n = int(cfg.duration_sec / (1.0 / cfg.sim_freq_hz))
    raw = jax.random.normal(jax.random.PRNGKey(seed), (n, 3), jnp.float64)
    return np.asarray(jnp.clip(0.1 * raw, -0.2, 0.2))


def test_flight_matches_jax(nn3_1, tmp_path):
    """A 0.3 s flight (30 plant steps, 3 ticks) of the shipped DNN2 against
    the JAX package's flight on the same scenario (seed 3, as in the JAX
    package's own test), weights and gate noise: plant states within 1e-8, the traversal
    result and margin equal, the final distance within 1e-8; the files are
    written, and the replay path flies the saved scenario again to the same
    states (exact).

    Not a fresh DNN2: its random outputs pose problems on which the tick's
    solve stalls at the iteration cap, and a tie decides the flight (see
    test_fresh_dnn2_tick_agrees_up_to_a_tie)."""
    model2, params2, tmodel = nn3_1
    cfg = tsim.ValidationSimConfig(duration_sec=0.3)
    seed = 3
    ref = jsim.run_validation_sim(model2, params2, cfg=jsim.ValidationSimConfig(duration_sec=0.3), seed=seed)
    out = tsim.run_validation_sim(tmodel, cfg=cfg, seed=seed, output_folder=str(tmp_path),
                                  save_settings=True, device="cpu",
                                  gate_noise=_jax_gate_noise(seed, cfg))
    assert out["states"].shape == (30, 13) and np.isfinite(out["states"]).all()
    assert len(out["tick_s"]) == 3
    np.testing.assert_allclose(out["states"], ref["states"], atol=1e-8, rtol=0)
    assert out["through_gate"] == ref["through_gate"]
    assert out["gate_margin"] == ref["gate_margin"] or abs(out["gate_margin"] - ref["gate_margin"]) < 1e-8
    assert abs(out["final_distance"] - ref["final_distance"]) < 1e-8
    for k in ref["scenario"]:
        np.testing.assert_array_equal(out["scenario"][k], ref["scenario"][k])
    assert (tmp_path / "validation.csv").exists() and (tmp_path / "last_inputs.npz").exists()

    short = tsim.ValidationSimConfig(duration_sec=0.05)  # the first tick
    again = tsim.run_validation_sim(tmodel, cfg=short, seed=99, replay_file=str(tmp_path / "last_inputs.npz"),
                                    device="cpu", gate_noise=_jax_gate_noise(seed, short))
    np.testing.assert_array_equal(again["scenario"]["start_point"], out["scenario"]["start_point"])
    np.testing.assert_array_equal(again["states"], out["states"][:5])


def test_gate_trajectory():
    """The JAX package's gate trajectory (its own PRNGKey(seed) draws) equals
    the port's given those draws (1e-15); without them the port draws from a
    CPU generator seeded with `seed`: the same seed the same gate, another
    seed another."""
    from learningagileflight_se3_tpu.geometry.gate import gate_move as jgate_move

    cfg = tsim.ValidationSimConfig(duration_sec=0.5)
    scen = tsim.sample_validation_scenario(np.random.default_rng(4), cfg)
    pts0 = jgate.gate_from_width(scen["gate_width"], scen["gate_pitch"], cfg.half_gate_height)
    ref = jgate_move(pts0, jax.random.PRNGKey(4), jnp.asarray(cfg.gate_v), cfg.gate_w, T=0.5, dt=0.01,
                     noise_std=0.1, noise_clip=0.2)
    moves, V = tsim.gate_trajectory(scen, cfg, 4, _jax_gate_noise(4, cfg))
    np.testing.assert_allclose(moves, np.asarray(ref[0]), atol=1e-15, rtol=0)
    np.testing.assert_allclose(V, np.asarray(ref[1]), atol=1e-15, rtol=0)
    a, b, c = (tsim.gate_trajectory(scen, cfg, s)[0] for s in (1, 1, 2))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (51, 4, 3) and np.abs(a - c).max() > 1e-4


def test_fresh_dnn2_tick_agrees_up_to_a_tie():
    """A fresh DNN2 (flax init from PRNGKey(0), carried across) on seed 3's
    first tick: the window-frame problem it poses is one on which the solve
    stalls (the iteration cap of 64, projected gradient about 450), and at
    its DDP iteration 22 the accept test compares costs equal to 1e-16
    relative, a tie that falls one way in the JAX single solver and the
    other way in the port's batch of one.  Up to that iteration the tick's
    solve agrees with the JAX package's on the same inputs: cost within
    1e-12 relative and controls within 1e-9 after 20 iterations."""
    import dataclasses

    from learningagileflight_se3_tpu.solver.ilqr import make_mpc_solver
    from learningagileflight_se3_torch.sim.external_controller import ExternalSimController

    model2 = jmlp.make_dnn2()
    params2 = model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    tmodel = tmlp.make_dnn2()
    tmodel.load_state_dict(jax_params_to_torch(jax.device_get(params2)))
    seen = []
    real_init = ExternalSimController.__init__

    class Seen(Exception):
        pass

    def init(self, *a, **kw):  # keep the inputs of the tick's first solve, and stop there
        real_init(self, *a, **kw)
        self._solve = lambda *args, **k: seen.append(args) or (_ for _ in ()).throw(Seen())

    cfg = tsim.ValidationSimConfig(duration_sec=0.01)
    try:
        ExternalSimController.__init__ = init
        with pytest.raises(Seen):
            tsim.run_validation_sim(tmodel, cfg=cfg, seed=3, device="cpu", gate_noise=np.zeros((1, 3)))
    finally:
        ExternalSimController.__init__ = real_init
    args = seen[0]
    _, W, S = jcfg.preset(jcfg.Variant.PYBULLET)[:3]
    tP, tW, tS = tcfg.preset(tcfg.Variant.PYBULLET)[:3]
    js = jax.jit(make_mpc_solver(jcfg.QuadParams(), W, dataclasses.replace(S, max_iters=20),
                                 return_gains=False))(*[jnp.asarray(a[0].numpy()) for a in args])
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    ts = make_batched_mpc_solver(tP, tW, dataclasses.replace(tS, max_iters=20))(*args)
    assert int(js.iterations) == int(ts.iterations[0]) == 20 and int(js.status) == int(ts.status[0])
    assert abs(float(ts.cost[0]) - float(js.cost)) <= 1e-12 * abs(float(js.cost))
    np.testing.assert_allclose(ts.control_traj[0].numpy(), np.asarray(js.control_traj), atol=1e-9, rtol=0)


def test_plots(tmp_path):
    """The logger's plot and the plotting module's figures are written
    (skipped where matplotlib is missing)."""
    pytest.importorskip("matplotlib")
    from learningagileflight_se3_torch.sim import plotting

    log = tsim.SimLogger()
    for i in range(10):
        log.log(i * 0.01, np.arange(20.0) * 0.1 * i, np.ones(4) * i)
    log.plot(str(tmp_path))
    X = np.zeros((11, 13))
    X[:, 6] = 1.0
    X[:, 1] = np.linspace(-1, 1, 11)
    plotting.plot_position(X, path=str(tmp_path / "pos.png"))
    plotting.plot_input(np.ones((10, 4)), path=str(tmp_path / "u.png"))
    for f in ("validation.png", "pos.png", "u.png"):
        assert (tmp_path / f).stat().st_size > 0
    from learningagileflight_se3_tpu.sim import plotting as jplot

    np.testing.assert_array_equal(plotting.quadrotor_positions(X, 1.5), jplot.quadrotor_positions(X, 1.5))
