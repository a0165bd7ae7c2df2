"""PyTorch port, the 10 Hz deployment tick and what it is built from.

On the CPU, against the JAX package on the same numpy inputs (float64): the
exported DNN2 weights against the orbax checkpoint they came from, the
flax-to-PyTorch conversion, the gate kinematics and window inputs, both
traversal-time solvers, the sampler's scenario expansion, and the replay
contract (artifacts/replay_contract.npz) replayed through the port's
ExternalSimController with the JAX contract test's tolerances."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from learningagileflight_se3_tpu.geometry import gate as jgate
from learningagileflight_se3_tpu.models import mlp as jmlp
from learningagileflight_se3_tpu.models import sampler as jsampler
from learningagileflight_se3_tpu.sim.tsolver import make_traversal_time_solver as jtsolver
from learningagileflight_se3_tpu.utils.checkpoint import load_params

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SamplerConfig, SolverConfig, Variant
from learningagileflight_se3_torch.geometry import gate as tgate
from learningagileflight_se3_torch.models import mlp as tmlp
from learningagileflight_se3_torch.models import sampler as tsampler
from learningagileflight_se3_torch.ops import riccati_fused, rollout
from learningagileflight_se3_torch.sim.external_controller import ExternalSimController
from learningagileflight_se3_torch.sim.tsolver import make_traversal_time_solver
from learningagileflight_se3_torch.utils.weights import NN3_1_DNN2, jax_params_to_torch, load_dnn2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = os.path.join(REPO, "artifacts", "replay_contract.npz")
TOL = dict(atol=1e-12, rtol=1e-10)


def close(a, b, **kw):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **(kw or TOL))


@pytest.fixture(scope="module")
def jax_dnn2():
    model2 = jmlp.make_dnn2()
    like = model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    return model2, load_params(os.path.join(REPO, "artifacts", "nn3_1"), like=like)


@pytest.fixture(scope="module")
def torch_dnn2():
    return load_dnn2().double()


def _gates(r, n):
    """n random pitched, translated gates (n,4,3)."""
    w = r.uniform(0.6, 1.6, size=n)
    pitch = r.uniform(-1.2, 1.2, size=n)
    shift = r.normal(size=(n, 3)) * 2.0
    pts = jax.vmap(jgate.gate_from_width)(jnp.asarray(w), jnp.asarray(pitch))
    return np.asarray(pts) + shift[:, None, :]


def _states(r, n):
    x = r.normal(size=(n, 13))
    x[:, 0:3] += [0.0, -4.0, 1.0]
    q = r.normal(size=(n, 4)) * 0.4
    q[:, 0] += 1.0
    x[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return x


def test_exported_npz_equals_checkpoint(jax_dnn2):
    _, params = jax_dnn2
    flat = traverse_util.flatten_dict(jax.device_get(params), sep="/")
    with np.load(NN3_1_DNN2) as z:
        assert sorted(z.files) == sorted(flat)
        for k, v in flat.items():
            a, b = z[k], np.asarray(v)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


def test_converted_dnn2_equals_flax_apply(jax_dnn2, torch_dnn2, rng):
    model2, params = jax_dnn2
    x = rng.normal(size=(32, 18))
    close(torch_dnn2(torch.tensor(x)), model2.apply(params, jnp.asarray(x)))
    close(torch_dnn2(torch.tensor(x[0])), model2.apply(params, jnp.asarray(x[0])))


@pytest.mark.parametrize("name,n_in", [("make_dnn1", 9), ("make_dnn2", 18)])
def test_jax_params_to_torch_on_fresh_params(name, n_in, rng):
    """Both networks: nested flax params convert, kernel.T is the weight."""
    jmodel = getattr(jmlp, name)()
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, n_in)))
    state = jax_params_to_torch(jax.tree_util.tree_map(np.asarray, params))
    tmodel = getattr(tmlp, name)()
    tmodel.load_state_dict(state)
    np.testing.assert_array_equal(state["layers.0.weight"].numpy(),
                                  np.asarray(params["params"]["Dense_0"]["kernel"]).T)
    x = rng.normal(size=(8, n_in))
    close(tmodel.double()(torch.tensor(x)), jmodel.apply(params, jnp.asarray(x)))


def test_gate_kinematics_and_window_inputs(rng):
    n = 48
    pts, st = _gates(rng, n), _states(rng, n)
    fin, disp, ang = rng.normal(size=(n, 3)) * 3, rng.normal(size=(n, 3)), rng.normal(size=n)
    tp, ts, tf = torch.tensor(pts), torch.tensor(st), torch.tensor(fin)
    v = jax.vmap
    close(tgate.gate_centroid(tp), v(jgate.gate_centroid)(pts))
    close(tgate.gate_frame(tp), v(jgate.gate_frame)(pts))
    close(tgate.gate_width(tp), v(jgate.gate_width)(pts))
    close(tgate.gate_pitch(tp), v(jgate.gate_pitch)(pts))
    close(tgate.rotate_y(tp, torch.tensor(ang)), v(jgate.rotate_y)(pts, ang))
    close(tgate.translate(tp, torch.tensor(disp)), v(jgate.translate)(pts, disp))
    close(tgate.transform_state_to_window(tp, ts), v(jgate.transform_state_to_window)(pts, st))
    close(tgate.final_to_window(tp, tf), v(jgate.final_to_window)(pts, fin))
    close(tgate.window_inputs(tp, ts, tf), v(jgate.window_inputs)(pts, st, fin))
    w, p = rng.uniform(0.5, 1.5, size=n), rng.uniform(-1, 1, size=n)
    close(tgate.gate_from_width(torch.tensor(w), torch.tensor(p), 0.8),
          v(lambda a, b: jgate.gate_from_width(a, b, 0.8))(w, p))
    close(tgate.gate_from_width(torch.tensor(w)), v(jgate.gate_from_width)(w))


@pytest.mark.parametrize("accel", ["reference", "secant"])
def test_traversal_time_solvers(accel, jax_dnn2, torch_dnn2):
    """Both fixed points on the contract's first ticks' geometry."""
    model2, params = jax_dnn2
    z = np.load(CONTRACT)
    jsolve = jax.jit(jtsolver(model2, tol=float(z["fixed_point_tol"]), accel=accel))
    tsolve = make_traversal_time_solver(torch_dnn2, tol=float(z["fixed_point_tol"]), accel=accel)
    r = np.random.default_rng(5)
    for k in range(3):
        obs = z["observations"][k]
        state = np.concatenate([obs[0:3] - z["origin"], obs[10:13], obs[[6, 3, 4, 5]],
                                r.normal(size=3) * 0.1])
        pts, velo = z["gate_moves"][int(z["tick_steps"][k])], z["gate_vel"][int(z["tick_steps"][k])]
        ref = jsolve(params, state, z["final_point"], pts, velo, float(z["w_rot"]))
        with torch.no_grad():
            out = tsolve(*[torch.tensor(a) for a in (state, z["final_point"], pts, velo)],
                         float(z["w_rot"]))
        assert abs(float(out) - float(ref)) < 1e-10, (k, float(out), float(ref))


def test_scenario_to_problem_and_sampler_support():
    r = np.random.default_rng(2)
    scen = np.asarray(jsampler.sample_scenarios(jax.random.PRNGKey(0), 64))
    scen = scen + r.normal(size=scen.shape) * 1e-3  # not the JAX draw's own values
    ref = jax.vmap(jsampler.scenario_to_problem)(jnp.asarray(scen))
    out = tsampler.scenario_to_problem(torch.tensor(scen))
    for k in ("x0", "goal_pos", "gate_pts"):
        close(out[k], ref[k])
    # the torch draw has the JAX draw's support (its numbers differ)
    cfg = SamplerConfig()
    s = tsampler.sample_scenarios(torch.Generator().manual_seed(0), 4096, dtype=torch.float64)
    assert s.shape == (4096, 9) and s.dtype == torch.float64
    lo = torch.tensor(cfg.init_pos_offset) - cfg.init_pos_halfwidth
    hi = torch.tensor(cfg.init_pos_offset) + cfg.init_pos_halfwidth
    assert bool(((s[:, 0:3] >= lo) & (s[:, 0:3] <= hi)).all())
    assert bool(((s[:, 7] >= cfg.width_clip[0]) & (s[:, 7] <= cfg.width_clip[1])).all())
    angle = torch.clamp(1.3 * (1.2 - s[:, 7]), 0.0, np.pi / 3)
    assert bool((s[:, 8].abs() >= angle - 1e-12).all() & (s[:, 8].abs() <= np.pi / 2).all())
    assert 0.4 < float((s[:, 8] > 0).double().mean()) < 0.6
    one = tsampler.sample_scenario(torch.Generator().manual_seed(0))
    assert one.shape == (9,)


def test_replay_contract_through_the_port():
    """tests/test_pybullet_harness.py::TestReplayContract, through the port on
    the CPU in float64 (the plain versions of the kernels)."""
    z = np.load(CONTRACT)
    moves, V = z["gate_moves"], z["gate_vel"]
    ctrl = ExternalSimController(
        load_dnn2(), final_point=z["final_point"],
        gate_motion=lambda i: (moves[min(i, len(moves) - 1)], V[min(i, len(moves) - 1)]),
        w_rot=float(z["w_rot"]), origin=z["origin"], variant=Variant.PYBULLET,
        solver_cfg=SolverConfig(horizon=int(z["solver_horizon"]),
                                max_iters=int(z["solver_max_iters"]),
                                u_ub=float(z["solver_u_ub"])),
        fixed_point_tol=float(z["fixed_point_tol"]), device="cpu",
    )
    plain = (rollout.plain_calls, riccati_fused.plain_calls)
    for k in range(len(z["tick_steps"])):
        obs = z["observations"][k]
        action, t_pred = ctrl.compute_control(
            step=int(z["tick_steps"][k]), cur_pos=obs[0:3], cur_quat_xyzw=obs[3:7],
            cur_vel=obs[10:13], cur_euler_rates=obs[13:16], cur_rpy=obs[7:10])
        np.testing.assert_allclose(action, z["actions"][k], atol=1e-4, rtol=0,
                                   err_msg=f"control wrench drifted at tick {k}")
        assert abs(float(t_pred) - z["tra_times"][k]) < 1e-6, f"traversal time drifted at tick {k}"
    assert rollout.plain_calls > plain[0] and riccati_fused.plain_calls > plain[1]


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """ExternalSimController, run_rl_training, run_pretraining,
    run_imitation_training, make_closed_loop_sim, run_validation_sim,
    make_mesh, initialize_distributed (given the LAF_* variables), the
    single-problem solver make_mpc_solver (whatever its inputs) and the
    two ablation scripts' mains run on the card unless given device="cpu":
    without a card their default raises before any work, and nothing runs
    on the CPU in its place."""
    import importlib.util
    import os

    from learningagileflight_se3_torch.parallel.distributed import initialize_distributed
    from learningagileflight_se3_torch.parallel.mesh import make_mesh
    from learningagileflight_se3_torch.sim.closed_loop import make_closed_loop_sim
    from learningagileflight_se3_torch.sim.validation_sim import ValidationSimConfig, run_validation_sim
    from learningagileflight_se3_torch.solver.ilqr import make_mpc_solver
    from learningagileflight_se3_torch.train.imitation import run_imitation_training
    from learningagileflight_se3_torch.train.pretrain import run_pretraining
    from learningagileflight_se3_torch.train.rl import run_rl_training
    from learningagileflight_se3_torch.utils.weights import load_dnn1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plain = (rollout.plain_calls, riccati_fused.plain_calls)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExternalSimController(load_dnn2(), final_point=np.zeros(3),
                              gate_motion=lambda i: (np.zeros((4, 3)), np.zeros(3)), w_rot=0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_rl_training(0, load_dnn1(), epochs=1, batch_size=2, log_fn=lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pretraining(0, steps=1, batch_size=2, log_fn=lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_imitation_training(0, load_dnn1(), epochs=1, batch_scenarios=2, log_fn=lambda *a: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_closed_loop_sim(load_dnn2())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_validation_sim(load_dnn2(), ValidationSimConfig(duration_sec=0.01))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mpc_solver(QuadParams(), CostWeights(), SolverConfig(horizon=4, max_iters=2))
    monkeypatch.setenv("LAF_COORDINATOR_ADDRESS", "file://" + str(tmp_path / "store"))
    monkeypatch.setenv("LAF_NUM_PROCESSES", "2")
    monkeypatch.setenv("LAF_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed()
    scripts = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
    for name in ("torch_ablate_rl", "torch_ablate_imitation"):
        spec = importlib.util.spec_from_file_location(name, os.path.join(scripts, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--out", str(tmp_path / name)])
        assert not os.path.exists(tmp_path / name)
    assert not (tmp_path / "store").exists()
    assert (rollout.plain_calls, riccati_fused.plain_calls) == plain
    ctrl = ExternalSimController(load_dnn2(), final_point=np.zeros(3),
                                 gate_motion=lambda i: (np.zeros((4, 3)), np.zeros(3)),
                                 w_rot=0.0, device="cpu")
    assert ctrl.device == torch.device("cpu")
    sol = make_mpc_solver(QuadParams(), CostWeights(), SolverConfig(horizon=4, max_iters=2), device="cpu")(
        np.eye(13)[6], np.zeros(4), [0.0, 4.0, 0.0], np.zeros(3), [0.0, 0.3, 0.0], 1.0)
    assert sol.control_traj.device.type == "cpu" and sol.control_traj.dtype == torch.float64
    sim = make_closed_loop_sim(load_dnn2(), solver_cfg=SolverConfig(horizon=4, max_iters=2), steps=1,
                               device="cpu")
    assert sim(np.zeros((1, 9)) + [0, -8, 0, 0, 6, 0, 0, 1, 0.3], generator=torch.Generator()).states.device.type == "cpu"
