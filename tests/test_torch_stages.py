"""PyTorch port, stage 1 (pretraining) and stage 3 (imitation).

On the CPU, against the JAX package on the same numpy inputs and the same
initial weights (through `jax_params_to_torch`), float64 weights:

  * the pretrain step on the JAX package's scenarios, and 5 steps of
    `run_pretraining` on its own scenarios, against optax Adam: losses and weights
    rtol 1e-9;
  * `traversal_pose_to_window`, both quaternion hemispheres (1e-12);
  * the imitation collect in the three label modes at H=10, B=4 against the
    JAX collect on lanes both solvers call converged (tight `tol`, default
    `max_iters`): inputs and labels atol 1e-6;
  * the imitation step under the cosine schedule against optax (rtol 1e-9);
  * the runs' seeded initialisation, determinism and device rule, and the
    parameter checkpoint.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.geometry import gate as jgate
from learningagileflight_se3_tpu.models import mlp as jmlp
from learningagileflight_se3_tpu.models import sampler as jsampler
from learningagileflight_se3_tpu.solver import ilqr as jilqr
from learningagileflight_se3_tpu.train import imitation as jimi
from learningagileflight_se3_tpu.train import pretrain as jpre

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.geometry import gate as tgate
from learningagileflight_se3_torch.models import mlp as tmlp
from learningagileflight_se3_torch.models.sampler import sample_scenarios
from learningagileflight_se3_torch.train import imitation as timi
from learningagileflight_se3_torch.train import pretrain as tpre
from learningagileflight_se3_torch.train.rl import cosine_decay_schedule, epoch_generator
from learningagileflight_se3_torch.utils import weights as tweights
from learningagileflight_se3_torch.utils.checkpoint import load_params, save_params

RTOL9 = dict(rtol=1e-9, atol=1e-12)


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(a, b, **kw):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **kw)


def _f64(params):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params)


def _pair(name, n_in, seed):
    """The same float64 network in both packages: (flax model, params, MLP)."""
    jmodel = getattr(jmlp, name)()
    params = _f64(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, n_in))))
    tmodel = getattr(tmlp, name)().double()
    tmodel.load_state_dict(tweights.jax_params_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _assert_same_weights(tmodel, params, **kw):
    want = tweights.jax_params_to_torch(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tmodel.state_dict().items():
        assert p.dtype == torch.float64
        close(p, want[name].numpy(), **kw)


# --------------------------------------------------------------- stage 1
def test_pretrain_step_matches_jax_on_its_scenarios():
    """Three steps of make_pretrain_step on the scenarios the JAX step draws
    from its key, optax Adam against torch Adam (lr 1e-3 so that the weights
    move by far more than the tolerance)."""
    jmodel, params, tmodel = _pair("make_dnn1", 9, seed=3)
    opt = optax.adam(1e-3)
    jstep = jax.jit(jpre.make_pretrain_step(jmodel, opt), static_argnums=(3,))
    tstep = tpre.make_pretrain_step(tmodel, torch.optim.Adam(tmodel.parameters(), lr=1e-3))
    state = opt.init(params)
    p0 = [p.detach().clone() for p in tmodel.parameters()]
    for i in range(3):
        key = jax.random.PRNGKey(40 + i)
        scen = np.asarray(jsampler.sample_scenarios(key, 32))
        assert scen.dtype == np.float64
        params, state, loss_j = jstep(params, state, key, 32)
        loss_t = tstep(t64(scen))
        close(loss_t, loss_j, **RTOL9)
    _assert_same_weights(tmodel, params, **RTOL9)
    assert max(float((p.detach() - q).abs().max()) for p, q in zip(tmodel.parameters(), p0)) > 1e-3


def test_run_pretraining_matches_optax_on_its_own_scenarios():
    """run_pretraining for 5 steps in chunks of 2: its scenarios come from
    epoch_generator(seed, chunk); the same scenarios through the JAX loss and
    optax give the chunk losses and the final weights."""
    jmodel, params, tmodel = _pair("make_dnn1", 9, seed=4)
    seed, B, lr = 11, 16, 1e-3
    logs = []
    model, losses = tpre.run_pretraining(seed, steps=5, batch_size=B, lr=lr, model=tmodel,
                                         log_every=2, log_fn=logs.append, device="cpu")
    assert model is tmodel and len(losses) == 3 and len(logs) == 3
    assert logs[-1].startswith("pretrain step 5/5 loss ")

    opt = optax.adam(lr)
    state = opt.init(params)

    @jax.jit
    def jstep(params, state, scen):
        labels = jax.vmap(jsampler.pretrain_label)(scen)
        loss, grads = jax.value_and_grad(
            lambda p: jnp.mean((jmodel.apply(p, scen) - labels) ** 2))(params)
        upd, state = opt.update(grads, state, params)
        return optax.apply_updates(params, upd), state, loss

    want = []
    for chunk, n in enumerate((2, 2, 1)):
        gen = epoch_generator(seed, chunk, "cpu")
        for _ in range(n):
            scen = sample_scenarios(gen, B, dtype=torch.float64).numpy()
            params, state, loss = jstep(params, state, jnp.asarray(scen))
        want.append(float(loss))
    close(losses, want, **RTOL9)
    _assert_same_weights(tmodel, params, **RTOL9)


def test_pretraining_from_a_seeded_init_is_reproducible_and_learns():
    a, la = tpre.run_pretraining(5, steps=60, batch_size=64, lr=1e-3, log_every=20,
                                 log_fn=lambda *_: None, device="cpu")
    b, lb = tpre.run_pretraining(5, steps=60, batch_size=64, lr=1e-3, log_every=20,
                                 log_fn=lambda *_: None, device="cpu")
    c, _ = tpre.run_pretraining(6, steps=1, batch_size=4, log_fn=lambda *_: None, device="cpu")
    assert la == lb and len(la) == 3 and la[-1] < la[0]
    for (n, p), q, r in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(p, q) and not torch.equal(p, r), n
    assert next(a.parameters()).dtype == torch.float32


def test_evaluate_pretrain_matches_jax_on_the_same_scenarios():
    jmodel, params, tmodel = _pair("make_dnn1", 9, seed=8)
    got = tpre.evaluate_pretrain(tmodel, torch.Generator().manual_seed(2), n=300)
    scen = sample_scenarios(torch.Generator().manual_seed(2), 300, dtype=torch.float64).numpy()
    labels = jax.vmap(jsampler.pretrain_label)(jnp.asarray(scen))
    want = float(jnp.mean((jmodel.apply(params, jnp.asarray(scen)) - labels) ** 2))
    assert isinstance(got, float)
    close(got, want, rtol=1e-12, atol=0)


def test_save_and_load_params_round_trip(tmp_path):
    model = tmlp.make_dnn2(generator=torch.Generator().manual_seed(1))
    save_params(str(tmp_path / "nn3_1"), model)
    other = load_params(str(tmp_path / "nn3_1"), tmlp.make_dnn2())
    for (n, p), q in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(p, q), n
    save_params(str(tmp_path / "nn3_1"), tmlp.make_dnn2(generator=torch.Generator().manual_seed(2)))
    again = load_params(str(tmp_path / "nn3_1"), tmlp.make_dnn2())
    assert not torch.equal(again.layers[0].weight, model.layers[0].weight)


# --------------------------------------------------------------- stage 3
def test_traversal_pose_to_window_matches_jax(rng):
    """Gates turned about z by up to +-pi and large desired rotations, so that
    both hemispheres of the window-frame quaternion occur."""
    n = 64
    pts = np.asarray(jax.vmap(jgate.gate_from_width)(jnp.asarray(rng.uniform(0.6, 1.4, n)),
                                                     jnp.asarray(rng.uniform(-1.2, 1.2, n))))
    pts = np.asarray(jax.vmap(jgate.rotate_z)(jnp.asarray(pts), jnp.asarray(rng.uniform(-3.1, 3.1, n))))
    pts = pts + rng.normal(size=(n, 1, 3))
    pos, ang = rng.normal(size=(n, 3)) * 2.0, rng.normal(size=(n, 3)) * 1.5
    pos_j, ang_j = jax.vmap(jimi.traversal_pose_to_window)(pts, pos, ang)
    pos_t, ang_t = timi.traversal_pose_to_window(t64(pts), t64(pos), t64(ang))
    close(pos_t, pos_j, rtol=1e-12, atol=1e-12)
    close(ang_t, ang_j, rtol=1e-12, atol=1e-12)
    from learningagileflight_se3_torch.core import rotations as trot

    q_win = trot.quat_mul(trot.dcm_to_quat(tgate.gate_frame(t64(pts))), trot.rodrigues_to_quat(t64(ang)))
    flipped = int((q_win[:, 0] < 0).sum())
    assert 0 < flipped < n, flipped
    one_pos, one_ang = timi.traversal_pose_to_window(t64(pts[3]), t64(pos[3]), t64(ang[3]))
    close(one_pos, pos_t[3], rtol=0, atol=0)
    close(one_ang, ang_t[3], rtol=0, atol=0)


_JAX_SOLVERS = {}


def _cached_vmapped_solver(params, weights, cfg, return_gains=False, backend="auto"):
    """Stand-in for the JAX package's make_batched_mpc_solver on the CPU (the
    vmapped single-problem solver), jitted once per configuration and shared
    by the three collects."""
    key = (params, weights, cfg, return_gains)
    if key not in _JAX_SOLVERS:
        _JAX_SOLVERS[key] = jax.jit(jax.vmap(
            jilqr.make_mpc_solver(params, weights, cfg, return_gains=return_gains)))
    return _JAX_SOLVERS[key]


COLLECT_H, COLLECT_B = 10, 4


@pytest.mark.parametrize("window_frame,consistent", [(False, False), (True, False), (True, True)])
def test_imitation_collect_matches_jax(monkeypatch, window_frame, consistent):
    monkeypatch.setattr(jilqr, "make_batched_mpc_solver", _cached_vmapped_solver)
    H, B = COLLECT_H, COLLECT_B
    scen = sample_scenarios(torch.Generator().manual_seed(31), B, dtype=torch.float64).numpy()
    jmodel, params = jmlp.make_dnn1(), None
    with np.load(tweights.NN_DEEP_DNN1) as z:
        flat = {k: z[k] for k in z.files}
    params = {"params": {f"Dense_{i}": {"kernel": jnp.asarray(flat[f"params/Dense_{i}/kernel"]),
                                        "bias": jnp.asarray(flat[f"params/Dense_{i}/bias"])}
                         for i in range(3)}}
    inp_j, lab_j = jimi.make_imitation_collect(
        jmodel, jcfg.QuadParams(), jcfg.CostWeights(), jcfg.SolverConfig(horizon=H),
        window_frame, consistent)(params, jnp.asarray(scen))
    sol_j = _cached_vmapped_solver(jcfg.QuadParams(), jcfg.CostWeights(), jcfg.SolverConfig(horizon=H))
    collect = timi.make_imitation_collect(
        tweights.load_dnn1(tweights.NN_DEEP_DNN1), tcfg.QuadParams(), tcfg.CostWeights(),
        tcfg.SolverConfig(horizon=H), window_frame, consistent)
    inp_t, lab_t, sol = collect(t64(scen), with_solution=True)
    assert inp_t.shape == (B * H, 18) and lab_t.shape == (B * H, 7)
    assert inp_t.dtype == lab_t.dtype == torch.float64
    assert len(collect(t64(scen))) == 2
    # lanes both call converged: the JAX lanes' flags from the same solve
    out = np.asarray(jmodel.apply(params, jnp.asarray(scen)))
    probs = jax.vmap(jsampler.scenario_to_problem)(jnp.asarray(scen))
    conv_j = np.asarray(sol_j(probs["x0"], jnp.zeros((B, 4)), probs["goal_pos"], out[:, 0:3],
                              out[:, 3:6], out[:, 6]).converged)
    both = np.repeat(conv_j & sol.converged.numpy(), H)
    assert both.reshape(B, H)[:, 0].sum() >= B - 1, (conv_j, sol.converged)
    close(inp_t[both], np.asarray(inp_j)[both], rtol=0, atol=1e-6)
    close(lab_t[both], np.asarray(lab_j)[both], rtol=0, atol=1e-6)
    # the time label counts down dt per step from DNN1's time
    lab = lab_t.reshape(B, H, 7)
    close(lab[:, :, 6], out[:, 6:7] - 0.1 * np.arange(H), rtol=0, atol=1e-12)
    if not window_frame:
        close(inp_t.reshape(B, H, 18)[:, 0, 0:3], scen[:, 0:3], rtol=0, atol=0)
        close(inp_t.reshape(B, H, 18)[:, :, 13:16], np.repeat(scen[:, None, 3:6], H, 1), rtol=0, atol=0)


def test_consistent_labels_need_the_window_frame():
    with pytest.raises(ValueError, match="consistent_labels requires window_frame"):
        timi.make_imitation_collect(tmlp.make_dnn1(), tcfg.QuadParams(), tcfg.CostWeights(),
                                    tcfg.SolverConfig(horizon=4), window_frame=False,
                                    consistent_labels=True)


def test_imitation_step_under_the_cosine_schedule_matches_optax(rng):
    """Six steps over one collected batch: optax Adam under
    cosine_decay_schedule(lr, 6, alpha=0.01) against torch Adam with the
    port's schedule set before each step."""
    jmodel, params, tmodel = _pair("make_dnn2", 18, seed=9)
    inputs, labels = rng.normal(size=(40, 18)), rng.normal(size=(40, 7))
    lr, n = 1e-3, 6
    sched_j = optax.cosine_decay_schedule(lr, n, alpha=0.01)
    sched_t = cosine_decay_schedule(lr, n, alpha=0.01)
    close([sched_t(c) for c in range(n + 2)], [float(sched_j(c)) for c in range(n + 2)],
          rtol=1e-12, atol=0)
    opt = optax.adam(sched_j)
    jstep = jax.jit(jimi.make_imitation_train_step(jmodel, opt))
    optimizer = torch.optim.Adam(tmodel.parameters(), lr=lr)
    tstep = timi.make_imitation_train_step(tmodel, optimizer)
    state = opt.init(params)
    for c in range(n):
        params, state, loss_j = jstep(params, state, jnp.asarray(inputs), jnp.asarray(labels))
        for group in optimizer.param_groups:
            group["lr"] = sched_t(c)
        close(tstep(t64(inputs), t64(labels)), loss_j, **RTOL9)
    _assert_same_weights(tmodel, params, **RTOL9)


def test_run_imitation_training_equals_its_parts_and_is_reproducible():
    """run_imitation_training at a tiny size: the epochs' scenarios come from
    epoch_generator(seed, e), each epoch is one collect and `sgd_passes`
    scheduled steps, and a second run gives the same losses and weights."""
    cfg = tcfg.SolverConfig(horizon=6, max_iters=8)
    kw = dict(epochs=2, batch_scenarios=3, sgd_passes=2, lr=1e-3, solver_cfg=cfg, window_frame=True,
              lr_schedule=True, device="cpu")
    teacher = lambda: tweights.load_dnn1(tweights.NN_DEEP_DNN1)
    logs = []
    m_a, l_a = timi.run_imitation_training(3, teacher(), log_fn=logs.append, **kw)
    m_b, l_b = timi.run_imitation_training(3, teacher(), log_fn=lambda *_: None, **kw)
    assert l_a == l_b and len(l_a) == 2 and all(np.isfinite(l_a))
    assert len(logs) == 1 and logs[0].startswith("imitation 2 epochs loss ")

    from learningagileflight_se3_torch.train.rl import init_generator

    model2 = tmlp.make_dnn2(generator=init_generator(3))
    optimizer = torch.optim.Adam(model2.parameters(), lr=1e-3)
    collect = timi.make_imitation_collect(teacher(), tcfg.QuadParams(), tcfg.CostWeights(), cfg,
                                          window_frame=True)
    step = timi.make_imitation_train_step(model2, optimizer)
    sched = cosine_decay_schedule(1e-3, 4, alpha=0.01)
    want = []
    for e in range(2):
        data = collect(sample_scenarios(epoch_generator(3, e, "cpu"), 3))
        for p in range(2):
            optimizer.param_groups[0]["lr"] = sched(2 * e + p)
            loss = step(*data)
        want.append(float(loss))
    assert l_a == want
    for (n, p), q, r in zip(m_a.state_dict().items(), m_b.state_dict().values(),
                            model2.state_dict().values()):
        assert torch.equal(p, q) and torch.equal(p, r), n


def test_stage_runs_default_to_the_card(monkeypatch):
    from learningagileflight_se3_torch.ops import riccati_fused, rollout

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plain = (rollout.plain_calls, riccati_fused.plain_calls)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.run_pretraining(0, steps=1, batch_size=2, log_fn=lambda *_: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timi.run_imitation_training(0, tmlp.make_dnn1(), epochs=1, batch_scenarios=2,
                                    log_fn=lambda *_: None)
    assert (rollout.plain_calls, riccati_fused.plain_calls) == plain
