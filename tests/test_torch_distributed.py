"""PyTorch port, multi-process data-parallel RL (parallel/, train/rl.py with a mesh).

Two gloo ranks on the CPU (processes of their own, a FileStore under
tmp_path, every join bounded), float64 scenarios, horizon 5, 2 DDP
iterations, 8 scenarios:

  * the dry run (parallel/dryrun.py) in the fd and analytic modes: the
    sharded step against the unsharded one with the network in float64
    (rewards rtol 1e-12, parameters atol 1e-10), both ranks identical;
  * fault injection as tests/test_training.py::TestShardedFaultInjection:
    poisoned rows (a NaN start, an absurd start, an absurd goal) on both
    ranks are masked, the update is finite and equals the unsharded masked
    update, and the clean rows' rewards are those of a clean batch;
  * the port's sharded step against the JAX package's sharded step on its
    CPU mesh (tests/test_training.py::TestRLStep::test_sharded_matches_unsharded),
    nn_pre's parameters carried over through utils/weights.py (float32
    Adam: the JAX dry run's atol 1.5e-4 on the parameters);
  * resume from rank 0's checkpoint equals the uninterrupted sharded run;
  * `B % world` raises, `global_batch_from_host` keeps this rank's rows,
    and `initialize_distributed()` without the LAF_* variables returns
    False (no process needed).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from learningagileflight_se3_tpu import config as jcfg
from learningagileflight_se3_tpu.models import mlp as jmlp
from learningagileflight_se3_tpu.parallel.mesh import make_mesh as jmake_mesh, replicate as jreplicate
from learningagileflight_se3_tpu.parallel.mesh import shard_batch as jshard_batch
from learningagileflight_se3_tpu.train.rl import make_rl_train_step as jstep

from learningagileflight_se3_torch import config as tcfg
from learningagileflight_se3_torch.models.sampler import sample_scenarios
from learningagileflight_se3_torch.parallel import distributed
from learningagileflight_se3_torch.parallel.dryrun import dryrun_multiprocess, run_ranks
from learningagileflight_se3_torch.parallel.mesh import Mesh, shard_batch
from learningagileflight_se3_torch.train.rl import make_rl_train_step
from learningagileflight_se3_torch.utils import weights as tweights

import torch_dist_worker as worker

TINY = dict(horizon=5, max_iters=2)
CFG = tcfg.SolverConfig(**TINY)
P_T, W_T, R_T = tcfg.QuadParams(), tcfg.CostWeights(), tcfg.RewardConfig()


def _scenarios(B, seed):
    return sample_scenarios(torch.Generator().manual_seed(seed), B, dtype=torch.float64)


def _unsharded(scen, grad_mode, dtype):
    model = tweights.load_dnn1(tweights.NN_PRE_DNN1).to(dtype)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    res = make_rl_train_step(model, opt, P_T, W_T, CFG, R_T, grad_mode=grad_mode)(scen)
    return [p.detach().clone() for p in model.parameters()], res.rewards, res.valid


@pytest.mark.parametrize("grad_mode", ["fd", "analytic"])
def test_dryrun_sharded_equals_unsharded_f64(tmp_path, grad_mode):
    report = dryrun_multiprocess(2, device="cpu", batch=8, solver_cfg=CFG, dtype=torch.float64,
                                 grad_modes=(grad_mode,), scratch_dir=str(tmp_path))
    assert report[grad_mode]["param_abs"] <= 1e-10 and report[grad_mode]["reward_rel"] <= 1e-12


def _poisoned(scen):
    scen = scen.clone()
    scen[1, 0] = float("nan")   # NaN start (rank 0)
    scen[3, :3] = 1e6           # absurd start position (rank 0)
    scen[6, 3:6] = -1e6         # absurd goal (rank 1)
    return scen


def test_sharded_fault_injection(tmp_path):
    clean = _scenarios(8, seed=11)
    poisoned = _poisoned(clean)
    got = run_ranks(worker.steps, 2, device="cpu", args=([clean, poisoned], CFG, "fd", torch.float64),
                    scratch_dir=str(tmp_path))
    (p_clean, r_clean, _), (p_s, r_s, v_s) = got[0]
    for a, b in zip(got[0][1][0], got[1][1][0]):
        assert torch.equal(a, b)
    p_u, r_u, v_u = _unsharded(poisoned, "fd", torch.float64)
    # the NaN row is reported non-finite and masked on both paths
    assert torch.isnan(r_s[1]) and torch.isnan(r_u[1])
    np.testing.assert_array_equal(v_s.numpy(), v_u.numpy())
    assert not v_s[1]
    for a, b in zip(p_s, p_u):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-10)
    ok = torch.isfinite(r_u)
    np.testing.assert_allclose(r_s[ok].numpy(), r_u[ok].numpy(), rtol=1e-12)
    # the healthy rows are unaffected by their poisoned shard-mates
    healthy = [0, 2, 4, 5, 7]
    np.testing.assert_allclose(r_clean[healthy].numpy(), r_s[healthy].numpy(), rtol=1e-12)


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


def test_sharded_step_matches_jax_sharded_step(tmp_path):
    scen = _scenarios(8, seed=3)
    model_j, params = _jax_dnn1(tweights.NN_PRE_DNN1)
    opt = optax.adam(1e-4)
    mesh = jmake_mesh(jax.devices()[:2])
    step_j = jstep(model_j, opt, jcfg.QuadParams(), jcfg.CostWeights(), jcfg.SolverConfig(**TINY),
                   jcfg.RewardConfig(), mesh=mesh)
    p_j, _, _, r_j = step_j(jreplicate(mesh, params), jreplicate(mesh, opt.init(params)),
                            jshard_batch(mesh, jnp.asarray(scen.numpy())))
    got = run_ranks(worker.steps, 2, device="cpu", args=([scen], CFG, "fd", torch.float32),
                    scratch_dir=str(tmp_path))
    params_t, r_t, _ = got[0][0]
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-8, atol=1e-8)
    want = tweights.jax_params_to_torch(jax.tree_util.tree_map(np.asarray, p_j))
    model = tweights.load_dnn1(tweights.NN_PRE_DNN1)
    for (name, _), p in zip(model.named_parameters(), params_t):
        assert p.dtype == torch.float32 and torch.isfinite(p).all()
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=2e-5, atol=1.5e-4, err_msg=name)


def test_resume_from_rank0_checkpoint_equals_uninterrupted(tmp_path):
    kw = dict(epochs=4, batch_size=4, lr=1e-3, solver_cfg=CFG, grad_mode="analytic", lr_schedule=True)
    got = run_ranks(worker.resume, 2, device="cpu", args=(str(tmp_path / "ck"), kw),
                    scratch_dir=str(tmp_path))
    for (p_full, r_full), (p_res, r_res) in got:
        assert len(r_full) == 4 and len(r_res) == 2 and r_res == r_full[2:]
        assert all(np.isfinite(r_full))
        for a, b in zip(p_full, p_res):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(got[0][0][0], got[1][0][0]):
        assert torch.equal(a, b)


def test_batch_must_divide_and_single_process_mode(monkeypatch):
    mesh = Mesh(rank=1, world=2, device=torch.device("cpu"))
    scen = _scenarios(7, seed=0)
    with pytest.raises(ValueError, match="not a multiple of the 2 ranks"):
        shard_batch(mesh, scen)
    model = tweights.load_dnn1(tweights.NN_PRE_DNN1)
    step = make_rl_train_step(model, torch.optim.Adam(model.parameters()), P_T, W_T, CFG, R_T, mesh=mesh)
    with pytest.raises(ValueError, match="not a multiple"):
        step(scen)
    assert torch.equal(shard_batch(mesh, scen[:6]), scen[3:6])
    assert torch.equal(distributed.global_batch_from_host(mesh, scen[:6].numpy()), scen[3:6])
    for var in ("LAF_COORDINATOR_ADDRESS", "LAF_NUM_PROCESSES", "LAF_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed() is False
    assert not distributed.is_multiprocess()
