"""Rank functions for tests/test_torch_distributed.py.

`learningagileflight_se3_torch.parallel.dryrun.run_ranks` starts each rank
in a process of its own (spawn) and calls one of these with the scenario
mesh; they import torch and the port only, and return CPU tensors.
"""

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, RewardConfig, SolverConfig
from learningagileflight_se3_torch.train.rl import make_rl_train_step, run_rl_training
from learningagileflight_se3_torch.utils.weights import NN_PRE_DNN1, load_dnn1

P, W, R = QuadParams(), CostWeights(), RewardConfig()


def _cpu_params(model):
    return [p.detach().cpu().clone() for p in model.parameters()]


def steps(mesh, batches, cfg: SolverConfig, grad_mode: str, dtype):
    """For each global batch, one sharded RL step from nn_pre (in `dtype`)
    with a fresh Adam (lr 1e-4): [(params, rewards, valid)]."""
    out = []
    for scen in batches:
        model = load_dnn1(NN_PRE_DNN1).to(device=mesh.device, dtype=dtype)
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        res = make_rl_train_step(model, opt, P, W, cfg, R, grad_mode=grad_mode, mesh=mesh)(scen)
        out.append((_cpu_params(model), res.rewards.cpu(), res.valid.cpu()))
    return out


class Cut(Exception):
    pass


def resume(mesh, ckpt_dir: str, kw: dict):
    """The uninterrupted 4-epoch run, then a run cut after its epoch-2
    checkpoint and resumed from it: (params, rewards) of each."""

    def cut_after_2(line):
        if line.startswith("rl epoch 2/"):
            raise Cut

    model, r_full, _ = run_rl_training(7, load_dnn1(), mesh=mesh, log_fn=lambda *a: None, **kw)
    full = (_cpu_params(model), r_full)
    try:
        run_rl_training(7, load_dnn1(), mesh=mesh, checkpoint_dir=ckpt_dir, checkpoint_every=2,
                        log_fn=cut_after_2, **kw)
    except Cut:
        pass
    model, r_res, _ = run_rl_training(7, load_dnn1(), mesh=mesh, checkpoint_dir=ckpt_dir,
                                      checkpoint_every=2, resume=True, log_fn=lambda *a: None, **kw)
    return full, (_cpu_params(model), r_res)
