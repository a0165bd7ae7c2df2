"""The ranks of the scaling bench: the port's scaling_worker.py.

Each function runs in one rank of a process group (parallel/dryrun.py
`run_ranks`: one spawned process per rank, its mesh made), writes its
output to a log file of its own (never to a pipe), and times `reps` steps
on its shard of the global batch after one untimed step, every step ended
by a sync of the device and a barrier of the group:

  * `solve_rank`: batched MPC solves;
  * `trainstep_rank`: the whole sharded RL step (train/rl.py
    `make_rl_train_step` with the mesh: the analytic learning signal, the
    all-reduce of the gradients, the Adam step).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from learningagileflight_se3_torch.config import CostWeights, LearnedGradConfig, QuadParams, RewardConfig, SolverConfig


def _log_to(log_dir: str, name: str, rank: int):
    """Send this process's stdout and stderr to log_dir/name.rank<r>.log."""
    os.makedirs(log_dir, exist_ok=True)
    fd = os.open(os.path.join(log_dir, f"{name}.rank{rank}.log"), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)


def _timed(mesh, step, reps: int) -> dict:
    """One untimed step, then `reps` timed ones, each ended by a sync and a
    barrier: each rep's seconds, their sum, and this rank's kernel launches
    over the timed reps."""
    from learningagileflight_se3_torch.benchmarks.harness import counts_since, kernel_counts

    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    step()
    sync()
    dist.barrier()
    c0, rep_s = kernel_counts(), []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        sync()
        dist.barrier()
        rep_s.append(time.perf_counter() - t0)
    out = dict(rank=mesh.rank, world=mesh.world, rep_s=rep_s, elapsed_s=float(sum(rep_s)),
               launches=counts_since(c0))
    print(out, flush=True)
    return out


def solve_rank(mesh, problem, horizon: int, iters: int, reps: int, log_dir: str, name: str) -> dict:
    """Solves of this rank's shard of `problem` (the solver's six arguments
    over a global batch, numpy) at H = `horizon`, `iters` DDP iterations,
    tol 1e-4, gtol 3e-4."""
    from learningagileflight_se3_torch.parallel.distributed import global_batch_from_host
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

    _log_to(log_dir, name, mesh.rank)
    args = [global_batch_from_host(mesh, a) for a in problem]
    cfg = SolverConfig(horizon=horizon, max_iters=iters, tol=1e-4, gtol=3e-4)
    solve = make_batched_mpc_solver(QuadParams(), CostWeights(), cfg)
    return _timed(mesh, lambda: solve(*args).cost.cpu(), reps)


def trainstep_rank(mesh, scen, horizon: int, iters: int, reps: int, log_dir: str, name: str) -> dict:
    """Sharded RL steps (analytic signal, Adam at lr 1e-4) of a seeded DNN1
    on the global batch `scen` (numpy), at H = `horizon` and `iters` DDP
    iterations, tol 1e-4, gtol 3e-4."""
    from learningagileflight_se3_torch.models.mlp import make_dnn1
    from learningagileflight_se3_torch.train.rl import init_generator, make_rl_train_step

    _log_to(log_dir, name, mesh.rank)
    cfg = SolverConfig(horizon=horizon, max_iters=iters, tol=1e-4, gtol=3e-4)
    model = make_dnn1(generator=init_generator(1)).to(mesh.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_rl_train_step(model, optimizer, QuadParams(), CostWeights(), cfg, RewardConfig(),
                              LearnedGradConfig(), grad_mode="analytic", mesh=mesh)
    scen_g = torch.as_tensor(np.asarray(scen, np.float32), device=mesh.device)
    return _timed(mesh, lambda: step(scen_g).rewards.cpu(), reps)
