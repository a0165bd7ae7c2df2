"""Multi-process dry run: sharded RL steps against the unsharded step.

Counterpart of `__graft_entry__.py` `dryrun_multichip`.  `run_ranks`
starts n processes (the `spawn` start method), each a rank of one process
group (a FileStore in a scratch directory: no port to race for), runs a
module-level function with the scenario mesh in each, and returns their
results; a rank that fails, or a run that outlasts its timeout, raises,
and no process is left behind.  `dryrun_multiprocess` runs one sharded RL
step in each of the `fd` and `analytic` modes on n ranks (scenarios
sharded, the network replicated, the gradients averaged over the ranks)
and asserts that it equals the unsharded step that rank 0 takes from the
same state: the rewards and the updated parameters.

Bounds (BOUNDS).  The sharded step solves and differentiates each shard
in a smaller batch than the unsharded step, and sums the gradient in
another order.  In float64 the gradient is held to the unsharded one
relative to each parameter tensor's largest entry (1e-10), the parameters
to 1e-10 and the rewards to rtol 1e-12.  In float32 the learning signals
themselves change with the batch (the card's batched linear algebra picks
its kernels by batch size, and the analytic signal's implicit-function VJP
magnifies their rounding: 2.6e-3 of a tensor's largest gradient entry with
two gloo ranks on one H100 at B=256, 1.0e-4 for the fd signal on the CPU
at batch 4), so the gradient is held only to 1e-2: loose for that
rounding, tight enough to catch a gradient summed and not averaged over
the ranks, which the parameters cannot show.  For Adam's first step moves
a parameter by lr * g / (|g| + eps), inside (-lr, lr) whatever the scale
of g, and a gradient entry near zero whose rounding flips its sign moves
its parameter by up to 2 lr: the parameters are held to 2 lr = 2e-4 (the
JAX dry run's 1.5e-4 is the step scale, under that limit; 1.946e-4 seen
on the card), the rewards to the JAX dry run's rtol 2e-5.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from learningagileflight_se3_torch.config import CostWeights, QuadParams, RewardConfig, SolverConfig
from learningagileflight_se3_torch.utils.device import resolve_device

# the ranks' time to start, run and exit; a collective gives up after COLLECTIVE_TIMEOUT_S
JOIN_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 120.0, 100.0
# what the sharded step must meet against the unsharded one: rewards (rtol),
# gradients (relative to each tensor's largest entry), parameters (atol)
BOUNDS = {torch.float32: dict(reward=2e-5, grad=1e-2, param=2e-4),
          torch.float64: dict(reward=1e-12, grad=1e-10, param=1e-10)}


def _rank_main(fn, rank, n, store, device, backend, args, out):
    from learningagileflight_se3_torch.parallel.distributed import initialize_distributed
    from learningagileflight_se3_torch.parallel.mesh import make_mesh

    if torch.device(device).type == "cpu":
        torch.set_num_threads(2)  # n ranks share the host's cores
    initialize_distributed(store, n, rank, device=device, backend=backend, timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        torch.save(fn(make_mesh(device), *args), out)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, device="cuda", backend: Optional[str] = None, args: Sequence = (),
              scratch_dir: Optional[str] = None) -> list:
    """fn(mesh, *args) in each of n new processes, ranks 0..n-1 of one group
    on `device` (the card by default: rank r on card r mod the card count;
    `backend` as initialize_distributed picks it unless given).  `fn` must
    be importable by module path, and its result picklable.  Returns the
    ranks' results in rank order.  Raises if a rank exits non-zero, or if
    the ranks are not all done within JOIN_TIMEOUT_S (every process is
    killed first)."""
    device = str(resolve_device(device))
    work = tempfile.mkdtemp(prefix="laf_ranks_", dir=scratch_dir)
    ctx = mp.get_context("spawn")
    outs = [os.path.join(work, f"rank{r}.pt") for r in range(n)]
    store = "file://" + os.path.join(work, "store")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, store, device, backend, tuple(args), outs[r]))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs):
            raise TimeoutError(f"run_ranks: {n} ranks not done within {JOIN_TIMEOUT_S} s")
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"run_ranks: rank exit codes {codes}")
        return [torch.load(o) for o in outs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        shutil.rmtree(work, ignore_errors=True)


def _params(model):
    return [p.detach().cpu().clone() for p in model.parameters()]


def _grads(model):
    return [p.grad.detach().cpu().clone() for p in model.parameters()]


def dryrun_rank(mesh, batch: int, solver_cfg: SolverConfig, dtype, grad_modes):
    """One rank of the dry run: for each grad mode, one sharded RL step from
    a seeded DNN1 with a fresh Adam (lr 1e-4) on `batch` seeded scenarios
    (after one untimed step from the same state, which warms the process
    up), then, on rank 0 only, the unsharded step from the same state.
    Returns {mode: dict(sharded=(params, grads, rewards, seconds),
    unsharded=... or None, launches=(K1, K2) of this rank's timed sharded
    step)}."""
    import copy

    from learningagileflight_se3_torch.models.mlp import make_dnn1
    from learningagileflight_se3_torch.ops import riccati_fused, rollout
    from learningagileflight_se3_torch.models.sampler import sample_scenarios
    from learningagileflight_se3_torch.train.rl import init_generator, make_rl_train_step

    P, W, R = QuadParams(), CostWeights(), RewardConfig()
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    model0 = make_dnn1(generator=init_generator(0)).to(device=mesh.device, dtype=dtype)
    scen = sample_scenarios(torch.Generator(device=mesh.device).manual_seed(0), batch, dtype=dtype)
    out = {}
    for mode in grad_modes:
        res = {}
        runs = [("warm-up", mesh), ("sharded", mesh)] + ([("unsharded", None)] if mesh.rank == 0 else [])
        for name, m in runs:
            model = copy.deepcopy(model0)
            opt = torch.optim.Adam(model.parameters(), lr=1e-4)
            step = make_rl_train_step(model, opt, P, W, solver_cfg, R, grad_mode=mode, mesh=m)
            sync()
            n0, t0 = (rollout.launches, riccati_fused.launches), time.perf_counter()
            r = step(scen)
            sync()
            res[name] = (_params(model), _grads(model), r.rewards.detach().cpu(), time.perf_counter() - t0)
            if name == "sharded":
                res["launches"] = (rollout.launches - n0[0], riccati_fused.launches - n0[1])
        del res["warm-up"]
        res.setdefault("unsharded", None)
        out[mode] = res
    return out


def dryrun_multiprocess(n: int, device="cuda", backend: Optional[str] = None, batch: Optional[int] = None,
                        solver_cfg: SolverConfig = SolverConfig(horizon=6, max_iters=3),
                        dtype=torch.float32, grad_modes=("fd", "analytic"),
                        scratch_dir: Optional[str] = None) -> dict:
    """n ranks, one sharded RL step each in every grad mode (batch 2n by
    default, horizon 6, 3 DDP iterations), held against rank 0's unsharded
    step under BOUNDS[dtype]; every rank's parameters must be identical.
    Raises AssertionError on a mismatch.  Returns {mode: dict(reward_rel,
    grad_rel, param_abs, sharded_s (each rank's step seconds), unsharded_s, launches
    (each rank's (K1, K2) kernel launches in its sharded step))}."""
    batch = 2 * n if batch is None else batch
    ranks = run_ranks(dryrun_rank, n, device=device, backend=backend,
                      args=(batch, solver_cfg, dtype, tuple(grad_modes)), scratch_dir=scratch_dir)
    tol = BOUNDS[dtype]
    report = {}
    for mode in grad_modes:
        ps, gs, rs, _ = ranks[0][mode]["sharded"]
        pu, gu, ru, tu = ranks[0][mode]["unsharded"]
        for other in ranks[1:]:
            po, _, ro, _ = other[mode]["sharded"]
            assert all(torch.equal(a, b) for a, b in zip(ps, po)), f"{mode}: ranks hold different parameters"
            assert torch.equal(rs, ro), f"{mode}: ranks hold different rewards"
        assert rs.shape == (batch,) and bool(torch.isfinite(rs).all()), f"{mode}: rewards {rs}"
        np.testing.assert_allclose(rs.numpy(), ru.numpy(), rtol=tol["reward"], atol=tol["reward"],
                                   err_msg=f"sharded != unsharded rewards ({mode})")
        grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(gs, gu))
        assert grad_rel <= tol["grad"], f"sharded != unsharded gradients ({mode}): {grad_rel:.3e}"
        for a, b in zip(ps, pu):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol["param"],
                                       err_msg=f"sharded != unsharded params ({mode})")
        report[mode] = dict(
            reward_rel=float(((rs - ru).abs() / ru.abs().clamp_min(1e-12)).max()),
            grad_rel=grad_rel,
            param_abs=max(float((a - b).abs().max()) for a, b in zip(ps, pu)),
            sharded_s=[r[mode]["sharded"][3] for r in ranks], unsharded_s=tu,
            launches=[r[mode]["launches"] for r in ranks])
    return report
