"""The port's flagship forward step and its dry run.

Counterpart of `__graft_entry__.py`:

  entry()              -> (forward_step, (dnn1, scenarios)): the flagship
                          forward step, DNN1 then one batched MPC solve, with
                          the JAX `entry()`'s own example arguments
  dryrun_multichip(n)  -> parallel/dryrun.py's sharded RL step on n ranks
                          against the unsharded step

The JAX `entry()` runs its single-problem solver under `vmap`, each lane a
`lax.while_loop` of its own; the port has one solver, so `forward_step`
makes one batched solve over the whole batch (the kernels on the card, their
plain versions on the CPU), whose lanes freeze when they are done.  Both run
on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import copy

import torch

from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig


def _configs(horizon: int, max_iters: int, tol: float = 1e-6, gtol: float = 1e-5):
    """The forward step's configurations: every default but the solver's
    horizon, iteration cap and tolerances."""
    return QuadParams(), CostWeights(), SolverConfig(horizon=horizon, max_iters=max_iters, tol=tol, gtol=gtol)


def make_forward_step(horizon: int = 50, max_iters: int = 30, tol: float = 1e-6, gtol: float = 1e-5,
                      device="cuda", dtype=torch.float32):
    """forward_step(dnn1, scenarios (B, 9)) -> first controls (B, 4).

    DNN1 predicts each scenario's traversal position, attitude (Rodrigues)
    and time; one batched MPC solve from the scenario's start, the previous
    control zero, tracks them; the result is each plan's first control.  The
    scenarios are moved to `device` in `dtype`, and so is DNN1 (a copy of
    it, where its parameters lie elsewhere or in another dtype).  The card
    unless the caller passes device="cpu": without a card the default raises
    here, before any work."""
    from learningagileflight_se3_torch.models.sampler import scenario_to_problem
    from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver
    from learningagileflight_se3_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # the parameters name their card by index
        dev = torch.device("cuda", torch.cuda.current_device())
    solve = make_batched_mpc_solver(*_configs(horizon, max_iters, tol, gtol), return_gains=False)

    def forward_step(dnn1: torch.nn.Module, scenarios) -> torch.Tensor:
        scen = torch.as_tensor(scenarios).to(dev, dtype)
        on = all(p.device == dev and p.dtype == dtype for p in dnn1.parameters())
        net = dnn1 if on else copy.deepcopy(dnn1).to(dev, dtype)
        with torch.no_grad():
            prob = scenario_to_problem(scen)
            out = net(scen)
            sol = solve(prob["x0"], torch.zeros((scen.shape[0], 4), dtype=dtype, device=dev), prob["goal_pos"],
                        out[:, 0:3], out[:, 3:6], out[:, 6])
        return sol.control_traj[:, 0]

    return forward_step


def entry(device="cuda"):
    """(forward_step, (dnn1, scenarios)) at the JAX `entry()`'s settings: H=50,
    30 DDP iterations, tol 1e-6, gtol 1e-5, float32, on `device`.  The
    example arguments are the JAX `entry()`'s own (the DNN1 of
    `make_dnn1().init(PRNGKey(0), ...)` and its 8 scenarios of
    `sample_scenarios(PRNGKey(0), 8)`), carried across in
    weights/entry_args.npz."""
    from learningagileflight_se3_torch.utils.weights import entry_args

    forward_step = make_forward_step(device=device)
    dnn1, scenarios = entry_args()
    dev = torch.device(device)
    return forward_step, (dnn1.to(dev), torch.as_tensor(scenarios, dtype=torch.float32, device=dev))


def dryrun_multichip(n: int, device="cuda") -> dict:
    """parallel/dryrun.py's `dryrun_multiprocess` on n ranks."""
    from learningagileflight_se3_torch.parallel.dryrun import dryrun_multiprocess

    return dryrun_multiprocess(n, device=device)
