"""Stage 2: differentiable-MPC reinforcement learning of DNN1.

Port of `learningagileflight_se3_tpu/train/rl.py` (`make_rl_train_step`
without a mesh, and `run_rl_training`).  Each step samples a batch of
scenarios, runs DNN1, gets per-scenario learning signals dp from the
batched solver (analytic: one solve per scenario; fd: 9 probe solves per
scenario, all one batched solve) and takes one Adam step on the surrogate
loss sum_i <dp_i, out_i> / B.

Failure masking is the JAX package's: a row whose signal or reward is not
finite, or whose scenario is not, gets dp = 0 and its input zeroed (so its
surrogate term is a finite zero), and the loss is still divided by B.  The
rewards of masked rows stay visible in the returned rewards.

Sampling: epoch e draws its scenarios from a `torch.Generator` seeded from
(seed, e), on the training device.  The stream differs from the JAX
package's `fold_in(key, e)`; what is kept is that a run resumed from a
checkpoint samples what the uninterrupted run would have.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from learningagileflight_se3_torch.config import (
    CostWeights,
    LearnedGradConfig,
    QuadParams,
    RewardConfig,
    SamplerConfig,
    SolverConfig,
)
from learningagileflight_se3_torch.models.mlp import MLP, surrogate_inner_loss
from learningagileflight_se3_torch.models.sampler import sample_scenarios, scenario_to_problem
from learningagileflight_se3_torch.policy import (
    make_analytic_gradient_batched,
    make_fd_gradient_batched,
)
from learningagileflight_se3_torch.utils.device import resolve_device


class RLStepResult(NamedTuple):
    mean_reward: torch.Tensor  # () mean over the batch, masked rows included
    rewards: torch.Tensor      # (B,)
    valid: torch.Tensor        # (B,) bool: rows whose signal entered the update


def make_rl_train_step(model: MLP, optimizer: torch.optim.Optimizer, params_q: QuadParams,
                       weights: CostWeights, solver_cfg: SolverConfig, reward_cfg: RewardConfig,
                       grad_cfg: LearnedGradConfig = LearnedGradConfig(),
                       grad_mode: str = "fd"):
    """step(scenarios (B,9)) -> RLStepResult; updates `model`'s parameters
    in place with one `optimizer` step.  Scenarios, model and solver share
    one device (the kernels for CUDA)."""
    if grad_mode == "fd":
        signal = make_fd_gradient_batched(params_q, weights, solver_cfg, reward_cfg, grad_cfg)
        sign = 1.0   # fd returns the negated ascent gradient already
    elif grad_mode == "analytic":
        signal = make_analytic_gradient_batched(params_q, weights, solver_cfg, reward_cfg,
                                                grad_cfg=grad_cfg)
        sign = -1.0  # ascent gradient -> the reference's negated convention
    else:
        raise ValueError(grad_mode)

    def step(scen):
        B = scen.shape[0]
        probs = scenario_to_problem(scen)
        with torch.no_grad():
            outs = model(scen)
        u_last = torch.zeros((B, 4), dtype=scen.dtype, device=scen.device)
        g, rewards = signal(probs["x0"], u_last, probs["goal_pos"], probs["gate_pts"],
                            outs[:, 0:3], outs[:, 3:6], outs[:, 6])
        dp = sign * g
        valid = (torch.all(torch.isfinite(dp), dim=-1) & torch.isfinite(rewards)
                 & torch.all(torch.isfinite(scen), dim=-1))
        dp = torch.where(valid[:, None], dp, torch.zeros_like(dp))
        scen_m = torch.where(valid[:, None], scen, torch.zeros_like(scen))
        optimizer.zero_grad(set_to_none=True)
        loss = surrogate_inner_loss(model(scen_m), dp) / B
        loss.backward()
        optimizer.step()
        return RLStepResult(torch.mean(rewards), rewards, valid)

    return step


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: the learning rate at a step count (the
    count before the update, as optax's Adam reads it)."""

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


def keyed_generator(device, *key: int) -> torch.Generator:
    """A generator on `device` seeded from a tuple of non-negative integers."""
    s = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of one epoch's scenarios, seeded from (seed, epoch)."""
    return keyed_generator(device, seed, epoch)


def init_generator(seed: int) -> torch.Generator:
    """The CPU generator a training run initialises its network from; its key has
    another length than any epoch's, so the streams differ."""
    return keyed_generator("cpu", seed, 0, 0)


def run_rl_training(seed: int, model: MLP, epochs: int = 100, batch_size: int = 128,
                    lr: float = 1e-4, params_q: QuadParams = QuadParams(),
                    weights: CostWeights = CostWeights(),
                    solver_cfg: SolverConfig = SolverConfig(),
                    reward_cfg: RewardConfig = RewardConfig(),
                    sampler_cfg: SamplerConfig = SamplerConfig(),
                    grad_mode: str = "fd", lr_schedule: bool = False, log_fn=print,
                    checkpoint_dir: Optional[str] = None, checkpoint_every: int = 20,
                    resume: bool = False, device="cuda",
                    ) -> Tuple[MLP, List[float], List[float]]:
    """Stage-2 training loop: `epochs` Adam steps of one batch each, from `model`
    (DNN1, moved to `device` and trained there in place: the card by default,
    which raises where there is none; `device="cpu"` for the CPU).

    With `checkpoint_dir` the full training state (parameters, Adam moments,
    epoch) is saved every `checkpoint_every` epochs and at the end, and
    `resume=True` continues from it.  With `lr_schedule` the learning rate
    follows cosine_decay_schedule(lr, epochs, alpha=0.1).  `log_fn` gets one
    line per epoch.  Returns (model, mean reward per epoch run, share of
    valid rows per epoch run)."""
    from learningagileflight_se3_torch.utils.checkpoint import (
        load_train_state,
        save_train_state,
        train_state_exists,
    )

    device = resolve_device(device)
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    schedule = cosine_decay_schedule(lr, epochs, alpha=0.1) if lr_schedule else (lambda _: lr)
    start_epoch = 0
    if checkpoint_dir is not None and resume and train_state_exists(checkpoint_dir):
        start_epoch = load_train_state(checkpoint_dir, model, optimizer)
        log_fn(f"rl resume from {checkpoint_dir} at epoch {start_epoch}")
    step = make_rl_train_step(model, optimizer, params_q, weights, solver_cfg, reward_cfg,
                              grad_mode=grad_mode)

    mean_rewards, valid_fracs = [], []
    for e in range(start_epoch, epochs):
        for group in optimizer.param_groups:
            group["lr"] = schedule(e)
        scen = sample_scenarios(epoch_generator(seed, e, device), batch_size, sampler_cfg)
        res = step(scen)
        mean_rewards.append(float(res.mean_reward))
        valid_fracs.append(float(res.valid.float().mean()))
        if checkpoint_dir is not None and (e + 1) % checkpoint_every == 0:
            save_train_state(checkpoint_dir, model, optimizer, e + 1)
        log_fn(f"rl epoch {e + 1}/{epochs} mean reward {mean_rewards[-1]:.3f} "
               f"valid {valid_fracs[-1]:.3f}")
    if checkpoint_dir is not None:
        save_train_state(checkpoint_dir, model, optimizer, epochs)
    return model, mean_rewards, valid_fracs
