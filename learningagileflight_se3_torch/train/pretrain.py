"""Stage 1: supervised pretraining of DNN1.

Port of `learningagileflight_se3_tpu/train/pretrain.py`.  Each step takes a
batch of scenarios, labels them with `pretrain_label` (zeros except the
heuristic traversal time) and takes one Adam step on the MSE.  The step
takes the scenarios as an argument; `run_pretraining` draws them, chunk by
chunk of `log_every` steps, from a `torch.Generator` seeded from (seed,
chunk) on the training device (not the JAX package's numbers), and fetches
one loss per chunk.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from learningagileflight_se3_torch.config import SamplerConfig
from learningagileflight_se3_torch.models.mlp import MLP, make_dnn1
from learningagileflight_se3_torch.models.sampler import pretrain_label, sample_scenarios
from learningagileflight_se3_torch.train.rl import epoch_generator, init_generator
from learningagileflight_se3_torch.utils.device import resolve_device


def _mse(model, scen):
    return torch.mean((model(scen) - pretrain_label(scen)) ** 2)


def make_pretrain_step(model: MLP, optimizer: torch.optim.Optimizer):
    """step(scenarios (B,9)) -> loss (0-d tensor, before the update); one
    `optimizer` step on the MSE to the pretrain label, in place."""

    def step(scen):
        optimizer.zero_grad(set_to_none=True)
        loss = _mse(model, scen)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def run_pretraining(seed: int, steps: int = 3000, batch_size: int = 256, lr: float = 2e-5,
                    sampler_cfg: SamplerConfig = SamplerConfig(), model: Optional[MLP] = None,
                    log_every: int = 100, log_fn=print, device="cuda") -> Tuple[MLP, List[float]]:
    """Stage 1: `steps` Adam steps of `batch_size` scenarios each on
    `device` (the card by default, which raises where there is none;
    `device="cpu"` for the CPU), from `model` or, without one, a DNN1
    initialised from the seed.  Scenarios are drawn in the model's dtype.
    Returns (model, the last loss of each chunk of `log_every` steps)."""
    device = resolve_device(device)
    if model is None:
        model = make_dnn1(generator=init_generator(seed))
    model = model.to(device)
    dtype = next(model.parameters()).dtype
    step = make_pretrain_step(model, torch.optim.Adam(model.parameters(), lr=lr))
    losses, done, chunk = [], 0, 0
    while done < steps:
        n = min(log_every, steps - done)
        gen = epoch_generator(seed, chunk, device)
        for _ in range(n):
            loss = step(sample_scenarios(gen, batch_size, sampler_cfg, dtype=dtype))
        done += n
        chunk += 1
        losses.append(float(loss))
        log_fn(f"pretrain step {done}/{steps} loss {losses[-1]:.6f}")
    return model, losses


@torch.no_grad()
def evaluate_pretrain(model: MLP, generator: torch.Generator, n: int = 1000,
                      sampler_cfg: SamplerConfig = SamplerConfig()) -> float:
    """Mean MSE over `n` fresh scenarios drawn from `generator` (on the
    model's device)."""
    p = next(model.parameters())
    return float(_mse(model, sample_scenarios(generator, n, sampler_cfg, dtype=p.dtype).to(p.device)))
