"""Policy networks DNN1 / DNN2 as `nn.Linear` / ReLU stacks.

Port of `learningagileflight_se3_tpu/models/mlp.py`:

  DNN1:  9 -> 64 -> 64 -> 7
  DNN2: 18 -> 128 -> 128 -> 7

Output 7-vector: [tra_pos(3), tra_ang Rodrigues(3), tra_time(1)].
`nn.Linear`'s default initialisation is the U(-1/sqrt(fan_in), +) scheme
the JAX package copies from PyTorch; it draws from the global generator, so
a factory given a `torch.Generator` redraws weight and bias from it with
the same bounds (`init_from_generator`).  Layer i holds flax's `Dense_i`.
Like flax's `Dense`, a layer computes in the promoted dtype of its input
and its parameters: float64 scenarios through float32 weights give a
float64 output (the CPU tests), float32 through float32 stays float32.

`surrogate_inner_loss` is the RL surrogate L = sum_i <dp_i, out_i>, whose
parameter gradient is (dr/dout)^T (dout/dtheta).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MLP(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        sizes = [in_features, *features]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            dt = torch.promote_types(x.dtype, layer.weight.dtype)
            x = F.linear(x.to(dt), layer.weight.to(dt), layer.bias.to(dt))
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def init_from_generator(model: MLP, generator: torch.Generator) -> MLP:
    """Redraw every layer's weight and bias from U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) on `generator`, in place."""
    with torch.no_grad():
        for layer in model.layers:
            bound = 1.0 / math.sqrt(layer.in_features)
            for p in (layer.weight, layer.bias):
                u = torch.rand(p.shape, generator=generator, device=generator.device, dtype=p.dtype)
                p.copy_((2.0 * u - 1.0) * bound)
    return model


def _make(in_features, features, generator):
    if generator is None:
        return MLP(in_features, features)
    with torch.random.fork_rng(devices=[]):  # nn.Linear's own draw leaves the global stream alone
        model = MLP(in_features, features)
    return init_from_generator(model, generator)


def make_dnn1(hidden: int = 64, generator: Optional[torch.Generator] = None) -> MLP:
    """9 -> hidden -> hidden -> 7, initialised from `generator` where given."""
    return _make(9, (hidden, hidden, 7), generator)


def make_dnn2(hidden: int = 128, generator: Optional[torch.Generator] = None) -> MLP:
    """18 -> hidden -> hidden -> 7, initialised from `generator` where given."""
    return _make(18, (hidden, hidden, 7), generator)


def surrogate_inner_loss(outputs, dp):
    """sum over the batch of <dp_i, out_i>, with dp held constant."""
    return torch.sum(outputs * dp.detach())
