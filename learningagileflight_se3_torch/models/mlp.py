"""Policy networks DNN1 / DNN2 as `nn.Linear` / ReLU stacks.

Port of `learningagileflight_se3_tpu/models/mlp.py`:

  DNN1:  9 -> 64 -> 64 -> 7
  DNN2: 18 -> 128 -> 128 -> 7

Output 7-vector: [tra_pos(3), tra_ang Rodrigues(3), tra_time(1)].
`nn.Linear`'s default initialisation is the U(-1/sqrt(fan_in), +) scheme
the JAX package copies from PyTorch.  Layer i holds flax's `Dense_i`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        sizes = [in_features, *features]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def make_dnn1(hidden: int = 64) -> MLP:
    """9 -> hidden -> hidden -> 7."""
    return MLP(9, (hidden, hidden, 7))


def make_dnn2(hidden: int = 128) -> MLP:
    """18 -> hidden -> hidden -> 7."""
    return MLP(18, (hidden, hidden, 7))
