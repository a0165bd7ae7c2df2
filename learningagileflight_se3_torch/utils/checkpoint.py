"""Training-state checkpoints with `torch.save`.

Port of `save_train_state` / `load_train_state` / `train_state_exists` of
`learningagileflight_se3_tpu/utils/checkpoint.py` (orbax there): the model's
and the optimizer's `state_dict`s and the epoch, so a run resumes with its
Adam moments.  A checkpoint is a directory holding `train_state.pt`.
"""

from __future__ import annotations

import os

import torch

_FILE = "train_state.pt"


def save_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     epoch: int) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "epoch": int(epoch)}, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def load_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> int:
    """Restore the model and optimizer saved by `save_train_state` in place,
    onto the model's device; returns the epoch."""
    device = next(model.parameters()).device
    state = torch.load(os.path.join(path, _FILE), map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])


def train_state_exists(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _FILE))
