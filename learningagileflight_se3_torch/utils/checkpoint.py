"""Checkpoints with `torch.save`.

Port of `learningagileflight_se3_tpu/utils/checkpoint.py` (orbax there).
`save_params` / `load_params` keep a model alone (its `state_dict`, in a
directory holding `params.pt`); `save_train_state` / `load_train_state` /
`train_state_exists` keep the model's and the optimizer's `state_dict`s and
the epoch (a directory holding `train_state.pt`), so a run resumes with its
Adam moments.
"""

from __future__ import annotations

import os

import torch

_FILE = "train_state.pt"
_PARAMS = "params.pt"


def _save(obj, path: str, name: str) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, os.path.join(path, name))


def save_params(path: str, model: torch.nn.Module) -> None:
    _save(model.state_dict(), path, _PARAMS)


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Restore the parameters saved by `save_params` into `model` in place,
    on the model's device; returns the model."""
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(os.path.join(path, _PARAMS), map_location=device,
                                     weights_only=True))
    return model


def save_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     epoch: int) -> None:
    _save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
           "epoch": int(epoch)}, path, _FILE)


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
