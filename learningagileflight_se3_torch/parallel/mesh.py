"""The scenario mesh: data parallelism over processes with torch.distributed.

Port of `learningagileflight_se3_tpu/parallel/mesh.py`.  The scenario axis
is the workload's data-parallel axis (every MPC solve is independent): each
rank holds a contiguous slice of the batch, the policy network is
replicated, and the policy gradients are all-reduced over the ranks
(`train/rl.py`).  A mesh here is one process per device, all the ranks of
a process group: JAX's device mesh inside one process has no counterpart.

`make_mesh` needs an initialised process group (`distributed.py`
`initialize_distributed`, or `torch.distributed.init_process_group`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from learningagileflight_se3_torch.utils.device import resolve_device

SCENARIO_AXIS = "scenario"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D scenario mesh over the ranks of the default process group."""

    rank: int
    world: int
    device: torch.device


def make_mesh(device="cuda") -> Mesh:
    """The scenario mesh over every rank of the process group, with this
    rank's tensors on `device` (the card by default, which raises where
    there is none; "cuda" is the card initialize_distributed made current)."""
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call initialize_distributed first")
    return Mesh(dist.get_rank(), dist.get_world_size(), device)


def shard_slice(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous part of a leading axis of length n."""
    if n % mesh.world:
        raise ValueError(f"batch {n} is not a multiple of the {mesh.world} ranks of the "
                         f"{SCENARIO_AXIS!r} mesh")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of x's leading (batch) axis, on the
    mesh's device.  Raises if the batch does not divide over the ranks."""
    return x[shard_slice(mesh, x.shape[0])].to(mesh.device)


def replicate(mesh: Mesh, module: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None):
    """Broadcast `module`'s parameters and buffers, and the tensors of
    `optimizer`'s state (Adam's moments and step), from the mesh's rank 0 to
    every rank, in place.  Every rank must hold the same structure (the same
    network, an optimizer at the same point).  Returns `module`."""
    tensors = [*module.parameters(), *module.buffers()]
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                tensors += [v for _, v in sorted(state.items()) if torch.is_tensor(v)]
    with torch.no_grad():
        for t in tensors:
            buf = t.detach().to(mesh.device)
            dist.broadcast(buf, src=0)
            t.copy_(buf)
    return module
