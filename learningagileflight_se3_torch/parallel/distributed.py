"""Process-group set-up: the multi-process half of data-parallel training.

Port of `learningagileflight_se3_tpu/parallel/distributed.py`.  Every
process calls `initialize_distributed`, and the same sharded training step
(train/rl.py with a mesh, parallel/mesh.py) runs in each.  The `LAF_*`
variables configure it:

    LAF_COORDINATOR_ADDRESS   host:port of rank 0's store (a TCP rendezvous),
                              or file:///path (a FileStore, for processes
                              on one host: no port to race for)
    LAF_NUM_PROCESSES         the number of processes (the world size)
    LAF_PROCESS_ID            this process's rank

JAX's `LAF_LOCAL_DEVICE_COUNT` (virtual CPU devices per process) has no
counterpart: PyTorch runs one process per device, so the world size is the
device count.  The backend is NCCL for CUDA and gloo for the CPU.  NCCL
refuses two ranks on one card; gloo all-reduces and broadcasts CUDA tensors
too, so `backend="gloo"` runs several ranks on one card.

Launch two ranks on one host, e.g.:

    LAF_COORDINATOR_ADDRESS=localhost:29511 LAF_NUM_PROCESSES=2 LAF_PROCESS_ID=0 python3 ... &
    LAF_COORDINATOR_ADDRESS=localhost:29511 LAF_NUM_PROCESSES=2 LAF_PROCESS_ID=1 python3 ...
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from learningagileflight_se3_torch.parallel.mesh import Mesh, shard_batch
from learningagileflight_se3_torch.utils.device import resolve_device


def initialize_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda", backend: Optional[str] = None,
                           timeout_s: float = 300.0) -> bool:
    """Join the process group.  Arguments default to the LAF_* variables;
    with neither an address nor a process count this is single-process mode
    and returns False (drivers call it unconditionally).

    `device` is this rank's (the card by default, which raises where there
    is none); for CUDA, rank r makes card r mod the card count current.
    `backend` defaults to NCCL for CUDA and gloo for the CPU.  A collective
    that waits longer than `timeout_s` fails instead of hanging."""
    coordinator_address = coordinator_address or os.environ.get("LAF_COORDINATOR_ADDRESS")
    if num_processes is None and "LAF_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LAF_NUM_PROCESSES"])
    if process_id is None and "LAF_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LAF_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False  # single-process
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs the coordinator address, the process count "
                         "and this process's id (LAF_COORDINATOR_ADDRESS, LAF_NUM_PROCESSES, LAF_PROCESS_ID)")
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None
                              else torch.device("cuda", process_id % torch.cuda.device_count()))
    init_method = (coordinator_address if coordinator_address.startswith("file://")
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def is_multiprocess() -> bool:
    """True inside a process group of more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_batch_from_host(mesh: Mesh, x) -> torch.Tensor:
    """This rank's part of a global batch that every process holds in full
    on the host (a numpy array or tensor, e.g. identically seeded scenario
    samples): its contiguous slice of the leading axis, on the mesh's
    device.  Works alike with one rank."""
    return shard_batch(mesh, torch.as_tensor(x))
