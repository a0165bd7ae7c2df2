"""The device of the port's entry points.

`ExternalSimController` and `run_rl_training` run on the card unless the
caller passes `device="cpu"`; on a machine without a card the default
raises here instead of running quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`; raises if it is a CUDA device and none is
    available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    return device


def platform_line(device) -> str:
    """What a record names its hardware by: for a CUDA device the card's
    name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them, else "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    import subprocess

    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
