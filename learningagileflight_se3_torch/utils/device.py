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
