"""What every bench shares: stderr diagnostics, the card's name and power
limit for the record, TF32 off, and a sync that is a no-op on the CPU."""

from __future__ import annotations

import sys

import torch

from learningagileflight_se3_torch.utils.device import platform_line, resolve_device


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_fields(device) -> dict:
    """{"platform": the card's nvidia-smi name, "power_limit": its power
    limit} ("cpu" and None on the CPU)."""
    line = platform_line(device)
    if line == "cpu":
        return {"platform": "cpu", "power_limit": None}
    name, _, power = line.rpartition(", ")
    return {"platform": name, "power_limit": power}


def prepare(device) -> torch.device:
    """`device` resolved (raises without a card unless it is the CPU), with
    TF32 off for every matmul and convolution, and asserted so."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is still on")
    return device


def build_kernels(device):
    """Build (or load) the kernels for a CUDA `device` before anything is
    timed: the seconds it took, None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    import time

    from learningagileflight_se3_torch.ops import build

    t0 = time.perf_counter()
    build.library()
    return time.perf_counter() - t0


def synchronizer(device):
    """A function that waits for `device`'s queued work (nothing on the CPU)."""
    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


def kernel_counts() -> dict:
    """The kernel wrappers' counters now: K1 and K2 launches (those that
    conditional graph bodies made on the card settled first) and their plain
    versions' calls (a bench reports its parts' differences)."""
    from learningagileflight_se3_torch.ops import riccati_fused, rollout
    from learningagileflight_se3_torch.utils import graphs

    graphs.settle()

    return {"K1": rollout.launches, "K2": riccati_fused.launches,
            "K1_plain": rollout.plain_calls, "K2_plain": riccati_fused.plain_calls}


def counts_since(before: dict) -> dict:
    """kernel_counts() now less `before`."""
    return {k: v - before[k] for k, v in kernel_counts().items()}
