"""The JAX benchmarks' problems, read from weights/bench_problems.npz.

`scripts/export_bench_problems.py` wrote the scenarios that bench.py,
bench_latency.py, check_pallas_tpu.py and bench_scaling.py draw (CPU draws
of the JAX sampler, float32); `bench_args` builds the solver's arguments
from them as bench.py:74-85 does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from learningagileflight_se3_torch.models.sampler import scenario_to_problem
from learningagileflight_se3_torch.utils.weights import WEIGHTS_DIR

BENCH_PROBLEMS = os.path.join(WEIGHTS_DIR, "bench_problems.npz")


def scenarios(key: int, n: int) -> np.ndarray:
    """(n, 9) float32: the JAX sampler's draw of n scenarios from PRNGKey(key)."""
    with np.load(BENCH_PROBLEMS) as z:
        name = f"key{key}_n{n}"
        if name not in z.files:
            raise KeyError(f"{BENCH_PROBLEMS} holds no draw of {n} from PRNGKey({key}); it has {sorted(z.files)}")
        return z[name]


def bench_args(scen, device, dtype=torch.float32):
    """bench.py's problem from scenarios (B, 9): (x0, u_last = 0, goal,
    tra_pos = 0, tra_ang = [0, pitch / 2, 0], t = clip(|p0| / 4, 2, 4)) as
    tensors on `device` in `dtype`.  `scen` is an array or a tensor."""
    scen = torch.as_tensor(scen, device=device).to(dtype)
    B = scen.shape[0]
    probs = scenario_to_problem(scen)
    x0 = probs["x0"]
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    tra_ang = torch.cat([zeros(B, 1), scen[:, 8:9] * 0.5, zeros(B, 1)], dim=1)
    t = torch.clamp(torch.linalg.vector_norm(x0[:, 0:3], dim=1) / 4.0, 2.0, 4.0)
    return x0, zeros(B, 4), probs["goal_pos"], zeros(B, 3), tra_ang, t
