"""Flax MLP parameters -> PyTorch `state_dict`, with numpy alone.

The shipped checkpoints are orbax directories that need JAX to read; the
JAX package's `scripts/export_torch_weights.py` writes their raw arrays to
an npz under `weights/` (keys like "params/Dense_0/kernel"), which this
module reads without JAX.  The same script writes the scenarios and the gate
noise that the JAX package's closed-loop benchmark draws for its two
recorded seeds (`bench_scenarios`), `scripts/export_accuracy_scenarios.py`
the 32 problems of the JAX package's accuracy benchmark
(`accuracy_scenarios`), and `scripts/export_entry_args.py` the example
arguments of the JAX package's flagship forward step (`entry_args`).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from learningagileflight_se3_torch.models.mlp import MLP, make_dnn1, make_dnn2

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights")
NN3_1_DNN2 = os.path.join(WEIGHTS_DIR, "nn3_1_dnn2.npz")
NN_PRE_DNN1 = os.path.join(WEIGHTS_DIR, "nn_pre_dnn1.npz")    # after pretraining
NN_DEEP_DNN1 = os.path.join(WEIGHTS_DIR, "nn_deep_dnn1.npz")  # after RL

BENCH_SEEDS = (2024, 4096)
ACCURACY_SCENARIOS = os.path.join(WEIGHTS_DIR, "accuracy_scenarios.npz")
ENTRY_ARGS = os.path.join(WEIGHTS_DIR, "entry_args.npz")


def bench_scenarios_path(seed: int) -> str:
    return os.path.join(WEIGHTS_DIR, f"bench_success_seed{seed}.npz")


def bench_scenarios(path: str):
    """(scenarios (n, 9), gate_noise (n, steps, 3)), float32 numpy: the
    scenarios and the clipped gate velocity noise of one exported seed."""
    with np.load(path) as z:
        return z["scenarios"], z["gate_noise"]


def accuracy_scenarios(path: str = ACCURACY_SCENARIOS) -> dict:
    """benchmarks/bench_accuracy.py's 32 problems, numpy: x0 (32, 13), goal,
    tra_ang (32, 3), t, u_ub (32,) float64 and the cell of each row,
    variant ("main" / "pybullet_bounds") and regime ("nominal" /
    "aggressive"), 8 rows a cell."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


_KEY = re.compile(r"(?:^|/)Dense_(\d+)/(kernel|bias)$")


def _flatten(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def jax_params_to_torch(params_np) -> dict:
    """Flax params (nested dicts, or flat "/"-joined keys) -> MLP state_dict.

    Dense_i.kernel (in, out) becomes layers.i.weight = kernel.T (out, in);
    Dense_i.bias carries across unchanged."""
    state = {}
    for key, arr in _flatten(dict(params_np)).items():
        m = _KEY.search(key)
        if m is None:
            raise KeyError(f"not a flax Dense parameter: {key!r}")
        i, kind = m.groups()
        a = torch.from_numpy(np.array(arr))
        if kind == "kernel":
            state[f"layers.{i}.weight"] = a.T.contiguous()
        else:
            state[f"layers.{i}.bias"] = a
    return state


def _load(model: MLP, path: str) -> MLP:
    with np.load(path) as z:
        params = {k: z[k] for k in z.files}
    model.load_state_dict(jax_params_to_torch(params))
    return model


def load_dnn2(path: str = NN3_1_DNN2) -> MLP:
    """DNN2 with the exported flax weights (float32, on the CPU)."""
    return _load(make_dnn2(), path)


def load_dnn1(path: str = NN_PRE_DNN1) -> MLP:
    """DNN1 with the exported flax weights (float32, on the CPU)."""
    return _load(make_dnn1(), path)


def entry_args(path: str = ENTRY_ARGS):
    """(DNN1, scenarios (8, 9) float32 numpy): the example arguments of the
    JAX package's flagship forward step, which
    scripts/export_entry_args.py exports (the DNN1 float32, on the CPU)."""
    with np.load(path) as z:
        params = {k: z[k] for k in z.files if k.startswith("params/")}
        scenarios = z["scenarios"]
    model = make_dnn1()
    model.load_state_dict(jax_params_to_torch(params))
    return model, scenarios
