"""Export the shipped checkpoints (orbax) to npz files that the PyTorch port
reads with numpy alone:

  artifacts/nn3_1   (DNN2) -> learningagileflight_se3_torch/weights/nn3_1_dnn2.npz
  artifacts/nn_pre  (DNN1) -> learningagileflight_se3_torch/weights/nn_pre_dnn1.npz
  artifacts/nn_deep (DNN1) -> learningagileflight_se3_torch/weights/nn_deep_dnn1.npz

Each npz holds the raw flax arrays under "/"-joined keys
("params/Dense_0/kernel", ...);
`learningagileflight_se3_torch.utils.weights.jax_params_to_torch` turns them
into a state_dict.

It also writes the scenarios that benchmarks/bench_success.py flies for
seeds 2024 and 4096 (the seeds of artifacts/bench_success*.json), since the
port's sampler draws other numbers than jax.random:

  learningagileflight_se3_torch/weights/bench_success_seed{2024,4096}.npz
    scenarios  (128, 9)       float32, sample_scenarios of the seed's first key
    gate_noise (128, 500, 3)  float32, the clipped velocity noise gate_move
                              draws from each scenario's key

Sampling only: no closed loop is run.  Needs the JAX package; the port
itself never imports it.

Usage: python scripts/export_torch_weights.py
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from learningagileflight_se3_tpu.config import GateMotionConfig  # noqa: E402
from learningagileflight_se3_tpu.geometry.gate import gate_from_width, gate_move, rotate_y  # noqa: E402
from learningagileflight_se3_tpu.models.mlp import make_dnn1, make_dnn2  # noqa: E402
from learningagileflight_se3_tpu.models.sampler import sample_scenarios  # noqa: E402
from learningagileflight_se3_tpu.utils.checkpoint import load_params  # noqa: E402

WEIGHTS = os.path.join(REPO, "learningagileflight_se3_torch", "weights")
# checkpoint under artifacts/ -> (model factory, input width, npz name)
CHECKPOINTS = {
    "nn3_1": (make_dnn2, 18, "nn3_1_dnn2.npz"),
    "nn_pre": (make_dnn1, 9, "nn_pre_dnn1.npz"),
    "nn_deep": (make_dnn1, 9, "nn_deep_dnn1.npz"),
}


def export(name: str, out_dir: str = WEIGHTS):
    make, width, npz = CHECKPOINTS[name]
    like = make().init(jax.random.PRNGKey(0), jnp.zeros((1, width)))
    params = load_params(os.path.join(REPO, "artifacts", name), like=like)
    flat = traverse_util.flatten_dict(jax.device_get(params), sep="/")
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, npz)
    np.savez(out, **arrays)
    return out, arrays


BENCH_SEEDS = (2024, 4096)


def export_scenarios(seed: int, n: int = 128, steps: int = 500, out_dir: str = WEIGHTS):
    """What bench_success.py (default float32) samples for `seed`: the
    scenarios, and the noise that gate_move draws inside the closed loop."""
    assert not jax.config.jax_enable_x64, "bench_success.py samples in float32"
    motion = GateMotionConfig()
    ks, kg = jax.random.split(jax.random.PRNGKey(seed))
    scen = sample_scenarios(ks, n).astype(jnp.float32)
    gate_keys = jax.random.split(kg, n)
    noise = jax.vmap(lambda k: jnp.clip(
        motion.noise_std * jax.random.normal(k, (steps, 3), jnp.float32),
        -motion.noise_clip, motion.noise_clip))(gate_keys)
    # gate_move itself on the same keys: its velocities are velocity + noise
    velo = jnp.asarray(motion.velocity)
    _, V = jax.vmap(lambda s, k: gate_move(
        rotate_y(gate_from_width(s[7]), s[8]), k, velo, motion.omega_y, T=steps * 0.01, dt=0.01,
        noise_std=motion.noise_std, noise_clip=motion.noise_clip))(scen, gate_keys)
    assert np.array_equal(np.asarray(V[:, 1:]), np.asarray(velo + noise))
    out = os.path.join(out_dir, f"bench_success_seed{seed}.npz")
    np.savez(out, scenarios=np.asarray(scen), gate_noise=np.asarray(noise))
    return out, np.asarray(scen), np.asarray(noise)


if __name__ == "__main__":
    for seed in BENCH_SEEDS:
        out, scen, noise = export_scenarios(seed)
        print(f"wrote {out}: scenarios {scen.shape} {scen.dtype}, gate_noise {noise.shape} {noise.dtype}")
    for name in CHECKPOINTS:
        out, arrays = export(name)
        for k, v in sorted(arrays.items()):
            print(k, v.shape, v.dtype)
        print(f"wrote {out}")
