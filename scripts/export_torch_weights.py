"""Export the shipped checkpoints (orbax) to npz files that the PyTorch port
reads with numpy alone:

  artifacts/nn3_1   (DNN2) -> learningagileflight_se3_torch/weights/nn3_1_dnn2.npz
  artifacts/nn_pre  (DNN1) -> learningagileflight_se3_torch/weights/nn_pre_dnn1.npz
  artifacts/nn_deep (DNN1) -> learningagileflight_se3_torch/weights/nn_deep_dnn1.npz

Each npz holds the raw flax arrays under "/"-joined keys
("params/Dense_0/kernel", ...);
`learningagileflight_se3_torch.utils.weights.jax_params_to_torch` turns them
into a state_dict.  Needs the JAX package; the port itself never imports it.

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

from learningagileflight_se3_tpu.models.mlp import make_dnn1, make_dnn2  # noqa: E402
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


if __name__ == "__main__":
    for name in CHECKPOINTS:
        out, arrays = export(name)
        for k, v in sorted(arrays.items()):
            print(k, v.shape, v.dtype)
        print(f"wrote {out}")
