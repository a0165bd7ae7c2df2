"""Export the shipped DNN2 checkpoint (artifacts/nn3_1, orbax) to an npz that
the PyTorch port reads with numpy alone.

Writes learningagileflight_se3_torch/weights/nn3_1_dnn2.npz holding the raw
flax arrays under "/"-joined keys ("params/Dense_0/kernel", ...);
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

from learningagileflight_se3_tpu.models.mlp import make_dnn2  # noqa: E402
from learningagileflight_se3_tpu.utils.checkpoint import load_params  # noqa: E402

OUT = os.path.join(REPO, "learningagileflight_se3_torch", "weights", "nn3_1_dnn2.npz")


def export(out: str = OUT):
    model2 = make_dnn2()
    like = model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    params = load_params(os.path.join(REPO, "artifacts", "nn3_1"), like=like)
    flat = traverse_util.flatten_dict(jax.device_get(params), sep="/")
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez(out, **arrays)
    return arrays


if __name__ == "__main__":
    arrays = export()
    for k, v in sorted(arrays.items()):
        print(k, v.shape, v.dtype)
    print(f"wrote {OUT}")
