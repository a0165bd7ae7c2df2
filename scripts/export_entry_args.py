"""Export the example arguments of the JAX package's flagship forward step
(`__graft_entry__.py` `entry()`) to an npz that the PyTorch port reads with
numpy alone:

  learningagileflight_se3_torch/weights/entry_args.npz
    params/Dense_<i>/kernel, params/Dense_<i>/bias
              the DNN1 of make_dnn1().init(PRNGKey(0), zeros((1, 9))),
              float32 (flax's layout: kernel (in, out))
    scenarios (8, 9) float32, sample_scenarios(PRNGKey(0), 8) cast to float32
    source    what these arrays are

The arrays are taken from `entry()[1]` itself, with JAX's default 32-bit
types, as `entry()` runs on an accelerator (the scenario draws in 64-bit
are other numbers).  `entry()` builds its solver but compiles and runs
none.  Needs the JAX package; the port itself never imports it.

Usage: python scripts/export_entry_args.py [--out FILE]
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

OUT = os.path.join(REPO, "learningagileflight_se3_torch", "weights", "entry_args.npz")
SOURCE = ("__graft_entry__.entry()[1] on the CPU in JAX's 32-bit types: the PRNGKey(0) DNN1 (flax keys "
          "params/Dense_<i>/kernel|bias) and sample_scenarios(PRNGKey(0), 8) as float32")


def entry_args() -> dict:
    """{"params/Dense_<i>/kernel" | "params/Dense_<i>/bias": float32 array,
    "scenarios": (8, 9) float32} from `__graft_entry__.entry()[1]`."""
    import __graft_entry__

    with jax.enable_x64(False):
        nn_params, scenarios = __graft_entry__.entry()[1]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(nn_params)[0]}
    return {**flat, "scenarios": np.asarray(scenarios)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = entry_args()
    np.savez_compressed(args.out, source=np.asarray(SOURCE), **out)
    print(f"wrote {', '.join(f'{k} {v.shape} {v.dtype}' for k, v in out.items())} to "
          f"{os.path.relpath(args.out, REPO)}")


if __name__ == "__main__":
    main()
