"""The JAX package's validation flight of the shipped DNN2, for comparison
with the PyTorch port's (chip_smoke.py phase 11).

Flies `learningagileflight_se3_tpu.sim.validation_sim.run_validation_sim`
with `artifacts/nn3_1` at its defaults (5 s, 100 Hz plant, 10 Hz tick) on
the CPU in float64 for the seeds given, and prints one JSON line per seed:
through_gate, gate_margin, final_distance and the plant position at 1, 2 and
5 s.  Needs the JAX package; the port never imports it.

Usage: python scripts/jax_validation_flights.py --seeds 0,1,2,3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from learningagileflight_se3_tpu.models.mlp import make_dnn2  # noqa: E402
from learningagileflight_se3_tpu.sim.validation_sim import run_validation_sim  # noqa: E402
from learningagileflight_se3_tpu.utils.checkpoint import load_params  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    args = ap.parse_args()
    model2 = make_dnn2()
    like = model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    params = load_params(os.path.join(REPO, "artifacts", "nn3_1"), like=like)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_validation_sim(model2, params, seed=seed)
        X = out["states"]
        print(json.dumps({"seed": seed, "through_gate": out["through_gate"], "gate_margin": out["gate_margin"],
                          "final_distance": out["final_distance"],
                          "position_1s_2s_5s": [X[99, 0:3].round(3).tolist(), X[199, 0:3].round(3).tolist(),
                                                X[-1, 0:3].round(3).tolist()]}), flush=True)


if __name__ == "__main__":
    main()
