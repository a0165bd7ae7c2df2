"""Export the 32 problems of benchmarks/bench_accuracy.py to an npz that the
PyTorch port reads with numpy alone:

  learningagileflight_se3_torch/weights/accuracy_scenarios.npz
    x0       (32, 13)  float64, the initial state of scenario_to_problem
    goal     (32, 3)   float64, its goal position
    tra_ang  (32, 3)   float64, [0, pitch / 2, 0]
    t        (32,)     float64, the traversal time of the cell's regime
    u_ub     (32,)     float64, the cell's thrust bound
    variant  (32,)     str, "main" or "pybullet_bounds"
    regime   (32,)     str, "nominal" or "aggressive"

The rows come in bench_accuracy.py's order: for each variant (MAIN, then
PYBULLET with its sampler and thrust bound) and each regime (nominal, then
aggressive), the 8 scenarios sample_scenarios draws from PRNGKey(7).  The
first row of each cell is rows 0, 8, 16 and 24.  The traversal times are
the bench's: t_nom = clip(|r0| / 4, 2, 4), aggressive clip(0.7 t_nom, 1.2, 4).
Sampling only: no solve is run.  Needs the JAX package; the port itself
never imports it.

Usage: python scripts/export_accuracy_scenarios.py [--out FILE]
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
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from learningagileflight_se3_tpu.config import Variant, preset  # noqa: E402
from learningagileflight_se3_tpu.models.sampler import sample_scenarios, scenario_to_problem  # noqa: E402

OUT = os.path.join(REPO, "learningagileflight_se3_torch", "weights", "accuracy_scenarios.npz")
N_PER_CELL = 8
CELLS = [(variant, regime) for variant in ("main", "pybullet_bounds") for regime in ("nominal", "aggressive")]


def accuracy_scenarios(n_per_cell: int = N_PER_CELL) -> dict:
    """bench_accuracy.py's problems as numpy arrays, in its order."""
    rows = {k: [] for k in ("x0", "goal", "tra_ang", "t", "u_ub", "variant", "regime")}
    for variant in (Variant.MAIN, Variant.PYBULLET):
        _, _, cfg, _, sampler_cfg, _ = preset(variant)
        scen = np.asarray(sample_scenarios(jax.random.PRNGKey(7), n_per_cell, sampler_cfg))
        name = "main" if variant is Variant.MAIN else "pybullet_bounds"
        for regime in ("nominal", "aggressive"):
            for i in range(n_per_cell):
                prob = scenario_to_problem(jnp.asarray(scen[i]))
                x0 = np.asarray(prob["x0"], np.float64)
                t_nom = float(np.clip(np.linalg.norm(x0[0:3]) / 4.0, 2.0, 4.0))
                t = t_nom if regime == "nominal" else float(np.clip(0.7 * t_nom, 1.2, 4.0))
                rows["x0"].append(x0)
                rows["goal"].append(np.asarray(prob["goal_pos"], np.float64))
                rows["tra_ang"].append(np.array([0.0, float(scen[i, 8]) * 0.5, 0.0]))
                rows["t"].append(t)
                rows["u_ub"].append(float(cfg.u_ub))
                rows["variant"].append(name)
                rows["regime"].append(regime)
    return {k: np.asarray(v) for k, v in rows.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = accuracy_scenarios()
    np.savez(args.out, **out)
    print(f"wrote {len(out['t'])} scenarios to {os.path.relpath(args.out, REPO)}")


if __name__ == "__main__":
    main()
