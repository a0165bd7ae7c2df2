"""Fly chosen lanes of benchmarks/bench_success.py's scenarios in the JAX
package on the CPU in float64, and export them for the PyTorch port.

For one recorded seed (2024 or 4096, the seeds of
artifacts/bench_success*.json) and the scenario indices given, this draws
what bench_success.py draws (sample_scenarios of the seed's first key, one
gate key per scenario), flies those lanes through the JAX package's closed
loop in float64 at bench_success.py's CPU settings (H=50, max_iters=45,
tol=1e-9, gtol=1e-7), and writes

  OUT.npz   indices (n,), scenarios (n, 9) float64 (the float32 draws), gate_noise
            (n, 500, 3) and, with --estimate-gate-motion, obs_noise
            (n, 500, 4, 3): the noise the JAX closed loop draws from each
            lane's key in float64; reference_states (n, 501, 13), the JAX
            flight's plant states
  OUT.json  the JAX flight's traversal, margin, final distance and last
            traversal times of each lane

so that `scripts/torch_bench_success.py --device cpu --float64 --scenarios
OUT.npz` flies the same lanes on the port's plain path with the same noise
and reports, lane by lane, where its states part from the JAX flight's.
Needs the JAX package (run on the CPU); the port never imports it.

Usage: python scripts/export_lane_flights.py --seed 2024 --lanes 117,124 --out runs/lanes/seed2024
       (also --static-gate, --estimate-gate-motion --gate-obs-noise 0.01)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from learningagileflight_se3_tpu.config import GateMotionConfig, SolverConfig  # noqa: E402
from learningagileflight_se3_tpu.models.mlp import make_dnn2  # noqa: E402
from learningagileflight_se3_tpu.models.sampler import sample_scenarios  # noqa: E402
from learningagileflight_se3_tpu.sim.closed_loop import (  # noqa: E402
    evaluate_closed_loop_full,
    make_closed_loop_sim,
)
from learningagileflight_se3_tpu.utils.checkpoint import load_params  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--lanes", required=True, help="comma-separated scenario indices")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--static-gate", action="store_true")
    ap.add_argument("--estimate-gate-motion", action="store_true")
    ap.add_argument("--gate-obs-noise", type=float, default=0.0)
    ap.add_argument("--out", required=True, help="output path without extension")
    args = ap.parse_args()
    lanes = [int(x) for x in args.lanes.split(",")]

    ks, kg = jax.random.split(jax.random.PRNGKey(args.seed))
    scen = np.asarray(sample_scenarios(ks, args.n).astype(jnp.float32), np.float64)[lanes]
    keys = jax.random.split(kg, args.n)[np.asarray(lanes)]
    motion = GateMotionConfig()
    if args.static_gate:
        motion = GateMotionConfig(velocity=(0.0, 0.0, 0.0), omega_y=0.0, noise_std=0.0)
    gate_noise = np.stack([np.asarray(jnp.clip(
        motion.noise_std * jax.random.normal(k, (args.steps, 3), jnp.float64),
        -motion.noise_clip, motion.noise_clip)) for k in keys])
    arrays = dict(scenarios=scen, gate_noise=gate_noise, indices=np.asarray(lanes))
    if args.estimate_gate_motion:
        arrays["obs_noise"] = np.stack([np.stack([args.gate_obs_noise * np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(k, 0x6B66), i), (4, 3), jnp.float64))
            for i in range(args.steps)]) for k in keys])

    model2 = make_dnn2()
    like = model2.init(jax.random.PRNGKey(0), jnp.zeros((1, 18)))
    params = load_params(os.path.join(REPO, "artifacts", "nn3_1"), like=like)
    cfg = SolverConfig(horizon=50, max_iters=45, tol=1e-9, gtol=1e-7, no_progress_iters=0)
    sim = make_closed_loop_sim(model2, solver_cfg=cfg, motion_cfg=motion, steps=args.steps,
                               estimate_gate_motion=args.estimate_gate_motion,
                               gate_obs_noise=args.gate_obs_noise)
    trace = jax.jit(jax.vmap(sim, in_axes=(None, 0, 0)))(params, jnp.asarray(scen), keys)
    m = jax.vmap(evaluate_closed_loop_full)(trace, jnp.asarray(scen[:, 3:6]))
    rows = []
    for j, i in enumerate(lanes):
        tt = np.asarray(trace.tra_times[j])
        rows.append({"scenario_index": i, "traversed": bool(m.traversed[j]),
                     "diverged": bool(m.diverged[j]), "margin_m": round(float(m.margin[j]), 4),
                     "final_dist_m": round(float(m.final_dist[j]), 4),
                     "tsolver_t_last_s": round(float(tt[-1]), 4),
                     "tsolver_t_min_s": round(float(tt.min()), 4)})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out + ".npz", reference_states=np.asarray(trace.states), **arrays)
    out = {"seed": args.seed, "static_gate": args.static_gate,
           "estimate_gate_motion": args.estimate_gate_motion, "gate_obs_noise": args.gate_obs_noise,
           "platform": "cpu", "dtype": "float64", "lanes": rows}
    with open(args.out + ".json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
