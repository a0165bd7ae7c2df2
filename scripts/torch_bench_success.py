"""Closed-loop traversal success rate of a trained DNN2, on the PyTorch port.

benchmarks/bench_success.py's run on `learningagileflight_se3_torch`: N
scenarios, all flown at once through the 500-step moving-gate closed loop
(sim/closed_loop.py: 100 Hz plant, 10 Hz DNN2 -> MPC replanning on the
hand-written kernels), scored by evaluate_closed_loop_full.  Runs on the
CUDA card unless --device cpu; on the card the solver has the accelerator
settings of bench_success.py (H=50, max_iters=45, tol=1e-4, gtol=3e-4,
no_progress_iters=10, float32).

Prints ONE JSON line with bench_success.py's fields ("platform" is the
card's name) plus "wall_s", the flight's synced wall time, and
"failed_scenarios", the diagnostics of every scenario that did not traverse
the gate (the rows of "worst_scenarios"); given an npz with the reference
flight's states, "against_reference_states" says where each lane parts from
it.  Diagnostics go to stderr.

Usage:
  python3 scripts/torch_bench_success.py                      # nn3_1, seed 2024, the port's sampler
  python3 scripts/torch_bench_success.py --scenarios \\
      learningagileflight_se3_torch/weights/bench_success_seed2024.npz
      # the scenarios and gate noise the JAX benchmark drew for that seed
  python3 scripts/torch_bench_success.py --ckpt runs/x/nn3_1 --n 128 --static-gate
  python3 scripts/torch_bench_success.py --device cpu --float64 --scenarios runs/lanes/seed2024.npz
      # lanes exported with the JAX package's own f64 noise by scripts/export_lane_flights.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from learningagileflight_se3_torch.models.mlp import make_dnn2  # noqa: E402
from learningagileflight_se3_torch.models.sampler import sample_scenarios  # noqa: E402
from learningagileflight_se3_torch.sim.bench import fly, summarize  # noqa: E402
from learningagileflight_se3_torch.utils.checkpoint import load_params  # noqa: E402
from learningagileflight_se3_torch.utils.device import resolve_device  # noqa: E402
from learningagileflight_se3_torch.utils.weights import NN3_1_DNN2, bench_scenarios, load_dnn2  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_model2(ckpt: str):
    """DNN2 from an npz of flax arrays or a `save_params` directory."""
    return load_params(ckpt, make_dnn2()) if os.path.isdir(ckpt) else load_dnn2(ckpt)


def worst_scenarios(trace, metrics, scen, k, index=None):
    """Per-scenario diagnostics of the k worst flights by final goal
    distance."""
    final_d = metrics.final_dist.cpu().numpy()
    final_d = np.where(np.isfinite(final_d), final_d, np.inf)
    return scenario_rows(trace, metrics, scen, np.argsort(-final_d)[:k], "worst", index)


def scenario_rows(trace, metrics, scen, indices, what, index=None):
    """Per-scenario diagnostics of the flights `indices`, naming the tail
    mechanism (most specific first); `index` maps a flight to the
    benchmark's scenario index where the flights are a subset."""
    m = {name: v.cpu().numpy() for name, v in metrics._asdict().items()}
    rows = []
    for j, i in enumerate(indices):
        states = trace.states[i].cpu().numpy()
        tt = trace.tra_times[i].cpu().numpy()
        d = np.linalg.norm(states[1:, 0:3] - np.asarray(scen[i][3:6]), axis=1)
        sit = trace.solver_iters[i].cpu().numpy()
        sit = sit[sit > 0]
        speed = float(m["goal_speed_end"][i])
        if bool(m["diverged"][i]):
            mech = "diverged"
        elif np.abs(tt).max() > 15.0:
            mech = "tsolver_runaway"
        elif not bool(m["traversed"][i]):
            mech = "missed_gate"
        elif float(d.min()) < 2.0 and speed < 0.0:
            mech = "overshoot_drift"
        elif speed > 0.0:
            mech = "slow_arrival"
        else:
            mech = "stalled"
        finite = np.isfinite(d)
        rows.append({
            "scenario_index": int(i if index is None else index[i]), "mechanism": mech,
            "final_dist_m": round(float(m["final_dist"][i]), 3),
            "traversed": bool(m["traversed"][i]), "diverged": bool(m["diverged"][i]),
            "margin_m": round(float(m["margin"][i]), 3),
            "min_goal_dist_m": round(float(d[finite].min()), 3) if finite.any() else None,
            "step_of_min_goal_dist": int(np.nanargmin(d)) + 1 if finite.any() else None,
            "goal_closing_speed_end_mps": round(speed, 3),
            "tsolver_t_first_s": round(float(tt[0]), 3),
            "tsolver_t_max_s": round(float(np.nanmax(tt)), 3) if np.isfinite(tt).any() else None,
            "tsolver_t_last_s": round(float(tt[-1]), 3),
            "dnn2_t_last_s": round(float(trace.hl_variables[i, -1, 6]), 3),
            "replan_iters_mean": round(float(sit.mean()), 1) if sit.size else None,
            "max_speed_mps": round(float(np.nanmax(np.linalg.norm(states[:, 3:6], axis=1))), 2),
        })
        log(f"{what}[{j}] scenario {i}: {mech}  final {m['final_dist'][i]:.2f} m  "
            f"v_end {speed:+.2f} m/s")
    return rows


def parting(states, reference, metrics, index, tol=1e-6):
    """Lane by lane, where the flight's plant states part from a reference
    flight's (scripts/export_lane_flights.py): the first step at which they
    differ by more than `tol`, the largest difference before it, and the
    difference at the end."""
    d = np.abs(states - reference).max(axis=2)
    rows = []
    for j in range(d.shape[0]):
        apart = np.flatnonzero(d[j] > tol)
        first = int(apart[0]) if apart.size else None
        rows.append({"scenario_index": int(j if index is None else index[j]),
                     "traversed": bool(metrics.traversed[j]), "parted_at_step": first,
                     "max_diff_before": float(d[j, :first].max()) if first else float(d[j].max()),
                     "diff_at_end": float(d[j, -1])})
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=NN3_1_DNN2,
                    help="trained DNN2: an npz of flax arrays or a save_params directory")
    ap.add_argument("--n", type=int, default=128, help="number of scenarios")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--scenarios", default=None,
                    help="npz of exported scenarios and gate noise (scripts/export_torch_weights.py); "
                         "its first --n scenarios are flown in place of the port's own draw")
    ap.add_argument("--static-gate", action="store_true", help="zero gate velocity/rotation (ablation)")
    ap.add_argument("--estimate-gate-motion", action="store_true",
                    help="feed the planner the Kalman filter's gate velocity in place of the ground truth")
    ap.add_argument("--gate-obs-noise", type=float, default=0.0,
                    help="std (m) of the gate corner observation noise (with --estimate-gate-motion)")
    ap.add_argument("--worst", type=int, default=3, help="diagnose the K worst scenarios by final distance")
    ap.add_argument("--device", default="cuda", help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--float64", action="store_true",
                    help="fly in float64 (the benchmark flies float32); with --scenarios, an npz's "
                         "obs_noise array is used as the gate observation noise")
    args = ap.parse_args()

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gate_noise = obs_noise = index = reference = None
    if args.scenarios:
        scen, gate_noise = bench_scenarios(args.scenarios)
        scen, gate_noise = scen[:args.n], gate_noise[:args.n, :args.steps]
        with np.load(args.scenarios) as z:
            if args.float64 and "obs_noise" in z.files:
                obs_noise = z["obs_noise"][:args.n, :args.steps]
            if "indices" in z.files:  # exported lanes keep their benchmark indices
                index = z["indices"][:args.n]
            if "reference_states" in z.files:
                reference = z["reference_states"][:args.n, :args.steps + 1]
        if gate_noise.shape[1] < args.steps:
            raise SystemExit(f"{args.scenarios} holds {gate_noise.shape[1]} steps of gate noise")
    else:
        scen = sample_scenarios(torch.Generator().manual_seed(args.seed), args.n).numpy()
    model2 = load_model2(args.ckpt)
    platform = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log(f"loaded DNN2 from {args.ckpt}; device {platform}")

    trace, metrics, wall = fly(model2, scen, gate_noise, steps=args.steps, static_gate=args.static_gate,
                               estimate_gate_motion=args.estimate_gate_motion,
                               gate_obs_noise=args.gate_obs_noise, seed=args.seed, device=device,
                               dtype=torch.float64 if args.float64 else torch.float32, obs_noise=obs_noise)
    log(f"{len(scen)} x {args.steps}-step closed-loop flights in {wall:.1f} s")
    out = summarize(
        metrics, trace.solver_iters, sim_steps=int(args.steps),
        gate_motion="static" if args.static_gate else "moving",
        gate_velocity_source=(f"kalman_filter(obs_noise={args.gate_obs_noise})"
                              if args.estimate_gate_motion else "ground_truth"),
        ckpt=os.path.relpath(args.ckpt, REPO) if os.path.isabs(args.ckpt) else args.ckpt,
        seed=int(args.seed), scenarios=args.scenarios or "sample_scenarios", platform=platform,
        wall_s=round(wall, 3))
    out["failed_scenarios"] = scenario_rows(trace, metrics, scen, np.flatnonzero(~metrics.traversed.cpu().numpy()),
                                            "failed", index)
    if args.worst > 0:
        out["worst_scenarios"] = worst_scenarios(trace, metrics, scen, min(args.worst, len(scen)), index)
    if reference is not None:
        out["against_reference_states"] = parting(trace.states.cpu().numpy(), reference, metrics, index)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
