"""Scoring a DNN2 by batched closed-loop flights: the solver settings, the
timed flight and the summary of `benchmarks/bench_success.py`, shared by
scripts/torch_bench_success.py, scripts/torch_train_pipeline.py, the
profiling scripts and chip_smoke.py.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from learningagileflight_se3_torch.config import (
    CostWeights,
    GateMotionConfig,
    QuadParams,
    SolverConfig,
)
from learningagileflight_se3_torch.sim.closed_loop import (
    evaluate_closed_loop_full,
    make_closed_loop_sim,
)
from learningagileflight_se3_torch.utils.device import resolve_device


def flight_solver_config(horizon: int = 50, max_iters: int = 45) -> SolverConfig:
    """bench_success.py's solver settings on an accelerator: the float32
    tolerances and the no-progress window."""
    return SolverConfig(horizon=horizon, max_iters=max_iters, tol=1e-4, gtol=3e-4, no_progress_iters=10)


def tight_solver_config(horizon: int = 50, max_iters: int = 45) -> SolverConfig:
    """bench_success.py's solver settings on the CPU (float64): tight
    tolerances, no progress window."""
    return SolverConfig(horizon=horizon, max_iters=max_iters, tol=1e-9, gtol=1e-7, no_progress_iters=0)


def solver_config(device: torch.device, horizon: int = 50, max_iters: int = 45) -> SolverConfig:
    """bench_success.py's choice: the tight settings on the CPU, the
    flight's on an accelerator."""
    make = tight_solver_config if device.type == "cpu" else flight_solver_config
    return make(horizon, max_iters)


def fly(model2, scen, gate_noise=None, *, steps=500, static_gate=False, estimate_gate_motion=False,
        gate_obs_noise=0.0, seed=0, device="cuda", solver_cfg=None, dtype=torch.float32, obs_noise=None,
        fixed_point_accel="reference"):
    """Fly `scen` (n, 9) through the closed loop in `dtype` (float32, as the
    benchmark flies).  Returns (log, metrics, synced wall seconds).  The gate
    noise is `gate_noise`, or drawn from a generator seeded by `seed`; so is
    the observation noise, unless `obs_noise` is given.  `fixed_point_accel`
    is the traversal-time fixed point's update (bench_realtime.py flies
    "secant")."""
    device = resolve_device(device)
    motion = GateMotionConfig()
    if static_gate:
        motion, gate_noise = GateMotionConfig(velocity=(0.0, 0.0, 0.0), omega_y=0.0, noise_std=0.0), None
    sim = make_closed_loop_sim(model2, QuadParams(), CostWeights(), solver_cfg or solver_config(device),
                               motion_cfg=motion, steps=steps, estimate_gate_motion=estimate_gate_motion,
                               gate_obs_noise=gate_obs_noise, fixed_point_accel=fixed_point_accel,
                               device=device, dtype=dtype)
    scen = torch.as_tensor(scen, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    trace = sim(scen, generator=gen, gate_noise=gate_noise, obs_noise=obs_noise)
    metrics = evaluate_closed_loop_full(trace, scen[:, 3:6])
    sync()
    return trace, metrics, time.perf_counter() - t0


def summarize(metrics, solver_iters, **extra) -> dict:
    """bench_success.py's JSON fields from a batch's scorecard."""
    m = {k: v.cpu().numpy() for k, v in metrics._asdict().items()}
    ok, diverged, final_d, goal_speed = m["traversed"], m["diverged"], m["final_dist"], m["goal_speed_end"]
    it = solver_iters.cpu().numpy()
    it = it[it > 0]  # nonzero rows = replan steps
    return {
        "metric": "closed_loop_success_rate",
        "value": round(float(ok.mean()), 4),
        "unit": "frac",
        "n_scenarios": int(ok.size),
        "success_and_reached_2m": round(float((ok & m["reached_2m"] & ~diverged).mean()), 4),
        "success_and_reached_1m": round(float((ok & m["reached_1m"] & ~diverged).mean()), 4),
        "n_diverged": int(diverged.sum()),
        "mean_margin_m": round(float(m["margin"][ok].mean()) if ok.any() else -1.0, 4),
        "mean_final_dist_m": round(float(final_d.mean()), 4),
        "median_final_dist_m": round(float(np.median(final_d)), 4),
        "final_dist_quantiles_m": {q: round(float(np.nanpercentile(final_d, int(q[1:]))), 3)
                                   for q in ("p10", "p50", "p90", "p99")},
        "mean_goal_closing_speed_end_mps": round(float(goal_speed.mean()), 3),
        "frac_still_converging_at_cut": round(
            float((goal_speed[final_d > 2.0] > 0.0).mean()) if (final_d > 2.0).any() else 1.0, 4),
        "replan_solver_iters_p50": float(np.median(it)) if it.size else None,
        "replan_solver_iters_p90": float(np.percentile(it, 90)) if it.size else None,
        **extra,
    }
