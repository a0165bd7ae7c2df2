"""One closed-loop MPC control query against the 10 Hz budget: the port's
bench_latency.py.

bench_latency.py's protocol: the PRNGKey(3) scenario at H=50,
`max_iters=5`, `tol=1e-4`, `gtol=3e-4`, f32; a cold solve, then 50
warm-started queries, each from the previous plan shifted one step (what
the tick does between ticks), the first 5 dropped.

The headline (`value`, `p90_s`) is a batch of one (B=1), because that is
what the port's tick solves (sim/external_controller.py): the kernels take
any batch, and the JAX tile of 128 rows was a TPU layout fix.  The JAX
tile is kept as a second row at B=128 (20 queries, the first 3 dropped, as
bench_latency.py times its second row).  `batch1_median_s` and
`pad_speedup` keep their JAX definitions: the B=1 median, and the B=1
median over the tile's, which on the card is expected under 1 (the tile
solves 128 copies of the query for one answer).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from learningagileflight_se3_torch.benchmarks.harness import card_fields, log, prepare
from learningagileflight_se3_torch.benchmarks.problems import bench_args, scenarios
from learningagileflight_se3_torch.config import CostWeights, QuadParams, SolverConfig
from learningagileflight_se3_torch.solver.ilqr import make_batched_mpc_solver

BUDGET_S = 0.1  # the reference's 10 Hz replanning budget


def warm_queries(solve, args, queries: int, drop: int) -> np.ndarray:
    """A cold solve of `args`, then `queries` warm-started ones (the plan
    shifted one step each time): the seconds of each after the first `drop`."""
    sol = solve(*args)
    U = sol.control_traj
    U.cpu()  # the fetch waits for the card
    lat = []
    for _ in range(queries):
        U = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
        t0 = time.perf_counter()
        sol = solve(*args, U_init=U)
        sol.control_traj.cpu()
        lat.append(time.perf_counter() - t0)
        U = sol.control_traj
    return np.asarray(lat[drop:])


def run(device="cuda", horizon: int = 50, queries: int = 50, tile: int = 128, tile_queries: int = 20) -> dict:
    """bench_latency.py's JSON fields for the port on `device` (the card
    unless given "cpu"), plus the card's name and power limit and the tile
    row."""
    device = prepare(device)
    cfg = SolverConfig(horizon=horizon, max_iters=5, tol=1e-4, gtol=3e-4)
    solve = make_batched_mpc_solver(QuadParams(), CostWeights(), cfg)
    scen = scenarios(3, 1)
    lat1 = warm_queries(solve, bench_args(scen, device), queries, drop=5)
    log(f"B=1 warm-start latency: median {np.median(lat1) * 1e3:.2f} ms p90 "
        f"{np.percentile(lat1, 90) * 1e3:.2f} ms max {lat1.max() * 1e3:.2f} ms")
    lat_t = warm_queries(solve, bench_args(np.tile(scen, (tile, 1)), device), tile_queries, drop=3)
    log(f"B={tile} tile latency: median {np.median(lat_t) * 1e3:.2f} ms")
    value = float(np.median(lat1))
    return {
        "metric": "mpc_query_latency",
        "value": round(value, 6),
        "unit": "s",
        "vs_baseline": round(BUDGET_S / value, 2),
        "p90_s": round(float(np.percentile(lat1, 90)), 6),
        "batch1_median_s": round(value, 6),
        "pad_speedup": round(value / float(np.median(lat_t)), 2),
        "horizon": horizon,
        **card_fields(device),
        "max_s": round(float(lat1.max()), 6),
        "headline_batch": 1,
        "tile_batch": tile,
        "tile_median_s": round(float(np.median(lat_t)), 6),
        "tile_p90_s": round(float(np.percentile(lat_t, 90)), 6),
        "n_queries": int(lat1.size),
        "notes": {
            "value": "B=1, the batch the port's tick solves; the JAX record's value is its padded tile",
            "pad_speedup": "B=1 median over the tile's median (the JAX definition)",
        },
    }
